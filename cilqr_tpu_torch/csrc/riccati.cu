// Batched backward Riccati recursion + closed-loop forward rollout.
//
// Replaces the TPU kernel cilqr_tpu/ops/riccati_pallas.py: `_kernel` (the
// backward recursion, riccati_pallas.py:84) and `_fwd_kernel` (the rollout,
// :225), launched by `backward_forward_batched` (:356) and
// `backward_batched` (:296).  One kernel serves both: `do_forward` = 0 is
// the backward-only form.
//
// What bounds it on an H100: each scenario is a sequential recursion of ~150
// flops per step over N steps, with no reuse across scenarios.  Per step a
// scenario reads 28 floats of derivatives and writes 10 floats of gains (and
// the rollout reads/writes 12 more), i.e. ~0.3 flop per byte: far below the
// card's balance point, so it is bound by device-memory bandwidth at large B
// and by the serial dependency chain (latency) at small B.
//
// Design: one thread per scenario, b = blockIdx.x * blockDim.x + threadIdx.x,
// masked to b < B; the value function (20 floats) lives in registers for
// the whole recursion; every per-step array is scenario-minor
// ([step][component][B]) so each warp load is one coalesced 128-byte line.
// k/K go through device memory between the two passes (L2-resident at the
// main-path batch size).
#include "cilqr_common.cuh"

using namespace cilqr;

// Mirrored field for field by riccati_cuda._RiccatiConfig (ctypes).
struct RiccatiConfig {
  int B, N, do_forward;
  float dt, acc_min, acc_max, tan_lo, tan_hi, speed_max;
};

__global__ void riccati_kernel(RiccatiConfig cfg,
                               const float* __restrict__ lx,   // [N][4][B]
                               const float* __restrict__ lxx,  // [N][16][B]
                               const float* __restrict__ lu,   // [N][2][B]
                               const float* __restrict__ luu,  // [N][3][B]
                               const float* __restrict__ vta,  // [N][3][B]
                               const float* __restrict__ lamb, // [B]
                               const float* __restrict__ X,    // [N+1][4][B]
                               const float* __restrict__ U,    // [N][2][B]
                               float* __restrict__ k,          // [N][2][B]
                               float* __restrict__ K,          // [N][8][B]
                               float* __restrict__ Xn,         // [N+1][4][B]
                               float* __restrict__ Un) {       // [N][2][B]
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = cfg.B, N = cfg.N;
  if (b >= B) return;
  const float lam = lamb[b];

  // V seeded from the step N-1 running cost (iLQR.cpp:108-113)
  float Vx[4], Vxx[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) Vx[i] = lx[at(N - 1, i, 4, B, b)];
#pragma unroll
  for (int i = 0; i < 16; ++i) Vxx[i] = lxx[at(N - 1, i, 16, B, b)];

  for (int j = N - 1; j >= 0; --j) {
    float l_x[4], l_xx[16], l_u[2], l_uu[3], kj[2], Kj[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) l_x[i] = lx[at(j, i, 4, B, b)];
#pragma unroll
    for (int i = 0; i < 16; ++i) l_xx[i] = lxx[at(j, i, 16, B, b)];
    l_u[0] = lu[at(j, 0, 2, B, b)];
    l_u[1] = lu[at(j, 1, 2, B, b)];
#pragma unroll
    for (int i = 0; i < 3; ++i) l_uu[i] = luu[at(j, i, 3, B, b)];
    const float v = vta[at(j, 0, 3, B, b)];
    const float th = vta[at(j, 1, 3, B, b)];
    const float a = vta[at(j, 2, 3, B, b)];
    riccati_backward_step(l_x, l_xx, l_u, l_uu, v, cosf(th), sinf(th), a, cfg.dt, lam, Vx, Vxx, kj, Kj);
    k[at(j, 0, 2, B, b)] = kj[0];
    k[at(j, 1, 2, B, b)] = kj[1];
#pragma unroll
    for (int i = 0; i < 8; ++i) K[at(j, i, 8, B, b)] = Kj[i];
  }
  if (!cfg.do_forward) return;

  const DynConst dc{cfg.dt, cfg.acc_min, cfg.acc_max, cfg.tan_lo, cfg.tan_hi, cfg.speed_max};
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = X[at(0, i, 4, B, b)];
    Xn[at(0, i, 4, B, b)] = x[i];
  }
  for (int j = 0; j < N; ++j) {
    float Xj[4], Uj[2], kj[2], Kj[8], u[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) Xj[i] = X[at(j, i, 4, B, b)];
    Uj[0] = U[at(j, 0, 2, B, b)];
    Uj[1] = U[at(j, 1, 2, B, b)];
    kj[0] = k[at(j, 0, 2, B, b)];
    kj[1] = k[at(j, 1, 2, B, b)];
#pragma unroll
    for (int i = 0; i < 8; ++i) Kj[i] = K[at(j, i, 8, B, b)];
    rollout_step(dc, Xj, Uj, kj, Kj, x, u);
    Un[at(j, 0, 2, B, b)] = u[0];
    Un[at(j, 1, 2, B, b)] = u[1];
#pragma unroll
    for (int i = 0; i < 4; ++i) Xn[at(j + 1, i, 4, B, b)] = x[i];
  }
}

extern "C" int cilqr_riccati(const RiccatiConfig* cfg, const float* lx, const float* lxx,
                             const float* lu, const float* luu, const float* vta,
                             const float* lamb, const float* X, const float* U, float* k,
                             float* K, float* Xn, float* Un, void* stream) {
  const int threads = 128;
  const int blocks = (cfg->B + threads - 1) / threads;
  riccati_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *cfg, lx, lxx, lu, luu, vta, lamb, X, U, k, K, Xn, Un);
  return (int)cudaGetLastError();
}

extern "C" int cilqr_riccati_config_size() { return (int)sizeof(RiccatiConfig); }

extern "C" const char* cilqr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
