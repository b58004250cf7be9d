// Batched backward Riccati recursion + closed-loop forward rollout.
//
// Replaces the TPU kernel cilqr_tpu/ops/riccati_pallas.py: `_kernel` (the
// backward recursion, riccati_pallas.py:84) and `_fwd_kernel` (the rollout,
// :225), launched by `backward_forward_batched` (:356) and
// `backward_batched` (:296).  One kernel serves both: `do_forward` = 0 is
// the backward-only form.
//
// What bounds it on an H100: bytes.  Each scenario is a sequential recursion
// of ~650 operations per step over N steps with no reuse across scenarios;
// per step it reads 26 floats of derivatives and 6 of X and U and writes 6
// (or 10 of gains): ~5 operations per byte, below the card's balance point
// of 20, so the derivatives read once set the bound at large B and the
// latency of one scenario's dependent chain sets the time at small B.
//
// Design: the kernel reads and writes the tensors as PyTorch holds them,
// batch-major ((B, N, 4, 4) and so on), so the wrapper makes no layout copy.
// A block is one warp of T scenarios, one scenario per lane (lanes >= T only
// help to copy).  A scenario's C steps of one array are a contiguous run in
// device memory; all 32 lanes copy the warp's runs with 16-byte cp.async
// (8-byte for the two-float arrays, whose rows are only 8-byte aligned) into
// a ring of two chunk buffers in shared memory, the next chunk in flight
// while the lanes compute the current one.  A buffer is [scenario][step]
// records of 128 bytes (l_xx 64, l_x 16, l_uu 16, X[j+1] 16, l_u 8, U 8; in
// the rollout 32 bytes: X[j] 16, U 8, and four times the steps), with a
// scenario pitch of C * 128 + 16 bytes: an odd number of 16-byte units, so
// the 16-byte read of one record field by the lanes of a quarter warp
// touches all 32 banks once.  v, theta and a come from X[j+1] and U[j] in
// the kernel.  The value function (20 floats) lives in registers.  Between
// the two passes k and K go through a device-memory scratch,
// [warp][step][component][T], that the rollout's ring brings back a chunk
// ahead: coalesced stores and 16-byte copies of one contiguous run.  Kept in
// shared memory instead (2,000 bytes per scenario at N = 50) they set how
// many scenarios an SM holds, and a large batch then ran in waves of one
// scenario's dependent chain: slower at B = 32768 and no faster at B = 4096,
// so that form went.  Backward-only writes k and K batch-major as its
// output.  The outputs are written with 16- and 8-byte stores straight from
// the lanes (rows of one scenario; L2 merges the sectors).  T = 16 scenarios
// per warp and chunks of C = 8 steps (runs of 512 bytes of l_xx) were the
// fastest, or within the spread of the fastest, of T = 8, 16, 32 and C = 2,
// 4, 8 in both forms at B = 32768 and B = 4096 on one H100, so both are
// constants; a scenario's arithmetic is one lane's whatever T is.
#include "cilqr_common.cuh"

using namespace cilqr;

// Mirrored field for field by riccati_cuda._RiccatiConfig (ctypes).
struct RiccatiConfig {
  int B, N, do_forward;
  float dt, acc_min, acc_max, tan_lo, tan_hi, speed_max;
};

namespace {

constexpr int kRecord = 128;     // bytes of one backward step's record
constexpr int kFwdRecord = 32;   // bytes of one rollout step's record
constexpr int kGainFloats = 10;  // k (2) and K (8) of one step
constexpr int T = 16;            // scenarios per warp (riccati_cuda.SCENARIOS_PER_WARP)
constexpr int C = 8;             // steps per backward chunk
constexpr int CF = 2 * C;        // steps per rollout chunk

// Bytes of one ring buffer per scenario: C backward records, or CF rollout
// records with their CF steps of gains behind them, whichever is larger.
constexpr int kBufferPitch =
    (C * kRecord > CF * (kFwdRecord + kGainFloats * 4) ? C * kRecord
                                                       : CF * (kFwdRecord + kGainFloats * 4)) + 16;
constexpr int kBufferBytes = T * kBufferPitch;
static_assert(T % 4 == 0 && T <= 32, "the gains' run is copied in 16-byte pieces by one warp");
static_assert(2 * kBufferBytes <= 48 * 1024, "the ring is static shared memory");

template <int BYTES>
__device__ __forceinline__ void cp_async(char* smem, const char* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  } else {
    static_assert(BYTES == 16 || BYTES == 8, "pieces of 16 or 8 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
  }
}

// All lanes copy n steps (from step j0 on) of one array for the warp's nsc
// scenarios: STEP_BYTES per step in device memory, in pieces of PIECE bytes,
// into the field at byte `off` of the buffer's records.  g points at step 0
// of the warp's first scenario; consecutive lanes take consecutive pieces of
// one scenario's run.
template <int CHUNK, int STEP_BYTES, int PIECE>
__device__ __forceinline__ void stage(char* buf, int pitch, int record, int off, const char* g,
                                      size_t scenario_bytes, int j0, int n, int nsc, int lane) {
  constexpr int PP = STEP_BYTES / PIECE;  // pieces per step
  constexpr int PER = CHUNK * PP;         // pieces per scenario and chunk
  for (int idx = lane; idx < nsc * PER; idx += 32) {
    const int s = idx / PER;
    const int r = idx - s * PER;
    const int st = r / PP;
    const int pc = r - st * PP;
    if (st < n) {
      cp_async<PIECE>(buf + s * pitch + st * record + off + pc * PIECE,
                      g + s * scenario_bytes + (size_t)(j0 + st) * STEP_BYTES + pc * PIECE);
    }
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// waits until at most one group (the chunk just started) is still in flight
__device__ __forceinline__ void wait_current() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__global__ void __launch_bounds__(32) riccati_kernel(
    RiccatiConfig cfg,
    const float* __restrict__ lx,    // [B][N][4]
    const float* __restrict__ lxx,   // [B][N][4][4]
    const float* __restrict__ lu,    // [B][N][2]
    const float* __restrict__ luu,   // [B][N][2][2]
    const float* __restrict__ lamb,  // [B]
    const float* __restrict__ X,     // [B][N+1][4]
    const float* __restrict__ U,     // [B][N][2]
    float* __restrict__ k,           // [B][N][2]      (backward only)
    float* __restrict__ K,           // [B][N][2][4]   (backward only)
    float* __restrict__ Xn,          // [B][N+1][4]
    float* __restrict__ Un,          // [B][N][2]
    float* __restrict__ scratch) {   // [warp][N][10][T] (with do_forward)
  __shared__ __align__(16) char smem[2 * kBufferBytes];
  const int B = cfg.B, N = cfg.N;
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * T;
  const int nsc = min(T, B - b0);
  const int b = b0 + lane;
  const bool active = lane < nsc;
  constexpr int pitch = C * kRecord + 16;
  constexpr int pitch_f = CF * kFwdRecord + 16;  // rollout records of one scenario
  auto ring = [&](int which) { return smem + which * kBufferBytes; };
  // gains between the passes, [step][component][T]: this warp's part of the scratch
  float* gains = scratch + (size_t)blockIdx.x * N * kGainFloats * T;

  const size_t s0 = (size_t)b0 * N;
  auto fetch_backward = [&](int q, char* buf) {
    const int j0 = q * C;
    const int n = min(C, N - j0);
    stage<C, 64, 16>(buf, pitch, kRecord, 0, (const char*)(lxx + s0 * 16), (size_t)N * 64, j0, n,
                     nsc, lane);
    stage<C, 16, 16>(buf, pitch, kRecord, 64, (const char*)(lx + s0 * 4), (size_t)N * 16, j0, n,
                     nsc, lane);
    stage<C, 16, 16>(buf, pitch, kRecord, 80, (const char*)(luu + s0 * 4), (size_t)N * 16, j0, n,
                     nsc, lane);
    // the successor state X[j+1] (the iLQR.cpp:102-106 quirk)
    stage<C, 16, 16>(buf, pitch, kRecord, 96, (const char*)(X + (size_t)b0 * (N + 1) * 4 + 4),
                     (size_t)(N + 1) * 16, j0, n, nsc, lane);
    stage<C, 8, 8>(buf, pitch, kRecord, 112, (const char*)(lu + s0 * 2), (size_t)N * 8, j0, n, nsc,
                   lane);
    stage<C, 8, 8>(buf, pitch, kRecord, 120, (const char*)(U + s0 * 2), (size_t)N * 8, j0, n, nsc,
                   lane);
  };

  const float lam = active ? lamb[b] : 1.0f;
  float Vx[4], Vxx[16];
  const int nq = (N + C - 1) / C;
  fetch_backward(nq - 1, ring(0));
  commit();
  for (int q = nq - 1; q >= 0; --q) {
    const int cur = (nq - 1 - q) & 1;
    if (q > 0) fetch_backward(q - 1, ring(cur ^ 1));
    commit();  // an empty group after the last chunk keeps the count uniform
    wait_current();
    __syncwarp();  // every lane's copies of the current chunk have landed
    if (active) {
      const int j0 = q * C;
      for (int st = min(C, N - j0) - 1; st >= 0; --st) {
        const int j = j0 + st;
        const float4* rec = (const float4*)(ring(cur) + lane * pitch + st * kRecord);
        float l_xx[16], l_x[4], kj[2], Kj[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v4 = rec[i];
          l_xx[4 * i] = v4.x, l_xx[4 * i + 1] = v4.y, l_xx[4 * i + 2] = v4.z, l_xx[4 * i + 3] = v4.w;
        }
        const float4 x4 = rec[4], uu4 = rec[5], xs4 = rec[6], lu4 = rec[7];
        l_x[0] = x4.x, l_x[1] = x4.y, l_x[2] = x4.z, l_x[3] = x4.w;
        if (j == N - 1) {  // V seeded from the step N-1 running cost (iLQR.cpp:108-113)
#pragma unroll
          for (int i = 0; i < 4; ++i) Vx[i] = l_x[i];
#pragma unroll
          for (int i = 0; i < 16; ++i) Vxx[i] = l_xx[i];
        }
        const float l_u[2] = {lu4.x, lu4.y};
        const float l_uu[3] = {uu4.x, uu4.y, uu4.w};
        riccati_backward_step(l_x, l_xx, l_u, l_uu, xs4.z, cosf(xs4.w), sinf(xs4.w), lu4.z,
                              cfg.dt, lam, Vx, Vxx, kj, Kj);
        if (cfg.do_forward) {
          float* g = gains + j * kGainFloats * T + lane;
          g[0] = kj[0];
          g[T] = kj[1];
#pragma unroll
          for (int i = 0; i < 8; ++i) g[(2 + i) * T] = Kj[i];
        } else {
          const size_t row = (size_t)b * N + j;
          *(float2*)(k + row * 2) = make_float2(kj[0], kj[1]);
          *(float4*)(K + row * 8) = make_float4(Kj[0], Kj[1], Kj[2], Kj[3]);
          *(float4*)(K + row * 8 + 4) = make_float4(Kj[4], Kj[5], Kj[6], Kj[7]);
        }
      }
    }
    __syncwarp();  // the buffer is free for the chunk after next
  }
  if (!cfg.do_forward) return;

  // the rollout: chunks of CF steps of (X[j], U[j]) through the same ring, and
  // behind them in the buffer the chunk's gains from the scratch (written
  // above by other lanes of this warp: __syncwarp orders them)
  auto fetch_forward = [&](int q, char* buf) {
    const int j0 = q * CF;
    const int n = min(CF, N - j0);
    stage<CF, 16, 16>(buf, pitch_f, kFwdRecord, 0, (const char*)(X + (size_t)b0 * (N + 1) * 4),
                      (size_t)(N + 1) * 16, j0, n, nsc, lane);
    stage<CF, 8, 8>(buf, pitch_f, kFwdRecord, 16, (const char*)(U + s0 * 2), (size_t)N * 8, j0, n,
                    nsc, lane);
    const float* src = gains + j0 * kGainFloats * T;
    char* dst = buf + T * pitch_f;
    const int count = n * kGainFloats * T;  // one contiguous run
    for (int e = lane * 4; e < count; e += 128) cp_async<16>(dst + e * 4, (const char*)(src + e));
  };
  const DynConst dc{cfg.dt, cfg.acc_min, cfg.acc_max, cfg.tan_lo, cfg.tan_hi, cfg.speed_max};
  float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (active) {
    const float4 x0 = *(const float4*)(X + (size_t)b * (N + 1) * 4);
    x[0] = x0.x, x[1] = x0.y, x[2] = x0.z, x[3] = x0.w;
    *(float4*)(Xn + (size_t)b * (N + 1) * 4) = x0;
  }
  const int nf = (N + CF - 1) / CF;
  fetch_forward(0, ring(0));
  commit();
  for (int q = 0; q < nf; ++q) {
    const int cur = q & 1;
    if (q + 1 < nf) fetch_forward(q + 1, ring(cur ^ 1));
    commit();
    wait_current();
    __syncwarp();
    if (active) {
      const int j0 = q * CF;
      const int n = min(CF, N - j0);
      const float* chunk_gains = (const float*)(ring(cur) + T * pitch_f);
      for (int st = 0; st < n; ++st) {
        const int j = j0 + st;
        const float4* rec = (const float4*)(ring(cur) + lane * pitch_f + st * kFwdRecord);
        const float4 x4 = rec[0], u4 = rec[1];
        const float Xj[4] = {x4.x, x4.y, x4.z, x4.w};
        const float Uj[2] = {u4.x, u4.y};
        const float* g = chunk_gains + st * kGainFloats * T + lane;
        const float kj[2] = {g[0], g[T]};
        float Kj[8], u[2];
#pragma unroll
        for (int i = 0; i < 8; ++i) Kj[i] = g[(2 + i) * T];
        rollout_step(dc, Xj, Uj, kj, Kj, x, u);
        *(float2*)(Un + ((size_t)b * N + j) * 2) = make_float2(u[0], u[1]);
        *(float4*)(Xn + ((size_t)b * (N + 1) + j + 1) * 4) = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// scratch ([ceil(B / T)][N][10][T] floats): cfg->do_forward only.
extern "C" int cilqr_riccati(const RiccatiConfig* cfg, const float* lx, const float* lxx,
                             const float* lu, const float* luu, const float* lamb,
                             const float* X, const float* U, float* k, float* K, float* Xn,
                             float* Un, float* scratch, void* stream) {
  const int blocks = (cfg->B + T - 1) / T;
  riccati_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(*cfg, lx, lxx, lu, luu, lamb, X, U, k, K,
                                                          Xn, Un, scratch);
  return (int)cudaGetLastError();
}

extern "C" int cilqr_riccati_config_size() { return (int)sizeof(RiccatiConfig); }

extern "C" const char* cilqr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
