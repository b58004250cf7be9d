// The two-phase LM step's cost derivatives and acceptance cost in one pass:
// l_x, l_xx, l_u, l_uu and J of costs.all_cost_derivs_and_J at (X, U), for
// the Riccati kernel (riccati.cu, K2) to read as they are written.
//
// The JAX reference computes them in XLA (solver_batched's two-phase path);
// the port's plain version is costs.all_cost_derivs_and_J, ~250 PyTorch
// kernels per LM step at CCNMPC's shapes.  Per (lane b, step j):
//   * the closest point on the lane's local plan: the tournament over its S
//     table samples, then the exact 3-candidate refine (cost_terms.cuh,
//     shared with K1 and K3);
//   * the tracking terms, the four control barriers and the step's share of
//     J (cost_terms.cuh);
//   * every obstacle slot m whose mask is not 0, both discs: the
//     rotated-ellipse barrier of obstacles.obstacle_cost_derivs from the
//     slot's dims and pose at step j, in the plain version's expression
//     order (half-axes, then the rotation into the obstacle frame, then
//     dx^2/a^2 + dy^2/b^2), each operation explicitly rounded;
//   * given external planes (e, gx, gy) at (b, j), the uncertainty barrier
//     (cost_terms.cuh, K3's).
// l_ux is identically zero and K2 does not read it: it is not written.
//
// The obstacles are shared (dims (M, N', 2), pos (M, N', 4), mask (M,)) or
// per lane (a leading B): the kernel reads each through element strides
// (b, m, step, component), so a stride-0 broadcast (ccnmpc's pos) is read
// at its shared shape and never copied.
//
// What bounds it on an H100: bytes.  At B=8192, N=40, three live obstacle
// slots of eight, S=200 it moves 63.5 MB (X, U, the live slots' per-lane
// dims, the scenario-minor sample table and the fit payload in; the four
// derivative tensors and J out): 0.019 ms, against 0.43 GFLOP
// (roofline.cost_step_ops, five per tournament candidate) at 0.006 ms.  In
// practice it is bound by instruction issue: each of the B x N items scans
// all S samples of its lane's table.
//
// Design.
//  * One thread per (lane, step): B x N independent items fill the card.  A
//    block holds L lanes (cfg.lanes, up to 8) and L x N threads (rounded up
//    to a warp), so a lane's table, staged once into shared memory, serves
//    its N steps; the threads of a lane read the same record (a broadcast).
//    The lanes' fit payloads are staged too.
//  * The table holds a 16-byte record (sxl, syl, r) per sample, r formed
//    once while staging with the plans' three rounded operations: the
//    tournament's candidate is one shared-memory load and four operations.
//    Against two 4-byte loads and r formed per candidate (K1's and K3's
//    layout, which spares their shared memory) it took 0.067 in place of
//    0.081 ms at B=8192 on one H100, the same bits; r stored as a third
//    4-byte channel 0.072 ms.  Records of one index in two lanes' tables lie
//    a record apart in the banks (table_pitch).
//  * The block's outputs are staged in shared memory, the 11 values that are
//    not constant per (lane, step), then written out: the block's L lanes
//    are one contiguous run of every batch-major output, which the block's
//    threads store word by word in order (coalesced), the constant entries
//    (zeros, l_xx[2][2]) formed on the way.
//  * J: each lane's steps summed in ascending order by one thread, so a
//    lane's J depends on neither B nor the launch shape.
//
// Numerics: no fast-math; the tournament, the refine and the obstacle
// barriers use explicitly rounded operations (no FMA contraction), the
// tracking, control and uncertainty terms are K3's.
#include "cost_terms.cuh"

using namespace cilqr;

// Mirrored field for field by cost_cuda._CostConfig (ctypes).
struct CostConfig {
  long long dims_stride[4], pos_stride[4];  // elements per (b, m, step, component)
  long long mask_stride[2];                 // elements per (b, m)
  int B, N, S, M, ncoef, has_obs, has_ext, lanes;
  DynConst dyn;
  float two_wpos, two_wvel, wpos, wvel, wacc, wyr, two_wacc, two_wyr, vdes;
  float q1a, q2a, q2a_sq, q1y, q2y, q2y_sq;
  float t_safe, s_safe_a, s_safe_b, ego_rad, efront, erear, w_obs;
  float q1f, q2f, q2f_sq, q1r, q2r, q2r_sq;
  float s1u, s2u;  // w_uncertainty q2, w_uncertainty q2^2
};

namespace {

constexpr int kMaxLanes = 8;      // lanes per block
constexpr int kMaxThreads = 512;  // lanes x steps per block
constexpr int kStaged = 11;       // lx 0-2, lxx 00 01 11, lu 0-1, luu 00 11, J
constexpr int kMaxSharedBytes = 232448;

// Floats between two lanes' tables: S records of 4, then one more record,
// so that two lanes' records at one index lie in other banks.
__host__ __device__ __forceinline__ int table_pitch(int S) { return 4 * S + 4; }

// Shared memory of a block: the tables, the staged outputs, the fits.
int shared_bytes(int lanes, int N, int S) {
  return (int)(((long long)lanes * table_pitch(S) + (long long)kStaged * lanes * N) *
                   sizeof(float) + (long long)lanes * sizeof(Fit));
}

// One disc's barrier against one obstacle (obstacles.obstacle_cost_derivs'
// `disc`): the gradient (vx, vy) and the Gauss-Newton Hessian (m00, m01,
// m11) at the disc centre (ex, ey), the obstacle at (px, py) with heading
// (co, so) and inverse squared half-axes ia2, ib2.
struct Barrier {
  float vx, vy, m00, m01, m11;
};

__device__ __forceinline__ Barrier disc_barrier(float ex, float ey, float px, float py, float co,
                                                float so, float ia2, float ib2, float q1, float q2,
                                                float q2_sq) {
  const float dxg = sub(ex, px), dyg = sub(ey, py);
  const float dx = add(mul(co, dxg), mul(so, dyg));
  const float dy = add(mul(-so, dxg), mul(co, dyg));
  const float cv = sub(1.0f, add(mul(mul(dx, dx), ia2), mul(mul(dy, dy), ib2)));
  const float gxo = mul(dx, ia2), gyo = mul(dy, ib2);
  const float gx = mul(-2.0f, sub(mul(co, gxo), mul(so, gyo)));
  const float gy = mul(-2.0f, add(mul(so, gxo), mul(co, gyo)));
  const float e = mul(q1, expf(mul(q2, cv)));
  const float s1 = mul(q2, e), s2 = mul(q2_sq, e);
  return {mul(gx, s1), mul(gy, s1), mul(s2, mul(gx, gx)), mul(s2, mul(gx, gy)),
          mul(s2, mul(gy, gy))};
}

__global__ void __launch_bounds__(kMaxThreads) cost_derivs_kernel(
    CostConfig c,
    const float* __restrict__ X,      // [B][N+1][4]
    const float* __restrict__ U,      // [B][N][2]
    const float* __restrict__ fit,    // [ncoef+10][B]
    const float* __restrict__ table,  // [S][2][B] sxl, syl
    const float* __restrict__ dims,   // through dims_stride
    const float* __restrict__ pos,    // through pos_stride
    const float* __restrict__ mask,   // through mask_stride
    const float* __restrict__ ext,    // [B][N][3] e, gx, gy (has_ext)
    float* __restrict__ l_x,          // [B][N][4]
    float* __restrict__ l_xx,         // [B][N][4][4]
    float* __restrict__ l_u,          // [B][N][2]
    float* __restrict__ l_uu,         // [B][N][2][2]
    float* __restrict__ J) {          // [B]
  extern __shared__ __align__(16) float smem[];
  const int L = c.lanes, N = c.N, S = c.S, LN = L * N;
  float* tabs = smem;                             // [L][table_pitch(S)]
  float* staged = tabs + L * table_pitch(S);      // [kStaged][L * N]
  Fit* fits = reinterpret_cast<Fit*>(staged + kStaged * LN);
  const int b0 = blockIdx.x * L;
  const int nl = min(L, c.B - b0);
  const int t = threadIdx.x;
  const int items = nl * N;

  // the lanes' tables, a record (sxl, syl, r) per sample: rows (s,
  // component) of B floats, nl neighbours each
  for (int e = t; e < S * nl; e += blockDim.x) {
    const int l = e % nl, s = e / nl;
    const float sxl = table[(size_t)(2 * s) * c.B + b0 + l];
    const float syl = table[(size_t)(2 * s + 1) * c.B + b0 + l];
    reinterpret_cast<float4*>(tabs + l * table_pitch(S))[s] =
        make_float4(sxl, syl, add(mul(sxl, sxl), mul(syl, syl)), 0.0f);
  }
  if (t < nl) fits[t] = read_fit(c, fit, b0 + t);
  __syncthreads();

  if (t < items) {
    const int l = t / N, j = t - l * N, b = b0 + l;
    const float* xr = X + ((size_t)b * (N + 1) + j) * 4;
    const float x0 = xr[0], x1 = xr[1], x2 = xr[2], x3 = xr[3];
    const float u0 = U[((size_t)b * N + j) * 2], u1 = U[((size_t)b * N + j) * 2 + 1];

    float cxp, cyp;
    const PackedTable tab{reinterpret_cast<const float4*>(tabs + l * table_pitch(S))};
    closest_point<1>(fits[l], tab, S, 0, 0u, 0, x0, x1, cxp, cyp);
    float ex, ey, ev, lx[3];
    tracking_terms(c, x0, x1, x2, cxp, cyp, ex, ey, ev, lx);
    float lxx00 = c.two_wpos, lxx01 = 0.0f, lxx11 = c.two_wpos;

    if (c.has_obs) {
      // the two disc centres, X + (+-1 * cos th) * reach
      const float cth = cosf(x3), sth = sinf(x3);
      const float fx = add(x0, mul(cth, c.efront)), fy = add(x1, mul(sth, c.efront));
      const float rx = add(x0, mul(-cth, c.erear)), ry = add(x1, mul(-sth, c.erear));
      const long long* ds = c.dims_stride;
      const long long* ps = c.pos_stride;
      float v0 = 0.0f, v1 = 0.0f, a00 = 0.0f, a01 = 0.0f, a11 = 0.0f;
      for (int m = 0; m < c.M; ++m) {
        // a padding slot (mask 0) adds nothing; passed over, an overflowed
        // barrier there cannot give inf * 0 = NaN
        const float msk = mask[b * c.mask_stride[0] + m * c.mask_stride[1]];
        if (msk == 0.0f) continue;
        const float* dm = dims + b * ds[0] + m * ds[1] + j * ds[2];
        const float* pm = pos + b * ps[0] + m * ps[1] + j * ps[2];
        const float px = pm[0], py = pm[ps[3]], ov = pm[2 * ps[3]], oth = pm[3 * ps[3]];
        const float co = cosf(oth), so = sinf(oth);
        // half-axes (Obstacle.cpp:39-63)
        const float a = add(add(add(mul(dm[0], 0.5f), mul(fabsf(mul(ov, co)), c.t_safe)),
                                c.s_safe_a), c.ego_rad);
        const float bh = add(add(add(add(mul(dm[ds[3]], 0.5f), mul(fabsf(mul(ov, so)), c.t_safe)),
                                     c.s_safe_b), c.ego_rad), 1.0f);
        const float ia2 = __fdiv_rn(1.0f, mul(a, a)), ib2 = __fdiv_rn(1.0f, mul(bh, bh));
        const Barrier f = disc_barrier(fx, fy, px, py, co, so, ia2, ib2, c.q1f, c.q2f, c.q2f_sq);
        const Barrier r = disc_barrier(rx, ry, px, py, co, so, ia2, ib2, c.q1r, c.q2r, c.q2r_sq);
        v0 = add(v0, mul(add(f.vx, r.vx), msk));
        v1 = add(v1, mul(add(f.vy, r.vy), msk));
        a00 = add(a00, mul(add(f.m00, r.m00), msk));
        a01 = add(a01, mul(add(f.m01, r.m01), msk));
        a11 = add(a11, mul(add(f.m11, r.m11), msk));
      }
      lx[0] = add(lx[0], mul(c.w_obs, v0));
      lx[1] = add(lx[1], mul(c.w_obs, v1));
      lxx00 = add(lxx00, mul(c.w_obs, a00));
      lxx01 = add(lxx01, mul(c.w_obs, a01));
      lxx11 = add(lxx11, mul(c.w_obs, a11));
    }
    if (c.has_ext) {
      const float* pe = ext + ((size_t)b * N + j) * 3;
      uncertainty_terms(c, pe[0], pe[1], pe[2], lx, lxx00, lxx01, lxx11);
    }
    float lu[2], luu[2];
    control_terms(c, x2, u0, u1, lu, luu);
    const float v[kStaged] = {lx[0], lx[1], lx[2], lxx00, lxx01, lxx11,
                              lu[0], lu[1], luu[0], luu[1], step_cost(c, ex, ey, ev, u0, u1)};
#pragma unroll
    for (int k = 0; k < kStaged; ++k) staged[k * LN + t] = v[k];
  }
  __syncthreads();

  if (t < nl) {
    const float* Js = staged + 10 * LN + t * N;
    float acc = 0.0f;
    for (int j = 0; j < N; ++j) acc = add(acc, Js[j]);
    J[b0 + t] = acc;
  }
  // the block's lanes are one contiguous run of each output, item i = l N + j
  const size_t run = (size_t)b0 * N;
  for (int e = t; e < items * 4; e += blockDim.x) {
    const int k = e & 3;
    l_x[run * 4 + e] = k < 3 ? staged[k * LN + (e >> 2)] : 0.0f;
  }
  for (int e = t; e < items * 16; e += blockDim.x) {
    const int row = (e >> 2) & 3, col = e & 3;
    float v = 0.0f;
    if (row < 2 && col < 2) v = staged[(3 + row + col) * LN + (e >> 4)];
    else if (row == 2 && col == 2) v = c.two_wvel;
    l_xx[run * 16 + e] = v;
  }
  for (int e = t; e < items * 2; e += blockDim.x) l_u[run * 2 + e] = staged[(6 + (e & 1)) * LN + (e >> 1)];
  for (int e = t; e < items * 4; e += blockDim.x) {
    const int k = e & 3;
    l_uu[run * 4 + e] = k == 0 ? staged[8 * LN + (e >> 2)] : k == 3 ? staged[9 * LN + (e >> 2)] : 0.0f;
  }
}

int valid(const CostConfig& c) {
  return c.B >= 1 && c.N >= 1 && c.S >= 1 && c.M >= 0 && c.ncoef >= 1 && c.ncoef <= kMaxCoef &&
         c.lanes >= 1 && c.lanes <= kMaxLanes && c.lanes * c.N <= kMaxThreads &&
         shared_bytes(c.lanes, c.N, c.S) <= kMaxSharedBytes;
}

}  // namespace

extern "C" int cilqr_cost_config_size() { return (int)sizeof(CostConfig); }

// One launch: ceil(B / lanes) blocks of lanes x N threads (rounded up to a
// warp).  dims, pos and mask are read only with has_obs, ext only with
// has_ext.
extern "C" int cilqr_cost_derivs(const CostConfig* cfg, const float* X, const float* U,
                                 const float* fit, const float* table, const float* dims,
                                 const float* pos, const float* mask, const float* ext,
                                 float* l_x, float* l_xx, float* l_u, float* l_uu, float* J,
                                 void* stream) {
  const CostConfig& c = *cfg;
  if (!valid(c) || (c.has_obs && (!dims || !pos || !mask)) || (c.has_ext && !ext))
    return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(c.lanes, c.N, c.S);
  const int rc = (int)cudaFuncSetAttribute(cost_derivs_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const int threads = (c.lanes * c.N + 31) / 32 * 32;
  const int blocks = (c.B + c.lanes - 1) / c.lanes;
  cost_derivs_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      c, X, U, fit, table, dims, pos, mask, ext, l_x, l_xx, l_u, l_uu, J);
  return (int)cudaGetLastError();
}

// out = [registers per thread, local-memory bytes per thread, shared-memory
// bytes per block, resident blocks per SM] of a launch with `lanes` lanes of
// N steps and S table samples.
extern "C" int cilqr_cost_resources(int lanes, int N, int S, int* out) {
  if (lanes < 1 || lanes > kMaxLanes || N < 1 || lanes * N > kMaxThreads || S < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = shared_bytes(lanes, N, S);
  cudaFuncAttributes attr;
  int rc = (int)cudaFuncGetAttributes(&attr, cost_derivs_kernel);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(cost_derivs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
  if (rc != 0) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, cost_derivs_kernel, (lanes * N + 31) / 32 * 32, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem;
  out[3] = blocks;
  return rc;
}
