// The whole Levenberg-Marquardt CILQR loop per scenario, in one kernel (K1),
// and one LM iteration per scenario (K3).
//
// K1 replaces the TPU kernel cilqr_tpu/ops/lm_pallas.py `_opt_kernel`
// (:682), launched by `_fused_optimize_call` (:860) from `fused_optimize`
// (:923), with its subroutines `_gen_sample_table` (:249),
// `_make_closest_point` (:263), `_run_iteration` (:322) and riccati_pallas
// `_fwd_kernel` (:225).  K3 replaces `_iter_kernel` (:663), launched by
// `fused_iteration` (:841): the same `_run_iteration` once, on a given
// trajectory and lambda, with the sample table read from the local plans
// and, in the hybrid mode for one uncertainty map per scenario, external
// (e, gx, gy) sample planes instead of the in-kernel map sampler.
// Per scenario: the initial rollout of U0 from x0, then per LM iteration
// the closest-point tournament + exact 3-candidate refine, tracking /
// control / obstacle / uncertainty barrier derivatives, the acceptance cost
// J, the backward Riccati pass with the eigen-clamp 2x2 inverse, the forward
// rollout, accept/reject, the lambda update and the per-scenario stop.
//
// What bounds it on an H100: device-memory traffic of the sample table.
// Each LM iteration runs N+1 closest-point tournaments per scenario, each
// re-reading the scenario's S x 3 table (2.4 KB at S=200): ~120 KB per
// scenario per iteration, ~4 GB per iteration at B=32768, whose 78 MB of
// tables exceed the 50 MB L2.  The arithmetic (~4 flops per sample read)
// is far below the card's rate.  At B=32768 only ~8 warps per SM are
// resident (one thread per scenario), too few to hide the memory latency.
//
// K3 reads and writes the same per-scenario arrays once per launch; the
// host loop (lm_cuda.fused_optimize with a sampler) does accept/reject.
//
// Design: one thread per scenario, b = blockIdx.x * blockDim.x + threadIdx.x,
// masked to b < B.  A scenario's live state (sample table S x 3, X/U, the
// proposal, k and K: ~1,700 floats) exceeds the 255-register budget, so the
// per-step arrays live in device-memory scratch, scenario-minor
// ([step][component][B]) for coalesced warp access.  The shared world
// (obstacle payload, uncertainty map, map-frame scalars) is read-only and
// shared by all scenarios.  A scenario leaves the loop as soon as it stops;
// its results are those of the masked batch loop, since masked updates of a
// stopped lane are no-ops.
//
// Numerics: the sample table and the tournament distance are built with
// explicitly rounded operations (no FMA contraction), so they reproduce the
// plain version's sequence of roundings and pick the same winners.  The rest
// may contract a*b+c into FMA.  No fast-math: the exp error would be scaled
// by the barrier gains.
#include <cfloat>

#include "cilqr_common.cuh"

using namespace cilqr;

constexpr int kMaxCoef = 16;

// Mirrored field for field by lm_cuda._LMConfig (ctypes).
struct LMConfig {
  int B, N, S, M, H, W, ncoef, max_iterations, has_obs, has_unc;
  DynConst dyn;
  float two_wpos, two_wvel, wpos, wvel, wacc, wyr, two_wacc, two_wyr, vdes;
  float q1a, q2a, q2a_sq, q1y, q2y, q2y_sq;
  float q1f, q2f, s1f, s2f, q1r, q2r, s1r, s2r;
  float q1u, q2u, s1u, s2u;
  float efront, erear;
  float lamb_init, lamb_factor, lamb_max, tol;
};

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Per-scenario fit parameters (reference_path.LocalPlan.samp_frame).
struct Fit {
  float cs[kMaxCoef];
  int ncoef;
  float x_mid, inv_xscale, x0r, dr, ox, oy, cph, sph, qx, qy;
};

// Global-frame sample at (float) index s: Horner in reversed coefficient
// order, then the rotate-back (lm_pallas._gen_global_sample).
__device__ __forceinline__ void global_sample(const Fit& f, float s, float& sxg, float& syg) {
  const float sxr = add(f.x0r, mul(f.dr, s));
  const float t = mul(sub(sxr, f.x_mid), f.inv_xscale);
  float r = 0.0f;
  for (int i = f.ncoef - 1; i >= 0; --i) r = add(mul(r, t), f.cs[i]);
  sxg = sub(add(f.ox, mul(f.cph, sxr)), mul(f.sph, r));
  syg = add(add(f.oy, mul(f.sph, sxr)), mul(f.cph, r));
}

struct Ctx {
  const LMConfig& c;
  const Fit& f;
  int b;
  const float* sxy;   // [S][3][B]
  const float* obs;   // [M*6][N]
  const float* map;   // [H][W]
  const float* scl;   // [16]
  const float* uext;  // [N][3][B] external (e, gx, gy) planes (K3; null in K1)
};

// Tournament argmin over the expanded local-frame distance (first minimum
// wins: strict <), then the exact global refine over {j-1, j, j+1}
// (lm_pallas._make_closest_point / reference_path.find_closest_points).
__device__ void closest_point(const Ctx& cx, float x0, float x1, float& cxp, float& cyp) {
  const Fit& f = cx.f;
  const int B = cx.c.B, b = cx.b, S = cx.c.S;
  const float dx0 = sub(x0, f.qx);
  const float dy0 = sub(x1, f.qy);
  const float xl = add(mul(f.cph, dx0), mul(f.sph, dy0));
  const float yl = sub(mul(f.cph, dy0), mul(f.sph, dx0));
  const float n0 = -2.0f * xl;
  const float n1 = -2.0f * yl;
  float best = FLT_MAX;
  int j = 0;
  for (int s = 0; s < S; ++s) {
    const float sxl = cx.sxy[at(s, 0, 3, B, b)];
    const float syl = cx.sxy[at(s, 1, 3, B, b)];
    const float r = cx.sxy[at(s, 2, 3, B, b)];
    const float d = add(add(r, mul(n0, sxl)), mul(n1, syl));
    if (s == 0 || d < best) {
      best = d;
      j = s;
    }
  }
  const float cand[3] = {fmaxf((float)j - 1.0f, 0.0f), (float)j,
                         fminf((float)j + 1.0f, (float)(S - 1))};
  float bd = 0.0f;
  for (int q = 0; q < 3; ++q) {
    float sxg, syg;
    global_sample(f, cand[q], sxg, syg);
    const float dxg = sub(x0, sxg);
    const float dyg = sub(x1, syg);
    const float dg = add(mul(dxg, dxg), mul(dyg, dyg));
    if (q == 0 || dg < bd) {
      bd = dg;
      cxp = sxg;
      cyp = syg;
    }
  }
}

// Bilinear costmap sample + global-frame gradient of c = val/100
// (models/uncertainty.py semantics): (e, gx, gy), e = 0 outside the map.
__device__ void unc_sample(const Ctx& cx, float x0, float x1, float& e, float& gx, float& gy) {
  const LMConfig& c = cx.c;
  const float* s = cx.scl;
  const float ox = s[0], oy = s[1], cyw = s[2], syw = s[3];
  const float fx0 = s[4], fy0 = s[5], ir = s[6];
  const float lox = s[7], hix = s[8], loy = s[9], hiy = s[10];
  const float d0 = x0 - ox;
  const float d1 = x1 - oy;
  const float lx = cyw * d0 + syw * d1;
  const float ly = -syw * d0 + cyw * d1;
  const bool inside = (lx >= lox) && (lx <= hix) && (ly >= loy) && (ly <= hiy);
  const float fi = clampf((fx0 - lx) * ir, 0.0f, (float)(c.H - 1));
  const float fj = clampf((fy0 - ly) * ir, 0.0f, (float)(c.W - 1));
  const float i0 = clampf(floorf(fi), 0.0f, (float)(c.H - 2));
  const float j0 = clampf(floorf(fj), 0.0f, (float)(c.W - 2));
  const float ti = fi - i0;
  const float tj = fj - j0;
  const int base = (int)i0 * c.W + (int)j0;
  const float v00 = cx.map[base];
  const float v01 = cx.map[base + 1];
  const float v10 = cx.map[base + c.W];
  const float v11 = cx.map[base + c.W + 1];
  const float v0 = v00 * (1.0f - tj) + v01 * tj;
  const float v1 = v10 * (1.0f - tj) + v11 * tj;
  const float val = v0 * (1.0f - ti) + v1 * ti;
  const float dv_di = v1 - v0;
  const float dv_dj = (v01 - v00) * (1.0f - ti) + (v11 - v10) * ti;
  const float gci = dv_di * (-ir) * 0.01f;
  const float gcj = dv_dj * (-ir) * 0.01f;
  gx = cyw * gci - syw * gcj;
  gy = syw * gci + cyw * gcj;
  e = inside ? c.q1u * expf(c.q2u * (val * 0.01f)) : 0.0f;
}

struct StepDerivs {
  float lx[3];    // l_x[3] == 0: yaw is untracked (Constraints.cpp:168)
  float lxx[4];   // (xx, xy, yy, vv): the only nonzeros of l_xx
  float lu[2];
  float luu[2];   // diagonal of l_uu (the off-diagonal is 0)
  float J;
};

// Cost derivatives and the J term at step j of trajectory (X, U)
// (costs.all_cost_derivs_and_J for one step).  kExt: the uncertainty sample
// comes from the external planes; K1 compiles that branch out.
template <bool kExt>
__device__ StepDerivs step_derivs(const Ctx& cx, const float* X, const float* U, int j) {
  const LMConfig& c = cx.c;
  const int B = c.B, b = cx.b, N = c.N;
  const float x0 = X[at(j, 0, 4, B, b)], x1 = X[at(j, 1, 4, B, b)];
  const float x2 = X[at(j, 2, 4, B, b)], x3 = X[at(j, 3, 4, B, b)];
  const float u0 = U[at(j, 0, 2, B, b)], u1 = U[at(j, 1, 2, B, b)];

  float cxp, cyp;
  closest_point(cx, x0, x1, cxp, cyp);
  const float ex = x0 - cxp, ey = x1 - cyp, ev = x2 - c.vdes;
  StepDerivs o;
  o.lx[0] = c.two_wpos * ex;
  o.lx[1] = c.two_wpos * ey;
  o.lx[2] = c.two_wvel * ev;
  float s00 = 0.0f, s01 = 0.0f, s11 = 0.0f;

  if (c.has_obs) {
    const float cth = cosf(x3), sth = sinf(x3);
    const float ecx[2] = {x0 + cth * c.efront, x0 - cth * c.erear};
    const float ecy[2] = {x1 + sth * c.efront, x1 - sth * c.erear};
    const float q1d[2] = {c.q1f, c.q1r}, q2d[2] = {c.q2f, c.q2r};
    const float s1d[2] = {c.s1f, c.s1r}, s2d[2] = {c.s2f, c.s2r};
    // every row of the payload, padding included: a padding row's mask is 0
    // and its barrier underflows to exactly 0
    for (int m = 0; m < c.M; ++m) {
      const float* row = cx.obs + (size_t)m * 6 * N + j;
      const float g11 = row[0 * N], g12 = row[1 * N], g22 = row[2 * N];
      const float px = row[3 * N], py = row[4 * N], msk = row[5 * N];
#pragma unroll
      for (int dsc = 0; dsc < 2; ++dsc) {
        const float dx = ecx[dsc] - px, dy = ecy[dsc] - py;
        const float gdx = g11 * dx + g12 * dy;
        const float gdy = g12 * dx + g22 * dy;
        const float cv = 1.0f - (dx * gdx + dy * gdy);
        const float e = (q1d[dsc] * msk) * expf(q2d[dsc] * cv);
        const float gx = -2.0f * gdx, gy = -2.0f * gdy;
        const float s1 = s1d[dsc] * e, s2 = s2d[dsc] * e;
        o.lx[0] += s1 * gx;
        o.lx[1] += s1 * gy;
        s00 += s2 * gx * gx;
        s01 += s2 * gx * gy;
        s11 += s2 * gy * gy;
      }
    }
  }
  if (kExt || c.has_unc) {
    float e, gx, gy;
    if (kExt) {
      e = cx.uext[at(j, 0, 3, B, b)];
      gx = cx.uext[at(j, 1, 3, B, b)];
      gy = cx.uext[at(j, 2, 3, B, b)];
    } else {
      unc_sample(cx, x0, x1, e, gx, gy);
    }
    const float s1 = c.s1u * e, s2 = c.s2u * e;
    o.lx[0] += s1 * gx;
    o.lx[1] += s1 * gy;
    s00 += s2 * gx * gx;
    s01 += s2 * gx * gy;
    s11 += s2 * gy * gy;
  }

  // control barriers (Constraints.cpp:86-137), yaw-rate bounds at the
  // concurrent state (Constraints.cpp:119-121)
  const float b1 = c.q1a * expf(c.q2a * (u0 - c.dyn.acc_max));
  const float b2 = c.q1a * expf(c.q2a * (c.dyn.acc_min - u0));
  const float b3 = c.q1y * expf(c.q2y * (u1 - x2 * c.dyn.tan_hi));
  const float b4 = c.q1y * expf(c.q2y * (x2 * c.dyn.tan_lo - u1));
  o.lu[0] = c.q2a * (b1 - b2) + c.two_wacc * u0;
  o.lu[1] = c.q2y * (b3 - b4) + c.two_wyr * u1;
  o.luu[0] = c.q2a_sq * (b1 + b2) + c.two_wacc;
  o.luu[1] = c.q2y_sq * (b3 + b4) + c.two_wyr;
  o.lxx[0] = c.two_wpos + s00;
  o.lxx[1] = s01;
  o.lxx[2] = c.two_wpos + s11;
  o.lxx[3] = c.two_wvel;
  o.J = c.wpos * (ex * ex + ey * ey) + c.wvel * (ev * ev) + c.wacc * (u0 * u0) +
        c.wyr * (u1 * u1);
  return o;
}

// One LM iteration on (X, U): backward pass with derivatives built per step
// (k, K into scratch), then the rollout into (Xp, Up).  Returns J of (X, U).
template <bool kExt>
__device__ float run_iteration(const Ctx& cx, const float* X, const float* U, float lamb,
                               float* Xp, float* Up, float* k, float* K) {
  const LMConfig& c = cx.c;
  const int B = c.B, b = cx.b, N = c.N;

  // V seeded from the running cost at step N-1, with a zero yaw row and
  // column; that step re-enters the recursion at j = N-1 (iLQR.cpp:108-113)
  const StepDerivs seed = step_derivs<kExt>(cx, X, U, N - 1);
  float Vx[4] = {seed.lx[0], seed.lx[1], seed.lx[2], 0.0f};
  float Vxx[16] = {seed.lxx[0], seed.lxx[1], 0.0f, 0.0f,
                   seed.lxx[1], seed.lxx[2], 0.0f, 0.0f,
                   0.0f, 0.0f, seed.lxx[3], 0.0f,
                   0.0f, 0.0f, 0.0f, 0.0f};
  float Jacc = 0.0f;
  for (int j = N - 1; j >= 0; --j) {
    const StepDerivs d = step_derivs<kExt>(cx, X, U, j);
    Jacc = Jacc + d.J;
    const float lx[4] = {d.lx[0], d.lx[1], d.lx[2], 0.0f};
    const float lxx[16] = {d.lxx[0], d.lxx[1], 0.0f, 0.0f,
                           d.lxx[1], d.lxx[2], 0.0f, 0.0f,
                           0.0f, 0.0f, d.lxx[3], 0.0f,
                           0.0f, 0.0f, 0.0f, 0.0f};
    const float luu[3] = {d.luu[0], 0.0f, d.luu[1]};
    // Jacobians at the successor state X[j+1] and U[j] (iLQR.cpp:102-106)
    const float v = X[at(j + 1, 2, 4, B, b)];
    const float th = X[at(j + 1, 3, 4, B, b)];
    const float a = U[at(j, 0, 2, B, b)];
    float kj[2], Kj[8];
    riccati_backward_step(lx, lxx, d.lu, luu, v, th, a, c.dyn.dt, lamb, Vx, Vxx, kj, Kj);
    k[at(j, 0, 2, B, b)] = kj[0];
    k[at(j, 1, 2, B, b)] = kj[1];
#pragma unroll
    for (int i = 0; i < 8; ++i) K[at(j, i, 8, B, b)] = Kj[i];
  }

  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = X[at(0, i, 4, B, b)];
    Xp[at(0, i, 4, B, b)] = x[i];
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
    rollout_step(c.dyn, Xj, Uj, kj, Kj, x, u);
    Up[at(j, 0, 2, B, b)] = u[0];
    Up[at(j, 1, 2, B, b)] = u[1];
#pragma unroll
    for (int i = 0; i < 4; ++i) Xp[at(j + 1, i, 4, B, b)] = x[i];
  }
  return Jacc;
}

// Scenario b's fit payload [coeffs, x_mid, x_scale, samp_frame] ([C][B]).
__device__ __forceinline__ Fit read_fit(const LMConfig& cfg, const float* fit, int b) {
  const int B = cfg.B, nc = cfg.ncoef;
  Fit f;
  f.ncoef = nc;
  for (int i = 0; i < nc; ++i) f.cs[i] = fit[(size_t)i * B + b];
  const float* v = fit + (size_t)nc * B + b;
  f.x_mid = v[0];
  f.inv_xscale = 1.0f / v[(size_t)1 * B];
  f.x0r = v[(size_t)2 * B];
  f.dr = v[(size_t)3 * B];
  f.ox = v[(size_t)4 * B];
  f.oy = v[(size_t)5 * B];
  f.cph = v[(size_t)6 * B];
  f.sph = v[(size_t)7 * B];
  f.qx = v[(size_t)8 * B];
  f.qy = v[(size_t)9 * B];
  return f;
}

__global__ void lm_opt_kernel(LMConfig cfg,
                              const float* __restrict__ fit,  // [ncoef+10][B]
                              const float* __restrict__ x0,   // [4][B] start states
                              const float* __restrict__ U0,   // [N][2][B]
                              const float* __restrict__ obs,  // [M*6][N]
                              const float* __restrict__ map,  // [H][W]
                              const float* __restrict__ scl,  // [16]
                              float* __restrict__ X,          // [N+1][4][B]
                              float* __restrict__ U,          // [N][2][B]
                              float* __restrict__ J_out,      // [B]
                              float* __restrict__ lamb_out,   // [B]
                              int* __restrict__ it_out,       // [B]
                              float* __restrict__ sxy,        // [S][3][B] scratch
                              float* __restrict__ Xp,         // [N+1][4][B] scratch
                              float* __restrict__ Up,         // [N][2][B] scratch
                              float* __restrict__ k,          // [N][2][B] scratch
                              float* __restrict__ K) {        // [N][8][B] scratch
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = cfg.B, N = cfg.N, S = cfg.S;
  if (b >= B) return;

  const Fit f = read_fit(cfg, fit, b);

  // regenerate the local sample table [sxl, syl, r] (Constraints.cpp:28-42
  // + reference_path._local_channels)
  for (int s = 0; s < S; ++s) {
    float sxg, syg;
    global_sample(f, (float)s, sxg, syg);
    const float dx0 = sub(sxg, f.qx);
    const float dy0 = sub(syg, f.qy);
    const float sxl = add(mul(f.cph, dx0), mul(f.sph, dy0));
    const float syl = sub(mul(f.cph, dy0), mul(f.sph, dx0));
    sxy[at(s, 0, 3, B, b)] = sxl;
    sxy[at(s, 1, 3, B, b)] = syl;
    sxy[at(s, 2, 3, B, b)] = add(mul(sxl, sxl), mul(syl, syl));
  }
  // initial trajectory: the rollout of U0 from x0 (iLQR.cpp:51-62), as a
  // closed-loop step with zero gains (u = U0[j] exactly)
  {
    const float zk[2] = {0.0f, 0.0f};
    const float zK[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float x[4];
    for (int i = 0; i < 4; ++i) {
      x[i] = x0[(size_t)i * B + b];
      X[at(0, i, 4, B, b)] = x[i];
    }
    for (int j = 0; j < N; ++j) {
      const float Uj[2] = {U0[at(j, 0, 2, B, b)], U0[at(j, 1, 2, B, b)]};
      const float Xj[4] = {x[0], x[1], x[2], x[3]};
      float u[2];
      rollout_step(cfg.dyn, Xj, Uj, zk, zK, x, u);
      U[at(j, 0, 2, B, b)] = Uj[0];
      U[at(j, 1, 2, B, b)] = Uj[1];
      for (int i = 0; i < 4; ++i) X[at(j + 1, i, 4, B, b)] = x[i];
    }
  }

  const Ctx cx{cfg, f, b, sxy, obs, map, scl, nullptr};
  // LM bookkeeping (iLQR.cpp:211-239), in the order accept -> trajectory
  // merge -> lambda -> stop
  float J_old = FLT_MAX, lamb = cfg.lamb_init;
  int it = 0;
  bool done = false;
  for (int iter = 0; iter < cfg.max_iterations && !done; ++iter) {
    const float J_new = run_iteration<false>(cx, X, U, lamb, Xp, Up, k, K);
    const bool accept = J_new < J_old;
    if (accept) {
      for (int j = 0; j <= N; ++j)
        for (int i = 0; i < 4; ++i) X[at(j, i, 4, B, b)] = Xp[at(j, i, 4, B, b)];
      for (int j = 0; j < N; ++j)
        for (int i = 0; i < 2; ++i) U[at(j, i, 2, B, b)] = Up[at(j, i, 2, B, b)];
    }
    const float lamb_n = accept ? lamb / cfg.lamb_factor : lamb * cfg.lamb_factor;
    done = accept ? (fabsf(J_new - J_old) < cfg.tol) : (lamb_n > cfg.lamb_max);
    J_old = J_new;
    lamb = lamb_n;
    ++it;
  }
  J_out[b] = J_old;
  lamb_out[b] = lamb;
  it_out[b] = it;
}

// One LM iteration on (X, U) at lambda per scenario (K3): J of (X, U) and
// the proposal (Xn, Un), the uncertainty sample taken from the external
// planes.  The sample table comes from the local plans.
__global__ void lm_iter_kernel(LMConfig cfg,
                               const float* __restrict__ fit,   // [ncoef+10][B]
                               const float* __restrict__ sxy,   // [S][3][B]
                               const float* __restrict__ X,     // [N+1][4][B]
                               const float* __restrict__ U,     // [N][2][B]
                               const float* __restrict__ lamb,  // [B]
                               const float* __restrict__ uext,  // [N][3][B]
                               const float* __restrict__ obs,   // [M*6][N]
                               float* __restrict__ Xn,          // [N+1][4][B]
                               float* __restrict__ Un,          // [N][2][B]
                               float* __restrict__ J,           // [B]
                               float* __restrict__ k,           // [N][2][B] gains
                               float* __restrict__ K) {         // [N][8][B] gains
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= cfg.B) return;
  const Fit f = read_fit(cfg, fit, b);
  const Ctx cx{cfg, f, b, sxy, obs, nullptr, nullptr, uext};
  J[b] = run_iteration<true>(cx, X, U, lamb[b], Xn, Un, k, K);
}

}  // namespace

extern "C" int cilqr_lm_config_size() { return (int)sizeof(LMConfig); }

extern "C" int cilqr_lm_opt(const LMConfig* cfg, const float* fit, const float* x0,
                            const float* U0, const float* obs, const float* map,
                            const float* scl, float* X, float* U, float* J, float* lamb,
                            int* it, float* sxy, float* Xp, float* Up, float* k, float* K,
                            void* stream) {
  if (cfg->ncoef > kMaxCoef) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (cfg->B + threads - 1) / threads;
  lm_opt_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *cfg, fit, x0, U0, obs, map, scl, X, U, J, lamb, it, sxy, Xp, Up, k, K);
  return (int)cudaGetLastError();
}

extern "C" int cilqr_lm_iter(const LMConfig* cfg, const float* fit, const float* sxy,
                             const float* X, const float* U, const float* lamb,
                             const float* uext, const float* obs, float* Xn, float* Un,
                             float* J, float* k, float* K, void* stream) {
  if (cfg->ncoef > kMaxCoef || cfg->has_unc || uext == nullptr)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (cfg->B + threads - 1) / threads;
  lm_iter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *cfg, fit, sxy, X, U, lamb, uext, obs, Xn, Un, J, k, K);
  return (int)cudaGetLastError();
}
