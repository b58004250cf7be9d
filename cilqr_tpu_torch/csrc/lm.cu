// The whole Levenberg-Marquardt CILQR loop per scenario, in one kernel (K1),
// one LM iteration per scenario (K3), and the hybrid loop's whole LM step
// over the lanes still running (lm_lanes_kernel, then lm_step_kernel).
//
// K1 replaces the TPU kernel cilqr_tpu/ops/lm_pallas.py `_opt_kernel`
// (:682), launched by `_fused_optimize_call` (:860) from `fused_optimize`
// (:923), with its subroutines `_gen_sample_table` (:249),
// `_make_closest_point` (:263), `_run_iteration` (:322) and riccati_pallas
// `_fwd_kernel` (:225).  K3 replaces `_iter_kernel` (:663), launched by
// `fused_iteration` (:841): the same `_run_iteration` once, on a given
// trajectory and lambda, with the sample table read from the local plans
// and external (e, gx, gy) uncertainty planes instead of the in-kernel map
// sampler (the hybrid mode for one uncertainty map per scenario).
// Per scenario: the initial rollout of U0 from x0, then per LM iteration
// the closest-point tournament + exact 3-candidate refine, tracking /
// control / obstacle / uncertainty barrier derivatives, the acceptance cost
// J, the backward Riccati pass with the eigen-clamp 2x2 inverse, the forward
// rollout, accept/reject, the lambda update and the per-scenario stop.
//
// What bounds it on an H100: latency.  One scenario's horizon step is a
// dependent chain: the tournament over the S-sample table (per sample 2
// shared-memory loads, 7 explicitly rounded operations, which cannot
// contract into FMA and so run at half the card's float32 peak, a compare
// and two selects), the 3-candidate refine, ~20 accurate expf / sinf / cosf
// and the ~650 operations of one Riccati step.  Only more resident warps
// hide it, and the tables bound them: 1,600 B of shared memory per
// scenario at S=200 (r = sxl^2 + syl^2 is recomputed, not stored: a third
// less shared memory, more resident scenarios) allow 128 scenarios per SM.
// Device-memory traffic (~8 KB per scenario and iteration of per-step
// scratch) is an order below the card's rate.
//
// Design.
//  * A lane group per scenario.  G lanes (1, 8 or 32, a template
//    parameter) of one warp own one scenario; a block is one warp and
//    holds T = 32/G scenarios.  The G lanes split
//    the tournament: lane g scans samples g, g+G, ... in ascending order
//    with the strict <, then a __shfl_xor_sync butterfly merges (d, j)
//    pairs, taking the smaller d and on equal d the smaller j: the
//    sequential first minimum, bit for bit, for any S.  Everything else
//    (refine, derivatives, Riccati step, rollout, accept/reject) is the
//    same instruction sequence in all G lanes on the same inputs, so a
//    scenario's result depends on neither G nor B; only the group's lane 0
//    stores.  No sum is split across lanes.  The host picks G from B
//    (lm_cuda.launch_shape): G=1 where B fills the card, G=32 at B=1.
//  * The table in shared memory.  A warp keeps its T scenarios' tables in
//    dynamic shared memory for its whole life, laid out [component][s][T].
//    A warp-wide load reads, for one component, sample g + G*i of the
//    scenario in slot t: word (g + G*i) * T + t = 32*i + (g*T + t), 32
//    consecutive words for the 32 (g, t) pairs of the warp, one per bank.
//    K1 fills its slot from the fit payload (each lane the samples it will
//    scan).  K3 stages its warp's slice of the scenario-minor table
//    [S][2][B] with cp.async, in 16-byte pieces (4 neighbouring scenarios of
//    one (s, component) row) when T and B are multiples of 4, else in 4-byte
//    pieces.  cp.async and not a TMA bulk copy: a warp's slice is 2*S runs
//    of T floats, B floats apart; a bulk copy wants one contiguous run, and
//    a 2-D tensor map would have to be encoded through libcuda at every
//    launch, for a copy that is ~2% of the kernel's work.
//  * No block barrier: a block is one warp.  Lanes of a group synchronise with __syncwarp(group mask)
//    where lane 0's stores are read back by the others; every shuffle names
//    only its own group's lanes, and a tail group of K3 (b >= B) just
//    leaves.  The tournament winner and the stop flag are broadcast from
//    lane 0, so the lanes of a group cannot part ways whatever the data
//    (NaN included).
//  * K1's groups are persistent.  Iteration counts spread from 7 to the cap
//    of 20, so a warp of 32 scenarios would run 1.67x the iterations its
//    scenarios need on average.  A group whose scenario has stopped takes
//    the next one from an atomic counter and rebuilds its table slot; the
//    warp votes once per LM iteration, which keeps its groups in step (a
//    warp whose lanes sit at different places of the loop would run them
//    one after another).
//  * Per-step arrays (X, U, the proposal, k, K: ~1,100 floats) stay in
//    device-memory scratch, scenario-minor ([step][component][slots]): the
//    T scenarios of a warp read T neighbouring floats, each broadcast to
//    its G lanes; the next step's values are loaded while the current step
//    is computed.  Accepting a proposal swaps two pointers.  A row of the
//    obstacle payload whose mask is 0 is passed over.
//
//  * The hybrid loop's step (one uncertainty map per scenario: MC and the
//    full stack).  K3 left the map sample (~40-80 PyTorch kernels), the
//    layout copies and lm_step's masks (~12 kernels) around it, all over
//    every lane, done or not.  The step kernel samples each lane's own map
//    in place of the external planes, runs K3's run_iteration and applies
//    lm_step's update to the loop's state in place (K1's lm_update).  Its
//    blocks take lanes from a list of the lanes still running, which a
//    one-block pass over `done` writes first, in lane order: a step's work
//    follows the lanes still running, and a block past the count leaves.
//
// Numerics: the sample table and the tournament distance are built with
// explicitly rounded operations (no FMA contraction), so they reproduce the
// plain version's sequence of roundings and pick the same winners.  The rest
// may contract a*b+c into FMA.  No fast-math: the exp error would be scaled
// by the barrier gains.
#include <type_traits>

#include "cost_terms.cuh"

using namespace cilqr;

constexpr int kTableComps = 2;           // sxl, syl per sample
constexpr int kMaxSharedBytes = 232448;  // what one block may opt in to on sm_90

// Mirrored field for field by lm_cuda._LMConfig (ctypes).
struct LMConfig {
  int B, N, S, M, H, W, ncoef, max_iterations, has_obs, has_unc;
  DynConst dyn;
  float two_wpos, two_wvel, wpos, wvel, wacc, wyr, two_wacc, two_wyr, vdes;
  float q1a, q2a, q2a_sq, q1y, q2y, q2y_sq;
  float q1f, q2f, s1f, s2f, q1r, q2r, s1r, s2r;
  float q1u, q2u, s1u, s2u;
  float efront, erear;
  float lamb_init, lamb_factor, lamb_inv, lamb_max, tol;  // lamb_inv: float32(1 / lamb_factor)
};

namespace {

// One lane's view of its scenario.
struct Ctx {
  const LMConfig& c;
  const Fit& f;
  int stride, col;    // per-step arrays are [step][component][stride], read at col
  int g;              // lane within the group; lane 0 stores
  int lead;           // warp lane of the group's lane 0
  unsigned mask;      // the group's lanes
  const float* tab;   // shared: [kTableComps][S][32 / G], at this scenario's slot
  const float* obs;   // [M*6][N]
  const float* map;   // [H][W]: K1's shared map; the step kernel's: this lane's own
  const float* scl;   // [16]: K1's map-frame scalars; the step kernel's: this lane's geometry row
  const float* uext;  // [N][3][B] external (e, gx, gy) planes (K3; null in K1)
};

// Where step_derivs takes the uncertainty sample from: K1's shared map
// (when cfg.has_unc), K3's external planes, or the lane's own map (the step
// kernel), sampled with explicitly rounded operations.
constexpr int kUncShared = 0, kUncExt = 1, kUncLane = 2;

// The group's lanes and this lane's place in it.
template <int G>
struct Lanes {
  int lane, g, slot, lead;  // slot: the scenario's place among the warp's 32 / G
  unsigned mask;
  __device__ Lanes() {
    lane = threadIdx.x & 31;
    g = lane % G;
    slot = lane / G;
    lead = lane - g;
    mask = G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1u) << lead;
  }
};

template <int G>
__device__ __forceinline__ void group_sync(const Ctx& cx) {
  if constexpr (G > 1) __syncwarp(cx.mask);
}

// Bilinear costmap sample + global-frame gradient of c = val/100
// (models/uncertainty.py semantics): (e, gx, gy), e = 0 outside the map.
// kRounded (the step kernel, one map per lane): the lane's map and its
// gradient sampled by lane_map_sample (cilqr_common.cuh: every operation
// explicitly rounded, in the order of the plain version as PyTorch runs it
// on the card, from the lane's geometry row computed by PyTorch as the plain
// version computes it), then the barrier (uncertainty_sample_batched's
// _barrier_sample), whose division by 100 is a product with float(1 / 100),
// which is what PyTorch's CUDA division by a Python scalar computes.  `cell`
// (when given) receives i0 * W + j0.  Else (K1) the arithmetic of the
// shared-map sampler, from K1's scalars (s[6] = 1/res), may contract.
template <bool kRounded>
__device__ void unc_sample(const Ctx& cx, float x0, float x1, float& e, float& gx, float& gy,
                           int* cell = nullptr) {
  const LMConfig& c = cx.c;
  const float* s = cx.scl;
  if constexpr (kRounded) {
    const MapSample m = lane_map_sample(s, cx.map, c.H, c.W, x0, x1, cell);
    gx = m.gx;
    gy = m.gy;
    e = m.inside ? mul(c.q1u, expf(mul(c.q2u, mul(m.val, 1.0f / 100.0f)))) : 0.0f;
    return;
  }
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
  float cth, sth;  // cosine and sine of the step's yaw
};

// Cost derivatives and the J term at step j of trajectory (X, U)
// (costs.all_cost_derivs_and_J for one step).  kUnc: where the uncertainty
// sample comes from (kUncShared, kUncExt, kUncLane); each kernel compiles the
// other branches out.
template <int G, int kUnc>
__device__ StepDerivs step_derivs(const Ctx& cx, const float x[4], const float u[2], int j) {
  const LMConfig& c = cx.c;
  const int B = cx.stride, b = cx.col, N = c.N;
  const float x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
  const float u0 = u[0], u1 = u[1];

  float cxp, cyp;
  closest_point<G>(cx.f, SplitTable<32 / G>(cx.tab, c.S), c.S, cx.g, cx.mask, cx.lead, x0, x1,
                   cxp, cyp);
  float ex, ey, ev;
  StepDerivs o;
  tracking_terms(c, x0, x1, x2, cxp, cyp, ex, ey, ev, o.lx);
  float s00 = 0.0f, s01 = 0.0f, s11 = 0.0f;
  const float cth = cosf(x3), sth = sinf(x3);
  o.cth = cth;
  o.sth = sth;

  if (c.has_obs) {
    const float ecx[2] = {x0 + cth * c.efront, x0 - cth * c.erear};
    const float ecy[2] = {x1 + sth * c.efront, x1 - sth * c.erear};
    const float q1d[2] = {c.q1f, c.q1r}, q2d[2] = {c.q2f, c.q2r};
    const float s1d[2] = {c.s1f, c.s1r}, s2d[2] = {c.s2f, c.s2r};
    // A row whose mask is 0 (padding) is passed over; the payload is
    // shared, so the whole warp passes it over.  It would add exactly 0 to
    // every sum as long as its barrier exp(q2 cv) is finite (the plain
    // version multiplies by the mask, so there an overflowed exp of a
    // padding row would give inf * 0 = NaN).
    for (int m = 0; m < c.M; ++m) {
      const float* row = cx.obs + (size_t)m * 6 * N + j;
      const float msk = row[5 * N];
      if (msk == 0.0f) continue;
      const float g11 = row[0 * N], g12 = row[1 * N], g22 = row[2 * N];
      const float px = row[3 * N], py = row[4 * N];
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
  if (kUnc != kUncShared || c.has_unc) {
    float e, gx, gy;
    if constexpr (kUnc == kUncExt) {
      e = cx.uext[at(j, 0, 3, B, b)];
      gx = cx.uext[at(j, 1, 3, B, b)];
      gy = cx.uext[at(j, 2, 3, B, b)];
    } else {
      unc_sample<kUnc == kUncLane>(cx, x0, x1, e, gx, gy);
    }
    uncertainty_terms(c, e, gx, gy, o.lx, s00, s01, s11);
  }

  control_terms(c, x2, u0, u1, o.lu, o.luu);
  o.lxx[0] = c.two_wpos + s00;
  o.lxx[1] = s01;
  o.lxx[2] = c.two_wpos + s11;
  o.lxx[3] = c.two_wvel;
  o.J = step_cost(c, ex, ey, ev, u0, u1);
  return o;
}

// One LM iteration on (X, U): backward pass with derivatives built per step
// (k, K into scratch), then the rollout into (Xp, Up).  Returns J of (X, U).
// Lane 0 of the group stores; the group synchronises before the rollout
// reads the gains back and before the caller reads the proposal.  Both
// loops load the next step's values while they compute the current one:
// a scenario's steps are one dependent chain, and a load from device
// memory in it would be waited for in full.
template <int G, int kUnc>
__device__ float run_iteration(const Ctx& cx, const float* X, const float* U, float lamb,
                               float* Xp, float* Up, float* k, float* K) {
  const LMConfig& c = cx.c;
  const int B = cx.stride, b = cx.col, N = c.N;
  const bool store = cx.g == 0;

  float xj[4], uj[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) xj[i] = X[at(N - 1, i, 4, B, b)];
  uj[0] = U[at(N - 1, 0, 2, B, b)];
  uj[1] = U[at(N - 1, 1, 2, B, b)];
  // Jacobians at the successor state X[j+1] and U[j] (iLQR.cpp:102-106):
  // X[N] here, afterwards the step just left
  float v = X[at(N, 2, 4, B, b)];
  const float thN = X[at(N, 3, 4, B, b)];
  float cth = cosf(thN), sth = sinf(thN);

  // V seeded from the running cost at step N-1, with a zero yaw row and
  // column; that step re-enters the recursion at j = N-1 (iLQR.cpp:108-113)
  StepDerivs d = step_derivs<G, kUnc>(cx, xj, uj, N - 1);
  float Vx[4] = {d.lx[0], d.lx[1], d.lx[2], 0.0f};
  float Vxx[16] = {d.lxx[0], d.lxx[1], 0.0f, 0.0f,
                   d.lxx[1], d.lxx[2], 0.0f, 0.0f,
                   0.0f, 0.0f, d.lxx[3], 0.0f,
                   0.0f, 0.0f, 0.0f, 0.0f};
  float Jacc = 0.0f;
  for (int j = N - 1;; --j) {
    float xn[4], un[2];  // step j-1, on its way while step j is computed
    const int jn = j > 0 ? j - 1 : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) xn[i] = X[at(jn, i, 4, B, b)];
    un[0] = U[at(jn, 0, 2, B, b)];
    un[1] = U[at(jn, 1, 2, B, b)];

    Jacc = Jacc + d.J;
    const float lx[4] = {d.lx[0], d.lx[1], d.lx[2], 0.0f};
    const float lxx[16] = {d.lxx[0], d.lxx[1], 0.0f, 0.0f,
                           d.lxx[1], d.lxx[2], 0.0f, 0.0f,
                           0.0f, 0.0f, d.lxx[3], 0.0f,
                           0.0f, 0.0f, 0.0f, 0.0f};
    const float luu[3] = {d.luu[0], 0.0f, d.luu[1]};
    float kj[2], Kj[8];
    riccati_backward_step(lx, lxx, d.lu, luu, v, cth, sth, uj[0], c.dyn.dt, lamb, Vx, Vxx, kj,
                          Kj);
    if (store) {
      k[at(j, 0, 2, B, b)] = kj[0];
      k[at(j, 1, 2, B, b)] = kj[1];
#pragma unroll
      for (int i = 0; i < 8; ++i) K[at(j, i, 8, B, b)] = Kj[i];
    }
    if (j == 0) break;
    v = xj[2];
    cth = d.cth;
    sth = d.sth;
#pragma unroll
    for (int i = 0; i < 4; ++i) xj[i] = xn[i];
    uj[0] = un[0];
    uj[1] = un[1];
    d = step_derivs<G, kUnc>(cx, xj, uj, j - 1);
  }
  group_sync<G>(cx);

  float Xj[4], Uj[2], kj[2], Kj[8], x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    Xj[i] = x[i] = X[at(0, i, 4, B, b)];
    if (store) Xp[at(0, i, 4, B, b)] = x[i];
  }
  Uj[0] = U[at(0, 0, 2, B, b)];
  Uj[1] = U[at(0, 1, 2, B, b)];
  kj[0] = k[at(0, 0, 2, B, b)];
  kj[1] = k[at(0, 1, 2, B, b)];
#pragma unroll
  for (int i = 0; i < 8; ++i) Kj[i] = K[at(0, i, 8, B, b)];
  for (int j = 0; j < N; ++j) {
    float Xn[4], Un[2], kn[2], Kn[8], u[2];  // step j+1, loaded ahead
    const int jn = j + 1 < N ? j + 1 : j;
#pragma unroll
    for (int i = 0; i < 4; ++i) Xn[i] = X[at(jn, i, 4, B, b)];
    Un[0] = U[at(jn, 0, 2, B, b)];
    Un[1] = U[at(jn, 1, 2, B, b)];
    kn[0] = k[at(jn, 0, 2, B, b)];
    kn[1] = k[at(jn, 1, 2, B, b)];
#pragma unroll
    for (int i = 0; i < 8; ++i) Kn[i] = K[at(jn, i, 8, B, b)];
    rollout_step(c.dyn, Xj, Uj, kj, Kj, x, u);
    if (store) {
      Up[at(j, 0, 2, B, b)] = u[0];
      Up[at(j, 1, 2, B, b)] = u[1];
#pragma unroll
      for (int i = 0; i < 4; ++i) Xp[at(j + 1, i, 4, B, b)] = x[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) Xj[i] = Xn[i];
    Uj[0] = Un[0];
    Uj[1] = Un[1];
    kj[0] = kn[0];
    kj[1] = kn[1];
#pragma unroll
    for (int i = 0; i < 8; ++i) Kj[i] = Kn[i];
  }
  group_sync<G>(cx);
  return Jacc;
}

// The LM update after an iteration of J_new (iLQR.cpp:211-239, solver.lm_step
// for a lane still running): accept on J_new < J_old; lambda times the
// rounded 1 / lamb_factor on accept (the JAX package's step: XLA turns
// lamb / lamb_factor into a product with the rounded reciprocal, and the
// abort test sits on that bit), times lamb_factor on reject; J_old, lambda
// and the count advance.  Returns the stop (on accept |J_new - J_old| < tol,
// on reject lambda > lamb_max), the cap of iterations left to the caller.
__device__ __forceinline__ bool lm_update(const LMConfig& cfg, float J_new, float& J_old,
                                          float& lamb, int& it, bool& accept) {
  accept = J_new < J_old;
  const float lamb_n = accept ? mul(lamb, cfg.lamb_inv) : mul(lamb, cfg.lamb_factor);
  const bool stop = accept ? (fabsf(J_new - J_old) < cfg.tol) : (lamb_n > cfg.lamb_max);
  J_old = J_new;
  lamb = lamb_n;
  ++it;
  return stop;
}

// The block's (one warp's) tables [kTableComps][S][32 / G] in dynamic shared
// memory.
__device__ __forceinline__ float* warp_table() {
  extern __shared__ __align__(16) float shared_tables[];
  return shared_tables;
}

// K1.  Groups are persistent: when a group's scenario stops, it takes the
// next unsolved one from the counter `next`, so it does not idle beside a
// slow scenario of its warp (iteration counts spread from 7 to the cap of
// 20 around a mean of 11).  The warp stays in step: all its groups run
// their LM iterations together, and between two iterations the groups
// without a scenario fetch one, rebuild their table slot and roll out the
// start, while the others wait at the warp's vote.  Per-step scratch
// belongs to the group's slot q (of Q = gridDim.x * 32 / G), not to a scenario.
template <int G>
__global__ void lm_opt_kernel(LMConfig cfg,
                              const float* __restrict__ fit,  // [ncoef+10][B]
                              const float* __restrict__ x0,   // [B][4] start states
                              const float* __restrict__ U0,   // [B][N][2]
                              const float* __restrict__ obs,  // [M*6][N]
                              const float* __restrict__ map,  // [H][W]
                              const float* __restrict__ scl,  // [16]
                              int* __restrict__ next,         // [1] scenarios handed out
                              float* __restrict__ X_out,      // [B][N+1][4]
                              float* __restrict__ U_out,      // [B][N][2]
                              float* __restrict__ J_out,      // [B]
                              float* __restrict__ lamb_out,   // [B]
                              int* __restrict__ it_out,       // [B]
                              float* Xa, float* Xb,           // [N+1][4][Q] scratch
                              float* Ua, float* Ub,           // [N][2][Q] scratch
                              float* __restrict__ k,          // [N][2][Q] scratch
                              float* __restrict__ K) {        // [N][8][Q] scratch
  constexpr int T = 32 / G;
  const Lanes<G> ln;
  const int B = cfg.B, N = cfg.N, S = cfg.S;
  const int Q = gridDim.x * T;
  const int q = blockIdx.x * T + ln.slot;
  const bool store = ln.g == 0;
  float* tab = warp_table() + ln.slot;
  Fit f;
  const Ctx cx{cfg, f, Q, q, ln.g, ln.lead, ln.mask, tab, obs, map, scl, nullptr};

  // the group's scenario and its LM state (iLQR.cpp:211-239); (Xc, Uc) is
  // the trajectory, (Xn, Un) receives the proposal, accepting swaps them
  int b = 0, it = 0;
  bool solving = false, drained = false;
  float *Xc = Xa, *Uc = Ua, *Xn = Xb, *Un = Ub;
  float J_old = FLT_MAX, lamb = cfg.lamb_init;
  for (;;) {
    if (!solving && !drained) {
      if (store) b = atomicAdd(next, 1);
      if constexpr (G > 1) b = __shfl_sync(ln.mask, b, ln.lead);
      drained = b >= B;
    }
    if (!solving && !drained) {
      f = read_fit(cfg, fit, b);
      // regenerate the local sample table [sxl, syl] (Constraints.cpp:28-42
      // + reference_path._local_channels), each lane the samples it scans
      for (int s = ln.g; s < S; s += G) {
        float sxg, syg;
        global_sample(f, (float)s, sxg, syg);
        const float dx0 = sub(sxg, f.qx);
        const float dy0 = sub(syg, f.qy);
        tab[s * T] = add(mul(f.cph, dx0), mul(f.sph, dy0));
        tab[(S + s) * T] = sub(mul(f.cph, dy0), mul(f.sph, dx0));
      }
      // initial trajectory: the rollout of U0 from x0 (iLQR.cpp:51-62), as
      // a closed-loop step with zero gains (u = U0[j] exactly)
      const float zk[2] = {0.0f, 0.0f};
      const float zK[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      Xc = Xa, Uc = Ua, Xn = Xb, Un = Ub;
      float x[4];
      for (int i = 0; i < 4; ++i) {
        x[i] = x0[(size_t)b * 4 + i];
        if (store) Xc[at(0, i, 4, Q, q)] = x[i];
      }
      const float* u0 = U0 + (size_t)b * N * 2;
      for (int j = 0; j < N; ++j) {
        const float Uj[2] = {u0[2 * j], u0[2 * j + 1]};
        const float Xj[4] = {x[0], x[1], x[2], x[3]};
        float u[2];
        rollout_step(cfg.dyn, Xj, Uj, zk, zK, x, u);
        if (store) {
          Uc[at(j, 0, 2, Q, q)] = Uj[0];
          Uc[at(j, 1, 2, Q, q)] = Uj[1];
          for (int i = 0; i < 4; ++i) Xc[at(j + 1, i, 4, Q, q)] = x[i];
        }
      }
      J_old = FLT_MAX;
      lamb = cfg.lamb_init;
      it = 0;
      solving = true;
      group_sync<G>(cx);  // the table and the trajectory are the whole group's now
    }
    // every lane of the warp votes, so the warp starts each iteration in step
    if (!__any_sync(0xffffffffu, solving)) return;
    if (!solving) continue;

    // one LM iteration, in the order accept -> trajectory merge -> lambda ->
    // stop; none at all with max_iterations = 0 (the same in every lane)
    if (it < cfg.max_iterations) {
      const float J_new = run_iteration<G, kUncShared>(cx, Xc, Uc, lamb, Xn, Un, k, K);
      bool accept;
      bool done = lm_update(cfg, J_new, J_old, lamb, it, accept);
      if (accept) {
        float* t = Xc; Xc = Xn; Xn = t;
        t = Uc; Uc = Un; Un = t;
      }
      done = done || it >= cfg.max_iterations;
      if constexpr (G > 1) done = __shfl_sync(ln.mask, (int)done, ln.lead) != 0;
      if (!done) continue;
    }
    // the result, scenario-major, written by the whole group (run_iteration
    // ended on a group sync, so lane 0's stores are visible)
    float* Xo = X_out + (size_t)b * (N + 1) * 4;
    for (int e = ln.g; e < (N + 1) * 4; e += G) Xo[e] = Xc[at(e >> 2, e & 3, 4, Q, q)];
    float* Uo = U_out + (size_t)b * N * 2;
    for (int e = ln.g; e < N * 2; e += G) Uo[e] = Uc[at(e >> 1, e & 1, 2, Q, q)];
    if (store) {
      J_out[b] = J_old;
      lamb_out[b] = lamb;
      it_out[b] = it;
    }
    solving = false;
    group_sync<G>(cx);  // before the slot's table and scratch are written anew
  }
}

__device__ __forceinline__ void cp_async(float* dst_shared, const float* src, bool sixteen) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(dst_shared);
  if (sixteen)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// One LM iteration on (X, U) at lambda per scenario (K3): J of (X, U) and
// the proposal (Xn, Un), the uncertainty sample taken from the external
// planes.  The sample table comes from the local plans, scenario-minor.
template <int G>
__global__ void lm_iter_kernel(LMConfig cfg,
                               const float* __restrict__ fit,   // [ncoef+10][B]
                               const float* __restrict__ sxy,   // [S][2][B]
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
  constexpr int T = 32 / G;
  const Lanes<G> ln;
  const int B = cfg.B, S = cfg.S;
  const int b0 = blockIdx.x * T;
  const int b = b0 + ln.slot;

  // Stage rows (s, c) of scenarios b0 .. b0+T-1 into [c][s][T]; all 32
  // lanes copy, also those of a tail group, and leave after the warp's sync.
  float* wtab = warp_table();
  const bool sixteen = T % 4 == 0 && B % 4 == 0;
  const int per_row = sixteen ? T / 4 : T;  // pieces per row
  const int width = sixteen ? 4 : 1;        // scenarios per piece
  for (int i = ln.lane; i < kTableComps * S * per_row; i += 32) {
    const int col = (i % per_row) * width, row = i / per_row;
    const int c = row / S, s = row - c * S;
    if (b0 + col < B)
      cp_async(wtab + row * T + col, sxy + ((size_t)s * kTableComps + c) * B + b0 + col, sixteen);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  Fit f;
  if (b < B) f = read_fit(cfg, fit, b);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
  if (b >= B) return;

  const Ctx cx{cfg, f, B, b, ln.g, ln.lead, ln.mask, wtab + ln.slot, obs, nullptr, nullptr, uext};
  const float Jb = run_iteration<G, kUncExt>(cx, X, U, lamb[b], Xn, Un, k, K);
  if (ln.g == 0) J[b] = Jb;
}

// The lanes still running: lanes[0 .. n) = the b with !done[b], in lane
// order, *count = n, and *total += n when total is given (the lanes the
// step runs, summed on the card).  One block of kListThreads: thread t
// takes a run of neighbouring lanes, a block-wide scan of the runs' counts
// gives each its place.  What bounds it: the launch (B bytes in, 4n out).
constexpr int kListThreads = 1024;

__global__ void lm_lanes_kernel(const bool* __restrict__ done, int B, int* __restrict__ lanes,
                                int* __restrict__ count, long long* __restrict__ total) {
  __shared__ int warp_sum[kListThreads / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int run = (B + kListThreads - 1) / kListThreads;
  const int lo = min(t * run, B), hi = min(lo + run, B);
  int mine = 0;
  for (int b = lo; b < hi; ++b) mine += !done[b];
  int incl = mine;  // inclusive scan over the warp, then over the warps' sums
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[w] = incl;
  __syncthreads();
  if (w == 0) {
    int v = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    warp_sum[lane] = v;
  }
  __syncthreads();
  int pos = (w > 0 ? warp_sum[w - 1] : 0) + incl - mine;
  for (int b = lo; b < hi; ++b)
    if (!done[b]) lanes[pos++] = b;
  if (t == kListThreads - 1) {
    const int n = warp_sum[kListThreads / 32 - 1];
    *count = n;
    if (total) *total += n;
  }
}

// One LM step of the hybrid loop per lane still running (the step kernel):
// the lane's own map sampled at its states (kUncLane), the iteration (K3's
// run_iteration), then solver.lm_step's update in place: X and U take the
// proposal on accept; J_old, lambda, the count and done advance.  Slot q of
// the lane list (lm_lanes_kernel) is lane lanes[q]; a block takes slots
// blockIdx.x * T .. + T - 1, and a block past the count returns at once.
// A lane's result depends on neither its slot nor G.  The loop's state is
// batch-major ([B][N+1][4], [B][N][2]) and stays so: each lane reads and
// writes its own rows (stride 1); the proposal and the gains go to scratch
// rows of the slot.  No k or K leaves the kernel.
template <int G>
__global__ void lm_step_kernel(LMConfig cfg,
                               const float* __restrict__ fit,    // [ncoef+10][B]
                               const float* __restrict__ sxy,    // [S][2][B]
                               const float* __restrict__ maps,   // [B][H][W]
                               const float* __restrict__ geo,    // [B][kGeoRow]
                               const float* __restrict__ obs,    // [M*6][N]
                               const int* __restrict__ lanes,    // [B], the first *count valid
                               const int* __restrict__ count,    // [1]
                               float* __restrict__ X,            // [B][N+1][4]
                               float* __restrict__ U,            // [B][N][2]
                               float* __restrict__ lamb,         // [B]
                               float* __restrict__ J_old,        // [B]
                               int* __restrict__ it,             // [B]
                               bool* __restrict__ done,          // [B]
                               float* __restrict__ Xp,           // [B][N+1][4] scratch by slot
                               float* __restrict__ Up,           // [B][N][2]
                               float* __restrict__ k,            // [B][N][2]
                               float* __restrict__ K) {          // [B][N][8]
  constexpr int T = 32 / G;
  const Lanes<G> ln;
  const int B = cfg.B, N = cfg.N, S = cfg.S;
  const int n = *count;
  const int q0 = blockIdx.x * T;
  if (q0 >= n) return;
  const int q = q0 + ln.slot;
  const bool live = q < n;

  // Stage rows (s, c) of the warp's T lanes into [c][s][T]: thread i copies
  // column i % T (32 is a multiple of T), 4 bytes at a time (the lanes of a
  // warp need not be neighbours).
  float* wtab = warp_table();
  const int col = ln.lane % T;
  const int bc = q0 + col < n ? lanes[q0 + col] : -1;
  for (int i = ln.lane; i < kTableComps * S * T; i += 32) {
    const int row = i / T;
    const int c = row / S, s = row - c * S;
    if (bc >= 0) cp_async(wtab + i, sxy + ((size_t)s * kTableComps + c) * B + bc, false);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int b = live ? lanes[q] : 0;
  Fit f;
  if (live) f = read_fit(cfg, fit, b);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
  if (!live) return;

  const Ctx cx{cfg, f, 1, 0, ln.g, ln.lead, ln.mask, wtab + ln.slot, obs,
               maps + (size_t)b * cfg.H * cfg.W, geo + (size_t)b * kGeoRow, nullptr};
  const int nx = (N + 1) * 4, nu = N * 2;
  float* Xb = X + (size_t)b * nx;
  float* Ub = U + (size_t)b * nu;
  float* Xq = Xp + (size_t)q * nx;
  float* Uq = Up + (size_t)q * nu;
  float lb = lamb[b], Jb = J_old[b];
  int itb = it[b];
  const float J_new = run_iteration<G, kUncLane>(cx, Xb, Ub, lb, Xq, Uq, k + (size_t)q * nu,
                                                 K + (size_t)q * N * 8);
  bool accept;
  const bool stop = lm_update(cfg, J_new, Jb, lb, itb, accept);
  if constexpr (G > 1) accept = __shfl_sync(ln.mask, (int)accept, ln.lead) != 0;
  if (accept) {  // run_iteration ended on a group sync: lane 0's proposal is visible
    for (int e = ln.g; e < nx; e += G) Xb[e] = Xq[e];
    for (int e = ln.g; e < nu; e += G) Ub[e] = Uq[e];
  }
  if (ln.g == 0) {
    J_old[b] = Jb;
    lamb[b] = lb;
    it[b] = itb;
    done[b] = stop;
  }
}

// The step kernel's sampler alone (the check against the plain sampler):
// per lane b and step j < N, [e, gx, gy] of lane b's map at X[b][j] into
// planes [B][N][3] and the corner cell i0 * W + j0 into cells [B][N].
__global__ void lm_sampler_kernel(LMConfig cfg, const float* __restrict__ maps,
                                 const float* __restrict__ geo, const float* __restrict__ X,
                                 float* __restrict__ planes, int* __restrict__ cells) {
  const int B = cfg.B, N = cfg.N;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, j = i - b * N;
  Fit f;
  const Ctx cx{cfg, f, 1, 0, 0, 0, 1u, nullptr, nullptr, maps + (size_t)b * cfg.H * cfg.W,
               geo + (size_t)b * kGeoRow, nullptr};
  const float* x = X + ((size_t)b * (N + 1) + j) * 4;
  float* out = planes + (size_t)i * 3;
  unc_sample<true>(cx, x[0], x[1], out[0], out[1], out[2], cells + i);
}

// Runs f(std::integral_constant<int, G>) for a supported group size.
template <typename F>
int with_group(int G, F f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 32: return f(std::integral_constant<int, 32>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of a block (one warp of 32 / G scenarios), or -1 if G
// is no group size or the tables do not fit.
int table_bytes(int G, int S) {
  if (G < 1 || G > 32 || 32 % G != 0) return -1;
  const long long bytes = (long long)(32 / G) * kTableComps * S * sizeof(float);
  return bytes <= kMaxSharedBytes ? (int)bytes : -1;
}

// Opts the kernel in to `bytes` of dynamic shared memory.
template <typename Kernel>
int opt_in(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int cilqr_lm_config_size() { return (int)sizeof(LMConfig); }

// `blocks` blocks of 32 / G scenario slots, G lanes per slot; scratch for
// Q = blocks * 32 / G slots; `next` zeroed by the caller.
extern "C" int cilqr_lm_opt(const LMConfig* cfg, const float* fit, const float* x0,
                            const float* U0, const float* obs, const float* map,
                            const float* scl, int* next, float* X, float* U, float* J,
                            float* lamb, int* it, float* Xa, float* Xb, float* Ua, float* Ub,
                            float* k, float* K, int blocks, int G, void* stream) {
  const int smem = table_bytes(G, cfg->S);
  if (cfg->ncoef > kMaxCoef || smem < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  return with_group(G, [&](auto group) {
    constexpr int kG = decltype(group)::value;
    const int rc = opt_in(lm_opt_kernel<kG>, smem);
    if (rc != 0) return rc;
    lm_opt_kernel<kG><<<blocks, 32, smem, (cudaStream_t)stream>>>(
        *cfg, fit, x0, U0, obs, map, scl, next, X, U, J, lamb, it, Xa, Xb, Ua, Ub, k, K);
    return (int)cudaGetLastError();
  });
}

// 32 / G scenarios per block, G lanes per scenario.
extern "C" int cilqr_lm_iter(const LMConfig* cfg, const float* fit, const float* sxy,
                             const float* X, const float* U, const float* lamb,
                             const float* uext, const float* obs, float* Xn, float* Un,
                             float* J, float* k, float* K, int G, void* stream) {
  const int smem = table_bytes(G, cfg->S);
  if (cfg->ncoef > kMaxCoef || cfg->has_unc || uext == nullptr || smem < 0)
    return (int)cudaErrorInvalidValue;
  return with_group(G, [&](auto group) {
    constexpr int kG = decltype(group)::value;
    const int rc = opt_in(lm_iter_kernel<kG>, smem);
    if (rc != 0) return rc;
    constexpr int kT = 32 / kG;
    lm_iter_kernel<kG><<<(cfg->B + kT - 1) / kT, 32, smem, (cudaStream_t)stream>>>(
        *cfg, fit, sxy, X, U, lamb, uext, obs, Xn, Un, J, k, K);
    return (int)cudaGetLastError();
  });
}

// The lanes still running (lm_lanes_kernel), one block; total may be null.
extern "C" int cilqr_lm_lanes(const bool* done, int B, int* lanes, int* count, long long* total,
                              void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  lm_lanes_kernel<<<1, kListThreads, 0, (cudaStream_t)stream>>>(done, B, lanes, count, total);
  return (int)cudaGetLastError();
}

// The step kernel over the lanes of `lanes` / `count` (cilqr_lm_lanes):
// ceil(B / T) blocks of 32 / G slots, G lanes per slot.
extern "C" int cilqr_lm_step(const LMConfig* cfg, const float* fit, const float* sxy,
                             const float* maps, const float* geo, const float* obs,
                             const int* lanes, const int* count, float* X, float* U, float* lamb,
                             float* J_old, int* it, bool* done, float* Xp, float* Up, float* k,
                             float* K, int G, void* stream) {
  const int smem = table_bytes(G, cfg->S);
  if (cfg->ncoef > kMaxCoef || !cfg->has_unc || cfg->H < 2 || cfg->W < 2 || smem < 0)
    return (int)cudaErrorInvalidValue;
  return with_group(G, [&](auto group) {
    constexpr int kG = decltype(group)::value;
    const int rc = opt_in(lm_step_kernel<kG>, smem);
    if (rc != 0) return rc;
    constexpr int kT = 32 / kG;
    lm_step_kernel<kG><<<(cfg->B + kT - 1) / kT, 32, smem, (cudaStream_t)stream>>>(
        *cfg, fit, sxy, maps, geo, obs, lanes, count, X, U, lamb, J_old, it, done, Xp, Up, k, K);
    return (int)cudaGetLastError();
  });
}

// The step kernel's sampler at every (lane, step < N) of X (lm_sampler_kernel).
extern "C" int cilqr_lm_sample(const LMConfig* cfg, const float* maps, const float* geo,
                               const float* X, float* planes, int* cells, void* stream) {
  if (cfg->H < 2 || cfg->W < 2 || cfg->B < 1) return (int)cudaErrorInvalidValue;
  const int n = cfg->B * cfg->N;
  lm_sampler_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(*cfg, maps, geo, X, planes,
                                                                      cells);
  return (int)cudaGetLastError();
}

// What the compiler and the card give one instantiation:
// out = [registers per thread, local-memory bytes per thread, shared-memory
// bytes per block, resident blocks per SM, SMs of the current device].
// kernel: 0 K3 (lm_iter_kernel), 1 K1 (lm_opt_kernel), 2 the step kernel.
extern "C" int cilqr_lm_resources(int kernel_id, int G, int S, int* out) {
  const int smem = table_bytes(G, S);
  if (smem < 0 || kernel_id < 0 || kernel_id > 2) return (int)cudaErrorInvalidValue;
  return with_group(G, [&](auto group) {
    constexpr int kG = decltype(group)::value;
    const void* kernel = kernel_id == 1   ? (const void*)lm_opt_kernel<kG>
                         : kernel_id == 2 ? (const void*)lm_step_kernel<kG>
                                          : (const void*)lm_iter_kernel<kG>;
    cudaFuncAttributes attr;
    int rc = (int)cudaFuncGetAttributes(&attr, kernel);
    if (rc != 0) return rc;
    rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
    int blocks = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32, smem);
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = smem;
    out[3] = blocks;
    if (rc != 0) return rc;
    int device = 0;
    rc = (int)cudaGetDevice(&device);
    if (rc != 0) return rc;
    return (int)cudaDeviceGetAttribute(&out[4], cudaDevAttrMultiProcessorCount, device);
  });
}
