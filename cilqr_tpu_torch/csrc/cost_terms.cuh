// Device code of the cost stack shared by the LM kernels (lm.cu: K1, K3) and
// the two-phase step's derivatives kernel (cost.cu): the closest point on
// the local plan (the split tournament over the sample table, then the exact
// 3-candidate refine), the tracking terms, the control barriers, the
// uncertainty barrier from a map sample and a step's acceptance cost J
// (costs.all_cost_derivs_and_J for one horizon step).
//
// The functions that read solver constants take the kernel's config as a
// template parameter C: any struct with the fields they name (LMConfig,
// CostConfig).
//
// Numerics: the sample table and the tournament distance are built with
// explicitly rounded operations (no FMA contraction), so they reproduce the
// plain version's sequence of roundings and pick the same winners.
#pragma once

#include <cfloat>
#include <climits>

#include "cilqr_common.cuh"

namespace cilqr {

constexpr int kMaxCoef = 16;

// Per-scenario fit parameters (reference_path.LocalPlan.samp_frame).
struct Fit {
  float cs[kMaxCoef];
  int ncoef;
  float x_mid, inv_xscale, x0r, dr, ox, oy, cph, sph, qx, qy;
};

// Scenario b's fit payload [coeffs, x_mid, x_scale, samp_frame] ([C][B]).
template <class C>
__device__ __forceinline__ Fit read_fit(const C& cfg, const float* fit, int b) {
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

// A scenario's sample table as the tournament reads it: sample s's
// local-frame channels (sxl, syl) and r = sxl^2 + syl^2 with the three
// rounded operations that built the plans' r (the same bits).
//  * SplitTable (K1, K3): [component][S][STRIDE] from `tab`, r recomputed
//    from the two channels (a third less shared memory per scenario, more
//    resident scenarios).
//  * PackedTable (cost.cu): one 16-byte record (sxl, syl, r, unused) per
//    sample, r computed once when the table was staged: one shared-memory
//    load per sample.
template <int STRIDE>
struct SplitTable {
  const float* tx;  // sxl of sample 0; syl S * STRIDE floats further
  const float* ty;
  __device__ __forceinline__ SplitTable(const float* tab, int S) : tx(tab), ty(tab + S * STRIDE) {}
  __device__ __forceinline__ void sample(int s, float& sxl, float& syl, float& r) const {
    sxl = tx[s * STRIDE];
    syl = ty[s * STRIDE];
    r = add(mul(sxl, sxl), mul(syl, syl));
  }
};

struct PackedTable {
  const float4* rec;
  __device__ __forceinline__ void sample(int s, float& sxl, float& syl, float& r) const {
    const float4 v = rec[s];
    sxl = v.x;
    syl = v.y;
    r = v.z;
  }
};

// Tournament argmin over the expanded local-frame distance
// d = r + n0 sxl + n1 syl of a scenario's table.  G lanes own the scenario:
// lane g scans samples g, g+G, ... in ascending order (first minimum wins:
// strict <), the butterfly over the group's lanes (`mask`, the group's lane
// 0 at warp lane `lead`) merges by (d, j) lexicographically, so the group
// holds the first minimum of the whole table
// (lm_pallas._make_closest_point's tournament).
__device__ __forceinline__ void take_smaller(float& d, int& j, float od, int oj) {
  if (od < d || (od == d && oj < j)) {
    d = od;
    j = oj;
  }
}

template <int G, class Table>
__device__ __forceinline__ int tournament(const Table& tab, int S, int g, unsigned mask, int lead,
                                          float n0, float n1) {
  float d = INFINITY;
  int j = INT_MAX;
#pragma unroll 4
  for (int s = g; s < S; s += G) {
    float sxl, syl, r;
    tab.sample(s, sxl, syl, r);
    const float ds = add(add(r, mul(n0, sxl)), mul(n1, syl));
    if (ds < d) {
      d = ds;
      j = s;
    }
  }
  if constexpr (G > 1) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      take_smaller(d, j, __shfl_xor_sync(mask, d, off), __shfl_xor_sync(mask, j, off));
    j = __shfl_sync(mask, j, lead);
  }
  return j < S ? j : 0;  // no finite distance at all: sample 0, as argmin of all-inf
}

// Closest point: the tournament, then the exact global refine over
// {j-1, j, j+1} (reference_path.find_closest_points).
template <int G, class Table>
__device__ void closest_point(const Fit& f, const Table& tab, int S, int g, unsigned mask,
                              int lead, float x0, float x1, float& cxp, float& cyp) {
  const float dx0 = sub(x0, f.qx);
  const float dy0 = sub(x1, f.qy);
  const float xl = add(mul(f.cph, dx0), mul(f.sph, dy0));
  const float yl = sub(mul(f.cph, dy0), mul(f.sph, dx0));
  const int j = tournament<G>(tab, S, g, mask, lead, -2.0f * xl, -2.0f * yl);
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

// Tracking residuals (ex, ey, ev) at state (x0, x1, x2) against the closest
// point and their gradient l_x[0..2] (Constraints.cpp:161-175; yaw is
// untracked).
template <class C>
__device__ __forceinline__ void tracking_terms(const C& c, float x0, float x1, float x2,
                                               float cxp, float cyp, float& ex, float& ey,
                                               float& ev, float lx[3]) {
  ex = x0 - cxp;
  ey = x1 - cyp;
  ev = x2 - c.vdes;
  lx[0] = c.two_wpos * ex;
  lx[1] = c.two_wpos * ey;
  lx[2] = c.two_wvel * ev;
}

// Quadratic effort + the four control barriers (Constraints.cpp:86-137),
// the yaw-rate bounds at the concurrent speed x2 (Constraints.cpp:119-121):
// l_u and the diagonal of l_uu (its off-diagonal is 0).
template <class C>
__device__ __forceinline__ void control_terms(const C& c, float x2, float u0, float u1,
                                              float lu[2], float luu[2]) {
  const float b1 = c.q1a * expf(c.q2a * (u0 - c.dyn.acc_max));
  const float b2 = c.q1a * expf(c.q2a * (c.dyn.acc_min - u0));
  const float b3 = c.q1y * expf(c.q2y * (u1 - x2 * c.dyn.tan_hi));
  const float b4 = c.q1y * expf(c.q2y * (x2 * c.dyn.tan_lo - u1));
  lu[0] = c.q2a * (b1 - b2) + c.two_wacc * u0;
  lu[1] = c.q2y * (b3 - b4) + c.two_wyr * u1;
  luu[0] = c.q2a_sq * (b1 + b2) + c.two_wacc;
  luu[1] = c.q2y_sq * (b3 + b4) + c.two_wyr;
}

// The uncertainty barrier at a sample (e, gx, gy) of the map
// (uncertainty.uncertainty_cost, weighted by w_uncertainty): s1 g added to
// the gradient lx[0..1] and s2 g g^T to the Hessian's (h00, h01, h11), with
// s1 = w q2 e and s2 = w q2^2 e (the config's s1u, s2u).
template <class C>
__device__ __forceinline__ void uncertainty_terms(const C& c, float e, float gx, float gy,
                                                  float lx[3], float& h00, float& h01,
                                                  float& h11) {
  const float s1 = c.s1u * e, s2 = c.s2u * e;
  lx[0] += s1 * gx;
  lx[1] += s1 * gy;
  h00 += s2 * gx * gx;
  h01 += s2 * gx * gy;
  h11 += s2 * gy * gy;
}

// One step's share of the acceptance cost J (Constraints.cpp:534-561): the
// quadratic tracking and control terms only.
template <class C>
__device__ __forceinline__ float step_cost(const C& c, float ex, float ey, float ev, float u0,
                                           float u1) {
  return c.wpos * (ex * ex + ey * ey) + c.wvel * (ev * ev) + c.wacc * (u0 * u0) +
         c.wyr * (u1 * u1);
}

}  // namespace cilqr
