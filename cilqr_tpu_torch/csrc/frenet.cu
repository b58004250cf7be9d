// The Frenet lattice planner's candidate evaluation and selection in one pass
// (models/frenet.lattice_plain): per lane, every candidate of the static
// lattice (K = n_lat * n_T * n_v end offsets, durations and speeds) walked over
// the horizon's N+1 points, held to the feasibility rules, the two ego circles
// against every live obstacle slot and (propagation mode) the lane's own
// uncertainty map, costed, and the first of least cost taken.
//
// It replaces no TPU kernel: the JAX package's lattice (cilqr_tpu/models/
// frenet.py) is plain XLA.  The plain version, as PyTorch runs it, makes ~100
// passes over (B, K, N+1) tensors (the obstacle tests over (B, M, K, N+1)),
// each written to device memory and read back: at the campaign's shape (B =
// 8192 lanes, K = 180, N = 40: 60.5 M candidate points) 0.24-1.94 GB a pass.
//
// What bounds it on an H100: operations.  The function needs ~130 float32
// operations a candidate point (the lateral quintic, the global point, speed
// and yaw, the speed and curvature rules, with obstacles a cosine, a sine and
// per live slot two ellipse tests, the map sample) and ~95 a point of each
// longitudinal profile, which the n_lat candidates of one (T, V) share (the
// quartic, one search of the reference line's knots and four
// interpolations, the tangent's heading), a transcendental counted as one
// (utils/roofline frenet_bound): ~8.8e9 at the campaign's shape, 0.26 ms at
// one operation per float32 lane and clock (none fuses into an FMA); its
// bytes (each lane's map read once, ~518 MB) ~0.17 ms.
// Design:
//   * one block per lane, its candidates over the block's threads (K rounded
//     up to whole warps, at most kMaxThreads; a thread strides over the
//     candidates when K is larger): the lane's terms are read once a block;
//   * the lane's reference line (s, x, y, tx, ty over its S samples) and the
//     live obstacle slots' half-axes, headings and centres over the horizon
//     are staged in shared memory once a block; a slot whose mask is 0 is
//     left out (the plain version ands every hit with the mask);
//   * the longitudinal quartic, and so the reference point, its tangent and
//     heading, depend on (T, V) alone: the lattice's n_T * n_v longitudinal
//     profiles are walked once a block, (profile, point) pairs over the
//     threads (the quartic, one upper-bound search of the knots serving the
//     four interpolations, the tangent's atan2, the acceleration and
//     reversing rules), into shared memory; the n_lat lateral offsets of a
//     profile read them there;
//   * each thread walks its candidate over t = 0..N in registers: the
//     quintic, the global point, speed and heading, the unwrap as a running
//     correction, the rules and the obstacle tests as a running verdict, the
//     map sample (lane_map_sample, cilqr_common.cuh, shared with the LM step
//     kernel); nothing per point leaves the registers;
//   * a block reduction selects: the first least-cost feasible candidate,
//     the first least cost of all (the lane brakes when none is feasible),
//     and the feasible count; then one thread per point recomputes the
//     winner's N+1 points and writes them once.
// Templated on the map: none (origin and expansion mode: the inflation enters
// through the staged half-axes), one shared map or one map per lane.
//
// Numerics: every operation is an explicitly rounded intrinsic (or an IEEE
// division, square root, atan2f, cosf, sinf, fmodf, as PyTorch's CUDA passes
// compute them) in the plain version's order, which nvcc may not contract
// into an FMA; a division by a Python scalar is PyTorch's product with the
// float reciprocal.  The results differ from the plain version on the card
// only where its reductions have their own order: the mean of the map's
// occupancy over the N+1 points and unwrap's cumulative sum (which only
// differs with three or more wraps in one candidate).
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "cilqr_common.cuh"

using namespace cilqr;

// Mirrored field for field by frenet_cuda._FrenetConfig (ctypes).
struct FrenetConfig {
  int B, N, S, M, H, W;
  int n_lat, n_T, n_v;  // the lattice's axes: K = n_lat * n_T * n_v, d major, then T, then v
  int map;              // kMapNone, kMapShared or kMapLane
  int threads;          // per block: K rounded up to whole warps, at most kMaxThreads
  float dt;
  float acc_hi, acc_lo, v_hi, sd_lo;  // the rules' bounds: acc_max + 1e-6, acc_min - 1e-6, ...
  float tiny_dx;                       // _interp's zero-width knot interval
  float efront, erear;
  float k_j, k_t, k_d, k_v, k_lat, k_lon, vdes;
  float unc_threshold, w_unc, mean_factor;
};

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxObstacles = 64;
constexpr int kRefComps = 5;  // s, x, y, tx, ty
constexpr int kObsComps = 6;  // a, b, cos, sin, x, y (frenet.obstacle_terms)
constexpr int kLonComps = 8;  // a profile's point: s, s_dot, x, y, tx, ty, the tangent's heading, tau
constexpr int kMapNone = 0, kMapShared = 1, kMapLane = 2;
constexpr int kMaxSharedBytes = 232448;  // what one block may opt in to on sm_90

constexpr float kThird = 1.0f / 3.0f;  // PyTorch's x / 3.0 on the card: x * float(1 / 3)
constexpr float kFifth = 1.0f / 5.0f;
constexpr float kHundredth = 1.0f / 100.0f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// The lane's start in the Frenet frame of its reference line.
struct Lane {
  float s0, d0, sd0, dd0;
};

// The products and the coefficients of a longitudinal quartic
// (frenet._quartic from (s_dot0, 0) to (V, 0) over T) as the plain version
// forms them, with its a0 = 0 terms.
struct Quartic {
  float sT, T2, sb3, sb4;
};

__device__ __forceinline__ Quartic quartic(const Lane& l, float T, float V) {
  const float zT = mul(0.0f, T);  // a0 * T with a0 = 0, as the plain version forms it
  const float f = mul(zT, T);     // (a1 - a0) * T * T
  const float gs = mul(sub(sub(V, l.sd0), zT), T);
  return Quartic{mul(l.sd0, T), mul(T, T), sub(gs, mul(f, kThird)),
                 add(mul(-0.5f, gs), mul(0.25f, f))};
}

// One candidate: its grid values and the coefficients of its lateral quintic
// (frenet._quintic from (d0, d_dot0, 0) to (D, 0, 0) over T) and of its
// longitudinal quartic.
struct Cand {
  float D, T, V;
  float dT;  // d_dot0 * T, formed once and read again
  float lb3, lb4, lb5;
  Quartic q;
};

__device__ __forceinline__ Cand candidate(const Lane& l, float D, float T, float V) {
  Cand c;
  c.D = D;
  c.T = T;
  c.V = V;
  const float zT = mul(0.0f, T);
  const float f = mul(zT, T);  // (a1 - a0) * T * T, and 0.5 * a0 * T * T
  c.dT = mul(l.dd0, T);
  const float h = sub(sub(sub(D, l.d0), c.dT), f);
  const float g = mul(sub(sub(0.0f, l.dd0), zT), T);
  c.lb3 = mul(0.5f, add(sub(mul(20.0f, h), mul(8.0f, g)), f));
  c.lb4 = mul(0.5f, sub(add(mul(-30.0f, h), mul(14.0f, g)), mul(2.0f, f)));
  c.lb5 = mul(0.5f, add(sub(mul(12.0f, h), mul(6.0f, g)), f));
  c.q = quartic(l, T, V);
  return c;
}

// A longitudinal profile's point (T, V, t): the Frenet state s, s_dot, its
// reference point and unit tangent (frenet._interp of x, y, tx, ty at s: one
// searchsorted(right=True) for all four, the same point on the same knots;
// the tangent renormalised), the tangent's heading, tau; and whether the
// acceleration and reversing rules hold there.
struct LonPoint {
  float s, sd, xr, yr, tx, ty, head, tau;
};

__device__ __forceinline__ LonPoint lon_point(const FrenetConfig& cfg, const Lane& l, float T,
                                              float V, const float* ref, float t, bool& ok) {
  const Quartic c = quartic(l, T, V);
  LonPoint p;
  p.tau = __fdiv_rn(fminf(t, T), T);
  const float tau2 = mul(p.tau, p.tau);
  const float tau3 = mul(p.tau, tau2);
  const float tau4 = mul(tau2, tau2);
  p.s = add(add(add(l.s0, mul(c.sT, p.tau)), mul(c.sb3, tau3)), mul(c.sb4, tau4));
  p.sd = __fdiv_rn(add(add(c.sT, mul(mul(3.0f, c.sb3), tau2)), mul(mul(4.0f, c.sb4), tau3)), T);
  float sdd = __fdiv_rn(add(mul(mul(6.0f, c.sb3), p.tau), mul(mul(12.0f, c.sb4), tau2)), c.T2);
  if (t > T) {  // past T: constant speed V
    p.s = add(p.s, mul(V, sub(t, T)));
    p.sd = V;
    sdd = 0.0f;
  }
  ok = (sdd <= cfg.acc_hi) & (sdd >= cfg.acc_lo) & (p.sd >= cfg.sd_lo);

  const int S = cfg.S;
  const float* ks = ref;
  int lo = 0, hi = S;  // the first knot above s (PyTorch's upper-bound search)
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(ks[mid] > p.s))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int i = min(max(lo, 1), S - 1);
  const float x0 = ks[i - 1];
  const float dx = sub(ks[i], x0);
  const bool flat = fabsf(dx) <= cfg.tiny_dx;
  const float w = __fdiv_rn(sub(p.s, x0), flat ? 1.0f : dx);
  const bool below = p.s < ks[0], above = p.s > ks[S - 1];
  auto interp = [&](int comp) {
    const float* fp = ref + comp * S;
    const float f0 = fp[i - 1];
    const float f = flat ? f0 : add(f0, mul(w, sub(fp[i], f0)));
    return above ? fp[S - 1] : (below ? fp[0] : f);
  };
  p.xr = interp(1);
  p.yr = interp(2);
  const float txr = interp(3), tyr = interp(4);
  const float tn = fmaxf(__fsqrt_rn(add(mul(txr, txr), mul(tyr, tyr))), 1e-9f);
  p.tx = __fdiv_rn(txr, tn);
  p.ty = __fdiv_rn(tyr, tn);
  p.head = atan2f(p.ty, p.tx);
  return p;
}

// Point j of profile `prof` from the staged profiles [8][profiles][N+1].
__device__ __forceinline__ LonPoint staged(const float* lon, int stride, int at) {
  return LonPoint{lon[at], lon[stride + at], lon[2 * stride + at], lon[3 * stride + at],
                  lon[4 * stride + at], lon[5 * stride + at], lon[6 * stride + at],
                  lon[7 * stride + at]};
}

// A point in the global frame: x, y, speed, yaw.
struct Pose {
  float x, y, v, yaw;
};

// The candidate's point on its profile's point p: the lateral quintic at
// tau (held at (D, 0) past T: tau is clamped at 1), then Frenet -> global.
__device__ __forceinline__ Pose pose(const Lane& l, const Cand& c, const LonPoint& p) {
  const float tau = p.tau;
  const float tau2 = mul(tau, tau);
  const float tau3 = mul(tau, tau2);
  const float tau4 = mul(tau2, tau2);
  const float tau5 = mul(tau, tau4);
  const float d = add(add(add(add(l.d0, mul(c.dT, tau)), mul(c.lb3, tau3)), mul(c.lb4, tau4)),
                      mul(c.lb5, tau5));
  const float dd = __fdiv_rn(
      add(add(add(c.dT, mul(mul(3.0f, c.lb3), tau2)), mul(mul(4.0f, c.lb4), tau3)),
          mul(mul(5.0f, c.lb5), tau4)),
      c.T);
  Pose g;
  g.x = sub(p.xr, mul(d, p.ty));
  g.y = add(p.yr, mul(d, p.tx));
  g.v = __fsqrt_rn(add(mul(p.sd, p.sd), mul(dd, dd)));
  g.yaw = add(p.head, atan2f(dd, fmaxf(p.sd, 1e-3f)));
  return g;
}

// torch.remainder(a, 2 pi) on the card: fmod, moved into [0, 2 pi).
__device__ __forceinline__ float remainder_2pi(float a) {
  float m = fmodf(a, kTwoPi);
  if (m != 0.0f && m < 0.0f) m = add(m, kTwoPi);
  return m;
}

// Whether the ellipse of staged slot o (its rows [6][N+1], read at step j)
// holds the circle centre (ex, ey).  A centre over twice the larger
// half-axis away cannot be held (q > 3.9 whatever the roundings), and
// skips the test's divisions.
__device__ __forceinline__ bool in_ellipse(const float* o, int n1, float ex, float ey) {
  const float a = o[0], b = o[n1], co = o[2 * n1], so = o[3 * n1];
  const float dxg = sub(ex, o[4 * n1]);
  const float dyg = sub(ey, o[5 * n1]);
  const float r = fmaxf(a, b);
  if (a > 0.0f && b > 0.0f && dxg * dxg + dyg * dyg > 4.0f * r * r) return false;
  const float dxo = add(mul(co, dxg), mul(so, dyg));
  const float dyo = add(mul(-so, dxg), mul(co, dyg));
  const float qa = __fdiv_rn(dxo, a), qb = __fdiv_rn(dyo, b);
  return add(mul(qa, qa), mul(qb, qb)) < 1.0f;
}

// frenet._jerk_integral: the squared jerk's closed-form integral over [0, T].
__device__ __forceinline__ float jerk_integral(float T, float b3, float b4, float b5) {
  const float c = mul(6.0f, b3), d = mul(24.0f, b4), e = mul(60.0f, b5);
  const float integ = add(add(add(add(mul(c, c), mul(c, d)),
                                  mul(add(mul(d, d), mul(mul(2.0f, c), e)), kThird)),
                              mul(mul(d, e), 0.5f)),
                          mul(mul(e, e), kFifth));
  const float Tc = fmaxf(T, 1e-6f);
  const float T2 = mul(Tc, Tc);
  return __fdiv_rn(integ, mul(Tc, mul(T2, T2)));
}

// The candidate's cost without the map's term (J_lat, J_lon combined).
__device__ __forceinline__ float closed_form_cost(const FrenetConfig& cfg, const Cand& c) {
  const float kjT = mul(cfg.k_t, c.T);
  const float J_lat = add(add(mul(cfg.k_j, jerk_integral(c.T, c.lb3, c.lb4, c.lb5)), kjT),
                          mul(mul(cfg.k_d, c.D), c.D));
  const float dv = sub(c.V, cfg.vdes);
  const float J_lon = add(add(mul(cfg.k_j, jerk_integral(c.T, c.q.sb3, c.q.sb4, 0.0f)), kjT),
                          mul(cfg.k_v, mul(dv, dv)));
  return add(mul(cfg.k_lat, J_lat), mul(cfg.k_lon, J_lon));
}

// One candidate over its N+1 points on its staged profile (`prof`): its cost
// (with the map's term) and whether every rule, obstacle slot and map cell
// lets it pass.
template <int kMap>
__device__ float walk(const FrenetConfig& cfg, const Lane& l, const Cand& c, const float* lon,
                      int prof, const float* obs, int n_live, const float* map, const float* geo,
                      float kb, bool& feasible) {
  const int N = cfg.N, n1 = N + 1, stride = cfg.n_T * cfg.n_v * n1;
  bool ok = true;
  float yaw_prev = 0.0f, unwrapped_prev = 0.0f, s_prev = 0.0f, wraps = 0.0f, usum = 0.0f;
  for (int j = 0; j <= N; ++j) {
    const LonPoint p = staged(lon, stride, prof * n1 + j);
    const Pose g = pose(l, c, p);
    ok = ok & (g.v <= cfg.v_hi);
    // the curvature: frenet.unwrap's running correction, its yaw differences
    // over the arclength differences
    float unwrapped = g.yaw;
    if (j > 0) {
      const float dd = sub(g.yaw, yaw_prev);
      if (!(fabsf(dd) < kPi)) {  // a wrap: the plain version's correction ddmod - dd
        float ddmod = sub(remainder_2pi(add(dd, kPi)), kPi);
        if (ddmod == -kPi && dd > 0.0f) ddmod = kPi;
        wraps = add(wraps, sub(ddmod, dd));
      }  // else the correction is 0, which adds nothing
      unwrapped = add(g.yaw, wraps);
      const float darc = fmaxf(sub(p.s, s_prev), 1e-3f);
      ok = ok & (fabsf(__fdiv_rn(sub(unwrapped, unwrapped_prev), darc)) <= kb);
    }
    yaw_prev = g.yaw;
    unwrapped_prev = unwrapped;
    s_prev = p.s;
    if (n_live > 0) {
      const float cy = cosf(g.yaw), sy = sinf(g.yaw);
      const float fx = add(g.x, mul(cy, cfg.efront)), fy = add(g.y, mul(sy, cfg.efront));
      const float rx = add(g.x, mul(-cy, cfg.erear)), ry = add(g.y, mul(-sy, cfg.erear));
      bool hit = false;
      for (int m = 0; m < n_live; ++m) {
        const float* o = obs + m * kObsComps * n1 + j;
        hit = hit | in_ellipse(o, n1, fx, fy) | in_ellipse(o, n1, rx, ry);
      }
      ok = ok & !hit;
    }
    if constexpr (kMap != kMapNone) {
      const MapSample ms = lane_map_sample(geo, map, cfg.H, cfg.W, g.x, g.y);
      const float u = ms.inside ? ms.val : 0.0f;
      ok = ok & (u < cfg.unc_threshold);
      usum = add(usum, mul(u, kHundredth));
    }
  }
  feasible = ok;
  float J = closed_form_cost(cfg, c);
  if constexpr (kMap != kMapNone) J = add(J, mul(cfg.w_unc, mul(usum, cfg.mean_factor)));
  return J;
}

// torch.argmin's order: a NaN before any number, equal values by index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a < b;
}

struct Pick {
  float v;
  int k;
};

__device__ __forceinline__ void take_if_before(Pick& mine, const Pick& other) {
  if (before(other.v, other.k, mine.v, mine.k)) mine = other;
}

__device__ __forceinline__ Pick shfl_pick(const Pick& p, int lane_mask) {
  return Pick{__shfl_xor_sync(0xffffffffu, p.v, lane_mask),
              __shfl_xor_sync(0xffffffffu, p.k, lane_mask)};
}

// One block per lane (blockIdx.x), cfg.threads threads over its candidates.
// Candidate k = (i_d * n_T + i_T) * n_v + i_v has the end offset axis_d[i_d],
// duration axis_t[i_T], speed axis_v[i_v] and the profile k % (n_T * n_v).
template <int kMap>
__global__ void __launch_bounds__(kMaxThreads, kMap == kMapShared ? 1 : 4)
frenet_lattice_kernel(FrenetConfig cfg,
                      const float* __restrict__ start,   // [B][4] s0, d0, s_dot0, d_dot0
                      const float* __restrict__ rs,      // [B][S] the reference line: s
                      const float* __restrict__ rx,      // [B][S] x
                      const float* __restrict__ ry,      // [B][S] y
                      const float* __restrict__ rtx,     // [B][S] unit tangent x
                      const float* __restrict__ rty,     // [B][S] unit tangent y
                      const float* __restrict__ axis_d,  // [n_lat] end offsets
                      const float* __restrict__ axis_t,  // [n_T] durations
                      const float* __restrict__ axis_v,  // [n_v] end speeds
                      const float* __restrict__ kappa,   // [1] the curvature bound
                      const float* __restrict__ obs,     // [M][6][N+1]
                      const bool* __restrict__ live,     // [M]
                      const float* __restrict__ maps,    // [H][W] shared or [B][H][W]
                      const float* __restrict__ geo,     // [1][16] shared or [B][16]
                      float* __restrict__ X,             // [B][N+1][4]
                      int* __restrict__ best,            // [B]
                      float* __restrict__ J_out,         // [B]
                      bool* __restrict__ any_ok,         // [B]
                      int* __restrict__ count) {         // [B]
  extern __shared__ float sh[];
  __shared__ int live_slots[kMaxObstacles];
  __shared__ int n_live_sh;
  __shared__ Pick warp_masked[kMaxWarps], warp_all[kMaxWarps];
  __shared__ int warp_count[kMaxWarps];
  __shared__ int pick_sh;

  const int b = blockIdx.x, tid = threadIdx.x, nthreads = blockDim.x;
  const int S = cfg.S, N = cfg.N, n1 = N + 1, n_v = cfg.n_v;
  const int n_prof = cfg.n_T * n_v, K = cfg.n_lat * n_prof;
  float* ref = sh;                       // [5][S]
  float* lon = ref + kRefComps * S;      // [8][profiles][N+1]
  int* lon_ok = reinterpret_cast<int*>(lon + kLonComps * n_prof * n1);  // [profiles]
  float* obs_sh = reinterpret_cast<float*>(lon_ok + n_prof);             // [live slots][6][N+1]

  if (tid == 0) {
    int n = 0;
    for (int m = 0; m < cfg.M; ++m)
      if (live[m]) live_slots[n++] = m;
    n_live_sh = n;
  }
  const float* comps[kRefComps] = {rs, rx, ry, rtx, rty};
#pragma unroll
  for (int c = 0; c < kRefComps; ++c)
    for (int i = tid; i < S; i += nthreads) ref[c * S + i] = comps[c][(size_t)b * S + i];
  for (int i = tid; i < n_prof; i += nthreads) lon_ok[i] = 1;
  __syncthreads();
  const int n_live = n_live_sh;
  const int slot = kObsComps * n1;
  for (int i = tid; i < n_live * slot; i += nthreads)
    obs_sh[i] = obs[(size_t)live_slots[i / slot] * slot + i % slot];

  const Lane l{start[4 * b], start[4 * b + 1], start[4 * b + 2], start[4 * b + 3]};
  // the longitudinal profiles' points, once a block
  const int stride = n_prof * n1;
  for (int i = tid; i < stride; i += nthreads) {
    const int prof = i / n1, j = i - prof * n1;
    bool ok;
    const LonPoint p = lon_point(cfg, l, axis_t[prof / n_v], axis_v[prof % n_v], ref,
                                 mul((float)j, cfg.dt), ok);
    const float v[kLonComps] = {p.s, p.sd, p.xr, p.yr, p.tx, p.ty, p.head, p.tau};
#pragma unroll
    for (int c = 0; c < kLonComps; ++c) lon[c * stride + i] = v[c];
    if (!ok) lon_ok[prof] = 0;
  }
  __syncthreads();

  const float* lane_map = nullptr;
  const float* lane_geo = nullptr;
  if constexpr (kMap == kMapShared) {
    lane_map = maps;
    lane_geo = geo;
  } else if constexpr (kMap == kMapLane) {
    lane_map = maps + (size_t)b * cfg.H * cfg.W;
    lane_geo = geo + (size_t)b * kGeoRow;
  }
  const float kb = mul(kappa[0], 1.5f);

  Pick masked{INFINITY, INT_MAX}, all{INFINITY, INT_MAX};
  int feasible_n = 0;
  for (int k = tid; k < K; k += nthreads) {
    const int prof = k % n_prof;
    const Cand c = candidate(l, axis_d[k / n_prof], axis_t[prof / n_v], axis_v[prof % n_v]);
    bool feasible;
    const float J = walk<kMap>(cfg, l, c, lon, prof, obs_sh, n_live, lane_map, lane_geo, kb,
                               feasible);
    feasible = feasible && lon_ok[prof];
    feasible_n += feasible;
    take_if_before(masked, Pick{feasible ? J : INFINITY, k});
    take_if_before(all, Pick{J, k});
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    take_if_before(masked, shfl_pick(masked, o));
    take_if_before(all, shfl_pick(all, o));
    feasible_n += __shfl_xor_sync(0xffffffffu, feasible_n, o);
  }
  const int warp = tid >> 5, nwarps = nthreads >> 5;
  if ((tid & 31) == 0) {
    warp_masked[warp] = masked;
    warp_all[warp] = all;
    warp_count[warp] = feasible_n;
  }
  __syncthreads();
  if (tid == 0) {
    int n = warp_count[0];
    for (int w = 1; w < nwarps; ++w) {
      take_if_before(masked, warp_masked[w]);
      take_if_before(all, warp_all[w]);
      n += warp_count[w];
    }
    const bool ok = n > 0;
    const Pick p = ok ? masked : all;
    best[b] = p.k;
    J_out[b] = p.v;
    any_ok[b] = ok;
    count[b] = n;
    pick_sh = p.k;
  }
  __syncthreads();

  // the winner's N+1 points, one thread each, written once
  const int k = pick_sh, prof = k % n_prof;
  const Cand c = candidate(l, axis_d[k / n_prof], axis_t[prof / n_v], axis_v[prof % n_v]);
  for (int j = tid; j < n1; j += nthreads) {
    const Pose g = pose(l, c, staged(lon, stride, prof * n1 + j));
    float* x = X + ((size_t)b * n1 + j) * 4;
    x[0] = g.x;
    x[1] = g.y;
    x[2] = g.v;
    x[3] = g.yaw;
  }
}

// Dynamic shared-memory bytes of a block: the reference line, the
// longitudinal profiles' points and flags, and every obstacle slot (the
// live ones are staged), or -1 if they do not fit.
int shared_bytes(int S, int N, int M, int n_prof) {
  const long long floats = (long long)kRefComps * S + (long long)(kLonComps * (N + 1) + 1) * n_prof +
                           (long long)kObsComps * (N + 1) * M;
  return floats * 4 <= kMaxSharedBytes ? (int)(floats * 4) : -1;
}

const void* kernel_of(int map) {
  switch (map) {
    case kMapNone: return (const void*)frenet_lattice_kernel<kMapNone>;
    case kMapShared: return (const void*)frenet_lattice_kernel<kMapShared>;
    case kMapLane: return (const void*)frenet_lattice_kernel<kMapLane>;
  }
  return nullptr;
}

}  // namespace

extern "C" int cilqr_frenet_config_size() { return (int)sizeof(FrenetConfig); }

// One launch: B blocks of cfg->threads threads.  maps / geo null unless
// cfg->map; obs / live null when cfg->M is 0.
extern "C" int cilqr_frenet_lattice(const FrenetConfig* cfg, const float* start, const float* rs,
                                    const float* rx, const float* ry, const float* rtx,
                                    const float* rty, const float* axis_d, const float* axis_t,
                                    const float* axis_v, const float* kappa, const float* obs,
                                    const bool* live, const float* maps, const float* geo, float* X,
                                    int* best, float* J, bool* any_ok, int* count, void* stream) {
  const FrenetConfig& c = *cfg;
  const bool axes = c.n_lat >= 1 && c.n_T >= 1 && c.n_v >= 1;
  const int smem = axes ? shared_bytes(c.S, c.N, c.M, c.n_T * c.n_v) : -1;
  const void* kernel = kernel_of(c.map);
  if (c.B < 1 || !axes || c.N < 1 || c.S < 2 || c.M < 0 || c.M > kMaxObstacles || smem < 0 ||
      kernel == nullptr || c.threads < 32 || c.threads > kMaxThreads || c.threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (c.map != kMapNone && (c.H < 2 || c.W < 2 || maps == nullptr || geo == nullptr))
    return (int)cudaErrorInvalidValue;
  if (c.M > 0 && (obs == nullptr || live == nullptr)) return (int)cudaErrorInvalidValue;
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
#define CILQR_FRENET_LAUNCH(kMap)                                                             \
  frenet_lattice_kernel<kMap><<<c.B, c.threads, smem, st>>>(                                  \
      c, start, rs, rx, ry, rtx, rty, axis_d, axis_t, axis_v, kappa, obs, live, maps, geo, X, \
      best, J, any_ok, count)
  if (c.map == kMapShared)
    CILQR_FRENET_LAUNCH(kMapShared);
  else if (c.map == kMapLane)
    CILQR_FRENET_LAUNCH(kMapLane);
  else
    CILQR_FRENET_LAUNCH(kMapNone);
#undef CILQR_FRENET_LAUNCH
  return (int)cudaGetLastError();
}

// What the compiler and the card give one instantiation (map: kMapNone,
// kMapShared, kMapLane) at `threads` threads and the shared memory of (S, N,
// M, n_prof profiles): out = [registers per thread, local-memory bytes per
// thread, shared-memory bytes per block, resident blocks per SM].
extern "C" int cilqr_frenet_resources(int map, int threads, int S, int N, int M, int n_prof,
                                      int* out) {
  const void* kernel = kernel_of(map);
  const int smem = n_prof >= 1 ? shared_bytes(S, N, M, n_prof) : -1;
  if (kernel == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  int rc = (int)cudaFuncGetAttributes(&attr, kernel);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != 0) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem + (int)attr.sharedSizeBytes;
  out[3] = blocks;
  return rc;
}
