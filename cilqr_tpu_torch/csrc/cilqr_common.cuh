// Device functions shared by the Riccati kernel (riccati.cu) and the LM
// kernel (lm.cu): one backward Riccati step and one closed-loop rollout step.
//
// Layout of every per-step array: scenario-minor, [step][component][B], so
// the 32 threads of a warp (32 neighbouring scenarios) read 32 neighbouring
// floats.  Index with at(step, comp, ncomp, B, b).
#pragma once

#include <cuda_runtime.h>

namespace cilqr {

__device__ __forceinline__ size_t at(int step, int comp, int ncomp, int B, int b) {
  return ((size_t)step * ncomp + comp) * (size_t)B + b;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);  // jnp.clip order: min(max(x, lo), hi)
}

// Constants of the Model.cpp:17-30 step.
struct DynConst {
  float dt, acc_min, acc_max, tan_lo, tan_hi, speed_max;
};

// One Riccati step (iLQR.cpp:133-191) at horizon index j: updates (Vx, Vxx)
// in place and writes k (2) and K (2x4, row-major).
//   lx (4), lxx (4x4 row-major), lu (2), luu = (l_uu00, l_uu01, l_uu11);
//   (v, th, a): Jacobian ingredients at the successor state X[j+1] and U[j]
//   (the iLQR.cpp:102-106 quirk).  fx = I + the bicycle terms
//   (Model.cpp:100-127), fu has 5 nonzeros (Model.cpp:139-155).
// The Q_uu inverse is the eigenvalue-clamp + lambda shift of
// iLQR.cpp:155-175 in closed form, with the relative degeneracy threshold.
__device__ __forceinline__ void riccati_backward_step(
    const float lx[4], const float lxx[16], const float lu[2], const float luu[3],
    float v, float th, float a, float dt, float lamb,
    float Vx[4], float Vxx[16], float k[2], float K[8]) {
  const float c = cosf(th);
  const float s = sinf(th);
  const float ds = v * dt + 0.5f * a * dt * dt;
  const float dtc = dt * c, dts = dt * s;
  const float sds = s * ds, cds = c * ds;
  const float hdt2c = 0.5f * dt * dt * c, hdt2s = 0.5f * dt * dt * s;

  // Q_x = l_x + fx^T V_x ; Q_u = l_u + fu^T V_x
  float Qx[4] = {lx[0] + Vx[0], lx[1] + Vx[1],
                 lx[2] + dtc * Vx[0] + dts * Vx[1] + Vx[2],
                 lx[3] - sds * Vx[0] + cds * Vx[1] + Vx[3]};
  float Qu[2] = {lu[0] + hdt2c * Vx[0] + hdt2s * Vx[1] + dt * Vx[2],
                 lu[1] + dt * Vx[3]};

  // M = fx^T V_xx ; Q_xx = l_xx + M fx
  float M[16];
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    M[0 * 4 + col] = Vxx[0 * 4 + col];
    M[1 * 4 + col] = Vxx[1 * 4 + col];
    M[2 * 4 + col] = dtc * Vxx[0 * 4 + col] + dts * Vxx[1 * 4 + col] + Vxx[2 * 4 + col];
    M[3 * 4 + col] = -sds * Vxx[0 * 4 + col] + cds * Vxx[1 * 4 + col] + Vxx[3 * 4 + col];
  }
  float Qxx[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    Qxx[r * 4 + 0] = lxx[r * 4 + 0] + M[r * 4 + 0];
    Qxx[r * 4 + 1] = lxx[r * 4 + 1] + M[r * 4 + 1];
    Qxx[r * 4 + 2] = lxx[r * 4 + 2] + (dtc * M[r * 4 + 0] + dts * M[r * 4 + 1] + M[r * 4 + 2]);
    Qxx[r * 4 + 3] = lxx[r * 4 + 3] + (-sds * M[r * 4 + 0] + cds * M[r * 4 + 1] + M[r * 4 + 3]);
  }

  // N2 = fu^T V_xx (2x4) ; Q_ux = N2 fx ; Q_uu = l_uu + N2 fu
  float N2[8];
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    N2[col] = hdt2c * Vxx[0 * 4 + col] + hdt2s * Vxx[1 * 4 + col] + dt * Vxx[2 * 4 + col];
    N2[4 + col] = dt * Vxx[3 * 4 + col];
  }
  float Qux[8];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    Qux[r * 4 + 0] = N2[r * 4 + 0];
    Qux[r * 4 + 1] = N2[r * 4 + 1];
    Qux[r * 4 + 2] = dtc * N2[r * 4 + 0] + dts * N2[r * 4 + 1] + N2[r * 4 + 2];
    Qux[r * 4 + 3] = -sds * N2[r * 4 + 0] + cds * N2[r * 4 + 1] + N2[r * 4 + 3];
  }
  const float Quu00 = luu[0] + hdt2c * N2[0] + hdt2s * N2[1] + dt * N2[2];
  const float Quu01 = luu[1] + dt * N2[3];
  const float Quu10 = luu[1] + hdt2c * N2[4] + hdt2s * N2[5] + dt * N2[6];
  const float Quu11 = luu[2] + dt * N2[7];

  // closed-form 2x2 eigen clamp + shift inverse of the symmetric view
  const float bsym = Quu01;
  const float half_tr = 0.5f * (Quu00 + Quu11);
  const float half_df = 0.5f * (Quu00 - Quu11);
  const float disc = sqrtf(half_df * half_df + bsym * bsym);
  const float w_lo = half_tr - disc;
  const float w_hi = half_tr + disc;
  const bool safe = fabsf(bsym) > 1.1920929e-07f * (fabsf(Quu00) + fabsf(Quu11));
  const bool a_ge = Quu00 >= Quu11;
  float vx1 = safe ? bsym : (a_ge ? 1.0f : 0.0f);
  float vy1 = safe ? (w_hi - Quu00) : (a_ge ? 0.0f : 1.0f);
  const float nrm = rsqrtf(vx1 * vx1 + vy1 * vy1);
  vx1 *= nrm;
  vy1 *= nrm;
  const float i_hi = 1.0f / (fmaxf(w_hi, 0.0f) + lamb);
  const float i_lo = 1.0f / (fmaxf(w_lo, 0.0f) + lamb);
  const float I00 = i_hi * vx1 * vx1 + i_lo * vy1 * vy1;
  const float I01 = (i_hi - i_lo) * vx1 * vy1;
  const float I11 = i_hi * vy1 * vy1 + i_lo * vx1 * vx1;

  // k = -Quu_inv Qu ; K = -Quu_inv Qux
  k[0] = -(I00 * Qu[0] + I01 * Qu[1]);
  k[1] = -(I01 * Qu[0] + I11 * Qu[1]);
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    K[col] = -(I00 * Qux[col] + I01 * Qux[4 + col]);
    K[4 + col] = -(I01 * Qux[col] + I11 * Qux[4 + col]);
  }

  // V_x = Q_x - K^T (Quu k) ; V_xx = Q_xx - K^T (Quu K)   (iLQR.cpp:180-181)
  const float t0 = Quu00 * k[0] + Quu01 * k[1];
  const float t1 = Quu10 * k[0] + Quu11 * k[1];
  float W[8];
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    Vx[col] = Qx[col] - (K[col] * t0 + K[4 + col] * t1);
    W[col] = Quu00 * K[col] + Quu01 * K[4 + col];
    W[4 + col] = Quu10 * K[col] + Quu11 * K[4 + col];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      Vxx[r * 4 + col] = Qxx[r * 4 + col] - (K[r] * W[col] + K[4 + r] * W[4 + col]);
    }
  }
}

// One closed-loop rollout step (iLQR.cpp:68-86): u = U_j + k_j + K_j (x - X_j),
// then x <- step(x, u) with the Model.cpp:17-30 clamps.  Writes u (2).
__device__ __forceinline__ void rollout_step(
    const DynConst& dc, const float Xj[4], const float Uj[2], const float kj[2],
    const float Kj[8], float x[4], float u[2]) {
  float u0 = Uj[0] + kj[0];
  float u1 = Uj[1] + kj[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float dxi = x[i] - Xj[i];
    u0 = u0 + Kj[i] * dxi;
    u1 = u1 + Kj[4 + i] * dxi;
  }
  u[0] = u0;
  u[1] = u1;
  const float acc = clampf(u0, dc.acc_min, dc.acc_max);
  const float yr = clampf(u1, x[2] * dc.tan_lo, x[2] * dc.tan_hi);
  const float ds = x[2] * dc.dt + 0.5f * acc * dc.dt * dc.dt;
  const float c = cosf(x[3]);
  const float s = sinf(x[3]);
  const float nx0 = x[0] + c * ds;
  const float nx1 = x[1] + s * ds;
  const float nx2 = clampf(x[2] + acc * dc.dt, 0.0f, dc.speed_max);
  const float nx3 = x[3] + yr * dc.dt;
  x[0] = nx0;
  x[1] = nx1;
  x[2] = nx2;
  x[3] = nx3;
}

}  // namespace cilqr
