// Nearest-cell resample of one shared global map at B rotated vehicle frames.
//
// Replaces the TPU kernels of cilqr_tpu/ops/sample_pallas.py: `_kernel_shear`
// (:236, the shear decomposition) and `_kernel` / `_kernel_fused` (:165/:174,
// the per-tile window gather).  Both compute, for every scenario b and
// vehicle-frame cell (i, j), op for op what costmap.sample_prior computes:
//
//   x_v = first_x[b] - res[b] * i          y_v = first_y[b] - res[b] * j
//   gx  = x_v * c[b] - y_v * s[b] + ego_x[b]
//   gy  = x_v * s[b] + y_v * c[b] + ego_y[b]
//   ii  = clamp(floor((top_x - gx) / res_g), 0, H - 1),  jj likewise with W
//   out[b, i, j] = map[ii, jj]
//
// The two TPU forms, their 128-lane rolls, window sizing and VMEM budget
// exist because a lane gather is costly on the TPU; on this card a gather
// is a load, so one kernel with one thread per output cell replaces both.
//
// What bounds it on an H100: bytes.  At the full-stack shape (B=8192 frames
// of 152x104 cells from a 256x256 map) it writes 518 MB once and reads a
// 256 KB map that stays in L2; ~20 float operations per cell are far below
// the arithmetic bound.  Design: a 2-D grid, scenarios on x (no limit that a
// batch reaches, so one call is always one launch) and runs of 256
// row-major cells on y, so a warp writes 32 neighbouring floats and reads
// 32 nearby map cells; the eight per-scenario scalars are one 32-byte line
// per scenario.
//
// Numerics: the result is a pure gather and must equal the plain version
// on every cell, and floor() is a knife-edge: one ulp in gx moves a cell.
// So cos/sin of the yaw, `first` and `top` come from PyTorch, and every
// operation is an explicitly rounded intrinsic in the plain version's
// order, which nvcc may not contract into an FMA.  The index is clamped as
// a float before the cast, so frames that leave the map read its edge.
#include <cuda_runtime.h>

#include <cmath>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void sample_kernel(int rows, int cols, int H, int W,
                              const float* __restrict__ map,   // [H][W]
                              const float* __restrict__ gscl,  // [top_x, top_y, res_g, 0]
                              const float* __restrict__ scl,   // [B][8]: first_x, first_y, res,
                                                               // ego_x, ego_y, cos, sin, 0
                              float* __restrict__ out) {       // [B][rows][cols]
  // blockIdx.x is the scenario, blockIdx.y a run of cells: no 64-bit
  // division per thread
  const int cells = rows * cols;
  const int cell = blockIdx.y * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  const long long b = blockIdx.x;
  const int i = cell / cols;
  const int j = cell - i * cols;

  const float4 s0 = __ldg(reinterpret_cast<const float4*>(scl + b * 8));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(scl + b * 8 + 4));
  const float first_x = s0.x, first_y = s0.y, res = s0.z, ego_x = s0.w;
  const float ego_y = s1.x, c = s1.y, s = s1.z;
  const float top_x = __ldg(gscl), top_y = __ldg(gscl + 1), res_g = __ldg(gscl + 2);

  const float x_v = sub(first_x, mul(res, (float)i));
  const float y_v = sub(first_y, mul(res, (float)j));
  const float gx = add(sub(mul(x_v, c), mul(y_v, s)), ego_x);
  const float gy = add(add(mul(x_v, s), mul(y_v, c)), ego_y);
  const float fi = fminf(fmaxf(floorf(__fdiv_rn(sub(top_x, gx), res_g)), 0.0f), (float)(H - 1));
  const float fj = fminf(fmaxf(floorf(__fdiv_rn(sub(top_y, gy), res_g)), 0.0f), (float)(W - 1));
  out[b * cells + cell] = __ldg(map + (long long)(int)fi * W + (int)fj);
}

}  // namespace

extern "C" int cilqr_sample_prior(int B, int rows, int cols, int H, int W, const float* map,
                                  const float* gscl, const float* scl, float* out,
                                  void* stream) {
  const int threads = 256;
  const long long cells = (long long)rows * cols;
  // gridDim.y holds at most 65535 runs of cells: 16.7 million cells a frame
  if (B < 1 || cells < 1 || cells > 65535LL * threads) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)((cells + threads - 1) / threads));
  sample_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(rows, cols, H, W, map, gscl, scl, out);
  return (int)cudaGetLastError();
}
