// Nearest-cell resample of one shared global map at B rotated vehicle frames,
// optionally with the costmap's two overrides applied on the way out.
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
//   prior[b, i, j] = map[ii, jj]
//
// With `bbox` (and `sem`) given, the kernel writes the vehicle map of
// costmap.build_local_costmap_batched instead of the prior:
//
//   out = sem > 90 ? sem : (bbox > 90 ? bbox : prior)
//
// (a NaN in bbox or sem fails its test and keeps the value below it).  The
// TPU kernels leave the overrides to XLA; fusing them here spares a pass
// that reads two frames and writes one, and the prior frame itself.
//
// What bounds it on an H100: bytes.  At the full-stack shape (B=8192 frames
// of 152x104 cells from a 256x256 map) it writes 518 MB once (and reads
// 518 MB of bbox when fused); the 256 KB map stays in L2.  Design:
//   * one block per scenario, the whole frame: a thread owns a run of four
//     neighbouring cells of a row and keeps that column run for the whole
//     frame, so the column products y_v*s, y_v*c are formed once per thread
//     and the row products x_v*c, x_v*s once per row; a cell is then four
//     additions, two divisions, two floor-casts and a gather.  No integer
//     division by the width anywhere.
//   * 16-byte stores (and bbox / sem loads) where the width is a multiple of
//     4 and every frame is 16-byte aligned, scalar accesses otherwise;
//     streaming (evict-first) stores and loads, so the frames that pass
//     through once do not push the map out of L2.
//   * neighbouring threads own neighbouring runs: a warp stores 512
//     contiguous bytes, and a block's rows follow one another in memory.
//
// Numerics: the result is a pure gather and must equal the plain version
// on every cell, and floor() is a knife-edge: one ulp in gx moves a cell.
// So cos/sin of the yaw and `first` come from PyTorch, `top` is formed here
// by the plain version's two operations, and every operation is an
// explicitly rounded intrinsic in the plain version's order, which nvcc may
// not contract into an FMA.  The quotient is cast with round-down (the
// floor) and clamped as an integer: the cast saturates, so a frame that
// leaves the map reads its edge exactly as the plain version's float clamp.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

constexpr int kRun = 4;          // neighbouring cells of a row per thread
constexpr int kMaxThreads = 256;  // per block; 512 was 3% slower with bbox fused (H100)

struct Frame {
  int rows, cols, H, W;
  int runs, row_step;  // runs of kRun cells per row; rows a block covers per pass
};

// floor(q) clamped to [0, n - 1]: __float2int_rd saturates out of range
__device__ __forceinline__ int cell_index(float q, int n) {
  return min(max(__float2int_rd(q), 0), n - 1);
}

__device__ __forceinline__ float override_cell(float v, const float* bbox, const float* sem,
                                               float bb, float sm) {
  if (bbox != nullptr) v = bb > 90.0f ? bb : v;
  if (sem != nullptr) v = sm > 90.0f ? sm : v;
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
sample_kernel(Frame f,
              const float* __restrict__ map,     // [H][W]
              const float* __restrict__ gcenter, // [2] global grid center
              const float* __restrict__ glength, // [2] global grid length
              const float* __restrict__ gres,    // [1] global resolution
              const float* __restrict__ first,   // [B][2] cell (0, 0) of each frame
              const float* __restrict__ res,     // [B * res_stride] frame resolution
              int res_stride,
              const float* __restrict__ xy,      // [B][xy_stride] ego x, y
              int xy_stride,
              const float* __restrict__ cs,      // [B] cos(yaw)
              const float* __restrict__ sn,      // [B] sin(yaw)
              const float* __restrict__ bbox,    // [B][rows][cols] or null
              const float* __restrict__ sem,     // [B][rows][cols] or null
              float* __restrict__ out) {         // [B][rows][cols]
  const int t = threadIdx.x;
  if (t >= f.runs * f.row_step) return;
  const long long b = blockIdx.x;
  const int j0 = (t % f.runs) * kRun;
  const int r0 = t / f.runs;

  const float top_x = add(__ldg(gcenter), mul(0.5f, __ldg(glength)));
  const float top_y = add(__ldg(gcenter + 1), mul(0.5f, __ldg(glength + 1)));
  const float res_g = __ldg(gres);
  const float first_x = __ldg(first + 2 * b), first_y = __ldg(first + 2 * b + 1);
  const float r = __ldg(res + b * res_stride);
  const float ego_x = __ldg(xy + b * xy_stride), ego_y = __ldg(xy + b * xy_stride + 1);
  const float c = __ldg(cs + b), s = __ldg(sn + b);

  // this thread's columns, formed once
  float ys[kRun], yc[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const float y_v = sub(first_y, mul(r, (float)(j0 + k)));
    ys[k] = mul(y_v, s);
    yc[k] = mul(y_v, c);
  }
  const long long frame = b * f.rows * f.cols;
  for (int i = r0; i < f.rows; i += f.row_step) {
    const float x_v = sub(first_x, mul(r, (float)i));
    const float xc = mul(x_v, c), xs = mul(x_v, s);
    const long long at = frame + (long long)i * f.cols + j0;
    float v[kRun], bb[kRun] = {}, sm[kRun] = {};
    if constexpr (kVec) {
      if (bbox != nullptr) {
        const float4 q = __ldcs(reinterpret_cast<const float4*>(bbox + at));
        bb[0] = q.x; bb[1] = q.y; bb[2] = q.z; bb[3] = q.w;
      }
      if (sem != nullptr) {
        const float4 q = __ldcs(reinterpret_cast<const float4*>(sem + at));
        sm[0] = q.x; sm[1] = q.y; sm[2] = q.z; sm[3] = q.w;
      }
    }
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      const float gx = add(sub(xc, ys[k]), ego_x);
      const float gy = add(add(xs, yc[k]), ego_y);
      const int ii = cell_index(__fdiv_rn(sub(top_x, gx), res_g), f.H);
      const int jj = cell_index(__fdiv_rn(sub(top_y, gy), res_g), f.W);
      v[k] = __ldg(map + (long long)ii * f.W + jj);
    }
    if constexpr (kVec) {
      float4 q;
      q.x = override_cell(v[0], bbox, sem, bb[0], sm[0]);
      q.y = override_cell(v[1], bbox, sem, bb[1], sm[1]);
      q.z = override_cell(v[2], bbox, sem, bb[2], sm[2]);
      q.w = override_cell(v[3], bbox, sem, bb[3], sm[3]);
      __stcs(reinterpret_cast<float4*>(out + at), q);
    } else {
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (j0 + k >= f.cols) break;
        const float bk = bbox != nullptr ? __ldcs(bbox + at + k) : 0.0f;
        const float sk = sem != nullptr ? __ldcs(sem + at + k) : 0.0f;
        __stcs(out + at + k, override_cell(v[k], bbox, sem, bk, sk));
      }
    }
  }
}

}  // namespace

// vec: 16-byte accesses (cols % 4 == 0 and every pointer 16-byte aligned,
// checked by the wrapper).  bbox and sem may be null.
extern "C" int cilqr_sample_prior(int B, int rows, int cols, int H, int W, int vec,
                                  const float* map, const float* gcenter, const float* glength,
                                  const float* gres, const float* first, const float* res,
                                  int res_stride, const float* xy, int xy_stride, const float* cs,
                                  const float* sn, const float* bbox, const float* sem, float* out,
                                  void* stream) {
  if (B < 1 || rows < 1 || cols < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (vec && cols % kRun != 0) return (int)cudaErrorInvalidValue;
  Frame f;
  f.rows = rows; f.cols = cols; f.H = H; f.W = W;
  f.runs = (cols + kRun - 1) / kRun;
  if (f.runs > kMaxThreads) return (int)cudaErrorInvalidValue;
  f.row_step = min(rows, kMaxThreads / f.runs);
  const int threads = (f.runs * f.row_step + 31) / 32 * 32;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    sample_kernel<true><<<B, threads, 0, st>>>(f, map, gcenter, glength, gres, first, res,
                                               res_stride, xy, xy_stride, cs, sn, bbox, sem, out);
  else
    sample_kernel<false><<<B, threads, 0, st>>>(f, map, gcenter, glength, gres, first, res,
                                                res_stride, xy, xy_stride, cs, sn, bbox, sem, out);
  return (int)cudaGetLastError();
}
