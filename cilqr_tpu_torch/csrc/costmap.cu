// The costmap build's two per-cell layers in one pass: the corridor mask and
// the obstacle (bounding-box) layer of ops/costmap._costmap_pre.
//
// For scenario b and cell (i, j), with x = xs[b][i] and y = ys[b][j] the
// cell centre (gridmap.cell_positions, formed by PyTorch):
//
//   corridor[b, i, j] = x >= x_min && x <= x_max && y >= y_min && y <= y_max
//   bbox[b, i, j]     = 100 if an active obstacle's polygon holds (x, y), else 0
//
// A polygon of four vertices v_e holds (x, y) when every edge's cross product
//
//   c_e = ex * (y - vy) - ey * (x - vx),   (ex, ey) = v_{e+1} - v_e
//
// is >= 0, or every one is <= 0 (gridmap.polygon_mask); an obstacle is
// active when its mask is set and it lies within the raster radius
// (costmap.obstacle_corners, per scenario, in PyTorch).  The plain version
// (ops/costmap_cuda.costmap_layers_plain) forms each step as a full
// (B, rows, cols) temporary: per obstacle edge a cross product and two
// compares, then the ands, the running maximum and the x100.  Here every cell
// is formed in registers and only the two maps are written.
//
// What bounds it on an H100: bytes out.  At the full-stack shape (B=8192
// frames of 152x104 cells) it writes 2 x 518 MB; its inputs are a few hundred
// bytes per scenario.  Design (as K5, csrc/sample.cu):
//   * one block per scenario: a thread owns a run of four neighbouring cells
//     of a row and keeps that column run for the whole frame, so the column
//     tests are formed once per thread and the row tests once per row;
//   * the scenario's edges (vertex, edge vector) and active flags are staged
//     in shared memory once per block; an inactive obstacle is skipped by
//     the whole block;
//   * 16-byte streaming stores where the width is a multiple of 4 (both maps
//     are fresh allocations, aligned beyond 16 bytes): a warp stores 512
//     contiguous bytes of a map.
//
// Numerics: the masks are exact 0 / 1 (0 / 100), so each compare must see
// the float the plain version sees.  Every subtraction and product is an
// explicitly rounded intrinsic in the plain version's order, which nvcc may
// not contract into an FMA; a NaN fails every compare, as it does there.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

constexpr int kRun = 4;           // neighbouring cells of a row per thread
constexpr int kMaxThreads = 256;  // per block
constexpr int kEdges = 4;         // vertices of an obstacle's box
constexpr int kMaxObstacles = 512;  // staged edges: 32 KB of shared memory

struct Layers {
  int rows, cols, M;
  int runs, row_step;  // runs of kRun cells per row; rows a block covers per pass
};

__device__ __forceinline__ void store_run(float* out, long long at, int left, const float (&v)[kRun],
                                          bool vec) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(out + at), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < left) __stcs(out + at + k, v[k]);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
costmap_layers_kernel(Layers f,
                      const float* __restrict__ xs,      // [B][rows] cell centres along x
                      const float* __restrict__ ys,      // [B][cols] cell centres along y
                      const float* __restrict__ bounds,  // [B][4] x_min, x_max, y_min, y_max
                      const float* __restrict__ verts,   // [B][M][4][2] vehicle-frame corners
                      const unsigned char* __restrict__ active,  // [B][M]
                      float* __restrict__ corridor,      // [B][rows][cols]
                      float* __restrict__ bbox) {        // [B][rows][cols]
  extern __shared__ float4 edges[];  // [M][4]: vx, vy, ex, ey; then M active flags
  int* live = reinterpret_cast<int*>(edges + kEdges * f.M);
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  for (int q = t; q < kEdges * f.M; q += blockDim.x) {
    const float* v = verts + (b * f.M * kEdges + q) * 2;
    const float* vn = verts + (b * f.M * kEdges + q - q % kEdges + (q + 1) % kEdges) * 2;
    const float vx = __ldg(v), vy = __ldg(v + 1);
    edges[q] = make_float4(vx, vy, sub(__ldg(vn), vx), sub(__ldg(vn + 1), vy));
  }
  for (int m = t; m < f.M; m += blockDim.x) live[m] = __ldg(active + b * f.M + m) != 0;
  __syncthreads();
  if (t >= f.runs * f.row_step) return;

  const int j0 = (t % f.runs) * kRun;
  const int left = f.cols - j0;  // cells of this run inside the row
  const float x_min = __ldg(bounds + 4 * b), x_max = __ldg(bounds + 4 * b + 1);
  const float y_min = __ldg(bounds + 4 * b + 2), y_max = __ldg(bounds + 4 * b + 3);
  // this thread's columns, tested once
  float y[kRun];
  bool in_y[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    y[k] = k < left ? __ldg(ys + b * f.cols + j0 + k) : 0.0f;
    in_y[k] = y[k] >= y_min && y[k] <= y_max;
  }
  const long long frame = b * f.rows * f.cols;
  for (int i = t / f.runs; i < f.rows; i += f.row_step) {
    const float x = __ldg(xs + b * f.rows + i);
    const bool in_x = x >= x_min && x <= x_max;
    bool inside[kRun] = {};
    for (int m = 0; m < f.M; ++m) {
      if (!live[m]) continue;
      bool all_ge[kRun], all_le[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k) all_ge[k] = all_le[k] = true;
#pragma unroll
      for (int e = 0; e < kEdges; ++e) {
        const float4 E = edges[kEdges * m + e];
        const float ey_rx = mul(E.w, sub(x, E.x));
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          const float c = sub(mul(E.z, sub(y[k], E.y)), ey_rx);
          all_ge[k] = all_ge[k] && c >= 0.0f;
          all_le[k] = all_le[k] && c <= 0.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k) inside[k] = inside[k] || all_ge[k] || all_le[k];
    }
    float cm[kRun], bm[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      cm[k] = in_x && in_y[k] ? 1.0f : 0.0f;
      bm[k] = inside[k] ? 100.0f : 0.0f;
    }
    const long long at = frame + (long long)i * f.cols + j0;
    store_run(corridor, at, left, cm, kVec);
    store_run(bbox, at, left, bm, kVec);
  }
}

}  // namespace

// vec: 16-byte stores (cols % 4 == 0; the maps 16-byte aligned).  M may be 0
// (then the box layer is all zero); at most kMaxObstacles (ops/costmap_cuda
// MAX_OBSTACLES).
extern "C" int cilqr_costmap_layers(int B, int rows, int cols, int M, int vec, const float* xs,
                                    const float* ys, const float* bounds, const float* verts,
                                    const unsigned char* active, float* corridor, float* bbox,
                                    void* stream) {
  if (B < 1 || rows < 1 || cols < 1 || M < 0 || M > kMaxObstacles)
    return (int)cudaErrorInvalidValue;
  if (vec && cols % kRun != 0) return (int)cudaErrorInvalidValue;
  Layers f;
  f.rows = rows; f.cols = cols; f.M = M;
  f.runs = (cols + kRun - 1) / kRun;
  if (f.runs > kMaxThreads) return (int)cudaErrorInvalidValue;
  f.row_step = min(rows, kMaxThreads / f.runs);
  const int threads = (f.runs * f.row_step + 31) / 32 * 32;
  const size_t shared = (size_t)M * (kEdges * sizeof(float4) + sizeof(int));
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    costmap_layers_kernel<true><<<B, threads, shared, st>>>(f, xs, ys, bounds, verts, active,
                                                            corridor, bbox);
  else
    costmap_layers_kernel<false><<<B, threads, shared, st>>>(f, xs, ys, bounds, verts, active,
                                                             corridor, bbox);
  return (int)cudaGetLastError();
}
