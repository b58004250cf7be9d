// Gaussian-ellipse uncertainty propagation of B costmaps, in one kernel.
//
// Replaces the TPU kernels of cilqr_tpu/ops/uncertainty_pallas.py: `_kernel`
// (:199, one map), `_kernel_band` (:283, one row band per grid step) and
// `_kernel_bands_fused` (:300, all bands of one scenario), with their shared
// body `_accumulate` (:48-184) and `_finish` (:192-196).  For every scenario
// b and cell (i, j):
//
//   u = sum w p / sum w,  w = exp(-q / (2 (1 - rho^2)))  where
//   q <= chi^2 (1 - rho^2) and the neighbour lies inside the map,
//   q = (zx - 2 rho zy) zx + zy^2,  zx = dx (1/sx),  zy = dy (1/sy),
//
// over the neighbours at index offsets (di, dj) within the cell's row band
// radius R and its disc cut di^2 + dj^2 <= r_disc^2, column-outer (dj) and
// row-inner (di) as in the Pallas body.  The prior is kept where psd = 0 or
// den = 0; the rest is clipped to [0, 100].  The per-cell fields
// (sx, sy, rho, psd) come from PyTorch (uncertainty_cuda.prep_fields).
//
// What bounds it on an H100: arithmetic.  At the Monte-Carlo shape
// (B=8192 maps of 152x104, row bands of radius 3..8 cut to their disc) a
// cell visits ~100-200 offsets of ~10 float operations each, plus one expf
// inside the ellipse: ~2e11 operations per call.  The prior (63 KB, shared
// by all scenarios) is read through the L1/L2 caches; fields and output
// are one coalesced read or write per cell.
//
// Design: one thread per (scenario, cell), cells row-major so a warp reads
// neighbouring columns.  Band radii are data: each row carries its band's
// R and squared disc radius (+inf: no disc cut), so one kernel serves the
// single-map, the full-window batched and the banded forms.  The prior has
// a scenario stride of 0 (one shared map) or rows*cols (one per scenario).
// Offsets outside the map or the ellipse contribute w = 0 in the Pallas
// body; here they are skipped, which gives the same sums.
//
// Numerics: the inside test q <= thresh is discontinuous (a weight jumps
// from ~0.05 of its peak to 0), so q, thresh, 1/(2(1-rho^2)) and the sums
// are built with explicitly rounded operations: nvcc may not contract them
// into FMAs, and the kernel takes the same branch as the plain version.
// expf is the accurate one (no fast-math).
#include <cuda_runtime.h>

#include <cmath>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void propagate_kernel(int B, int rows, int cols, float res, double res_d,
                                 float chi2,
                                 const float* __restrict__ prior,  // [B or 1][rows][cols]
                                 long long prior_stride,           // 0 or rows*cols
                                 const float* __restrict__ sx,     // [B][rows][cols]
                                 const float* __restrict__ sy,
                                 const float* __restrict__ rho,
                                 const float* __restrict__ psd,
                                 const int* __restrict__ row_R,       // [rows]
                                 const double* __restrict__ row_rd2,  // [rows]
                                 float* __restrict__ out) {           // [B][rows][cols]
  const long long cells = (long long)rows * cols;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * cells) return;
  const long long b = idx / cells;
  const int cell = (int)(idx - b * cells);
  const int i = cell / cols;
  const int j = cell - i * cols;
  const float* pr = prior + b * prior_stride;

  if (!(psd[idx] > 0.0f)) {
    out[idx] = pr[cell];
    return;
  }
  const float r = rho[idx];
  const float inv_sx = __fdiv_rn(1.0f, sx[idx]);
  const float inv_sy = __fdiv_rn(1.0f, sy[idx]);
  const float two_rho = add(r, r);
  const float one_m_rho2 = sub(1.0f, mul(r, r));
  const float inv_det2 = __fdiv_rn(1.0f, mul(2.0f, one_m_rho2));
  const float thresh = mul(chi2, one_m_rho2);
  const int R = row_R[i];
  const double rd2 = row_rd2[i];
  const bool disc = isfinite(rd2);

  float num = 0.0f, den = 0.0f;
  for (int djo = -R; djo <= R; ++djo) {
    int m = R;
    if (disc) {
      const double d2 = (double)djo * (double)djo;
      if (d2 > rd2) continue;  // the whole column lies outside the disc
      m = min(R, (int)floor(sqrt(rd2 - d2)));
    }
    const int jj = j + djo;
    if (jj < 0 || jj >= cols) continue;
    // -(dj - R) * res in double, then rounded once (a Python float in the
    // Pallas body)
    const float dy = (float)(-(double)djo * res_d);
    const float zy = mul(dy, inv_sy);
    const float t2 = mul(two_rho, zy);
    const float zy2 = mul(zy, zy);
    for (int dio = -m; dio <= m; ++dio) {
      const int ii = i + dio;
      if (ii < 0 || ii >= rows) continue;
      const float dx = mul((float)(-dio), res);
      const float zx = mul(dx, inv_sx);
      const float q = add(mul(sub(zx, t2), zx), zy2);
      if (q <= thresh) {
        const float w = expf(mul(-q, inv_det2));
        num = add(num, mul(w, pr[ii * cols + jj]));
        den = add(den, w);
      }
    }
  }
  out[idx] = den > 0.0f ? fminf(fmaxf(__fdiv_rn(num, den), 0.0f), 100.0f) : pr[cell];
}

}  // namespace

extern "C" int cilqr_propagate(int B, int rows, int cols, float res, double res_d, float chi2,
                               const float* prior, long long prior_stride, const float* sx,
                               const float* sy, const float* rho, const float* psd,
                               const int* row_R, const double* row_rd2, float* out,
                               void* stream) {
  const long long total = (long long)B * rows * cols;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  propagate_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      B, rows, cols, res, res_d, chi2, prior, prior_stride, sx, sy, rho, psd, row_R, row_rd2,
      out);
  return (int)cudaGetLastError();
}
