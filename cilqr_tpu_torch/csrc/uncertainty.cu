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
// den = 0; the rest is clipped to [0, 100].
//
// What bounds it on an H100: the function itself is bound by bytes (the
// prior in, the map out, 12 floats per scenario; with the fields given, four
// more floats per cell in).  The work that the function needs is the offsets
// inside each cell's own 95% ellipse, ~pi chi^2 sx sy sqrt(1 - rho^2) / res^2
// of them; what an implementation spends beyond that is its scan: offsets
// that fail the inside test, and the latency of reading the prior at every
// offset that passes it.
//
// Design, in the order in which each part was added and timed:
//  a. A cell scans its own ellipse's neighbourhood, not its band's window.
//     With a = zx - rho zy, q = a^2 + (1 - rho^2) zy^2 (and the same with zx
//     and zy swapped).  An offset that passes the float32 test has q <=
//     thresh + e with e, the rounding of q and thresh, below 1e-4 as long as
//     1 - rho^2 >= kRangeMinDet = 2^-16 (then |zx|, |zy| < 1.2 chi, so q's
//     terms stay below ~10 and carry a few ulps each).  With kRangeSlack =
//     1e-3 > e that gives
//       zx^2, zy^2 <= chi^2 + slack / (1 - rho^2)      (the cell's box), and
//       a^2 <= (1 - rho^2)(chi^2 - zy^2) + slack       (per column dj: an
//                         interval of rows around -rho zy sx / res),
//     so the loops run over |dj| <= min(R, floor(reach sy / res + 0.01))
//     and, per column, over that interval of rows, each bound widened by
//     kCellMargin = 0.01 rows before it is floored: the bounds are sums and
//     products of a few float32 terms below ~20 cells, so their own rounding
//     is below 1e-5 cells, and the slack alone already leaves 1.6e-4 in z;
//     clipped to the disc cut and the map.  For a thin ellipse (|rho| near
//     1: sigma_theta times the lever far above sigma_x, as on the full-stack
//     path) the interval is a small part of the box's column.  Every visited
//     offset still takes the test.  Where 1 - rho^2 < 2^-16 (the faithful
//     formula's cells next to |rho| = 1) the band's window is scanned.
//     Skipped offsets had w = 0 and the order of accumulation is unchanged,
//     so num and den keep their bits.
//  b. A block owns one scenario's tile of kTileRows rows by all columns and
//     first copies those rows plus the halo of the tile's band radius from
//     the prior into shared memory (cp.async, one contiguous run of the
//     map); every offset then reads shared memory.  A thread owns several
//     cells of the tile.  After step a the prior is read only at the offsets
//     inside the ellipse (1 to 17 per cell at the measured shapes), so this
//     step gives 3-8% for a shared prior and for per-scenario priors alike
//     (one H100, B = 8192 maps of 152x104), where it gave 10-13% on the
//     window scan.  The row loop is clipped to the tile's rows [r_lo, r_hi),
//     which are the rows of the map that the tile's band radius reaches, so
//     no read leaves the tile whatever the scan bounds are.
//  c. The per-cell covariance fields (sx, sy, rho, psd) are computed in the
//     kernel from a table of 12 floats per scenario (`cell_fields`), in the
//     order and rounding of costmap.sigma_rho_cells, so they are never
//     written to or read from device memory.  `kFused = false` reads given
//     fields instead (uncertainty_cuda.prep_fields): the same kernel body.
//     `cilqr_fields` writes the fields through `cell_fields` so that they
//     can be held to the PyTorch ones bit for bit.
// Band radii are data: each row carries its band's R and, per |dj|, the row
// half-extent m of its disc cut (-1: the column lies outside), so one kernel
// serves the single-map, the full-window batched and the banded forms.  The
// prior has a scenario stride of 0 (one shared map) or rows*cols.
// What is left above the bound: arithmetic, not bytes.  After step a nearly
// every visited offset lies inside the ellipse, and each costs the rounded
// test, the accurate expf and two rounded accumulations (~40 operations);
// a column costs its bounds and a row loop whose trip count differs between
// the lanes of a warp; a cell costs four IEEE divisions and three square
// roots (the fields and the reciprocals must keep the plain version's bits).
//
// Numerics: the inside test q <= thresh is discontinuous (a weight jumps
// from ~0.05 of its peak to 0), so the fields, q, thresh, 1/(2(1-rho^2)) and
// the sums are built with explicitly rounded operations: nvcc may not
// contract them into FMAs, and the kernel takes the same branch as the plain
// version.  expf is the accurate one (no fast-math).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTileRows = 8;
constexpr int kThreads = 256;
constexpr int kTableFloats = 12;
constexpr float kRangeMinDet = 1.0f / 65536.0f;
constexpr float kRangeSlack = 1e-3f;
constexpr float kCellMargin = 0.01f;  // cells added to a scan bound before it is floored

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct CellFields {
  float sx, sy, rho;
  bool psd;
};

// The per-cell arithmetic of costmap.sigma_rho_cells on the cell centre of
// gridmap.cell_positions.  t: one scenario's table
// [first_x, first_y, res, s, c, sc, ssmcc, a, b, dxy, st2, unused].
__device__ __forceinline__ CellFields cell_fields(const float* __restrict__ t, int i, int j,
                                                  bool faithful) {
  const float Cx = sub(t[0], mul(t[2], (float)i));
  const float Cy = sub(t[1], mul(t[2], (float)j));
  const float st2 = t[10];
  float g1, g2, tt;
  if (faithful) {
    const float s = t[3], c = t[4];
    g1 = sub(mul(-s, Cx), mul(c, Cy));
    g2 = sub(mul(c, Cx), mul(s, Cy));
    tt = add(mul(t[5], sub(mul(Cx, Cx), mul(Cy, Cy))), mul(mul(Cx, Cy), t[6]));
  } else {
    g1 = add(-Cy, mul(0.0f, Cx));  // the broadcast terms of the plain version
    g2 = add(Cx, mul(0.0f, Cy));
    tt = mul(g1, g2);
  }
  CellFields f;
  f.sx = __fsqrt_rn(add(t[7], mul(st2, mul(g1, g1))));
  f.sy = __fsqrt_rn(add(t[8], mul(st2, mul(g2, g2))));
  const float rho = __fdiv_rn(add(t[9], mul(st2, tt)), mul(f.sx, f.sy));
  f.psd = fabsf(rho) < 1.0f;
  f.rho = f.psd ? rho : 0.0f;
  return f;
}

__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

// A cell's half extent along one axis: min(cap, floor(reach cells_per_z + margin)).
__device__ __forceinline__ int half_extent(float reach, float cells_per_z, int cap) {
  return (int)fminf(floorf(add(mul(reach, cells_per_z), kCellMargin)), (float)cap);
}

struct PropArgs {
  int B, rows, cols, r_max, faithful;
  float res, inv_res, chi2;
  long long prior_stride;  // 0 or rows*cols
  const float* prior;      // [B or 1][rows][cols]
  const float* table;      // [B][12]            (kFused)
  const float* sx;         // [B][rows][cols]    (!kFused)
  const float* sy;
  const float* rho;
  const float* psd;
  const int* row_tab;      // [rows][r_max + 2]: R, then m for |dj| = 0..r_max
  const float* dy_tab;     // [r_max + 1]: |dj| * res, in double, rounded once
  float* out;              // [B][rows][cols]
};

template <bool kFused>
__global__ void __launch_bounds__(kThreads) propagate_kernel(PropArgs a) {
  extern __shared__ __align__(16) float tile[];
  const int rows = a.rows, cols = a.cols;
  const int n_tiles = (rows + kTileRows - 1) / kTileRows;
  const int b = blockIdx.x / n_tiles;
  const int i0 = (blockIdx.x - b * n_tiles) * kTileRows;
  const int n_row = min(kTileRows, rows - i0);
  const int tab_w = a.r_max + 2;
  const float* map_b = a.prior + (long long)b * a.prior_stride;

  // the rows [r_lo, r_hi) of the prior that the tile's cells can reach, staged
  int Rt = 0;
  for (int r = 0; r < n_row; ++r) Rt = max(Rt, a.row_tab[(i0 + r) * tab_w]);
  const int r_lo = max(0, i0 - Rt);
  const int r_hi = min(rows, i0 + n_row + Rt);
  {
    const int count = (r_hi - r_lo) * cols;
    const float* src = map_b + (long long)r_lo * cols;
    if ((((uintptr_t)src) & 15) == 0 && (count & 3) == 0) {
      for (int e = threadIdx.x * 4; e < count; e += kThreads * 4) cp_async_16(tile + e, src + e);
    } else {
      for (int e = threadIdx.x; e < count; e += kThreads) cp_async_4(tile + e, src + e);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  const long long map0 = (long long)b * rows * cols;
  for (int c = threadIdx.x; c < n_row * cols; c += kThreads) {
    const int il = c / cols;
    const int j = c - il * cols;
    const int i = i0 + il;
    const long long idx = map0 + (long long)i * cols + j;
    CellFields f;
    if (kFused) {
      f = cell_fields(a.table + (long long)b * kTableFloats, i, j, a.faithful != 0);
    } else {
      f.sx = a.sx[idx];
      f.sy = a.sy[idx];
      f.rho = a.rho[idx];
      f.psd = a.psd[idx] > 0.0f;
    }
    if (!f.psd) {
      a.out[idx] = tile[(i - r_lo) * cols + j];
      continue;
    }
    const float r = f.rho;
    const float inv_sx = __fdiv_rn(1.0f, f.sx);
    const float inv_sy = __fdiv_rn(1.0f, f.sy);
    const float two_rho = add(r, r);
    const float one_m_rho2 = sub(1.0f, mul(r, r));
    const float inv_det2 = __fdiv_rn(1.0f, mul(2.0f, one_m_rho2));
    const float thresh = mul(a.chi2, one_m_rho2);
    const int* tab = a.row_tab + i * tab_w;
    const int R = tab[0];
    // the box and the columns' row intervals, where 1 - rho^2 allows them
    const bool ranged = one_m_rho2 >= kRangeMinDet;
    const float rows_per_z = mul(f.sx, a.inv_res);  // a step of 1 in zx is this many rows
    int hj = R, hi = R;
    if (ranged) {
      // |zx|, |zy| <= sqrt(chi^2 + slack / (1 - rho^2)) inside the ellipse
      const float reach = __fsqrt_rn(add(a.chi2, mul(2.0f * kRangeSlack, inv_det2)));
      hj = half_extent(reach, mul(f.sy, a.inv_res), R);
      hi = half_extent(reach, rows_per_z, R);
    }
    const int dj_hi = min(hj, cols - 1 - j);
    float num = 0.0f, den = 0.0f;
    for (int djo = max(-hj, -j); djo <= dj_hi; ++djo) {
      int m = tab[1 + abs(djo)];
      if (m < 0) continue;  // the whole column lies outside the disc
      m = min(m, hi);
      // -(dj - R) * res in double, then rounded once (a Python float in the
      // Pallas body): dy_tab holds |dj| * res rounded so
      const float dy = djo > 0 ? -a.dy_tab[djo] : a.dy_tab[-djo];
      const float zy = mul(dy, inv_sy);
      const float t2 = mul(two_rho, zy);
      const float zy2 = mul(zy, zy);
      int lo = -m, up = m;
      if (ranged) {
        // rows of this column that can lie inside: (zx - rho zy)^2 <= h2
        const float h2 = add(mul(one_m_rho2, sub(a.chi2, zy2)), kRangeSlack);
        if (h2 < 0.0f) continue;
        // sqrt(h2) to ~3 ulps (one special-function operation): far inside the slack
        const float h = h2 > 0.0f ? mul(h2, rsqrtf(h2)) : 0.0f;
        const float cz = mul(r, zy);
        // di = -zx sx / res lies in [-(cz + h), h - cz] rows_per_z, each bound
        // widened by kCellMargin; min before max sends a NaN to the wide side
        const float m2 = (float)(m + 2);
        const float below = add(mul(add(cz, h), rows_per_z), kCellMargin);
        const float above = add(mul(sub(h, cz), rows_per_z), kCellMargin);
        lo = max(-__float2int_rd(fmaxf(fminf(below, m2), -m2)), -m);
        up = min(__float2int_rd(fmaxf(fminf(above, m2), -m2)), m);
      }
      // rows of the tile: the map's rows that this cell's band radius reaches
      // all lie in [r_lo, r_hi)
      const int t_lo = max(i + lo, r_lo) - r_lo, t_hi = min(i + up, r_hi - 1) - r_lo;
      int e = t_lo * cols + (j + djo);  // the offset's place in the tile
      // -di as a float, stepped exactly (small integers): no conversion per offset
      float neg_di = (float)(i - r_lo - t_lo);
      for (int t = t_lo; t <= t_hi; ++t, e += cols, neg_di = sub(neg_di, 1.0f)) {
        const float dx = mul(neg_di, a.res);
        const float zx = mul(dx, inv_sx);
        const float q = add(mul(sub(zx, t2), zx), zy2);
        if (q <= thresh) {
          const float w = expf(mul(-q, inv_det2));
          num = add(num, mul(w, tile[e]));
          den = add(den, w);
        }
      }
    }
    a.out[idx] =
        den > 0.0f ? fminf(fmaxf(__fdiv_rn(num, den), 0.0f), 100.0f) : tile[(i - r_lo) * cols + j];
  }
}

__global__ void fields_kernel(int B, int rows, int cols, int faithful,
                              const float* __restrict__ table, float* __restrict__ sx,
                              float* __restrict__ sy, float* __restrict__ rho,
                              float* __restrict__ psd) {
  const long long cells = (long long)rows * cols;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * cells) return;
  const long long b = idx / cells;
  const int cell = (int)(idx - b * cells);
  const int i = cell / cols;
  const CellFields f = cell_fields(table + b * kTableFloats, i, cell - i * cols, faithful != 0);
  sx[idx] = f.sx;
  sy[idx] = f.sy;
  rho[idx] = f.rho;
  psd[idx] = f.psd ? 1.0f : 0.0f;
}

template <bool kFused>
int launch_propagate(const PropArgs& a, cudaStream_t stream) {
  const long long blocks = (long long)a.B * ((a.rows + kTileRows - 1) / kTileRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the tile's rows plus the largest halo, all columns
  const size_t smem = sizeof(float) * (size_t)(kTileRows + 2 * a.r_max) * a.cols;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        propagate_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  propagate_kernel<kFused><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// fused != 0: the fields come from `table` ([B][12], see cell_fields) and
// sx..psd are not read; fused == 0: the fields are read and `table` is not.
extern "C" int cilqr_propagate(int B, int rows, int cols, int r_max, int fused, int faithful,
                               float res, float inv_res, float chi2,
                               const float* prior, long long prior_stride, const float* table,
                               const float* sx, const float* sy, const float* rho,
                               const float* psd, const int* row_tab, const float* dy_tab,
                               float* out, void* stream) {
  PropArgs a;
  a.B = B, a.rows = rows, a.cols = cols, a.r_max = r_max, a.faithful = faithful;
  a.res = res, a.inv_res = inv_res, a.chi2 = chi2;
  a.prior_stride = prior_stride, a.prior = prior, a.table = table;
  a.sx = sx, a.sy = sy, a.rho = rho, a.psd = psd, a.row_tab = row_tab, a.dy_tab = dy_tab, a.out = out;
  return fused ? launch_propagate<true>(a, (cudaStream_t)stream)
               : launch_propagate<false>(a, (cudaStream_t)stream);
}

// The four fields of every cell, written through cell_fields: (B, rows, cols)
// each, for the bit-for-bit check against the PyTorch fields.
extern "C" int cilqr_fields(int B, int rows, int cols, int faithful, const float* table,
                            float* sx, float* sy, float* rho, float* psd, void* stream) {
  const long long total = (long long)B * rows * cols;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fields_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      B, rows, cols, faithful, table, sx, sy, rho, psd);
  return (int)cudaGetLastError();
}
