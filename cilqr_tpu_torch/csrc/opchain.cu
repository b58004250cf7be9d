// Op-throughput probe: chains of one elementwise body on register-resident
// float32 pairs.
//
// Replaces the TPU kernel of scripts/microbench_vpu.py (`_chain_kernel`, :57,
// launched by `_run_chain`, :74), which times chains of one VPU op on
// (128, 128) blocks held in vector registers.  Re-expressed for SIMT: each
// thread holds one rotation pair (a, b) in registers and runs `rounds`
// rounds of one body; timing two depths and taking the slope
// (utils/opbench.py) cancels the launch and the one read and write of the
// pair.  The Givens rotation keeps the values bounded and never reaches a
// fixed point.  `rounds` is a run-time argument, so the compiler cannot
// fold a chain.
//
// Bodies (per round, per thread):
//   0 mul     a *= 1.0000001
//   1 fma     a = a * 0.9999999 + 1e-7              (one FFMA)
//   2 rot     (a, b) = (a c - b s, a s + b c)       (2 FMUL + 2 FFMA)
//   3 sel     rot, then a = b > 0.01 r - 2.5 ? a : -a
//   4 exp     rot, then a += expf(b * 1e-3) * 1e-6  (the accurate expf that
//             the propagation kernel uses)
//   5 gather  rot, then a += shfl(b, lane (int)b & 31) * 1e-6: a
//             data-dependent lane, the SIMT analogue of the TPU's lane
//             take_along_axis
//   6 roll    rot, then a += shfl(b, (lane - amt) & 31) * 1e-6 with the
//             warp-uniform amount amt = (r + 1) & 31
//   7 tpose   rot, then a += (b transposed within the block's 16x16 tile,
//             through shared memory) * 1e-6
//
// What bounds it: operations, by design (8 bytes read and written per
// thread against thousands of instructions).  Blocks of 256 threads; the
// pair of thread t is (x[t], x[n + t]).
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;  // kTile * kTile == kThreads

__device__ __forceinline__ void rot(float& a, float& b, float c, float s) {
  const float na = a * c - b * s;
  const float nb = a * s + b * c;
  a = na;
  b = nb;
}

template <int BODY>
__global__ void opchain_kernel(int rounds, long long n, const float* __restrict__ x,
                               float* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  // n is a multiple of kThreads (checked by the wrapper), so whole blocks
  // and whole warps are live: the shuffles and barriers see every lane
  float a = x[t];
  float b = x[n + t];
  const float c = 0.7648421872844885f;  // cos(0.7)
  const float s = 0.644217687237691f;   // sin(0.7)
  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
#pragma unroll 32
  for (int r = 0; r < rounds; ++r) {
    if (BODY == 0) {
      a = a * 1.0000001f;
    } else if (BODY == 1) {
      a = fmaf(a, 0.9999999f, 1e-7f);
    } else {
      rot(a, b, c, s);
      if (BODY == 3) {
        a = b > (0.01f * (float)r - 2.5f) ? a : -a;
      } else if (BODY == 4) {
        a = a + expf(b * 1e-3f) * 1e-6f;
      } else if (BODY == 5) {
        const int src = (int)b & 31;
        a = a + __shfl_sync(0xffffffffu, b, src) * 1e-6f;
      } else if (BODY == 6) {
        const int amt = (r + 1) & 31;
        a = a + __shfl_sync(0xffffffffu, b, (lane - amt) & 31) * 1e-6f;
      } else if (BODY == 7) {
        tile[ty][tx] = b;
        __syncthreads();
        a = a + tile[tx][ty] * 1e-6f;
        __syncthreads();
      }
    }
  }
  out[t] = a;
  out[n + t] = b;
}

}  // namespace

extern "C" int cilqr_opchain(int body, int rounds, long long n, const float* x, float* out,
                             void* stream) {
  if (n <= 0 || n % kThreads != 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = n / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = (cudaStream_t)stream;
  switch (body) {
    case 0: opchain_kernel<0><<<grid, kThreads, 0, st>>>(rounds, n, x, out); break;
    case 1: opchain_kernel<1><<<grid, kThreads, 0, st>>>(rounds, n, x, out); break;
    case 2: opchain_kernel<2><<<grid, kThreads, 0, st>>>(rounds, n, x, out); break;
    case 3: opchain_kernel<3><<<grid, kThreads, 0, st>>>(rounds, n, x, out); break;
    case 4: opchain_kernel<4><<<grid, kThreads, 0, st>>>(rounds, n, x, out); break;
    case 5: opchain_kernel<5><<<grid, kThreads, 0, st>>>(rounds, n, x, out); break;
    case 6: opchain_kernel<6><<<grid, kThreads, 0, st>>>(rounds, n, x, out); break;
    case 7: opchain_kernel<7><<<grid, kThreads, 0, st>>>(rounds, n, x, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
