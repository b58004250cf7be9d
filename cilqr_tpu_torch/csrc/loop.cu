// The LM loop's condition on the card, and the loop graph that runs it.
//
// The reference runs every LM loop as a `jax.lax.while_loop`
// (cilqr_tpu/models/solver.py:167-204, the unbatched loop;
// cilqr_tpu/models/solver_batched.py:75-106, the batched one), whose `cond`
// XLA evaluates on the chip: the host never sees it.  This is the port's
// counterpart.  It is no TPU kernel (no `pl.pallas_call` computes the
// condition), so it replaces none.
//
// lm_continue_kernel: v = any(!done[b]) && *steps < max_it, then
// *steps += v, and the graph's conditional handle set to v.  Every lane
// that has not stopped has run exactly *steps iterations (a lane advances
// its count only while it runs, and every lane starts running), so this is
// the reference's `any(~done & it < max_iterations)`.  One block: a strided
// pass over the lanes, a block-wide OR (__syncthreads_or), one thread writes.
// What bounds it: the launch; it reads B bytes (at most 32768) and writes
// one int.
//
// cilqr_loop_graph builds, around a captured step graph, the graph
//
//   reset (*steps = 0) -> lm_continue -> WHILE(h) { step graph -> lm_continue }
//
// so one launch runs `while cond: body` with no host read between the
// iterations.  The step graph enters as a child-graph node (a copy of its
// nodes, which read and write the memory the step graph was captured on).
#include <cuda_runtime.h>

#include <chrono>

namespace {

constexpr int kThreads = 256;

__global__ void lm_reset_kernel(int* steps) { *steps = 0; }

__global__ void lm_continue_kernel(const bool* __restrict__ done, int B, int* steps, int max_it,
                                   int* out, cudaGraphConditionalHandle handle) {
  int left = 0;
  for (int b = threadIdx.x; b < B; b += kThreads) left |= !done[b];
  const int any_left = __syncthreads_or(left);
  if (threadIdx.x == 0) {
    const int s = *steps;
    const unsigned int v = (any_left && s < max_it) ? 1u : 0u;
    *steps = s + (int)v;
    if (out) *out = (int)v;
    if (handle) cudaGraphSetConditional(handle, v);
  }
}

// A kernel node of one block of `threads` threads.
cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                       size_t n_deps, void* func, int threads, void** args) {
  cudaKernelNodeParams kp = {};
  kp.func = func;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(threads);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &kp);
}

}  // namespace

#define LOOP_TRY(expr)                    \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) {            \
      cudaGraphDestroy(graph);            \
      return (int)err_;                   \
    }                                     \
  } while (0)

// The condition alone, on the given stream, outside any graph: writes v to
// *out (the check against its plain version).
extern "C" int cilqr_lm_continue(const bool* done, int B, int* steps, int max_it, int* out,
                                 void* stream) {
  lm_continue_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(done, B, steps, max_it, out, 0);
  return (int)cudaGetLastError();
}

// The loop graph around `step` (a cudaGraph_t, left as it is), on the
// current device.  Writes the graph and its instantiation to *graph_out and
// *exec_out, and to info: [0] the nodes of the loop graph, the step graph's
// copy included; [1] the instantiation's microseconds; [2]
// cudaGraphInstantiateResult and [3] the cudaGraphNodeType of the node it
// refused (-1 if none).  Returns a cudaError_t; on an error nothing is kept.
extern "C" int cilqr_loop_graph(void* step, const bool* done, int B, int* steps, int max_it,
                                void** graph_out, void** exec_out, long long* info) {
  info[0] = info[1] = info[2] = 0;
  info[3] = -1;
  size_t step_nodes = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)step, nullptr, &step_nodes);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t graph = nullptr;
  err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return (int)err;

  cudaGraphConditionalHandle handle;
  LOOP_TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault));
  int* no_out = nullptr;
  void* reset_args[] = {&steps};
  void* cond_args[] = {(void*)&done, &B, &steps, &max_it, &no_out, &handle};
  cudaGraphNode_t reset, cond, loop, child, again;
  LOOP_TRY(add_kernel(&reset, graph, nullptr, 0, (void*)lm_reset_kernel, 1, reset_args));
  LOOP_TRY(add_kernel(&cond, graph, &reset, 1, (void*)lm_continue_kernel, kThreads, cond_args));

  cudaGraphNodeParams wp = {};
  wp.type = cudaGraphNodeTypeConditional;
  wp.conditional.handle = handle;
  wp.conditional.type = cudaGraphCondTypeWhile;
  wp.conditional.size = 1;
#if CUDART_VERSION >= 13000
  LOOP_TRY(cudaGraphAddNode(&loop, graph, &cond, nullptr, 1, &wp));
#else
  LOOP_TRY(cudaGraphAddNode(&loop, graph, &cond, 1, &wp));
#endif
  cudaGraph_t body = wp.conditional.phGraph_out[0];
  LOOP_TRY(cudaGraphAddChildGraphNode(&child, body, nullptr, 0, (cudaGraph_t)step));
  LOOP_TRY(add_kernel(&again, body, &child, 1, (void*)lm_continue_kernel, kThreads, cond_args));
  info[0] = (long long)step_nodes + 5;

  cudaGraphInstantiateParams ip = {};
  ip.flags = 0;
  const auto t0 = std::chrono::steady_clock::now();
  err = cudaGraphInstantiateWithParams((cudaGraphExec_t*)exec_out, graph, &ip);
  info[1] = std::chrono::duration_cast<std::chrono::microseconds>(
                std::chrono::steady_clock::now() - t0).count();
  info[2] = (long long)ip.result_out;
  if (ip.errNode_out) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(ip.errNode_out, &type) == cudaSuccess) info[3] = (long long)type;
  }
  if (err == cudaSuccess && ip.result_out != cudaGraphInstantiateSuccess)
    err = cudaErrorInvalidValue;
  LOOP_TRY(err);
  *graph_out = graph;
  return 0;
}

extern "C" int cilqr_loop_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" void cilqr_loop_destroy(void* graph, void* exec) {
  if (exec) cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) cudaGraphDestroy((cudaGraph_t)graph);
}
