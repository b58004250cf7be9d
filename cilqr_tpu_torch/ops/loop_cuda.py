"""The LM loop's condition on the card, and the loop graph around a step graph.

The JAX package runs every LM loop as a ``jax.lax.while_loop``
(``cilqr_tpu/models/solver.py:167-204``, the unbatched loop;
``cilqr_tpu/models/solver_batched.py:75-106``, the batched one), whose
``cond`` XLA evaluates on the chip.  Here ``csrc/loop.cu`` computes it:
``lm_continue_kernel`` gives v = any(~done) & (steps < max_iterations) and
advances ``steps`` by v.  Every lane that has not stopped has run exactly
``steps`` iterations (a lane counts only the iterations it runs, and every
lane starts running), so v is the reference's ``any(~done & it <
max_iterations)``.  It is the port's own kernel, no TPU kernel's port.

``loop_graph`` builds, around a captured step graph, one CUDA graph that runs
``while v: step`` (a WHILE conditional node whose body is the step graph
and the condition again); ``utils/graphs.Loop`` holds it.  ``lm_continue``
is the condition alone: for a ``done`` on the CPU its plain version
(``lm_continue_plain``), on the card the kernel, outside any graph (the
check against the plain version).  A failed build, launch or instantiation
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import torch

from cilqr_tpu_torch.utils import build

LAUNCHES = 0  # runs of lm_continue_kernel: by ``lm_continue``, and counted after each loop graph


class LoopStats(NamedTuple):
    nodes: int            # nodes of the loop graph, the step graph's copy included
    instantiate_s: float  # cudaGraphInstantiate of the loop graph
    build_s: float        # the whole build (nodes, the step graph's copy, instantiation)


def lm_continue_plain(done: torch.Tensor, steps: torch.Tensor, max_iterations: int):
    """Plain version of the kernel: v = any(~done) & (steps < max_iterations)
    as int32 of ``steps``' shape (1,), and steps += v in place."""
    v = ((~done).any() & (steps < max_iterations)).to(torch.int32)
    steps.add_(v)
    return v


def _check(done: torch.Tensor, steps: torch.Tensor) -> None:
    if not (done.is_cuda and steps.device == done.device):
        raise ValueError(f"done on {done.device}, steps on {steps.device}: both on one card")
    if done.dtype != torch.bool or not done.is_contiguous() or not done.numel():
        raise ValueError(f"done: a contiguous non-empty bool tensor (the lanes' mask, () "
                         f"unbatched), got {done.dtype} {tuple(done.shape)}")
    if steps.dtype != torch.int32 or steps.shape != (1,):
        raise ValueError(f"steps: an int32 (1,) tensor, got {steps.dtype} {tuple(steps.shape)}")


def lm_continue(done: torch.Tensor, steps: torch.Tensor, max_iterations: int):
    """The condition once: v (int32, (1,)), steps advanced by v.  On the
    card one launch of ``lm_continue_kernel`` on the current stream."""
    global LAUNCHES
    if not done.is_cuda:
        return lm_continue_plain(done, steps, max_iterations)
    _check(done, steps)
    out = torch.empty(1, dtype=torch.int32, device=done.device)
    lib = build.load_library()
    with torch.cuda.device(done.device):  # the card of the tensors, whichever is current
        rc = lib.cilqr_lm_continue(done.data_ptr(), done.numel(), steps.data_ptr(), max_iterations,
                                   out.data_ptr(), torch.cuda.current_stream(done.device).cuda_stream)
    build.check(lib, rc, "lm_continue kernel launch")
    LAUNCHES += 1
    return out


def loop_graph(step_graph: int, done: torch.Tensor, steps: torch.Tensor,
               max_iterations: int) -> tuple:
    """The loop graph around ``step_graph`` (a ``cudaGraph_t``, as
    ``torch.cuda.CUDAGraph.raw_cuda_graph`` gives it) on ``done``'s card:
    ``steps`` reset to 0, the condition, then a WHILE node whose body is a
    copy of the step graph followed by the condition.  Returns (graph, exec,
    ``LoopStats``); ``destroy`` frees them.  A refused node or
    instantiation raises, naming what the card refused."""
    _check(done, steps)
    lib = build.load_library()
    graph, exec_ = ctypes.c_void_p(), ctypes.c_void_p()
    info = (ctypes.c_longlong * 4)()
    t0 = time.perf_counter()
    with torch.cuda.device(done.device):
        rc = lib.cilqr_loop_graph(step_graph, done.data_ptr(), done.numel(), steps.data_ptr(),
                                  max_iterations, ctypes.byref(graph), ctypes.byref(exec_), info)
    build_s = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"the loop graph was refused: CUDA error {rc} "
                           f"({lib.cilqr_error_string(rc).decode()}), instantiate result "
                           f"{info[2]}, refused node type {info[3]} (cudaGraphNodeType; -1: none)")
    return graph.value, exec_.value, LoopStats(int(info[0]), info[1] / 1e6, build_s)


def launch(exec_: int, device: torch.device) -> None:
    """One launch of a loop graph on ``device``'s current stream."""
    lib = build.load_library()
    with torch.cuda.device(device):
        rc = lib.cilqr_loop_launch(exec_, torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, rc, "loop graph launch")


def destroy(graph: int, exec_: int) -> None:
    build.load_library().cilqr_loop_destroy(graph, exec_)
