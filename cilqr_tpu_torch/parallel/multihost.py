"""Multi-process launch and data plumbing.

Port of ``cilqr_tpu/parallel/multihost.py`` on ``torch.distributed``.  One
process per card (or per host) runs the same program:

  * ``initialize()`` makes the process group (NCCL for CUDA, gloo for
    ``device="cpu"``; address, world size and rank from the arguments or
    torch's standard environment);
  * ``global_mesh()`` is this process's part of the global scenario mesh;
    the global mesh is these parts in rank order (process-major, as the JAX
    package's mesh over ``jax.devices()``);
  * ``put_global()`` / ``scatter_local()`` give this process's rows of the
    global batch as a ``batch.ProcessBlock``: process p owns the contiguous
    block [p*b, (p+1)*b).  Nothing crosses processes but the metric sums
    (``all_reduce`` in ``parallel.batch``).

A single process is the degenerate case of the same code path: no group,
rank 0, every row local.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from cilqr_tpu_torch.parallel.batch import ProcessBlock
from cilqr_tpu_torch.parallel.batch import process_rank as process_index
from cilqr_tpu_torch.utils.device import resolve


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> bool:
    """Make the process group; returns whether one was made.

    ``coordinator_address`` ("host:port") defaults to ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE``, ``process_id`` to
    ``RANK``.  A single process (no address, and one process or none named)
    is a no-op, as in the JAX package; name an address to make a one-rank
    group.  ``device`` is this process's device: CUDA (the default, the card
    ``cuda:LOCAL_RANK``) takes NCCL, ``"cpu"`` gloo."""
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    npr = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    pid = process_id if process_id is not None else _env_int("RANK")
    if npr in (None, 1) and addr is None:
        return False  # single process
    if addr is None:
        raise ValueError("initialize: name the coordinator address (or MASTER_ADDR/MASTER_PORT)")
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                            init_method=f"tcp://{addr}", world_size=npr or 1, rank=pid or 0)
    return True


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_device(device=None) -> torch.device:
    """This process's device: ``device`` if given, else its card
    ``cuda:LOCAL_RANK`` (``cuda:0`` without ``LOCAL_RANK``)."""
    if device is not None:
        return resolve(device)
    return torch.device("cuda", _env_int("LOCAL_RANK") or 0)


def global_mesh(shards_per_process: int = 1, device=None) -> list:
    """This process's part of the global scenario mesh: ``shards_per_process``
    entries of its device (``local_device``)."""
    return [local_device(device)] * shards_per_process


def put_global(global_array, device=None) -> ProcessBlock:
    """This process's contiguous block of a global batch that every process
    holds whole (the same draws from a shared seed): process p keeps rows
    [p*b, (p+1)*b), on ``device`` (where the array lies when unset)."""
    arr = torch.as_tensor(global_array)
    n, pid = process_count(), process_index()
    if arr.shape[0] % n:
        raise ValueError(f"global batch {arr.shape[0]} not divisible by process count {n}")
    b = arr.shape[0] // n
    local = arr[pid * b:(pid + 1) * b]
    return ProcessBlock(local if device is None else local.to(device), pid * b)


def scatter_local(local_batch, device=None) -> ProcessBlock:
    """A global batch assembled from each process's own rows: this process
    passes its (b, ...) block, every process the same b, and it stands at
    rows [p*b, (p+1)*b) of the global (b * processes, ...) batch."""
    local = torch.as_tensor(local_batch)
    if device is not None:
        local = local.to(device)
    return ProcessBlock(local, process_index() * local.shape[0])


def gather_metrics(metrics) -> dict:
    """Reduced metrics (the same on every process) -> host floats."""
    return {k: float(v) for k, v in metrics._asdict().items()}
