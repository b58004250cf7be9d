"""Checkpoint / resume for long-running Monte-Carlo campaigns.

Port of ``cilqr_tpu/utils/checkpoint.py``.  A campaign checkpoints its
whole state (accumulated metrics, counters) so a multi-hour run survives
preemption.  The file layout is the JAX package's: an ``.npz`` of
``leaf_0``, ``leaf_1``, ... arrays, so either package's checkpoint reads
back leaf for leaf in the other.  The port has no pytree library: it
flattens nests of ``NamedTuple``, tuple, list, dict (keys sorted, as
JAX does) and leaves (tensors, arrays, numbers) itself and records the
structure as a string under ``__structure__`` (JAX records its treedef
under ``__treedef__``; each package checks only its own key).
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any

import numpy as np
import torch

_STRUCTURE = "__structure__"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any) -> tuple:
    """(leaves in order, structure string)."""
    if _is_namedtuple(tree):
        parts = [_flatten(v) for v in tree]
        body = ", ".join(f"{f}={s}" for f, (_, s) in zip(tree._fields, parts))
        return [l for ls, _ in parts for l in ls], f"{type(tree).__name__}({body})"
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        body = ", ".join(s for _, s in parts)
        wrap = "({})" if isinstance(tree, tuple) else "[{}]"
        return [l for ls, _ in parts for l in ls], wrap.format(body)
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        body = ", ".join(f"{k!r}: {s}" for k, (_, s) in zip(keys, parts))
        return [l for ls, _ in parts for l in ls], "{" + body + "}"
    return [tree], "*"


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken from the iterator."""
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like_leaf(arr: np.ndarray, want):
    """The restored array as the kind of leaf ``want`` is: a tensor on
    ``want``'s device, else the array."""
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(arr).to(want.device)
    return arr


def save(path: str, tree: Any) -> None:
    """Atomic checkpoint write (a ``.tmp`` file, then ``os.replace``)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, structure = _flatten(tree)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{_STRUCTURE: np.frombuffer(structure.encode(), dtype=np.uint8)},
                 **{f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)})
    os.replace(tmp, path)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``; the saved structure (when the
    file records one), the leaf count and every leaf's shape and dtype are
    validated against ``like``.  Tensor leaves come back on the device of
    ``like``'s."""
    with np.load(path, allow_pickle=False) as z:
        leaves = [z[f"leaf_{i}"] for i in range(sum(1 for k in z.files if k.startswith("leaf_")))]
        saved = bytes(z[_STRUCTURE]).decode() if _STRUCTURE in z.files else None
    like_leaves, structure = _flatten(like)
    if saved is not None and saved != structure:
        raise ValueError(f"checkpoint structure mismatch:\n  saved: {saved}\n  expected: {structure}")
    if len(leaves) != len(like_leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, expected {len(like_leaves)}")
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        w = _to_numpy(want)
        if got.shape != w.shape:
            raise ValueError(f"leaf {i} shape mismatch: {got.shape} vs {w.shape}")
        if got.dtype != w.dtype:
            raise ValueError(f"leaf {i} dtype mismatch: {got.dtype} vs {w.dtype}")
    return _unflatten(like, iter(_like_leaf(g, w) for g, w in zip(leaves, like_leaves)))


def save_metadata(path: str, meta: dict) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(meta, indent=2, sort_keys=True))
    os.replace(tmp, p)


def load_metadata(path: str) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def latest_step(directory: str, prefix: str = "ckpt_") -> int | None:
    """Highest step with a complete checkpoint in ``directory`` or None."""
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = []
    for f in d.glob(f"{prefix}*.npz"):
        try:
            steps.append(int(f.stem[len(prefix):]))
        except ValueError:
            continue
    return max(steps) if steps else None
