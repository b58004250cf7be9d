"""ctypes bindings for the native experiment log (``native/explog.cpp``) —
the framework's `rosbag record /experiment` equivalent
(vehiclepub/msg/Experiment.msg payload: start_time, start_pos[4],
planning_time, X[], U[]).

Port of ``cilqr_tpu/utils/explog.py`` on the same C ABI and file format: a
log written by either package reads back in the other.  The library is
built at first use by ``utils.build.build_explog`` into the port's build
directory (host compiler, the flags of ``native/Makefile``).  Records hold
float64 NumPy arrays; ``append`` takes tensors on any device or arrays.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from cilqr_tpu_torch.utils import build

    lib = ctypes.CDLL(str(build.build_explog()))
    lib.explog_open.restype = ctypes.c_void_p
    lib.explog_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    dp = ctypes.POINTER(ctypes.c_double)
    lib.explog_append.restype = ctypes.c_int
    lib.explog_append.argtypes = [
        ctypes.c_void_p, ctypes.c_double, dp, ctypes.c_double,
        dp, ctypes.c_uint32, dp, ctypes.c_uint32,
    ]
    lib.explog_flush.argtypes = [ctypes.c_void_p]
    lib.explog_count.restype = ctypes.c_int64
    lib.explog_count.argtypes = [ctypes.c_void_p]
    lib.explog_record_sizes.restype = ctypes.c_int
    lib.explog_record_sizes.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.explog_read.restype = ctypes.c_int
    lib.explog_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        dp, dp, dp, dp, ctypes.c_uint32, dp, ctypes.c_uint32,
    ]
    lib.explog_data_start.restype = ctypes.c_long
    lib.explog_data_start.argtypes = []
    lib.explog_frame_sizes.restype = ctypes.c_int
    lib.explog_frame_sizes.argtypes = [
        ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.explog_read_frame.restype = ctypes.c_int
    lib.explog_read_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
        dp, dp, dp, dp, ctypes.c_uint32, dp, ctypes.c_uint32,
    ]
    lib.explog_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class Record(NamedTuple):
    start_time: float
    start_pos: np.ndarray     # (4,)
    planning_time: float
    X: np.ndarray             # (N+1, 4)
    U: np.ndarray             # (N, 2)


def _as_dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a) -> np.ndarray:
    """A float64 C-contiguous host copy of a tensor (any device) or array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().double().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


class ExperimentLog:
    """Append-only CRC-framed experiment log."""

    MODES = {"w": 0, "r": 1, "a": 2}

    def __init__(self, path: str, mode: str = "w"):
        self._lib = _load()
        self._h = self._lib.explog_open(str(path).encode(), self.MODES[mode])
        if not self._h:
            raise OSError(f"explog_open failed for {path!r} mode={mode!r}")
        self.path = str(path)

    def append(self, start_time, start_pos, planning_time, X, U) -> None:
        start_pos = _f64(start_pos).reshape(4)
        X, U = _f64(X), _f64(U)
        rc = self._lib.explog_append(
            self._h, float(start_time), _as_dp(start_pos), float(planning_time),
            _as_dp(X), X.size, _as_dp(U), U.size,
        )
        if rc != 0:
            raise OSError(f"explog_append rc={rc}")

    def flush(self) -> None:
        self._lib.explog_flush(self._h)

    def __len__(self) -> int:
        self.flush()
        n = self._lib.explog_count(self._h)
        if n < 0:
            raise OSError("explog_count failed")
        return int(n)

    def read(self, i: int) -> Record:
        ns, nc = ctypes.c_uint32(), ctypes.c_uint32()
        rc = self._lib.explog_record_sizes(self._h, i, ctypes.byref(ns), ctypes.byref(nc))
        if rc != 0:
            raise IndexError(f"record {i} unavailable (rc={rc})")
        st, pt = ctypes.c_double(), ctypes.c_double()
        sp = np.empty(4, np.float64)
        X = np.empty(ns.value, np.float64)
        U = np.empty(nc.value, np.float64)
        rc = self._lib.explog_read(
            self._h, i, ctypes.byref(st), _as_dp(sp), ctypes.byref(pt),
            _as_dp(X), ns.value, _as_dp(U), nc.value,
        )
        if rc != 0:
            raise OSError(f"explog_read rc={rc}")
        return Record(st.value, sp, pt.value, X.reshape(-1, 4), U.reshape(nc.value // 2, 2))

    def __iter__(self) -> Iterator[Record]:
        """Sequential O(1)-per-record scan.  The offset cursor is owned by
        this Python iterator (not the handle), so nested or concurrent
        iterations over the same log are independent; stops at the first
        torn/corrupt frame like the indexed reader."""
        self.flush()
        off = ctypes.c_long(self._lib.explog_data_start())
        while True:
            ns, nc = ctypes.c_uint32(), ctypes.c_uint32()
            rc = self._lib.explog_frame_sizes(self._h, off.value, ctypes.byref(ns),
                                              ctypes.byref(nc))
            if rc != 0:
                return
            st, pt = ctypes.c_double(), ctypes.c_double()
            sp = np.empty(4, np.float64)
            X = np.empty(ns.value, np.float64)
            U = np.empty(nc.value, np.float64)
            rc = self._lib.explog_read_frame(
                self._h, off.value, ctypes.byref(off),
                ctypes.byref(st), _as_dp(sp), ctypes.byref(pt),
                _as_dp(X), ns.value, _as_dp(U), nc.value,
            )
            if rc != 0:
                return
            yield Record(st.value, sp, pt.value, X.reshape(-1, 4), U.reshape(nc.value // 2, 2))

    def close(self) -> None:
        if self._h:
            self._lib.explog_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_experiment_log(path: str) -> dict:
    """Bag-reader equivalent (``read_experiment_bag``, dataprocess.py:12-40):
    dict of stacked NumPy arrays."""
    with ExperimentLog(path, "r") as log:
        recs = list(log)
    return {
        "start_time": np.array([r.start_time for r in recs]),
        "start_pos": np.stack([r.start_pos for r in recs]) if recs else np.zeros((0, 4)),
        "planning_time": np.array([r.planning_time for r in recs]),
        "X": [r.X for r in recs],
        "U": [r.U for r in recs],
    }
