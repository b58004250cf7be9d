"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``cilqr_tpu_torch/csrc/*.cu`` for Hopper (sm_90a),
one process per source, all started together, and links the objects into
one shared library with a plain C interface, which ``ctypes`` loads.
The library goes to ``build/cilqr_tpu_torch/libcilqr_kernels.so`` at the
repository root and is rebuilt when the hash of the sources changes.  Only
the sources in the package are used.  A failed build raises with nvcc's
output; nothing falls back.

``build_explog`` compiles the experiment log's host library
(``native/explog.cpp``) with the host compiler into the same directory.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cilqr_tpu_torch"
LIB_NAME = "libcilqr_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels cannot be built")
    return str(candidate)


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists.

    Returns the library path.  The compiler's resource report
    (``-Xptxas -v``) is kept beside it as ``build.log``.
    """
    digest = source_hash()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    nvcc = nvcc_path()
    tmp = BUILD_DIR / f"tmp.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    # one nvcc per source, all started together, then one link
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                               str(tmp / f"{src.stem}.o"), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src in sources()]
    log = "".join(proc.communicate()[0] for proc in procs)
    failed = any(proc.returncode for proc in procs)
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME),
                               *map(str, sorted(tmp.glob("*.o")))],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += link.stdout
        failed = link.returncode != 0
    (BUILD_DIR / "build.log").write_text(log)
    if not failed:
        os.replace(tmp / LIB_NAME, lib)
    shutil.rmtree(tmp)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{log}")
    stamp.write_text(digest)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process), with
    the argument and result types of every entry point declared."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cilqr_riccati.argtypes = [p] * 13 + [p]
    lib.cilqr_riccati.restype = i
    lib.cilqr_lm_opt.argtypes = [p] * 19 + [i, i] + [p]
    lib.cilqr_lm_opt.restype = i
    lib.cilqr_lm_iter.argtypes = [p] * 13 + [i] + [p]
    lib.cilqr_lm_iter.restype = i
    lib.cilqr_lm_lanes.argtypes = [p, i, p, p, p, p]
    lib.cilqr_lm_lanes.restype = i
    lib.cilqr_lm_step.argtypes = [p] * 18 + [i] + [p]
    lib.cilqr_lm_step.restype = i
    lib.cilqr_lm_sample.argtypes = [p] * 7
    lib.cilqr_lm_sample.restype = i
    lib.cilqr_lm_resources.argtypes = [i, i, i, p]
    lib.cilqr_lm_resources.restype = i
    f, d = ctypes.c_float, ctypes.c_double
    lib.cilqr_propagate.argtypes = ([i] * 6 + [f, f, f, p, ctypes.c_longlong] + [p] * 8
                                    + [p])
    lib.cilqr_propagate.restype = i
    lib.cilqr_fields.argtypes = [i] * 4 + [p] * 5 + [p]
    lib.cilqr_fields.restype = i
    lib.cilqr_sample_prior.argtypes = [i] * 6 + [p] * 6 + [i, p, i] + [p] * 5 + [p]
    lib.cilqr_sample_prior.restype = i
    lib.cilqr_costmap_layers.argtypes = [i] * 5 + [p] * 7 + [p]
    lib.cilqr_costmap_layers.restype = i
    lib.cilqr_cost_derivs.argtypes = [p] * 14 + [p]
    lib.cilqr_cost_derivs.restype = i
    lib.cilqr_cost_resources.argtypes = [i, i, i, p]
    lib.cilqr_cost_resources.restype = i
    lib.cilqr_cost_config_size.argtypes = []
    lib.cilqr_cost_config_size.restype = i
    lib.cilqr_frenet_lattice.argtypes = [p] * 20 + [p]
    lib.cilqr_frenet_lattice.restype = i
    lib.cilqr_frenet_resources.argtypes = [i] * 6 + [p]
    lib.cilqr_frenet_resources.restype = i
    lib.cilqr_frenet_config_size.argtypes = []
    lib.cilqr_frenet_config_size.restype = i
    lib.cilqr_opchain.argtypes = [i, i, ctypes.c_longlong, p, p, p]
    lib.cilqr_opchain.restype = i
    lib.cilqr_lm_continue.argtypes = [p, i, p, i, p, p]
    lib.cilqr_lm_continue.restype = i
    lib.cilqr_loop_graph.argtypes = [p, p, i, p, i, p, p, p]
    lib.cilqr_loop_graph.restype = i
    lib.cilqr_loop_launch.argtypes = [p, p]
    lib.cilqr_loop_launch.restype = i
    lib.cilqr_loop_destroy.argtypes = [p, p]
    lib.cilqr_loop_destroy.restype = None
    lib.cilqr_riccati_config_size.argtypes = []
    lib.cilqr_riccati_config_size.restype = i
    lib.cilqr_lm_config_size.argtypes = []
    lib.cilqr_lm_config_size.restype = i
    lib.cilqr_error_string.argtypes = [i]
    lib.cilqr_error_string.restype = ctypes.c_char_p
    return lib


EXPLOG_SOURCE = Path(__file__).resolve().parents[2] / "native" / "explog.cpp"
EXPLOG_LIB = "libexplog.so"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra"]  # native/Makefile's


def build_explog() -> Path:
    """Compile the experiment log's C ABI (``native/explog.cpp``, shared
    with the JAX package) with the host compiler and the flags of
    ``native/Makefile`` into ``BUILD_DIR``, unless a library of the current
    source exists.  Returns the library path; a failed build raises."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(EXPLOG_SOURCE.read_bytes())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / EXPLOG_LIB
    stamp = BUILD_DIR / "explog.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ / c++) on PATH; the experiment log cannot be built")
    # a private name, then an atomic rename: processes may build at once
    tmp = BUILD_DIR / f"{EXPLOG_LIB}.{os.getpid()}"
    out = subprocess.run([cxx, *CXX_FLAGS, "-shared", "-o", str(tmp), str(EXPLOG_SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {EXPLOG_SOURCE.name}:\n{out.stdout}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.cilqr_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
