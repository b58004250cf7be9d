"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``cilqr_tpu_torch/csrc/*.cu`` for Hopper (sm_90a),
one process per source, all started together, and links the objects into
one shared library with a plain C interface, which ``ctypes`` loads.
The library goes to ``build/cilqr_tpu_torch/libcilqr_kernels.so`` at the
repository root and is rebuilt when the hash of the sources changes.  Only
the sources in the package are used.  A failed build raises with nvcc's
output; nothing falls back.
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
    lib.cilqr_lm_opt.argtypes = [p] * 17 + [p]
    lib.cilqr_lm_opt.restype = i
    lib.cilqr_lm_iter.argtypes = [p] * 13 + [p]
    lib.cilqr_lm_iter.restype = i
    f, d = ctypes.c_float, ctypes.c_double
    lib.cilqr_propagate.argtypes = [i, i, i, f, d, f, p, ctypes.c_longlong] + [p] * 7 + [p]
    lib.cilqr_propagate.restype = i
    lib.cilqr_riccati_config_size.argtypes = []
    lib.cilqr_riccati_config_size.restype = i
    lib.cilqr_lm_config_size.argtypes = []
    lib.cilqr_lm_config_size.restype = i
    lib.cilqr_error_string.argtypes = [i]
    lib.cilqr_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.cilqr_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
