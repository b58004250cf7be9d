"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``cilqr_tpu_torch/csrc/*.cu`` for Hopper (sm_90a)
into one shared library with a plain C interface, which ``ctypes`` loads.
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *[str(s) for s in sources()]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
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
