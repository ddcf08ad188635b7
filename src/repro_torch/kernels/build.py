"""Build and load the port's CUDA kernels.

The sources under ``repro_torch/csrc`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, which
is loaded with :mod:`ctypes`: a build takes seconds, where an extension
that includes PyTorch's headers takes minutes. The library is built at
first use into ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("lowrank_matmul.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB: Optional[ctypes.CDLL] = None
#: what the last build printed (ptxas registers / shared memory per
#: kernel) and how long it took; empty when the library was already built
BUILD_LOG = {"seconds": 0.0, "ptxas": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"repro_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if this exact build is not there yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent builders never see
    # (or load) a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["ptxas"] = proc.stderr
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lr_xus_workspace.argtypes = [i, i, i, i]
        lib.lr_xus_workspace.restype = ctypes.c_longlong
        lib.lr_xus.argtypes = [i, i, p, p, p, p, p, i, i, i, i, p]
        lib.lr_xus.restype = i
        lib.lr_avt.argtypes = [i, p, p, p, i, i, i, i, p]
        lib.lr_avt.restype = i
        lib.lr_error_string.argtypes = [i]
        lib.lr_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
