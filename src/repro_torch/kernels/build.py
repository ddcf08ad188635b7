"""Build and load the port's CUDA kernels.

The sources under ``repro_torch/csrc`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, which
is loaded with :mod:`ctypes`: a build takes seconds, where an extension
that includes PyTorch's headers takes minutes. Each source is compiled to
an object by its own ``nvcc``, all started together, and the objects are
linked into one library. The library is built at first use into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the flags and of every source and
header under ``csrc`` (``*.cu``, ``*.cuh``), so an edited source or header
is rebuilt and an unchanged tree is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

from repro_torch.telemetry.clock import perf_seconds

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def sources() -> list:
    """The sources compiled, one object each: every ``*.cu`` under ``CSRC``."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """The library's path, named by a hash of the flags and of every source
    and header under ``CSRC`` (names and contents)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if this exact build is not there yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = perf_seconds()
    # build in a private directory, then rename the library: concurrent
    # builds never see (or load) a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        compiles = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            compiles.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )))
        logs = [proc.communicate()[1] for _, _, proc in compiles]
        for (cmd, _, proc), err in zip(compiles, logs):
            _check(proc.returncode, cmd, err)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *(obj for _, obj, _ in compiles)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check(proc.returncode, cmd, proc.stderr)
        os.replace(lib, out)
    BUILD_LOG["seconds"] = perf_seconds() - t0
    BUILD_LOG["ptxas"] = "".join(logs)
    return out


def _check(returncode: int, cmd, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{stderr}")


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lr_xus.argtypes = [
            i, i, p, p, p, p, p, ctypes.c_longlong, p, i, i, i, i, i, i, i, i, p,
        ]
        lib.lr_xus.restype = i
        lib.lr_capture_id.argtypes = [p]
        lib.lr_capture_id.restype = ctypes.c_ulonglong
        lib.lr_avt.argtypes = [i, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.lr_avt.restype = i
        lib.lr_atb.argtypes = [i, p, p, p, p, ctypes.c_longlong, p, i, i, i, i, i, i, p]
        lib.lr_atb.restype = i
        lib.lr_flash_attention.argtypes = [
            i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, i, p,
        ]
        lib.lr_flash_attention.restype = i
        lib.lr_error_string.argtypes = [i]
        lib.lr_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
