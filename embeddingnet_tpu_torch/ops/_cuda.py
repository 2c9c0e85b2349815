"""Build and bind the port's CUDA kernels.

The sources under ``embeddingnet_tpu_torch/csrc/`` are compiled with
``nvcc`` for ``sm_90a`` (Hopper) into a shared library with a plain C
interface, which ctypes loads. The build happens at first use, never at
import, into ``embeddingnet_tpu_torch/_build/`` (listed in ``.gitignore``),
keyed by a hash of the source, so an edited source builds anew. A failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "csrc" / "fused_conv3x3.cu"
BUILD_DIR = _PACKAGE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidates = [shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "toolkit is needed to build " + str(SOURCE))


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"fused_conv3x3_{digest}.so"


def build() -> Path:
    """Compile the kernels unless a library of this source exists; return
    its path. ``nvcc``'s report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside it as ``.log``."""
    path = library_path()
    if path.exists():
        return path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.embn_conv3x3_small
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
