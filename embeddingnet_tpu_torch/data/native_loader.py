"""ctypes bindings for the native C++ decode and resize library (port of
``embeddingnet_tpu/data/native_loader.py``).

``csrc/enloader.cpp`` decodes a whole batch in C++ threads (libjpeg,
libpng) and resizes with cv2's bilinear sampling straight into a uint8 BGR
batch buffer, without the GIL. It is built with ``g++`` at first use, never
at import, into ``embeddingnet_tpu_torch/_build/`` (beside the CUDA
builds), under a name that carries a hash of the source and the flags. The
build holds an ``fcntl`` lock on a file beside the library and compiles to
a temporary name that ``os.replace`` moves into place, so processes that
build at once (test workers, ranks) all load one complete library.

:func:`available` is False only when the compiler or the libjpeg/libpng
headers and libraries are missing, and logs the compiler's message once;
any other build failure raises. :func:`decode_batch` raises when the
library cannot be built: it never decodes with cv2 in its place.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "csrc" / "enloader.cpp"
BUILD_DIR = _PACKAGE / "_build"
# native/Makefile's flags
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared"]
LIBS = ["-ljpeg", "-lpng", "-lz", "-lpthread"]
# what the compiler or the linker says when a header or a library is absent
_MISSING = re.compile(r"(jpeglib|png|zlib)\.h: No such file|"
                      r"cannot find -l(jpeg|png|z|pthread)")

_lib: Optional[ctypes.CDLL] = None
_unavailable: Optional[str] = None
_lock = threading.Lock()


class Unavailable(RuntimeError):
    """The compiler or the image libraries' headers are missing."""


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    """Where the library is built, keyed by the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([_compiler(), *CXX_FLAGS, *LIBS]).encode())
    return BUILD_DIR / f"enloader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; return its path. Safe across
    processes: one builds under the lock, the others wait for it and find
    the library in place. Raises :class:`Unavailable` when the compiler or
    the headers are missing, ``RuntimeError`` on any other failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return path
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                   *LIBS]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except FileNotFoundError as e:
                raise Unavailable(f"{cmd[0]}: {e}") from e
            if proc.returncode:
                message = f"{' '.join(cmd)}\n{proc.stderr.strip()}"
                if _MISSING.search(proc.stderr):
                    raise Unavailable(message)
                raise RuntimeError(f"the native decoder failed to build "
                                   f"({proc.returncode}): {message}")
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built on first use (raises as :func:`build`)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                        ctypes.c_int, ctypes.c_int]
            lib.en_decode_batch.restype = ctypes.c_int
            lib.en_decode_batch.argtypes = argtypes
            lib.en_decode_batch_ex.restype = ctypes.c_int
            lib.en_decode_batch_ex.argtypes = argtypes + [ctypes.c_int]
            lib.en_version.restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads; False only when the compiler
    or the headers are missing (the compiler's message logged once)."""
    global _unavailable
    if _unavailable is not None:
        return False
    try:
        load()
    except Unavailable as e:
        _unavailable = str(e)
        log.warning("native decoder unavailable: %s", e)
        return False
    return True


def unavailable_reason() -> Optional[str]:
    """The compiler's message when :func:`available` found the toolchain
    missing, else None."""
    return _unavailable


def decode_batch(paths: Sequence[str], height: int, width: int,
                 n_threads: int = 8, out: Optional[np.ndarray] = None,
                 fast: bool = False) -> np.ndarray:
    """Decode and resize ``paths`` into a [N, H, W, 3] uint8 BGR array; a
    file that does not decode leaves its slot zero. ``out`` (C-contiguous
    [N, H, W, 3] uint8) is filled and returned when given.

    ``fast=True`` takes libjpeg's DCT-prescaled decode (M/8 scaling) for
    JPEGs before the same bilinear resize: faster on downscales of 2:1 and
    more, a few gray levels from the exact path. PNGs are always exact."""
    lib = load()
    n = len(paths)
    if out is None:
        out = np.zeros((n, height, width, 3), np.uint8)
    elif (out.shape != (n, height, width, 3) or out.dtype != np.uint8
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be C-contiguous uint8 "
                         f"{(n, height, width, 3)}, got {out.dtype} "
                         f"{out.shape}")
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib.en_decode_batch_ex(arr, n, ptr, height, width, n_threads,
                           1 if fast else 0)
    return out
