"""Build and bind the port's CUDA kernels.

Each source under ``embeddingnet_tpu_torch/csrc/`` is compiled with
``nvcc`` for ``sm_90a`` (Hopper) into a shared library with a plain C
interface, which ctypes loads. The build happens at first use, never at
import, into ``embeddingnet_tpu_torch/_build/`` (listed in ``.gitignore``);
one ``nvcc`` per source, all started together. Every library's name carries
a hash of all the sources, so an edit to any of them builds everything
anew. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# Entry points of each source: name -> (argtypes); all return int (the
# launch's cudaGetLastError()).
ENTRY_POINTS = {
    "fused_conv3x3": {"embn_conv3x3_small": [_P] * 5 + [_I] * 5 + [_P]},
    "conv3x3_wgrad": {"embn_conv3x3_wgrad": [_P] * 6 + [_I] * 6 + [_P]},
}
SOURCES = [CSRC / f"{name}.cu" for name in ENTRY_POINTS]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidates = [shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "toolkit is needed to build " + ", ".join(str(s) for s in SOURCES))


def _digest() -> str:
    h = hashlib.sha256()
    for source in SOURCES:
        h.update(source.name.encode())
        h.update(source.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: Path) -> Path:
    """Where the library of ``source`` is built, keyed by all sources."""
    return BUILD_DIR / f"{source.stem}_{_digest()}.so"


def build() -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    in parallel; return the libraries' paths. ``nvcc``'s report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    as ``.log``."""
    paths = [library_path(s) for s in SOURCES]
    todo = [(s, p) for s, p in zip(SOURCES, paths) if not p.exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source, path in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
        jobs.append((cmd, tmp, path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for cmd, tmp, path, proc in jobs:
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): "
                            f"{' '.join(cmd)}\n{report}")
            continue
        path.with_suffix(".log").write_text(report)
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            paths = dict(zip((s.stem for s in SOURCES), build()))
            lib = ctypes.CDLL(str(paths[name]))
            for fn_name, argtypes in ENTRY_POINTS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
