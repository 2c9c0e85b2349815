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

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _D = ctypes.c_longlong, ctypes.c_double
# Entry points of each source: name -> (argtypes); all return int (the
# launch's cudaGetLastError(), or a negative code the source documents).
# embn_conv3x3_sm90 (K1 forward and dgrad, K3, T1): x, w, scale, bias (both
# null but for K3 and T1), out, batch, s, cin, cout, mode (0 K1, 1 K1 as the
# dgrad, 2 K3, 3 T1), rows, ctas, stream. embn_conv3x3_wgrad_sm90 (K2, K4):
# x, g, scale, bias (both null but for K4), ws, out, batch, s, cin, cout,
# parts, per_part, stream. conv3x3_sm90.cu resolves cuTensorMapEncodeTiled
# through the runtime (cudaGetDriverEntryPoint), so no library beyond the
# runtime is linked. embn_normalize_u8 (T2): x, out, n, head, grid, stream;
# embn_normalize_u8_blocks_per_sm: a pointer to the int it fills.
# batchnorm_sm90.cu (ops/batchnorm.py): pointers, then rows, spatial and
# rows per block, then the ints of the channels, layout, plan, dtypes and
# flags, then eps, momentum and count, the stream last; the source says
# which are which. attention_sm90.cu (ops/attention.py): the tensors'
# pointers, batch, tokens, heads, head dimension and the dtype code, the
# (row, batch) strides of each input, the scale, the stream.
# layernorm_sm90.cu (ops/layernorm.py): the tensors' pointers, the rows,
# row strides and rows a block, then D, the dtype code and the plan's ints,
# eps (forward), the stream; embn_layernorm_blocks_per_sm: the instance's
# ints and a pointer to the int it fills.
ENTRY_POINTS = {
    "conv3x3_sm90": {"embn_conv3x3_sm90": [_P] * 5 + [_I] * 7 + [_P],
                     "embn_conv3x3_wgrad_sm90": [_P] * 6 + [_I] * 6 + [_P]},
    "normalize_u8_sm90": {"embn_normalize_u8": [_P] * 2 + [_I] * 3 + [_P],
                          "embn_normalize_u8_blocks_per_sm": [_P]},
    "batchnorm_sm90": {
        "embn_bn_stats": [_P] * 9 + [_L] * 3 + [_I] * 9 + [_D] * 3 + [_P],
        "embn_bn_apply": [_P] * 7 + [_L] * 3 + [_I] * 9 + [_D] + [_P],
        "embn_bn_bwd_reduce": [_P] * 9 + [_L] * 3 + [_I] * 10 + [_D] * 2
        + [_P],
        "embn_bn_bwd_dx": [_P] * 4 + [_L] * 3 + [_I] * 8 + [_P],
        "embn_bn_finalize": [_P] * 13 + [_I] * 4 + [_D] * 3 + [_P]},
    "attention_sm90": {
        "embn_attention_fwd": [_P] * 5 + [_I] * 5 + [_L] * 6 + [_D, _P],
        "embn_attention_bwd": [_P] * 9 + [_I] * 5 + [_L] * 10 + [_D, _P]},
    "layernorm_sm90": {
        "embn_layernorm_fwd": [_P] * 6 + [_L] * 3 + [_I] * 6 + [_D, _P],
        "embn_layernorm_bwd": [_P] * 8 + [_L] * 4 + [_I] * 6 + [_P],
        "embn_layernorm_blocks_per_sm": [_I] * 6 + [_P]},
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


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, for a launch:
    the raw handle, as PyTorch's own generated launchers read it, without
    the ``torch.cuda.Stream`` object that ``current_stream`` builds."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(device: torch.device):
    """Makes ``device`` current for a launch, where it is not already (a
    device switch costs a few microseconds of host time a launch)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
