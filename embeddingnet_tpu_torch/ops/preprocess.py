"""uint8 image batch -> compute-dtype batch divided by 255 (the port of
``_preprocess`` in ``embeddingnet_tpu/train/steps.py``, augmentation off).

The division is exact: ``float32(u8) / 255`` rounded once to the compute
dtype. The JAX package's bf16 path goes through a float16 multiply instead,
a TPU workaround that the port does not carry over; it differs from the
exact divide by one bf16 ulp on 31 of the 256 u8 values
(``tests/test_torch_port_train.py`` pins that).

For bf16 the division is :func:`normalize_u8`, which on a CUDA tensor
launches T2, ``csrc/normalize_u8_sm90.cu`` — the port of the Pallas kernel
``kern`` in ``tools/perf_probe3.py`` (via ``norm_pallas``):
``bf16(f32(u8) * (1/255))``, which equals the exact divide on every u8
value. On a CPU tensor it runs the plain version.

What bounds T2 on an H100: it reads each byte once and writes two bytes
(37.7 MB at [1024, 64, 64, 3]), so memory, 11.3 us at 3.35 TB/s. The
kernel moves 16 input bytes a thread in one load and 32 output bytes in
two stores; :func:`plan_normalize_u8` lays the launch out: the elements
before the first aligned vector (the head), the vectors, the tail, the
grid, and the scalar path an input that is not 8-byte aligned takes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from embeddingnet_tpu_torch.ops import _cuda

# Launches of T2 since the last reset_launch_counts(), counted where the
# wrapper launches.
LAUNCHES = {"normalize_u8": 0}

VECTOR = 16         # input bytes a thread loads at once (one uint4)
THREADS = 256       # the kernel's kThreads: threads a block
UNROLL = 4          # the kernel's kUnroll: vectors a thread has in flight
TILE = THREADS * UNROLL


class NormalizePlan(NamedTuple):
    """T2's launch over ``n`` elements: ``head`` elements one a thread,
    then ``vectors`` of 16, then ``tail`` one a thread, by ``grid`` blocks
    of THREADS. ``scalar``: the input is not 8-byte aligned, so every
    element goes one a thread (``head`` = n)."""
    head: int
    vectors: int
    tail: int
    grid: int
    scalar: bool


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _plain_normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """The plain version of T2: bf16(f32(x) * (1/255))."""
    return (x.float() * (1.0 / 255.0)).bfloat16()


@functools.lru_cache(maxsize=1024)
def plan_normalize_u8(n: int, in_addr_mod_16: int, sm_count: int,
                      blocks_per_sm: int = 2048 // THREADS) -> NormalizePlan:
    """T2's launch over ``n`` elements whose input starts ``in_addr_mod_16``
    bytes past a 16-byte boundary; the output is 16-byte aligned. The head
    runs up to the first aligned input vector; the output is then aligned
    too only where the head is a multiple of 8, so any input not 8-byte
    aligned takes the scalar path. The grid is one block a tile of TILE
    vectors (or of THREADS scalar elements), at most ``sm_count`` times
    ``blocks_per_sm``, the blocks the card holds at once."""
    r = in_addr_mod_16 % VECTOR
    scalar = r % 8 != 0
    if scalar:
        head, vectors, tail = n, 0, 0
        blocks = -(-n // THREADS)
    else:
        head = min((VECTOR - r) % VECTOR, n)
        vectors = (n - head) // VECTOR
        tail = n - head - VECTOR * vectors
        blocks = max(-(-vectors // TILE), -(-(head + tail) // THREADS))
    grid = max(1, min(blocks, sm_count * blocks_per_sm))
    return NormalizePlan(head, vectors, tail, grid, scalar)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int) -> int:
    blocks = ctypes.c_int(0)
    with _cuda.on_device(torch.device("cuda", index)):
        err = _entry("embn_normalize_u8_blocks_per_sm")(ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"normalize_u8: occupancy query failed, CUDA "
                           f"error {err}, {blocks.value} blocks an SM")
    return blocks.value


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return getattr(_cuda.library("normalize_u8_sm90"), name)


def normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 tensor (any shape, contiguous) -> bf16 ``x / 255``. A CUDA
    tensor launches T2; a CPU tensor runs the plain version. The launch
    path reads each property once and caches what does not change (the
    entry point, the card's SMs and resident blocks, the plan of a size):
    on a host that takes ~10 us to enqueue a PyTorch op, T2's host cost is
    as large as its device time."""
    device = x.device
    if device.type == "cpu":
        return _plain_normalize_u8(x)
    if x.dtype != torch.uint8 or not x.is_contiguous():
        raise ValueError(f"normalize_u8 takes a contiguous uint8 tensor, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=device)
    n = x.numel()
    if n == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError(f"normalize_u8: {n} elements exceed int32 offsets")
    src, index = x.data_ptr(), device.index
    plan = plan_normalize_u8(n, src % VECTOR, _cuda.sm_count(index),
                             _blocks_per_sm(index))
    with _cuda.on_device(device):
        err = _entry("embn_normalize_u8")(src, out.data_ptr(), n, plan.head,
                                          plan.grid, _cuda.stream(device))
    if err != 0:
        raise RuntimeError(f"normalize_u8: kernel launch failed, CUDA error "
                           f"{err}")
    LAUNCHES["normalize_u8"] += 1
    return out


def preprocess(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 (or float 0..255) BGR batch -> ``images / 255`` in ``dtype``,
    on the images' device: T2 for uint8 to bf16, else the f32 divide."""
    if images.dtype == torch.uint8 and dtype == torch.bfloat16:
        return normalize_u8(images.contiguous())
    return (images.float() / 255.0).to(dtype)
