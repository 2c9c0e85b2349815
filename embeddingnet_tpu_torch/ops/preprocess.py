"""uint8 image batch -> compute-dtype batch divided by 255 (the port of
``_preprocess`` in ``embeddingnet_tpu/train/steps.py``, augmentation off).

The division is exact: ``float32(u8) / 255`` rounded once to the compute
dtype. The JAX package's bf16 path goes through a float16 multiply instead,
a TPU workaround that the port does not carry over; it differs from the
exact divide by one bf16 ulp on 31 of the 256 u8 values
(``tests/test_torch_port_train.py`` pins that).

For bf16 the division is :func:`normalize_u8`, which on a CUDA tensor
launches a Triton kernel, T2 — the port of the Pallas kernel ``kern`` in
``tools/perf_probe3.py`` (via ``norm_pallas``): ``bf16(f32(u8) * (1/255))``,
which equals the exact divide on every u8 value. On a CPU tensor it runs
the plain version. ``triton`` is imported, and the kernel compiled, at the
first launch, never when this module is imported.

What bounds T2 on an H100: it reads each byte once and writes two bytes
(37.7 MB at [1024, 64, 64, 3]), so memory, 11.3 us at 3.35 TB/s; a flat
one-dimensional pass of 16-byte loads with no reuse, which is what a CUDA
kernel would do too.
"""

from __future__ import annotations

import torch

# Launches of T2 since the last reset_launch_counts(), counted where the
# wrapper launches.
LAUNCHES = {"normalize_u8": 0}

BLOCK = 4096        # elements per Triton program; the kernel's literal

triton = None       # bound at the first launch
tl = None
_kernel = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _normalize_u8_kernel(x_ptr, out_ptr, n):
    # T2's body, compiled by triton.jit at the first launch (``tl`` is this
    # module's global, bound then). 4096 is BLOCK.
    offs = tl.program_id(0) * 4096 + tl.arange(0, 4096)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0)
    y = x.to(tl.float32) * 0.00392156862745098
    tl.store(out_ptr + offs, y.to(tl.bfloat16), mask=mask)


def _plain_normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """The plain version of T2: bf16(f32(x) * (1/255))."""
    return (x.float() * (1.0 / 255.0)).bfloat16()


def _compiled():
    global triton, tl, _kernel
    if _kernel is None:
        import triton as triton_mod
        import triton.language as tl_mod
        triton, tl = triton_mod, tl_mod
        _kernel = triton.jit(_normalize_u8_kernel)
    return _kernel


def normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 tensor (any shape, contiguous) -> bf16 ``x / 255``. A CUDA
    tensor launches T2; a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return _plain_normalize_u8(x)
    if x.dtype != torch.uint8 or not x.is_contiguous():
        raise ValueError(f"normalize_u8 takes a contiguous uint8 tensor, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    if n >= 2 ** 31:
        raise ValueError(f"normalize_u8: {n} elements exceed int32 offsets")
    kernel = _compiled()
    with torch.cuda.device(x.device):
        kernel[(-(-n // BLOCK),)](x, out, n, num_warps=4)
    LAUNCHES["normalize_u8"] += 1
    return out


def preprocess(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 (or float 0..255) BGR batch -> ``images / 255`` in ``dtype``,
    on the images' device: T2 for uint8 to bf16, else the f32 divide."""
    if images.dtype == torch.uint8 and dtype == torch.bfloat16:
        return normalize_u8(images.contiguous())
    return (images.float() / 255.0).to(dtype)
