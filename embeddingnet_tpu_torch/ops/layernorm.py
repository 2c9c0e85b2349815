"""LayerNorm over the last dimension on the card: the hand-written Hopper
kernels of ``csrc/layernorm_sm90.cu``, one launch forward and one backward
(with a small second launch that adds the blocks' partial parameter sums
in order), for :class:`~embeddingnet_tpu_torch.models.vit.LayerNorm`.

The arithmetic is Flax's ``nn.LayerNorm`` on a bf16 input with f32
parameters, as :func:`plain_layer_norm` computes it: the mean and the
two-pass variance in f32, ``rstd = rsqrt(var + eps)``, ``y = (x - mean) *
rstd * weight + bias`` in f32, rounded once to the input's dtype. The
kernels read each value of x once, in 16-byte accesses where the row
allows, and keep every sum in registers and warp shuffles; the forward
keeps mean and rstd (f32 ``[rows]``) only when autograd will need them.
The backward reads x, dy, mean, rstd and the weight and writes ``dx =
rstd * (g - mean(g) - x^ * mean(g * x^))`` with ``g = dy * weight``,
rounded once to x's dtype; each block adds ``dy * x^`` and ``dy`` over its
rows in a fixed order into partial sums, which the second launch adds in
order: no atomics, so two calls, and a remat recompute, give the same bits.

Which version runs follows the input, with no knob:

* a CUDA tensor launches the kernels (``LAUNCHES["fwd"]``, ``["bwd"]``):
  bf16 and fp16 with f32 sums, parameters and statistics; float32; float64
  (the precision the card-vs-CPU checks run a model in) with every sum in
  float64. Parameters of another dtype are converted to that precision
  first. :func:`plan_shape` and :func:`plan_layernorm` lay a launch out
  from D, the dtype, the rows' alignment and the card;
* a CPU or ``meta`` tensor, or a traced one (``torch.export``'s fake
  tensors, ``torch.compile``), runs :func:`plain_layer_norm`, the eager code
  the Flax parity tests hold (``LAUNCHES["plain"]``);
* anything else on the card raises: another dtype, a last dimension whose
  stride is not 1, leading dimensions that do not collapse into rows at
  one stride, no rows, or a row longer than the kernels hold.

:func:`plain_forward` and :func:`plain_backward` are the kernels' arithmetic
in plain PyTorch: the tests hold them to autograd of ``F.layer_norm`` on
the CPU, and the kernels to them on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from embeddingnet_tpu_torch.ops import _cuda

# Launches since the last reset_launch_counts(): the kernels' forward and
# backward, and calls of the plain version.
LAUNCHES = {"fwd": 0, "bwd": 0, "plain": 0}

THREADS = 256       # the kernels' kThreads: threads a block
WARP = 32
CHUNK_BYTES = 16    # kChunkBytes: one vector access
CHUNKS = (3, 4)     # kChunks3, kChunks4: the vector instances' chunks a lane
SCALAR_CHUNKS = 32  # kScalar: the scalar instances' values a lane
# the dtypes with vector instances; float32 and float64, which only the
# card-vs-CPU checks run, take the scalar ones
VECTOR_DTYPES = (torch.bfloat16, torch.float16)

# dtype codes (csrc/layernorm_sm90.cu kBF16, kF16, kF32, kF64)
_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2,
          torch.float64: 3}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- the plain version -------------------------------------------------------


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The precision of the sums: f32, or float64 for a float64 input."""
    return torch.promote_types(dtype, torch.float32)


def plain_layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor],
                     eps: float) -> torch.Tensor:
    """The eager LayerNorm over the last dimension: ``F.layer_norm`` on x in
    f32 (float64 stays float64), the result rounded once to x's dtype."""
    return F.layer_norm(x.to(_acc(x.dtype)), x.shape[-1:], weight, bias,
                        eps).to(x.dtype)


def plain_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic in the sums' precision: each row's
    mean and ``rstd = rsqrt(var + eps)`` with the two-pass variance, and
    ``y = (x - mean) * rstd * weight + bias`` rounded once to x's dtype;
    (y, mean, rstd), the statistics a value a row."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    mean = xf.mean(-1)
    var = (xf - mean[..., None]).square().mean(-1)
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean[..., None]) * rstd[..., None] * weight.to(acc)
         + bias.to(acc))
    return y.to(x.dtype), mean, rstd


def plain_backward(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, weight: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in the sums' precision: ``x^ = (x -
    mean) * rstd``, ``g = dy * weight``, ``dx = rstd * (g - mean(g) - x^ *
    mean(g * x^))`` in x's dtype; ``dweight``, ``dbias`` the sums of ``dy *
    x^`` and ``dy`` over the rows. ``mean`` and ``rstd`` hold a value a
    row, as x's leading dimensions or flat, as the kernel keeps them."""
    acc = _acc(x.dtype)
    mean, rstd = (t.reshape(x.shape[:-1] + (1,)) for t in (mean, rstd))
    xh = (x.to(acc) - mean) * rstd
    dyf = dy.to(acc)
    g = dyf * weight.to(acc)
    a = g.mean(-1, keepdim=True)
    b = (g * xh).mean(-1, keepdim=True)
    dx = (rstd * (g - a - xh * b)).to(x.dtype)
    d = x.shape[-1]
    return (dx, (dyf * xh).reshape(-1, d).sum(0),
            dyf.reshape(-1, d).sum(0))


# -- the launch plan ---------------------------------------------------------


class LayerNormPlan(NamedTuple):
    """A launch over ``rows`` rows of D values: ``vec`` values a 16-byte
    access (1 where the row is not 16-byte aligned), ``lanes`` lanes of a
    warp a row (a power of two), each holding up to ``chunks`` accesses
    (the kernel's instance); ``blocks`` blocks of THREADS, block ``i``
    walking rows ``[i * rows_per_block, (i + 1) * rows_per_block)``,
    ``THREADS // lanes`` at a time."""
    vec: int
    lanes: int
    chunks: int
    blocks: int
    rows_per_block: int


def plan_shape(d: int, dtype: torch.dtype,
               aligned: bool) -> Tuple[int, int, int]:
    """(vec, lanes, chunks) for rows of ``d`` values of ``dtype``: in bf16
    and fp16 16-byte accesses where ``aligned`` and d fills them, else one
    value an access; as many lanes as the accesses, up to a warp."""
    vec, sizes = CHUNK_BYTES // dtype.itemsize, CHUNKS
    if dtype not in VECTOR_DTYPES or not aligned or d % vec:
        vec, sizes = 1, (SCALAR_CHUNKS,)
    nc = d // vec
    lanes = min(WARP, 1 << (nc - 1).bit_length())
    for chunks in sizes:
        if lanes * chunks >= nc:
            return vec, lanes, chunks
    raise ValueError(f"layer_norm: rows of {d} {dtype} values; the kernels "
                     f"hold up to {WARP * sizes[-1] * vec} a row")


def plan_layernorm(rows: int, shape: Tuple[int, int, int], sm_count: int,
                   blocks_per_sm: int) -> LayerNormPlan:
    """The launch over ``rows`` of the instance ``shape`` (vec, lanes,
    chunks; :func:`plan_shape`): as many blocks as the card holds at once
    (``sm_count * blocks_per_sm``), each a contiguous share of the rows,
    none empty."""
    per_block = -(-rows // max(1, sm_count * blocks_per_sm))
    return LayerNormPlan(*shape, -(-rows // per_block), per_block)


# -- the kernels -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return getattr(_cuda.library("layernorm_sm90"), name)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, code: int, vec: int, lanes: int, chunks: int,
                   d: int, backward: bool) -> int:
    """The blocks of an instance that one SM of card ``index`` holds."""
    blocks = ctypes.c_int(0)
    with _cuda.on_device(torch.device("cuda", index)):
        err = _entry("embn_layernorm_blocks_per_sm")(
            code, vec, lanes, chunks, d, int(backward), ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"layer_norm: no block of the instance fits an "
                           f"SM (error {err})")
    return blocks.value


@functools.lru_cache(maxsize=1024)
def _plan(rows: int, d: int, dtype: torch.dtype, aligned: bool, index: int,
          backward: bool) -> LayerNormPlan:
    shape = plan_shape(d, dtype, aligned)
    return plan_layernorm(rows, shape, _cuda.sm_count(index), _blocks_per_sm(
        index, _CODES[dtype], *shape, d, backward))


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The stride between consecutive rows of ``t`` taken as ``[rows, D]``
    (D where it is contiguous or has one row), or None where its leading
    dimensions do not collapse into rows at one stride of at least D or the
    last one's stride is not 1."""
    d = t.shape[-1]
    if t.is_contiguous():
        return d
    if d > 1 and t.stride(-1) != 1:
        return None
    stride = span = None
    for size, step in reversed(list(zip(t.shape[:-1], t.stride()[:-1]))):
        if size == 1:
            continue
        if span is not None and step != span:
            return None
        stride = step if stride is None else stride
        span = step * size
    stride = d if stride is None else stride
    return stride if stride >= d else None


def _aligned(t: torch.Tensor, stride: int) -> bool:
    """Whether the rows of ``t`` start on 16-byte boundaries."""
    return (t.data_ptr() % CHUNK_BYTES == 0
            and stride * t.element_size() % CHUNK_BYTES == 0)


def _check(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> int:
    """x's row stride, after checking what the kernels take (a row too
    long for them raises in :func:`plan_shape`, before the launch)."""
    if x.dtype not in _CODES:
        raise ValueError(f"layer_norm: the kernels take bfloat16, float16, "
                         f"float32 or float64 on the card, got {x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"layer_norm: x {tuple(x.shape)} has no rows")
    d = x.shape[-1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p is None or p.shape != (d,) or p.device != x.device:
            raise ValueError(f"layer_norm: {name} must be [{d}] on "
                             f"{x.device}, got "
                             f"{None if p is None else tuple(p.shape)}")
    stride = _row_stride(x)
    if stride is None:
        raise ValueError(f"layer_norm: x {tuple(x.shape)} has strides "
                         f"{x.stride()}: the kernels take rows at one stride "
                         f"and a last dimension at stride 1")
    return stride


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"layer_norm: {name} launch failed, "
                           + ("arguments refused" if err < 0
                              else f"CUDA error {err}"))
    LAUNCHES[name] += 1


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, keep_stats: bool, stride: Optional[int] = None):
    """y, and the statistics ``[2, rows]`` (mean, then rstd) where
    ``keep_stats`` (else None); ``weight`` and ``bias`` in the sums'
    precision, contiguous; ``stride`` x's row stride where known."""
    d, device = x.shape[-1], x.device
    rows = x.numel() // d
    stride = _row_stride(x) if stride is None else stride
    plan = _plan(rows, d, x.dtype, _aligned(x, stride), device.index, False)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    stats = mean = rstd = 0
    if keep_stats:
        stats = torch.empty((2, rows), dtype=weight.dtype, device=device)
        mean = stats.data_ptr()
        rstd = mean + rows * stats.element_size()
    with _cuda.on_device(device):
        _launched(_entry("embn_layernorm_fwd")(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean, rstd, rows, stride, plan.rows_per_block, d,
            _CODES[x.dtype], plan.vec, plan.lanes, plan.chunks, plan.blocks,
            eps, _cuda.stream(device)), "fwd")
    return y, (stats if keep_stats else None)


def _backward(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor,
              weight: torch.Tensor, x_stride: Optional[int] = None):
    """dx, dweight and dbias (in the sums' precision) from the forward's
    statistics ``[2, rows]``; ``dy`` is copied where its rows are not at
    one stride (the expanded gradient of a sum)."""
    d, device = x.shape[-1], x.device
    rows = x.numel() // d
    x_stride = _row_stride(x) if x_stride is None else x_stride
    dy_stride = _row_stride(dy)
    if dy_stride is None:
        dy, dy_stride = dy.contiguous(), d
    aligned = _aligned(x, x_stride) and _aligned(dy, dy_stride)
    plan = _plan(rows, d, x.dtype, aligned, device.index, True)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    # the blocks' partial sums, then [dweight; dbias]
    sums = torch.empty((plan.blocks + 1, 2, d), dtype=weight.dtype,
                       device=device)
    mean = stats.data_ptr()
    with _cuda.on_device(device):
        _launched(_entry("embn_layernorm_bwd")(
            x.data_ptr(), dy.data_ptr(), mean,
            mean + rows * stats.element_size(), weight.data_ptr(),
            dx.data_ptr(), sums.data_ptr(),
            sums.data_ptr() + plan.blocks * 2 * d * sums.element_size(),
            rows, x_stride, dy_stride, plan.rows_per_block, d,
            _CODES[x.dtype], plan.vec, plan.lanes, plan.chunks, plan.blocks,
            _cuda.stream(device)), "bwd")
    dweight, dbias = sums[-1]
    return dx, dweight, dbias


class _LayerNormFunction(torch.autograd.Function):
    """The forward kernel, keeping x, the weight and the statistics, and
    the backward kernel. Under remat the recompute runs the forward kernel
    again and gives the same bits."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, stride):
        y, stats = _forward(x, weight, bias, eps, True, stride)
        ctx.stride = stride
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        return (*_backward(x, dy, stats, weight, ctx.stride), None, None)


def _plain(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the plain version: not on the card, or
    traced."""
    return (not x.is_cuda or isinstance(x, FakeTensor)
            or torch.compiler.is_compiling())


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of ``x`` over its last dimension with ``weight`` and
    ``bias`` ``[D]``, in x's dtype: :func:`plain_layer_norm` where
    :func:`_plain`, else the kernels, which raise on what they cannot
    take."""
    if _plain(x):
        LAUNCHES["plain"] += 1
        return plain_layer_norm(x, weight, bias, eps)
    stride = _check(x, weight, bias)
    acc = _acc(x.dtype)
    if weight.dtype != acc or not weight.is_contiguous():
        weight = weight.to(acc).contiguous()
    if bias.dtype != acc or not bias.is_contiguous():
        bias = bias.to(acc).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNormFunction.apply(x, weight, bias, eps, stride)
    return _forward(x, weight, bias, eps, False, stride)[0]
