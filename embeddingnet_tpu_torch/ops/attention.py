"""The attention core of a ViT block on the card: ``softmax(q k^T /
sqrt(d)) v`` per head as the hand-written Hopper kernels of
``csrc/attention_sm90.cu``, one launch forward and one backward, for
:class:`~embeddingnet_tpu_torch.models.vit.MultiHeadDotProductAttention`.

q, k, v and the result are the projections' ``[B, N, heads * d]`` (Flax's
layout at the public function): the kernels address each head in place, so
no head is split out, scaled or merged by a copy. The scores are scaled in
f32 and never rounded before the softmax; P is rounded to the input's dtype
for the value product, as FlashAttention does. The forward keeps the row
logsumexp (f32 ``[B, heads, N]``) when autograd will need it; the backward
rebuilds P from it and sums every gradient in one fixed order (no atomics),
so a remat recompute gives the same bits.

Which version runs follows the input, with no knob:

* a CUDA tensor launches the kernels (``LAUNCHES["fwd"]``, ``["bwd"]``):
  in bf16 or fp16 the tensor-core kernels, with a head dimension that is a
  multiple of 16 up to 128; in float32 or float64 (the precisions the
  card-vs-CPU checks run a model in) their instances without tensor cores,
  every sum and the logsumexp in the input's precision, with a head
  dimension up to 128;
* a CPU or ``meta`` tensor, or a traced one (``torch.export``'s fake
  tensors, ``torch.compile``), runs :func:`plain_attention`, the eager code
  the Flax parity tests hold (``LAUNCHES["plain"]``);
* anything else on the card raises: another dtype, a head dimension the
  kernels do not take, a column stride other than 1, or, in bf16 and fp16,
  rows and batches whose strides or base are not 16-byte aligned.

:func:`plain_forward_lse` and :func:`plain_backward` are the kernels'
arithmetic in plain PyTorch (the logsumexp; P rebuilt from it, ``D =
rowsum(dO * O)``, ``dS = P * (dP - D)``): the tests hold them to autograd
of :func:`plain_attention` on the CPU, and the kernels' logsumexp and
gradients to them on the card.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from embeddingnet_tpu_torch.ops import _cuda

# Launches since the last reset_launch_counts(): the kernels' forward and
# backward, and calls of the plain version.
LAUNCHES = {"fwd": 0, "bwd": 0, "plain": 0}

# dtype codes (csrc/attention_sm90.cu kBF16, kF16, kF32, kF64): the first
# two read through tensor maps by the tensor-core kernels
_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2,
          torch.float64: 3}
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)
ALIGN = 8           # elements of 16 bits in the 16 bytes TMA aligns to
MAX_HEAD_DIM = 128


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- the plain version -------------------------------------------------------


def _split(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, heads * d] -> [B, heads, N, d]."""
    b, n, c = t.shape
    return t.view(b, n, heads, c // heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """[B, heads, N, d] -> [B, N, heads * d]."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Flax's ``MultiHeadDotProductAttention`` core on ``[B, N, heads * d]``
    inputs: q divided by ``sqrt(d)``, ``q @ k^T``, a softmax, ``@ v``, in
    the inputs' dtype."""
    head_dim = q.shape[-1] // heads
    q = _split(q, heads) / math.sqrt(head_dim)
    weights = torch.softmax(q @ _split(k, heads).transpose(-2, -1), dim=-1)
    return _merge(weights @ _split(v, heads))


def plain_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic: the output and the row logsumexp
    ``[B, heads, N]`` of the scaled scores, in the inputs' dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    s = (_split(q, heads) @ _split(k, heads).transpose(-2, -1)) * scale
    lse = torch.logsumexp(s, dim=-1)
    return _merge(torch.exp(s - lse[..., None]) @ _split(v, heads)), lse


def plain_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                   heads: int) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's arithmetic (FlashAttention-2's): P rebuilt
    from the logsumexp, ``dP = dO v^T``, ``D = rowsum(dO * O)``, ``dS = P *
    (dP - D)``; ``dq = dS k / sqrt(d)``, ``dk = dS^T q / sqrt(d)``, ``dv =
    P^T dO``."""
    scale = 1.0 / math.sqrt(q.shape[-1] // heads)
    qh, kh, vh = (_split(t, heads) for t in (q, k, v))
    oh, doh = _split(out, heads), _split(dout, heads)
    p = torch.exp((qh @ kh.transpose(-2, -1)) * scale - lse[..., None])
    dp = doh @ vh.transpose(-2, -1)
    ds = p * (dp - (doh * oh).sum(-1, keepdim=True))
    return (_merge(ds @ kh) * scale, _merge(ds.transpose(-2, -1) @ qh) * scale,
            _merge(p.transpose(-2, -1) @ doh))


# -- the kernels -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return getattr(_cuda.library("attention_sm90"), name)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _strides(t: torch.Tensor) -> Tuple[int, int]:
    """(row, batch) strides of a [B, N, C] tensor in elements, those of a
    dimension of size 1 as a contiguous tensor has them."""
    b, n, c = t.shape
    row = t.stride(1) if n > 1 else c
    return row, (t.stride(0) if b > 1 else n * row)


def _fits(t: torch.Tensor) -> bool:
    """Whether the kernels take ``t`` as it stands: unit column stride;
    in bf16 and fp16, for the tensor maps, a 16-byte aligned base, rows and
    batches."""
    if t.stride(2) != 1:
        return False
    if t.dtype not in TENSOR_CORE_DTYPES:
        return True
    row, batch = _strides(t)
    return t.data_ptr() % 16 == 0 and row % ALIGN == 0 and batch % ALIGN == 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           heads: int) -> int:
    """The head dimension, after checking what the kernels take."""
    if q.dtype not in _CODES:
        raise ValueError(f"attention: the kernels take bfloat16 or float16 "
                         f"(on tensor cores), float32 or float64 on the "
                         f"card, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"attention: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} does not match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if q.dim() != 3 or q.shape[-1] % heads:
        raise ValueError(f"attention: q {tuple(q.shape)} is not [B, N, "
                         f"{heads} heads * d]")
    b, n, c = q.shape
    head_dim = c // heads
    tensor_cores = q.dtype in TENSOR_CORE_DTYPES
    if (head_dim % 16 if tensor_cores else 0) or not (
            1 <= head_dim <= MAX_HEAD_DIM):
        raise ValueError(f"attention: head dimension {head_dim}; the kernels "
                         f"take multiples of 16 up to {MAX_HEAD_DIM} in "
                         f"bfloat16 and float16, 1 to {MAX_HEAD_DIM} in "
                         f"float32 and float64")
    # rows of a block: the tensor-core backward's tile, the others' warps
    rows = 64 if tensor_cores else 8
    if min(b, n) < 1 or 2 * -(-n // rows) * b * heads >= 2 ** 31:
        raise ValueError(f"attention: {b} x {n} tokens x {heads} heads; the "
                         f"kernels take 1 to 2^31 / 2 blocks")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _fits(t):
            raise ValueError(
                f"attention: {name} has strides {t.stride()} at "
                f"{t.data_ptr() % 16} bytes past 16: the kernels take a unit "
                f"column stride, and in bfloat16 and float16 16-byte aligned "
                f"rows and batches")
    return head_dim


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"attention: {name} launch failed, "
                           + ("arguments refused" if err < 0
                              else f"CUDA error {err}"))
    LAUNCHES[name] += 1


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
             head_dim: int, keep_lse: bool):
    b, n, c = q.shape
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    # f32 for bf16 and fp16, else the input's precision
    lse = (torch.empty((b, heads, n), device=q.device,
                       dtype=torch.promote_types(q.dtype, torch.float32))
           if keep_lse else None)
    with _cuda.on_device(q.device):
        _launched(_entry("embn_attention_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(lse), b, n, heads, head_dim, _CODES[q.dtype],
            *_strides(q), *_strides(k), *_strides(v),
            1.0 / math.sqrt(head_dim), _cuda.stream(q.device)), "fwd")
    return out, lse


def _backward(q, k, v, out, dout, lse, heads: int, head_dim: int):
    b, n, c = q.shape
    dq, dk, dv = (torch.empty((b, n, c), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    with _cuda.on_device(q.device):
        _launched(_entry("embn_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, n, heads, head_dim, _CODES[q.dtype],
            *_strides(q), *_strides(k),
            *_strides(v), *_strides(out), *_strides(dout),
            1.0 / math.sqrt(head_dim), _cuda.stream(q.device)), "bwd")
    return dq, dk, dv


class _AttentionFunction(torch.autograd.Function):
    """The kernels' forward, keeping q, k, v, the output and the logsumexp,
    and their backward. Under remat the recompute runs the forward kernel
    again and gives the same bits."""

    @staticmethod
    def forward(ctx, q, k, v, heads, head_dim):
        out, lse = _forward(q, k, v, heads, head_dim, keep_lse=True)
        ctx.heads, ctx.head_dim = heads, head_dim
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if not _fits(dout):             # e.g. the expanded gradient of a sum
            dout = dout.contiguous()
        dq, dk, dv = _backward(q, k, v, out, dout, lse, ctx.heads,
                               ctx.head_dim)
        return dq, dk, dv, None, None


def _plain(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the plain version: not on the card, or
    traced."""
    return (x.device.type != "cuda" or isinstance(x, FakeTensor)
            or torch.compiler.is_compiling())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` per head of ``[B, N, heads * d]``
    inputs, as ``[B, N, heads * d]``: :func:`plain_attention` where
    :func:`_plain`, else the kernels, which raise on what they cannot
    take."""
    if _plain(q):
        LAUNCHES["plain"] += 1
        return plain_attention(q, k, v, heads)
    head_dim = _check(q, k, v, heads)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _AttentionFunction.apply(q, k, v, heads, head_dim)
    return _forward(q, k, v, heads, head_dim, keep_lse=False)[0]
