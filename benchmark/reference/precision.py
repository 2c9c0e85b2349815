"""Rounding to a narrower float type, for the controls: the plain reference
computed one precision below what a configuration states. The benchmark's
configurations compute in bfloat16, so the next step down is fp8, as an
fp8 training recipe runs it: the operands of every product (inputs and
weights) in e4m3 with a per-tensor scale, the gradients reaching a product's
output in e5m2, and the sums in float32.
"""

from __future__ import annotations

import torch


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).clamp(-top, top).to(dtype).float()
            / scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class Quant:
    """fp8 products: :meth:`operand` on each input and weight of a conv or
    dense layer, :meth:`output` on its result."""

    name = "fp8"

    @staticmethod
    def operand(x: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(x)

    @staticmethod
    def output(y: torch.Tensor) -> torch.Tensor:
        return _Output.apply(y)
