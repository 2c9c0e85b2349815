"""Backbones written as their Flax ``@nn.compact`` twins are: one
``graph`` function that makes each submodule where it is first used
(Xception, the Inceptions, NASNet).

Those JAX modules size each layer by the tensor that reaches it (a
separable conv's depthwise width, a counter-numbered ``conv{i}``), so a
second, hand-kept list of layers would have to repeat the whole graph. A
:class:`Compact` backbone runs ``graph`` once at construction on a
``meta`` tensor of the family's smallest input (shapes only, no compute):
each :meth:`~Compact.child` call registers its submodule under the Flax
name, in Flax's call order. Later calls of ``graph`` find the submodules
by name. The parameters then take torch's default initialisation on the
device in effect; the registry's ``_reset_backbone`` draws the JAX
initialisers over them.

The layer helpers follow Flax's semantics: ``"SAME"`` convs pad as TF does
(:class:`~embeddingnet_tpu_torch.models.efficientnet.SameConv2d`),
``"VALID"`` ones not at all, and :func:`max_pool_same` pads with -inf on
the high side first, as TF's ``"SAME"`` max pool does at stride 2 on an
even size (``F.max_pool2d``'s ``padding`` pads both sides).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.models.efficientnet import (SameConv2d,
                                                        same_padding)
from embeddingnet_tpu_torch.models.resnet import BatchNorm, Conv2d


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax ``max_pool(x, (k, k), (s, s), "SAME")``: TF's padding, the odd
    pixel on the high side, with -inf; then a VALID pool."""
    (top, bottom), (left, right) = (same_padding(n, k, s)
                                    for n in x.shape[2:])
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """Flax ``avg_pool(x, (3, 3), (1, 1), "SAME", count_include_pad=
    False)`` (Keras' ``AveragePooling2D(padding="same")``)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class Compact(nn.Module):
    """Base of a backbone whose submodules ``graph`` makes on first use.

    A subclass sets ``dtype``, ``bn_momentum`` and ``bn_epsilon``, defines
    ``graph(x)`` and calls :meth:`build` at the end of its ``__init__``;
    ``forward`` runs ``graph``."""

    remat_blocks = False

    def __init__(self, dtype: Optional[torch.dtype], bn_momentum: float,
                 bn_epsilon: float, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.bn_momentum = bn_momentum
        self.bn_epsilon = bn_epsilon
        self.in_channels = in_channels
        self._building = False

    def graph(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def build(self, size: int) -> None:
        """Make every submodule by one ``graph`` run on a meta input of
        ``size`` x ``size``, then give them memory on the default device
        and torch's default initialisation."""
        device = torch.empty(()).device
        self._building = True
        try:
            with torch.device("meta"), torch.no_grad():
                out = self.graph(torch.empty(1, self.in_channels, size, size))
        finally:
            self._building = False
        self.out_channels = out.shape[1]
        self.to_empty(device=device)
        self.train(self.training)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.graph(x)

    def child(self, name: str, make: Callable[[], nn.Module]) -> nn.Module:
        """The submodule ``name``, made by ``make`` while building (in
        eval mode there: the build runs no batch statistics)."""
        if self._building:
            self.add_module(name, make().eval())
        return self._modules[name]

    # -- Flax's layers -------------------------------------------------------

    def conv(self, y: torch.Tensor, name: str, filters: int,
             kernel: Sequence[int] = (1, 1), strides: Sequence[int] = (1, 1),
             padding: str = "SAME", groups: int = 1,
             use_bias: bool = False) -> torch.Tensor:
        """Flax ``nn.Conv`` with ``"SAME"`` or ``"VALID"`` padding."""
        def make():
            cls = SameConv2d if padding == "SAME" else Conv2d
            return cls(y.shape[1], filters, tuple(kernel), tuple(strides),
                       groups=groups, bias=use_bias, compute_dtype=self.dtype)
        return self.child(name, make)(y)

    def sep_conv(self, y: torch.Tensor, name: str, filters: int, k: int,
                 strides: Sequence[int] = (1, 1),
                 padding: str = "SAME") -> torch.Tensor:
        """Keras' ``SeparableConv2D(use_bias=False)`` as Flax builds it: a
        depthwise conv ``{name}_dw`` and a pointwise ``{name}_pw``."""
        y = self.conv(y, f"{name}_dw", y.shape[1], (k, k), strides, padding,
                      groups=y.shape[1])
        return self.conv(y, f"{name}_pw", filters)

    def bn(self, y: torch.Tensor, name: str,
           use_scale: bool = True) -> torch.Tensor:
        """Flax ``nn.BatchNorm`` with the backbone's momentum and epsilon."""
        return self.child(name, lambda: BatchNorm(
            y.shape[1], eps=self.bn_epsilon, momentum=self.bn_momentum,
            compute_dtype=self.dtype, use_scale=use_scale))(y)
