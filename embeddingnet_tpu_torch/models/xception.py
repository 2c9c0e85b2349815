"""Xception (Chollet 2017), port of ``embeddingnet_tpu/models/xception.py``.

The Keras structure as the JAX package builds it: bias-free convs,
BatchNorm with eps 1e-3, separable convs as a depthwise ``{name}_dw`` and a
pointwise ``{name}_pw`` conv, VALID entry convs, 1x1 stride-2 shortcuts,
and a 3x3 stride-2 max pool with TF's ``"SAME"`` padding (the odd pixel
high, -inf). Returns the final 2048-channel map. Written as the Flax
module is (:class:`~embeddingnet_tpu_torch.models.compact.Compact`), with
its layer names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from embeddingnet_tpu_torch.models.compact import Compact, max_pool_same

MIN_SIZE = 71


class Xception(Compact):
    def __init__(self, bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dtype, bn_momentum, bn_epsilon=1e-3)
        self.build(MIN_SIZE)

    def _sep(self, y, filters, name):
        return self.sep_conv(y, name, filters, 3)

    def _shortcut(self, y, filters, block):
        y = self.conv(y, f"block{block}_res_conv", filters, (1, 1), (2, 2))
        return self.bn(y, f"block{block}_res_bn")

    def graph(self, x: torch.Tensor) -> torch.Tensor:
        bn, sep = self.bn, self._sep
        pool = lambda y: max_pool_same(y, 3, 2)  # noqa: E731

        # entry flow
        x = self.conv(x, "block1_conv1", 32, (3, 3), (2, 2), "VALID")
        x = F.relu(bn(x, "block1_conv1_bn"))
        x = self.conv(x, "block1_conv2", 64, (3, 3), padding="VALID")
        x = F.relu(bn(x, "block1_conv2_bn"))

        # block2: no leading relu (Keras' first sepconv block)
        res = self._shortcut(x, 128, 2)
        x = bn(sep(x, 128, "block2_sepconv1"), "block2_sepconv1_bn")
        x = bn(sep(F.relu(x), 128, "block2_sepconv2"), "block2_sepconv2_bn")
        x = pool(x) + res

        for block, filters in ((3, 256), (4, 728)):
            res = self._shortcut(x, filters, block)
            y = bn(sep(F.relu(x), filters, f"block{block}_sepconv1"),
                   f"block{block}_sepconv1_bn")
            y = bn(sep(F.relu(y), filters, f"block{block}_sepconv2"),
                   f"block{block}_sepconv2_bn")
            x = pool(y) + res

        # middle flow: 8 identity-residual triple-sepconv blocks
        for block in range(5, 13):
            y = x
            for i in (1, 2, 3):
                y = bn(sep(F.relu(y), 728, f"block{block}_sepconv{i}"),
                       f"block{block}_sepconv{i}_bn")
            x = x + y

        # exit flow
        res = self._shortcut(x, 1024, 13)
        x = bn(sep(F.relu(x), 728, "block13_sepconv1"), "block13_sepconv1_bn")
        x = bn(sep(F.relu(x), 1024, "block13_sepconv2"),
               "block13_sepconv2_bn")
        x = pool(x) + res

        x = F.relu(bn(sep(x, 1536, "block14_sepconv1"), "block14_sepconv1_bn"))
        x = F.relu(bn(sep(x, 2048, "block14_sepconv2"), "block14_sepconv2_bn"))
        return x


def xception(**kw) -> Xception:
    return Xception(**kw)
