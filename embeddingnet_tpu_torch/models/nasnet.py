"""NASNet-A (Zoph et al. 2018), port of ``embeddingnet_tpu/models/
nasnet.py``: Keras' NASNetMobile and NASNetLarge as the JAX package
builds them.

A VALID stride-2 stem conv, two stem reduction cells, then ``num_blocks``
normal cells, a reduction cell, ``num_blocks`` normal cells, a reduction
cell and ``num_blocks`` normal cells; BatchNorm eps 1e-3; separable convs
as a depthwise ``{name}_dw`` and a pointwise ``{name}_pw`` conv. A strided
separable conv, and the reduction cells' 3x3 stride-2 pools, run VALID on
an input that Keras' ``correct_pad`` has zero-padded first, by the map's
parity (:func:`correct_pad`); so the max pool sees zeros there, and the
average pool counts them. ``adjust`` brings the previous cell's output to
the current one's size: at half the size by two 1x1 convs on the map
subsampled at stride 2 and on it shifted one pixel down-right (zero at the
far edge), concatenated. ``skip_reduction`` (NASNetLarge) hands the cell
before a reduction on as ``p``. Inputs of 32 px and up; returns the final
ReLU'd ``penultimate_filters``-channel map. Written as the Flax module is
(:class:`~embeddingnet_tpu_torch.models.compact.Compact`), with its names.

The module default momentum, 0.9997, is Keras'; the registry passes
``PERFORMANCE.bn_momentum`` (0.99 by default) as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from embeddingnet_tpu_torch.models.compact import Compact, avg_pool_same

MIN_SIZE = 32


def correct_pad(x: torch.Tensor, k: int) -> Tuple[int, int, int, int]:
    """Keras ``imagenet_utils.correct_pad`` as ``F.pad``'s (left, right,
    top, bottom): a stride-2 VALID window then covers the map as SAME
    would, one pixel less on the low side of an even axis."""
    adjust_h, adjust_w = 1 - x.shape[2] % 2, 1 - x.shape[3] % 2
    return (k // 2 - adjust_w, k // 2, k // 2 - adjust_h, k // 2)


class NASNet(Compact):
    def __init__(self, penultimate_filters: int = 1056, num_blocks: int = 4,
                 stem_block_filters: int = 32, skip_reduction: bool = False,
                 filter_multiplier: int = 2, bn_momentum: float = 0.9997,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dtype, bn_momentum, bn_epsilon=1e-3)
        self.penultimate_filters = penultimate_filters
        self.num_blocks = num_blocks
        self.stem_block_filters = stem_block_filters
        self.skip_reduction = skip_reduction
        self.filter_multiplier = filter_multiplier
        self.build(MIN_SIZE)

    def sep_block(self, ip, filters, k=3, strides=1, bid=""):
        """_separable_conv_block: 2x [relu - sepconv - BN], the first
        sepconv optionally strided behind correct_pad."""
        y = F.relu(ip)
        padding = "SAME"
        if strides == 2:
            y, padding = F.pad(y, correct_pad(y, k)), "VALID"
        y = self.sep_conv(y, f"separable_conv_1_{bid}", filters, k,
                          (strides, strides), padding)
        y = F.relu(self.bn(y, f"separable_conv_1_bn_{bid}"))
        y = self.sep_conv(y, f"separable_conv_2_{bid}", filters, k)
        return self.bn(y, f"separable_conv_2_bn_{bid}")

    def adjust(self, p, ip, filters, bid):
        """_adjust_block: the previous cell's output at the current
        input's size and width."""
        if p is None:
            return ip
        if p.shape[2] != ip.shape[2]:
            p = F.relu(p)
            p1 = self.conv(p[:, :, ::2, ::2], f"adjust_conv_1_{bid}",
                           filters // 2)
            # one pixel down-right (zero at the far edge), then stride 2:
            # Keras' zero-pad + crop + avgpool(1x1, 2) composite
            p2 = F.pad(p, (0, 1, 0, 1))[:, :, 1::2, 1::2]
            p2 = self.conv(p2, f"adjust_conv_2_{bid}", filters // 2)
            return self.bn(torch.cat([p1, p2], 1), f"adjust_bn_{bid}")
        if p.shape[1] != filters:
            p = self.conv(F.relu(p), f"adjust_conv_projection_{bid}",
                          filters)
            return self.bn(p, f"adjust_bn_{bid}")
        return p

    def normal_cell(self, ip, p, filters, bid):
        """_normal_a_cell: 5 two-operand blocks, 6-way concat."""
        sep = self.sep_block
        p = self.adjust(p, ip, filters, bid)
        h = self.bn(self.conv(F.relu(ip), f"normal_conv_1_{bid}", filters),
                    f"normal_bn_1_{bid}")
        x1 = (sep(h, filters, 5, bid=f"normal_left1_{bid}")
              + sep(p, filters, 3, bid=f"normal_right1_{bid}"))
        x2 = (sep(p, filters, 5, bid=f"normal_left2_{bid}")
              + sep(p, filters, 3, bid=f"normal_right2_{bid}"))
        x3 = avg_pool_same(h) + p
        x4 = avg_pool_same(p) + avg_pool_same(p)
        x5 = sep(h, filters, 3, bid=f"normal_left5_{bid}") + h
        return torch.cat([p, x1, x2, x3, x4, x5], 1), ip

    def reduction_cell(self, ip, p, filters, bid):
        """_reduction_a_cell: strided blocks, 4-way concat."""
        sep = self.sep_block
        p = self.adjust(p, ip, filters, bid)
        h = self.bn(self.conv(F.relu(ip), f"reduction_conv_1_{bid}",
                              filters), f"reduction_bn_1_{bid}")
        # Keras pools a ZeroPadding2D(correct_pad) output with VALID
        # windows: the max sees zeros, the mean counts them
        h3 = F.pad(h, correct_pad(h, 3))
        x1 = (sep(h, filters, 5, 2, bid=f"reduction_left1_{bid}")
              + sep(p, filters, 7, 2, bid=f"reduction_right1_{bid}"))
        x2 = (F.max_pool2d(h3, 3, 2)
              + sep(p, filters, 7, 2, bid=f"reduction_right2_{bid}"))
        x3 = (F.avg_pool2d(h3, 3, 2)
              + sep(p, filters, 5, 2, bid=f"reduction_right3_{bid}"))
        x4 = x2 + avg_pool_same(x1)
        x5 = (sep(x1, filters, 3, bid=f"reduction_left4_{bid}")
              + F.max_pool2d(h3, 3, 2))
        return torch.cat([x2, x3, x4, x5], 1), ip

    def graph(self, x: torch.Tensor) -> torch.Tensor:
        if min(x.shape[2], x.shape[3]) < MIN_SIZE:
            raise ValueError(
                f"nasnet needs input >= {MIN_SIZE}px (keras min_size), got "
                f"{x.shape[2]}x{x.shape[3]}")
        mult, n = self.filter_multiplier, self.num_blocks
        filters = self.penultimate_filters // 24
        x = self.conv(x, "stem_conv1", self.stem_block_filters, (3, 3),
                      (2, 2), "VALID")
        x = self.bn(x, "stem_bn1")

        p = None
        x, p = self.reduction_cell(x, p, filters // mult ** 2, "stem_1")
        x, p = self.reduction_cell(x, p, filters // mult, "stem_2")
        for i in range(n):
            x, p = self.normal_cell(x, p, filters, f"{i}")
        x, p0 = self.reduction_cell(x, p, filters * mult, f"reduce_{n}")
        p = p if self.skip_reduction else p0
        for i in range(n):
            x, p = self.normal_cell(x, p, filters * mult, f"{n + i + 1}")
        x, p0 = self.reduction_cell(x, p, filters * mult ** 2,
                                    f"reduce_{2 * n}")
        p = p if self.skip_reduction else p0
        for i in range(n):
            x, p = self.normal_cell(x, p, filters * mult ** 2,
                                    f"{2 * n + i + 1}")
        return F.relu(x)


def nasnetmobile(bn_momentum: float = 0.9997, **kw) -> NASNet:
    """NASNet-A (4 @ 1056), Keras' NASNetMobile."""
    return NASNet(penultimate_filters=1056, num_blocks=4,
                  stem_block_filters=32, skip_reduction=False,
                  bn_momentum=bn_momentum, **kw)


def nasnetlarge(bn_momentum: float = 0.9997, **kw) -> NASNet:
    """NASNet-A (6 @ 4032), Keras' NASNetLarge."""
    return NASNet(penultimate_filters=4032, num_blocks=6,
                  stem_block_filters=96, skip_reduction=True,
                  bn_momentum=bn_momentum, **kw)
