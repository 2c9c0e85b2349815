"""VGG-16/19, port of ``embeddingnet_tpu/models/vgg.py``: biased 3x3 SAME
convs with ReLU, each block closed by a 2x2 max pool (Keras'
``include_top=False``). Layer names ``block{b}_conv{c}``, as in Flax."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.models.resnet import Conv2d


class VGG(nn.Module):
    remat_blocks = False

    def __init__(self, blocks: Sequence[Tuple[int, int]],
                 dtype: Optional[torch.dtype] = None, in_channels: int = 3):
        super().__init__()
        self.layout = []
        channels = in_channels
        for b, (ch, n_convs) in enumerate(blocks, start=1):
            names = [f"block{b}_conv{c}" for c in range(1, n_convs + 1)]
            for name in names:
                self.add_module(name, Conv2d(channels, ch, 3, 1, 1,
                                             compute_dtype=dtype))
                channels = ch
            self.layout.append(names)
        self.out_channels = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for names in self.layout:
            for name in names:
                x = F.relu(getattr(self, name)(x))
            x = F.max_pool2d(x, 2, 2)
        return x


def vgg16(bn_momentum=None, **kw) -> VGG:
    del bn_momentum  # the registry passes it; VGG has no BatchNorm
    return VGG(((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)), **kw)


def vgg19(bn_momentum=None, **kw) -> VGG:
    del bn_momentum
    return VGG(((64, 2), (128, 2), (256, 4), (512, 4), (512, 4)), **kw)
