"""DenseNet-121/169/201, port of ``embeddingnet_tpu/models/densenet.py``.

Keras' structure: BatchNorm eps 1.001e-5, bias-free convs, pre-activation
layers (BN-ReLU-1x1 conv to 4g, BN-ReLU-3x3 conv to g) whose output is
concatenated after their input, transitions (BN, ReLU, 1x1 conv to C/2,
2x2 average pool) between the blocks, and a closing BN + ReLU. Names as in
Flax: ``stem_conv``, ``stage{i}_block{j}.bn0``/``conv1``/``bn1``/``conv2``,
``transition{i}_bn``/``_conv``, ``final_bn``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.models.resnet import BatchNorm, Conv2d


class DenseLayer(nn.Module):
    """BN-ReLU-Conv1x1(4g) -> BN-ReLU-Conv3x3(g), concatenated after the
    input."""

    def __init__(self, in_channels: int, growth: int, norm: Callable,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bn0 = norm(in_channels)
        self.conv1 = Conv2d(in_channels, 4 * growth, 1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = norm(4 * growth)
        self.conv2 = Conv2d(4 * growth, growth, 3, 1, 1, bias=False,
                            compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.bn0(x)))
        y = self.conv2(F.relu(self.bn1(y)))
        return torch.cat([x.to(y.dtype), y], 1)


class DenseNet(nn.Module):
    """The final feature map, after the closing BN + ReLU."""

    remat_blocks = False

    def __init__(self, block_sizes: Sequence[int], growth: int = 32,
                 bn_epsilon: float = 1.001e-5, bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 3):
        super().__init__()
        norm = partial(BatchNorm, eps=bn_epsilon, momentum=bn_momentum,
                       compute_dtype=dtype)
        self.stem_conv = Conv2d(in_channels, 64, 7, 2, 3, bias=False,
                                compute_dtype=dtype)
        self.stem_bn = norm(64)
        channels = 64
        self.layout = []
        for i, n_layers in enumerate(block_sizes, start=1):
            names = [f"stage{i}_block{j + 1}" for j in range(n_layers)]
            for name in names:
                self.add_module(name, DenseLayer(channels, growth, norm,
                                                 dtype))
                channels += growth
            transition = None
            if i < len(block_sizes):
                transition = (f"transition{i}_bn", f"transition{i}_conv")
                self.add_module(transition[0], norm(channels))
                self.add_module(transition[1], Conv2d(
                    channels, channels // 2, 1, bias=False,
                    compute_dtype=dtype))
                channels //= 2
            self.layout.append((names, transition))
        self.final_bn = norm(channels)
        self.out_channels = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for names, transition in self.layout:
            for name in names:
                x = getattr(self, name)(x)
            if transition is not None:
                bn, conv = (getattr(self, n) for n in transition)
                x = F.avg_pool2d(conv(F.relu(bn(x))), 2, 2)
        return F.relu(self.final_bn(x))


def densenet121(**kw) -> DenseNet:
    return DenseNet(block_sizes=(6, 12, 24, 16), **kw)


def densenet169(**kw) -> DenseNet:
    return DenseNet(block_sizes=(6, 12, 32, 32), **kw)


def densenet201(**kw) -> DenseNet:
    return DenseNet(block_sizes=(6, 12, 48, 32), **kw)
