"""InceptionV3 and Inception-ResNet-v2, port of
``embeddingnet_tpu/models/inception.py``.

Keras' structure as the JAX package builds it: bias-free convs, each with
a BatchNorm without scale (``use_scale=False``: a unit weight outside the
parameters) and eps 1e-3, then ReLU, numbered ``conv{i}``/``bn{i}`` in
construction order; 3x3 stride-1 average pools that leave the padding out
of the mean. Inception-ResNet-v2's residual blocks close with a biased 1x1
conv without BatchNorm and add it scaled by 0.17, 0.1 or 0.2; the last
``block8`` has scale 1 and no activation. Both return the final map (2048
and 1536 channels); inputs of 75 px and up. Written as the Flax modules
are (:class:`~embeddingnet_tpu_torch.models.compact.Compact`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from embeddingnet_tpu_torch.models.compact import Compact, avg_pool_same

MIN_SIZE = 75


def _cat(parts):
    return torch.cat(parts, 1)


class _Inception(Compact):
    """The numbered conv-BN(-ReLU) of both models."""

    def __init__(self, bn_momentum: float, dtype: Optional[torch.dtype]):
        super().__init__(dtype, bn_momentum, bn_epsilon=1e-3)
        self._counter = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._counter = 0
        return self.graph(x)

    def build(self, size: int) -> None:
        self._counter = 0
        super().build(size)

    def cb(self, y, filters, kh, kw, strides=(1, 1), padding="SAME",
           activation=True, use_bias=False):
        """conv2d_bn, numbered in construction order; a biased conv has no
        BatchNorm (Inception-ResNet-v2's block projections)."""
        self._counter += 1
        i = self._counter
        y = self.conv(y, f"conv{i}", filters, (kh, kw), strides, padding,
                      use_bias=use_bias)
        if not use_bias:
            y = self.bn(y, f"bn{i}", use_scale=False)
        return F.relu(y) if activation else y

    def stem(self, x):
        cb = self.cb
        x = cb(x, 32, 3, 3, strides=(2, 2), padding="VALID")
        x = cb(x, 32, 3, 3, padding="VALID")
        x = cb(x, 64, 3, 3)
        x = F.max_pool2d(x, 3, 2)
        x = cb(x, 80, 1, 1, padding="VALID")
        x = cb(x, 192, 3, 3, padding="VALID")
        return F.max_pool2d(x, 3, 2)


class InceptionV3(_Inception):
    def __init__(self, bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(bn_momentum, dtype)
        self.build(MIN_SIZE)

    def graph(self, x: torch.Tensor) -> torch.Tensor:
        cb = self.cb
        x = self.stem(x)

        # mixed 0-2 (35x35): pool-proj channels 32, 64, 64
        for pool_ch in (32, 64, 64):
            b1 = cb(x, 64, 1, 1)
            b5 = cb(cb(x, 48, 1, 1), 64, 5, 5)
            b3 = cb(cb(cb(x, 64, 1, 1), 96, 3, 3), 96, 3, 3)
            bp = cb(avg_pool_same(x), pool_ch, 1, 1)
            x = _cat([b1, b5, b3, bp])

        # mixed 3 (reduction -> 17x17)
        b3 = cb(x, 384, 3, 3, strides=(2, 2), padding="VALID")
        bd = cb(cb(x, 64, 1, 1), 96, 3, 3)
        bd = cb(bd, 96, 3, 3, strides=(2, 2), padding="VALID")
        bp = F.max_pool2d(x, 3, 2)
        x = _cat([b3, bd, bp])

        # mixed 4-7 (17x17): 7x7-factorised branches
        for mid in (128, 160, 160, 192):
            b1 = cb(x, 192, 1, 1)
            b7 = cb(cb(cb(x, mid, 1, 1), mid, 1, 7), 192, 7, 1)
            bd = cb(x, mid, 1, 1)
            bd = cb(bd, mid, 7, 1)
            bd = cb(bd, mid, 1, 7)
            bd = cb(bd, mid, 7, 1)
            bd = cb(bd, 192, 1, 7)
            bp = cb(avg_pool_same(x), 192, 1, 1)
            x = _cat([b1, b7, bd, bp])

        # mixed 8 (reduction -> 8x8)
        b3 = cb(cb(x, 192, 1, 1), 320, 3, 3, strides=(2, 2), padding="VALID")
        b7 = cb(cb(cb(x, 192, 1, 1), 192, 1, 7), 192, 7, 1)
        b7 = cb(b7, 192, 3, 3, strides=(2, 2), padding="VALID")
        bp = F.max_pool2d(x, 3, 2)
        x = _cat([b3, b7, bp])

        # mixed 9-10 (8x8): split 3x3 branches
        for _ in range(2):
            b1 = cb(x, 320, 1, 1)
            b3 = cb(x, 384, 1, 1)
            b3 = _cat([cb(b3, 384, 1, 3), cb(b3, 384, 3, 1)])
            bd = cb(cb(x, 448, 1, 1), 384, 3, 3)
            bd = _cat([cb(bd, 384, 1, 3), cb(bd, 384, 3, 1)])
            bp = cb(avg_pool_same(x), 192, 1, 1)
            x = _cat([b1, b3, bd, bp])
        return x


def inceptionv3(**kw) -> InceptionV3:
    return InceptionV3(**kw)


class InceptionResNetV2(_Inception):
    def __init__(self, bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(bn_momentum, dtype)
        self.build(MIN_SIZE)

    def _up(self, y, parts):
        return self.cb(_cat(parts), y.shape[1], 1, 1, activation=False,
                       use_bias=True)

    def block35(self, y, scale=0.17):
        cb = self.cb
        b0 = cb(y, 32, 1, 1)
        b1 = cb(cb(y, 32, 1, 1), 32, 3, 3)
        b2 = cb(cb(cb(y, 32, 1, 1), 48, 3, 3), 64, 3, 3)
        return F.relu(y + scale * self._up(y, [b0, b1, b2]))

    def block17(self, y, scale=0.1):
        cb = self.cb
        b0 = cb(y, 192, 1, 1)
        b1 = cb(cb(cb(y, 128, 1, 1), 160, 1, 7), 192, 7, 1)
        return F.relu(y + scale * self._up(y, [b0, b1]))

    def block8(self, y, scale=0.2, activation=True):
        cb = self.cb
        b0 = cb(y, 192, 1, 1)
        b1 = cb(cb(cb(y, 192, 1, 1), 224, 1, 3), 256, 3, 1)
        y = y + scale * self._up(y, [b0, b1])
        return F.relu(y) if activation else y

    def graph(self, x: torch.Tensor) -> torch.Tensor:
        cb = self.cb
        x = self.stem(x)

        # mixed_5b (Inception-A base)
        b0 = cb(x, 96, 1, 1)
        b1 = cb(cb(x, 48, 1, 1), 64, 5, 5)
        b2 = cb(cb(cb(x, 64, 1, 1), 96, 3, 3), 96, 3, 3)
        bp = cb(avg_pool_same(x), 64, 1, 1)
        x = _cat([b0, b1, b2, bp])

        for _ in range(10):
            x = self.block35(x)

        # mixed_6a (reduction)
        b0 = cb(x, 384, 3, 3, strides=(2, 2), padding="VALID")
        b1 = cb(cb(cb(x, 256, 1, 1), 256, 3, 3), 384, 3, 3,
                strides=(2, 2), padding="VALID")
        bp = F.max_pool2d(x, 3, 2)
        x = _cat([b0, b1, bp])

        for _ in range(20):
            x = self.block17(x)

        # mixed_7a (reduction)
        b0 = cb(cb(x, 256, 1, 1), 384, 3, 3, strides=(2, 2), padding="VALID")
        b1 = cb(cb(x, 256, 1, 1), 288, 3, 3, strides=(2, 2), padding="VALID")
        b2 = cb(cb(cb(x, 256, 1, 1), 288, 3, 3), 320, 3, 3,
                strides=(2, 2), padding="VALID")
        bp = F.max_pool2d(x, 3, 2)
        x = _cat([b0, b1, b2, bp])

        for _ in range(9):
            x = self.block8(x)
        x = self.block8(x, scale=1.0, activation=False)

        return cb(x, 1536, 1, 1)  # conv_7b


def inceptionresnetv2(**kw) -> InceptionResNetV2:
    return InceptionResNetV2(**kw)
