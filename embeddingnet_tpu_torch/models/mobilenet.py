"""MobileNet v1 and v2 (port of ``embeddingnet_tpu/models/mobilenet.py``).

* :class:`MobileNetV2` (``mobilenetv2``): Sandler et al. 2018 inverted
  residuals on the port's
  :class:`~embeddingnet_tpu_torch.models.efficientnet.MBConv` (no SE,
  ReLU6, no drop-connect), returning the 1280-channel feature map;
* :class:`MobileNetV1` (``mobilenet``): a 3x3 stem and 13
  depthwise-separable blocks (Keras ``MobileNet``'s schedule), ReLU6,
  returning the 1024-channel map.

BatchNorm eps 1e-3, the JAX ``conv_init`` on every conv
(:func:`~embeddingnet_tpu_torch.models.efficientnet.init_fan_out_`), TF
``"SAME"`` padding, the Flax names (``stem_conv``, ``stage2_block1``,
``block3_dw``, ``block3_pw_bn``, ...). Neither draws random masks.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.models.efficientnet import (BN_EPS, MBConv,
                                                        SameConv2d)
from embeddingnet_tpu_torch.models import remat
from embeddingnet_tpu_torch.models.resnet import BatchNorm, Conv2d

# (expand_ratio, channels, repeats, stride)
_V2_BLOCKS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# (channels, stride) per depthwise-separable block
_V1_BLOCKS = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
)


def _norm(bn_momentum, dtype):
    return partial(BatchNorm, eps=BN_EPS, momentum=bn_momentum,
                   compute_dtype=dtype)


class MobileNetV2(nn.Module):
    """NCHW image batch -> [B, 1280 (or ch(1280) above width 1), H/32,
    W/32]."""

    stochastic = False
    remat_blocks = True

    def __init__(self, width_multiplier: float = 1.0,
                 bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()

        def ch(c):
            c = int(c * width_multiplier)
            return max(8, (c + 4) // 8 * 8)

        norm = _norm(bn_momentum, dtype)
        self.stem_conv = SameConv2d(3, ch(32), 3, 2, bias=False,
                                    compute_dtype=dtype)
        self.stem_bn = norm(ch(32))
        in_ch = ch(32)
        self.block_names = []
        for stage, (expand, c, repeats, stride) in enumerate(_V2_BLOCKS):
            out_ch = ch(c)
            for rep in range(repeats):
                name = f"stage{stage + 1}_block{rep + 1}"
                self.add_module(name, MBConv(
                    in_ch, out_ch, expand, 3, stride if rep == 0 else 1,
                    norm, se_ratio=0.0, activation=F.relu6, dtype=dtype))
                self.block_names.append(name)
                in_ch = out_ch
        self.out_channels = 1280 if width_multiplier <= 1.0 else ch(1280)
        self.head_conv = Conv2d(in_ch, self.out_channels, 1, bias=False,
                                compute_dtype=dtype)
        self.head_bn = norm(self.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = remat.run(getattr(self, name), x)
        return F.relu6(self.head_bn(self.head_conv(x)))


class MobileNetV1(nn.Module):
    """NCHW image batch -> [B, ch(1024), H/32, W/32]."""

    stochastic = False

    def __init__(self, width_multiplier: float = 1.0,
                 bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()

        def ch(c):
            return max(8, int(c * width_multiplier + 4) // 8 * 8)

        norm = _norm(bn_momentum, dtype)
        self.stem_conv = SameConv2d(3, ch(32), 3, 2, bias=False,
                                    compute_dtype=dtype)
        self.stem_bn = norm(ch(32))
        in_ch = ch(32)
        self.n_blocks = len(_V1_BLOCKS)
        for i, (c, stride) in enumerate(_V1_BLOCKS, start=1):
            self.add_module(f"block{i}_dw", SameConv2d(
                in_ch, in_ch, 3, stride, groups=in_ch, bias=False,
                compute_dtype=dtype))
            self.add_module(f"block{i}_dw_bn", norm(in_ch))
            self.add_module(f"block{i}_pw", Conv2d(
                in_ch, ch(c), 1, bias=False, compute_dtype=dtype))
            self.add_module(f"block{i}_pw_bn", norm(ch(c)))
            in_ch = ch(c)
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.stem_bn(self.stem_conv(x)))
        for i in range(1, self.n_blocks + 1):
            x = F.relu6(getattr(self, f"block{i}_dw_bn")(
                getattr(self, f"block{i}_dw")(x)))
            x = F.relu6(getattr(self, f"block{i}_pw_bn")(
                getattr(self, f"block{i}_pw")(x)))
        return x
