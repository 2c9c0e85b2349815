"""ResNet family (18/34/50/101/152), port of
``embeddingnet_tpu/models/resnet.py``.

He et al. v1 post-activation; ``stride_in_3x3`` places a bottleneck stage's
downsampling stride on the 3x3 conv (torchvision "v1.5", the default) or on
the first 1x1. The backbone returns the final feature map; the embedding
head lives in :mod:`embeddingnet_tpu_torch.models.registry`.

Submodules carry the Flax names (``stem_conv``, ``stage3_block2.conv2``, ...),
so :func:`~embeddingnet_tpu_torch.models.convert.flax_to_torch` maps a JAX
checkpoint name for name. Tensors are NCHW in ``torch.channels_last``
memory. ``fast_conv`` (``PERFORMANCE.pallas_conv``) routes the stride-1 3x3
convs through :mod:`embeddingnet_tpu_torch.ops.fused_conv`, and a
``bn -> relu -> 3x3 conv`` chain through the fused BN-ReLU conv; the
parameters are the same either way. A grouped 3x3 conv (ResNeXt, SENet-154)
is never fused and :class:`FastConv3x3` sends it to ``F.conv2d``, as JAX's
falls back to ``lax``.

The squeeze-excitation variants (``seresnet*``, ``seresnext*``) put an
:class:`SEModule` after the last BatchNorm of each block; ResNeXt widens the
grouped bottleneck (``groups * width_per_group * 2^i``) and narrows its
expansion; SENet-154 (:class:`SENet154`) has a three-conv stem and blocks
whose downsample is a 3x3 conv.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.models import remat
from embeddingnet_tpu_torch.models.heads import Dense, lecun_normal_
from embeddingnet_tpu_torch.ops import batchnorm
from embeddingnet_tpu_torch.ops.fused_conv import (BNScaleBias, FastConv3x3,
                                                    FusedBNReluConv3x3, cast)
from embeddingnet_tpu_torch.utils import trace


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (Flax ``nn.Conv``'s
    ``dtype``: input and weight cast at use, parameters f32)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or torch.promote_types(x.dtype,
                                                          self.weight.dtype)
        return self._conv_forward(*cast(dtype, x, self.weight, self.bias))


class BatchNorm(BNScaleBias):
    """Flax ``nn.BatchNorm`` over NCHW: the affine of :class:`BNScaleBias`
    applied in f32, the result in ``compute_dtype`` (f32 when None; a
    float64 input stays float64); on the card the kernels of
    :mod:`~embeddingnet_tpu_torch.ops.batchnorm`. ``use_scale=False``
    (Flax's, the Inceptions') keeps a unit ``weight`` that is a buffer
    outside the ``state_dict``, so the parameters are Flax's leaves."""

    def __init__(self, num_features: int, eps: float, momentum: float,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_scale: bool = True):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.compute_dtype = compute_dtype
        if not use_scale:
            del self.weight
            self.register_buffer("weight", torch.ones(num_features),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("bn"):
            return batchnorm.batch_norm(self, x, self.compute_dtype)


def _conv3x3(in_channels, filters, strides, groups, use_bias, dtype, fast):
    """3x3 conv factory: :class:`FastConv3x3` when ``fast`` and bias-free,
    else a plain conv. Both hold the same ``weight``, so the flag never
    changes checkpoints."""
    if fast and not use_bias:
        return FastConv3x3(in_channels, filters, strides=strides,
                           groups=groups, compute_dtype=dtype)
    return Conv2d(in_channels, filters, 3, tuple(strides), 1, bias=use_bias,
                  groups=groups, compute_dtype=dtype)


def _can_fuse_bn_conv(fast, use_bias, groups, strides) -> bool:
    """Whether a ``bn -> relu -> 3x3 conv`` chain becomes the fused
    :class:`BNScaleBias` + :class:`FusedBNReluConv3x3` pair: ``fast`` on,
    the conv bias-free, ungrouped and stride 1."""
    return (bool(fast) and not use_bias and groups == 1
            and tuple(strides) == (1, 1))


def _relu_conv_chain(block, y):
    """``conv2(relu(bn1(y)))``, fused when the block built the pair (which
    sits under the same names, so the state_dict is the unfused one)."""
    if isinstance(block.conv2, FusedBNReluConv3x3):
        scale, bias = block.bn1(y)
        return block.conv2(y, scale, bias)
    return block.conv2(F.relu(block.bn1(y)))


def _bn1_conv2(in_channels, filters, strides, groups, norm, use_bias, dtype,
               fast):
    """``(bn1, conv2)`` of a block: the fused pair where
    :func:`_can_fuse_bn_conv` holds, else BatchNorm and the 3x3 factory."""
    if _can_fuse_bn_conv(fast, use_bias, groups, strides):
        return (BNScaleBias(in_channels, eps=norm.keywords["eps"],
                            momentum=norm.keywords["momentum"]),
                FusedBNReluConv3x3(in_channels, filters, compute_dtype=dtype))
    return (norm(in_channels),
            _conv3x3(in_channels, filters, strides, groups, use_bias, dtype,
                     fast))


class SEModule(nn.Module):
    """Squeeze-excitation (Hu et al.): the spatial mean, Dense ``fc1`` to
    ``max(channels // reduction, 1)``, ReLU, Dense ``fc2``, and a sigmoid
    gate on the input; the Dense layers compute in ``dtype``, as Flax's."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        reduced = max(channels // reduction, 1)
        self.fc1 = Dense(channels, reduced, dtype)
        self.fc2 = Dense(reduced, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.relu(self.fc1(x.mean((2, 3)))))
        return x * torch.sigmoid(s)[:, :, None, None]


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity shortcut (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, norm: Callable,
                 strides: Sequence[int] = (1, 1),
                 use_bias: bool = False, use_se: bool = False,
                 fast_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_channels = filters
        # symmetric (1, 1) padding: SAME at stride 1, torch's conv at 2
        self.conv1 = _conv3x3(in_channels, filters, strides, 1, use_bias,
                              dtype, fast_conv)
        self.bn1, self.conv2 = _bn1_conv2(filters, filters, (1, 1), 1, norm,
                                          use_bias, dtype, fast_conv)
        self.bn2 = norm(filters)
        self.se = SEModule(filters, dtype=dtype) if use_se else None
        if tuple(strides) != (1, 1) or in_channels != filters:
            self.downsample_conv = Conv2d(in_channels, filters, 1,
                                          tuple(strides), bias=use_bias,
                                          compute_dtype=dtype)
            self.downsample_bn = norm(filters)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _relu_conv_chain(self, self.conv1(x))
        y = self.bn2(y)
        if self.se is not None:
            y = self.se(y)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1(expansion x) bottleneck (ResNet-50/101/152; the
    3x3 grouped for ResNeXt)."""

    def __init__(self, in_channels: int, filters: int, norm: Callable,
                 strides: Sequence[int] = (1, 1),
                 stride_in_3x3: bool = True, use_bias: bool = False,
                 use_se: bool = False, groups: int = 1, expansion: int = 4,
                 fast_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        s1 = (1, 1) if stride_in_3x3 else tuple(strides)
        s3 = tuple(strides) if stride_in_3x3 else (1, 1)
        out_channels = self.out_channels = filters * expansion
        self.conv1 = Conv2d(in_channels, filters, 1, s1, bias=use_bias,
                            compute_dtype=dtype)
        self.bn1, self.conv2 = _bn1_conv2(filters, filters, s3, groups, norm,
                                          use_bias, dtype, fast_conv)
        self.bn2 = norm(filters)
        self.conv3 = Conv2d(filters, out_channels, 1, bias=use_bias,
                            compute_dtype=dtype)
        self.bn3 = norm(out_channels)
        self.se = SEModule(out_channels, dtype=dtype) if use_se else None
        if tuple(strides) != (1, 1) or in_channels != out_channels:
            self.downsample_conv = Conv2d(in_channels, out_channels, 1,
                                          tuple(strides), bias=use_bias,
                                          compute_dtype=dtype)
            self.downsample_bn = norm(out_channels)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _relu_conv_chain(self, self.conv1(x))
        y = F.relu(self.bn2(y))
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Generic ResNet backbone: NCHW image batch -> final [B, C, H/32, W/32]
    feature map. Inside :func:`~embeddingnet_tpu_torch.models.remat.
    rematerialize` each block runs under a checkpoint."""

    remat_blocks = True

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_filters: int = 64, stride_in_3x3: bool = True,
                 use_bias: bool = False, use_se: bool = False,
                 groups: int = 1, width_per_group: int = 64,
                 bn_epsilon: float = 1.001e-5,
                 bn_momentum: float = 0.99, fast_conv: bool = False,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 3):
        super().__init__()
        norm = partial(BatchNorm, eps=bn_epsilon, momentum=bn_momentum,
                       compute_dtype=dtype)
        self.stem_conv = Conv2d(in_channels, num_filters, 7, 2, 3,
                                bias=use_bias, compute_dtype=dtype)
        self.stem_bn = norm(num_filters)
        channels = num_filters
        self.block_names = []
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                expansion = 4
                if groups > 1:
                    # canonical ResNeXt (e.g. 32x4d): mid width
                    # groups * width_per_group * 2^i, expansion 2
                    filters = groups * width_per_group * 2 ** i
                    expansion = num_filters * 4 // (groups * width_per_group)
                kwargs = dict(strides=strides, norm=norm, use_bias=use_bias,
                              use_se=use_se, fast_conv=fast_conv, dtype=dtype)
                if block_cls is BottleneckBlock:
                    kwargs.update(stride_in_3x3=stride_in_3x3, groups=groups,
                                  expansion=expansion)
                name = f"stage{i + 1}_block{j + 1}"
                block = block_cls(channels, filters, **kwargs)
                self.add_module(name, block)
                self.block_names.append(name)
                channels = block.out_channels
        self.out_channels = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = remat.run(getattr(self, name), x)
        return x


def init_he_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's ``he_normal`` on every conv under ``module``: a normal
    truncated at two standard deviations, scaled so the variance is
    2 / fan_in (a grouped conv's fan_in is its group's); conv biases zero.
    The squeeze-excitation's Dense layers take Flax's default,
    ``lecun_normal``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(2.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, Dense):
            lecun_normal_(m, generator)


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), block_cls=BottleneckBlock, **kw)


def seresnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock,
                  use_se=True, **kw)


def seresnet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock,
                  use_se=True, **kw)


def seresnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock,
                  use_se=True, **kw)


def seresnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock,
                  use_se=True, **kw)


def seresnet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), block_cls=BottleneckBlock,
                  use_se=True, **kw)


def seresnext50(**kw) -> ResNet:
    """SE-ResNeXt-50 32x4d."""
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock,
                  groups=32, width_per_group=4, use_se=True, **kw)


def seresnext101(**kw) -> ResNet:
    """SE-ResNeXt-101 32x4d."""
    return ResNet(stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock,
                  groups=32, width_per_group=4, use_se=True, **kw)


def resnext50(**kw) -> ResNet:
    """ResNeXt-50 32x4d."""
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock,
                  groups=32, width_per_group=4, **kw)


def resnext101(**kw) -> ResNet:
    """ResNeXt-101 32x8d (expansion 1, as the JAX package builds it)."""
    return ResNet(stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock,
                  groups=32, width_per_group=8, **kw)


class SENet154Block(nn.Module):
    """The SENet-154 bottleneck: 1x1 -> planes*2, grouped 3x3 (groups=64)
    -> planes*4, 1x1 -> planes*4, SE (reduction 16); the downsample
    shortcut is a 3x3 conv (pad 1), not a 1x1."""

    def __init__(self, in_channels: int, planes: int, norm: Callable,
                 strides: Sequence[int] = (1, 1), groups: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        out_channels = self.out_channels = planes * 4
        self.conv1 = Conv2d(in_channels, planes * 2, 1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = norm(planes * 2)
        self.conv2 = Conv2d(planes * 2, out_channels, 3, tuple(strides), 1,
                            groups=groups, bias=False, compute_dtype=dtype)
        self.bn2 = norm(out_channels)
        self.conv3 = Conv2d(out_channels, out_channels, 1, bias=False,
                            compute_dtype=dtype)
        self.bn3 = norm(out_channels)
        self.se = SEModule(out_channels, dtype=dtype)
        if tuple(strides) != (1, 1) or in_channels != out_channels:
            self.downsample_conv = Conv2d(in_channels, out_channels, 3,
                                          tuple(strides), 1, bias=False,
                                          compute_dtype=dtype)
            self.downsample_bn = norm(out_channels)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.se(self.bn3(self.conv3(y)))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(residual + y)


class SENet154(nn.Module):
    """SENet-154: a three-conv stem (64, 64, 128), then (3, 8, 36, 3)
    stages of :class:`SENet154Block`; returns the final 2048-channel map."""

    remat_blocks = True

    def __init__(self, bn_epsilon: float = 1e-5, bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None, in_channels: int = 3):
        super().__init__()
        norm = partial(BatchNorm, eps=bn_epsilon, momentum=bn_momentum,
                       compute_dtype=dtype)
        channels = in_channels
        for i, (ch, s) in enumerate(((64, 2), (64, 1), (128, 1)), start=1):
            self.add_module(f"stem_conv{i}", Conv2d(
                channels, ch, 3, s, 1, bias=False, compute_dtype=dtype))
            self.add_module(f"stem_bn{i}", norm(ch))
            channels = ch
        self.block_names = []
        for i, block_count in enumerate((3, 8, 36, 3)):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"stage{i + 1}_block{j + 1}"
                block = SENet154Block(channels, 64 * 2 ** i, norm, strides,
                                      dtype=dtype)
                self.add_module(name, block)
                self.block_names.append(name)
                channels = block.out_channels
        self.out_channels = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in (1, 2, 3):
            conv, bn = (getattr(self, f"stem_conv{i}"),
                        getattr(self, f"stem_bn{i}"))
            x = F.relu(bn(conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = remat.run(getattr(self, name), x)
        return x


def senet154(**kw) -> SENet154:
    return SENet154(**kw)
