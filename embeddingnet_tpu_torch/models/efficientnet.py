"""EfficientNet B0-B7 (port of ``embeddingnet_tpu/models/efficientnet.py``).

Tan & Le 2019: MBConv blocks with squeeze-excitation and swish (SiLU),
BatchNorm with eps 1e-3, the final ``round_filters(1280)``-channel feature
map (``include_top=False``), drop-connect on the residual blocks in train
mode. :class:`MBConv` is also the MobileNetV2 inverted residual
(``se_ratio=0``, ReLU6; :mod:`~embeddingnet_tpu_torch.models.mobilenet`).

TF's ``"SAME"`` padding (Flax's, and Keras EfficientNet's) is asymmetric
at stride 2 and depends on the input size: :func:`same_padding` computes
it per forward and :class:`SameConv2d` pads explicitly where the two sides
differ. The depthwise convs are ``groups=C`` convs whose ``[C, 1, k, k]``
weight is the Flax ``[k, k, 1, C]`` kernel transposed, as
:func:`~embeddingnet_tpu_torch.models.convert.flax_to_torch` does for every
conv. The squeeze-excitation's 1x1 convs on the pooled [B, C] vector run as
``F.linear`` with their ``[O, I, 1, 1]`` weights viewed as ``[O, I]``: the
same products.

Drop-connect keeps a residual block's branch per example with probability
``1 - rate`` (rate ``drop_connect_rate * block_idx / total_blocks``); its
[B] masks come from a :class:`~embeddingnet_tpu_torch.models.stochastic.
MaskSource`, one per residual block in block order.

Submodules carry the Flax names (``stem_conv``, ``stage2_block1.dw_conv``,
``stage2_block1.se.reduce``, ``head_bn``, ...). Tensors are NCHW in
``torch.channels_last`` memory; the convs go to cuDNN (the JAX registry
gives this family no ``fast_conv``: its convs are depthwise, 1x1 or 5x5).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.models import remat
from embeddingnet_tpu_torch.models.resnet import BatchNorm, Conv2d
from embeddingnet_tpu_torch.models.stochastic import MaskSource, drop_connect
from embeddingnet_tpu_torch.ops.fused_conv import cast

# (expand_ratio, channels, repeats, stride, kernel)
_B0_BLOCKS: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# name -> (width_coefficient, depth_coefficient, default_resolution)
SCALINGS = {
    "efficientnet-b0": (1.0, 1.0, 224),
    "efficientnet-b1": (1.0, 1.1, 240),
    "efficientnet-b2": (1.1, 1.2, 260),
    "efficientnet-b3": (1.2, 1.4, 300),
    "efficientnet-b4": (1.4, 1.8, 380),
    "efficientnet-b5": (1.6, 2.2, 456),
    "efficientnet-b6": (1.8, 2.6, 528),
    "efficientnet-b7": (2.0, 3.1, 600),
}

BN_EPS = 1e-3


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:  # never drop more than 10%
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF ``"SAME"`` padding of one spatial axis of size ``n`` for a kernel
    ``k`` at stride ``s``: ``(low, high)``, the odd pixel at the high
    end."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(Conv2d):
    """:class:`~embeddingnet_tpu_torch.models.resnet.Conv2d` with TF
    ``"SAME"`` padding: the conv's own padding where both sides of an axis
    take the same, else an explicit ``F.pad`` first (stride 2 on an even
    size). ``kernel`` and ``stride`` are an int or an (h, w) pair."""

    def __init__(self, in_channels: int, out_channels: int, kernel,
                 stride=1, **kwargs):
        super().__init__(in_channels, out_channels, kernel, stride, 0,
                         **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            same_padding(n, k, s) for n, k, s in zip(
                x.shape[2:], self.kernel_size, self.stride))
        dtype = self.compute_dtype or torch.promote_types(x.dtype,
                                                          self.weight.dtype)
        x, weight, bias = cast(dtype, x, self.weight, self.bias)
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        return F.conv2d(x, weight, bias, self.stride, padding, 1,
                        self.groups)


class SqueezeExcite(nn.Module):
    """GAP -> 1x1 conv ``reduce`` (``max(1, int(in_channels * se_ratio))``
    of the *block's input* channels) -> swish -> 1x1 conv ``expand`` ->
    sigmoid gate on the input."""

    def __init__(self, in_channels: int, channels: int, se_ratio: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        reduced = max(1, int(in_channels * se_ratio))
        self.reduce = Conv2d(channels, reduced, 1, compute_dtype=dtype)
        self.expand = Conv2d(reduced, channels, 1, compute_dtype=dtype)

    @staticmethod
    def _dense(conv: Conv2d, s: torch.Tensor) -> torch.Tensor:
        dtype = conv.compute_dtype or torch.promote_types(s.dtype,
                                                          conv.weight.dtype)
        s, weight, bias = cast(dtype, s, conv.weight, conv.bias)
        return F.linear(s, weight.flatten(1), bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((2, 3))
        s = self._dense(self.expand, F.silu(self._dense(self.reduce, s)))
        return x * torch.sigmoid(s)[:, :, None, None]


class MBConv(nn.Module):
    """Mobile inverted bottleneck: [1x1 expand -> BN -> act] -> depthwise
    k x k (SAME) -> BN -> act -> [SE] -> 1x1 project -> BN [-> drop-connect
    -> + input, when stride 1 and the widths agree]. ``se_ratio=0``
    disables SE, ``activation=F.relu6`` gives the MobileNetV2 block."""

    def __init__(self, in_channels: int, out_channels: int,
                 expand_ratio: int, kernel: int, stride: int,
                 norm: Callable, se_ratio: float = 0.25,
                 drop_rate: float = 0.0, activation: Callable = F.silu,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation = activation
        self.drop_rate = drop_rate
        expanded = in_channels * expand_ratio
        conv = partial(Conv2d, kernel_size=1, bias=False, compute_dtype=dtype)
        if expand_ratio != 1:
            self.expand_conv = conv(in_channels, expanded)
            self.expand_bn = norm(expanded)
        else:
            self.expand_conv = None
        self.dw_conv = SameConv2d(expanded, expanded, kernel, stride,
                                  groups=expanded, bias=False,
                                  compute_dtype=dtype)
        self.dw_bn = norm(expanded)
        self.se = (SqueezeExcite(in_channels, expanded, se_ratio, dtype)
                   if se_ratio else None)
        self.project_conv = conv(expanded, out_channels)
        self.project_bn = norm(out_channels)
        self.residual = stride == 1 and in_channels == out_channels

    @property
    def drops(self) -> bool:
        """Whether the block draws a drop-connect mask in train mode."""
        return self.residual and self.drop_rate > 0.0

    def forward(self, x: torch.Tensor,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        inputs = x
        if self.expand_conv is not None:
            x = self.activation(self.expand_bn(self.expand_conv(x)))
        x = self.activation(self.dw_bn(self.dw_conv(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.project_bn(self.project_conv(x))
        if self.residual:
            if self.training and self.drops:
                masks = masks if masks is not None else MaskSource()
                keep = masks.next((x.shape[0],), 1.0 - self.drop_rate,
                                  x.device)
                x = drop_connect(x, keep, self.drop_rate)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """Backbone: NCHW image batch -> the head conv's feature map
    [B, round_filters(1280), H/32, W/32]."""

    stochastic = True
    remat_blocks = True

    def __init__(self, width_coefficient: float = 1.0,
                 depth_coefficient: float = 1.0,
                 drop_connect_rate: float = 0.2, bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        norm = partial(BatchNorm, eps=BN_EPS, momentum=bn_momentum,
                       compute_dtype=dtype)
        w = width_coefficient
        stem = round_filters(32, w)
        self.stem_conv = SameConv2d(3, stem, 3, 2, bias=False,
                                    compute_dtype=dtype)
        self.stem_bn = norm(stem)
        total_blocks = sum(round_repeats(r, depth_coefficient)
                           for _, _, r, _, _ in _B0_BLOCKS)
        block_idx, in_ch = 0, stem
        self.block_names = []
        for stage, (expand, ch, repeats, stride, kernel) in enumerate(
                _B0_BLOCKS):
            out_ch = round_filters(ch, w)
            for rep in range(round_repeats(repeats, depth_coefficient)):
                name = f"stage{stage + 1}_block{rep + 1}"
                self.add_module(name, MBConv(
                    in_ch, out_ch, expand, kernel,
                    stride if rep == 0 else 1, norm,
                    drop_rate=drop_connect_rate * block_idx / total_blocks,
                    dtype=dtype))
                self.block_names.append(name)
                in_ch = out_ch
                block_idx += 1
        self.out_channels = round_filters(1280, w)
        self.head_conv = Conv2d(in_ch, self.out_channels, 1, bias=False,
                                compute_dtype=dtype)
        self.head_bn = norm(self.out_channels)

    def forward(self, x: torch.Tensor,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = remat.run(getattr(self, name), x, masks)
        return F.silu(self.head_bn(self.head_conv(x)))


def init_fan_out_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX ``conv_init``, ``variance_scaling(2.0, "fan_out",
    "normal")``, on every conv under ``module``: an untruncated normal of
    variance 2 / fan_out, fan_out = out channels x kernel area (a depthwise
    kernel's is C k^2); conv biases zero. BatchNorm to 1/0 with statistics
    0/1."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            o, _, kh, kw = m.weight.shape
            nn.init.normal_(m.weight, 0.0, math.sqrt(2.0 / (o * kh * kw)),
                            generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def build_efficientnet(name: str, **kw) -> EfficientNet:
    if name not in SCALINGS:
        raise ValueError(f"unknown efficientnet variant {name!r}; "
                         f"valid: {sorted(SCALINGS)}")
    width, depth, _ = SCALINGS[name]
    return EfficientNet(width_coefficient=width, depth_coefficient=depth,
                        **kw)
