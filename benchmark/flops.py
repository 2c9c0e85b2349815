"""The benchmark's own operation and byte counts, and the card's peaks.

An operation is a multiply or an add: a conv or dense layer of ``m``
multiply-accumulates does ``2 m``. A model's forward count covers every
conv and dense layer of backbone and head (the squeeze-excitation's
included), nothing else: no BatchNorm, activation, pooling or norm. A
training step counts three forwards (the forward, and the backward's two
products per layer); no recompute, augmentation or miner.

A conv kernel's least time is the larger of its operations at the bf16
peak and its bytes at the memory peak, each input read once and each
output written once.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from benchmark.reference import models

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _conv_macs(cin, cout, k, h_out, w_out, groups=1) -> int:
    return cin // groups * cout * k * k * h_out * w_out


def resnet50_macs(size: int, encodings_len: int) -> int:
    """Multiply-accumulates of one image's forward at ``size`` px."""
    s = (size + 2 * 3 - 7) // 2 + 1                          # stem, s2 p3
    macs = _conv_macs(3, 64, 7, s, s)
    s = (s + 2 - 3) // 2 + 1                                  # max pool
    for _, cin, mid, stride in models._resnet50_blocks():
        s_out = (s + 2 - 3) // stride + 1
        macs += _conv_macs(cin, mid, 1, s, s)
        macs += _conv_macs(mid, mid, 3, s_out, s_out)
        macs += _conv_macs(mid, mid * 4, 1, s_out, s_out)
        if stride != 1 or cin != mid * 4:
            macs += _conv_macs(cin, mid * 4, 1, s_out, s_out)
        s = s_out
    return macs + _head_macs(2048, encodings_len)


def _head_macs(channels: int, encodings_len: int) -> int:
    return channels * (encodings_len // 2) + encodings_len // 2 * encodings_len


def effnet_macs(name: str, size: int, encodings_len: int) -> int:
    width, _ = models.EFFNET_SCALING[name]
    stem = models.round_filters(32, width)
    s = math.ceil(size / 2)
    macs = _conv_macs(3, stem, 3, s, s)
    for _, cin, cout, expand, k, stride, _ in models.effnet_blocks(name):
        mid = cin * expand
        if expand != 1:
            macs += _conv_macs(cin, mid, 1, s, s)
        s = math.ceil(s / stride)
        macs += _conv_macs(mid, mid, k, s, s, groups=mid)
        red = max(1, int(cin * 0.25))
        macs += 2 * mid * red                                 # SE's two FCs
        macs += _conv_macs(mid, cout, 1, s, s)
        cin = cout
    head = models.round_filters(1280, width)
    macs += _conv_macs(cin, head, 1, s, s)
    return macs + _head_macs(head, encodings_len)


def forward_flops(backbone: str, size: int, encodings_len: int) -> int:
    """Operations of one image's forward."""
    if backbone == "resnet50":
        return 2 * resnet50_macs(size, encodings_len)
    return 2 * effnet_macs(backbone, size, encodings_len)


def train_flops(backbone: str, size: int, encodings_len: int) -> int:
    """Operations of one image's training step: three forwards."""
    return 3 * forward_flops(backbone, size, encodings_len)


# -- the port's 3x3 conv kernels ----------------------------------------------

# The kernels' names as the program counts their launches
# (``ops/fused_conv.py`` ``LAUNCHES``), and the substrings of their CUDA
# symbols in a profiler trace (the part sums of K2 and K4 included).
CONV3X3_KERNELS = ("conv3x3_small", "conv3x3_small_bn_relu", "conv3x3_dgrad",
                   "conv3x3_wgrad", "conv3x3_wgrad_bn_relu",
                   "conv3x3_small_affine_relu")
CONV3X3_SYMBOLS = ("conv3x3_sm90_kernel", "conv3x3_wgrad_sm90_kernel",
                   "conv3x3_sum_parts_kernel")


def conv_cost(name: str, b: int, s: int, c: int) -> Tuple[int, int]:
    """(operations, bytes) of one call of a conv kernel at [b, s, s, c],
    c -> c: each input read once, each output written once."""
    flops = 2 * b * s * s * 9 * c * c
    act = b * s * s * c * 2                       # a bf16 activation
    weight = 9 * c * c * 2                        # a bf16 weight
    affine = 2 * c * 4                            # f32 scale and bias
    nbytes = {
        "conv3x3_small": 2 * act + weight,
        "conv3x3_small_bn_relu": 2 * act + weight + affine,
        "conv3x3_dgrad": 2 * act + weight,
        "conv3x3_wgrad": 2 * act + 2 * weight,    # f32 dW
        "conv3x3_wgrad_bn_relu": 2 * act + 2 * weight + affine,
        "conv3x3_small_affine_relu": 2 * act + weight + affine,
    }[name]
    return flops, nbytes


def least_seconds(flops: int, nbytes: int) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def resnet50_conv3x3_launches(batch: int, size: int
                              ) -> List[Tuple[str, int, int, int]]:
    """The port's 3x3 conv kernel launches of one ResNet-50 training step
    with ``pallas_conv`` on, in bf16: ``(kernel, b, s, c)``. A stride-1
    3x3 conv of a bottleneck runs its forward as K3 (its BatchNorm and ReLU
    applied on the kernel's input) and its backward as K1 (the dgrad) and
    K4 at 2x2 and 4x4; at 8x8 its forward is cuDNN's and its backward K1
    and K2, where the batch is a multiple of 8 and the width under 512."""
    s = (size + 2 * 3 - 7) // 2 + 1
    s = (s + 2 - 3) // 2 + 1
    out = []
    for _, cin, mid, stride in models._resnet50_blocks():
        s = (s + 2 - 3) // stride + 1
        if stride != 1 or mid % 128:
            continue
        if s in (2, 4):
            out += [("conv3x3_small_bn_relu", batch, s, mid),
                    ("conv3x3_dgrad", batch, s, mid),
                    ("conv3x3_wgrad_bn_relu", batch, s, mid)]
        elif s == 8 and batch % 8 == 0 and mid < 512:
            out += [("conv3x3_dgrad", batch, s, mid),
                    ("conv3x3_wgrad", batch, s, mid)]
    return out
