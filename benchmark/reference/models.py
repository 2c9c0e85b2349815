"""Plain float32 forwards of the benchmark's encoders, written from the
papers: ResNet-50 v1.5 (He et al., arXiv:1512.03385; the stride on the 3x3
conv, as torchvision's v1.5) and EfficientNet-B3 (Tan & Le,
arXiv:1905.11946; width 1.2, depth 1.4), each under the embedding head
GAP -> Dense(len/2) -> ReLU -> Dense(len) -> ReLU -> L2 and a Dense(1)
classifier that the triplet loss never reaches.

The weights are a flat ``{name: tensor}`` dict whose names follow the Flax
modules the encoders were ported from (``backbone.stage3_block2.conv2.
weight``, ``head.dense_1.bias``, ...), so that the benchmark can hand the
same values to the program and to this file. :func:`leaves` lists every
tensor of an encoder with its shape and how the benchmark draws it.

``quant`` is the precision of the products: ``None`` computes every conv and
dense layer in float32; a :class:`~benchmark.reference.precision.Quant`
rounds their inputs and weights (and, in a backward, the gradients reaching
their outputs) to a narrower type first. BatchNorm, activations, pooling
and the L2 norm stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Leaf = Tuple[str, Tuple[int, ...], str, int]

RESNET_BN_EPS = 1.001e-5
EFFNET_BN_EPS = 1e-3
RESNET50_STAGES = (3, 4, 6, 3)
# The scale of the last BatchNorm of each ResNet bottleneck at the start:
# small, after the zero-init of that scale (Goyal et al., arXiv:1706.02677),
# but not zero, so that every layer of a branch has a gradient at the first
# step. With scales of 1 the randomly initialised 50-layer train-mode net is
# chaotic (Yang et al., arXiv:1902.08129): rounding the products to bf16
# moves its embeddings by a quarter of their norm, half as far as fp8 does,
# and no comparison could tell the two apart.
RESIDUAL_SCALE = 0.1

# EfficientNet-B0's stages: (expand ratio, channels, repeats, stride, kernel)
EFFNET_B0 = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
             (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
             (6, 320, 1, 1, 3))
EFFNET_SCALING = {"efficientnet-b3": (1.2, 1.4)}


def _conv_leaf(name, cout, cin, k) -> Leaf:
    return (name + ".weight", (cout, cin, k, k), "conv_fan_in", cin * k * k)


def _bn_leaves(name, c) -> List[Leaf]:
    return [(name + ".weight", (c,), "one", 0),
            (name + ".bias", (c,), "zero", 0),
            (name + ".running_mean", (c,), "zero", 0),
            (name + ".running_var", (c,), "one", 0),
            (name + ".num_batches_tracked", (), "count", 0)]


def _dense_leaves(name, cin, cout) -> List[Leaf]:
    return [(name + ".weight", (cout, cin), "dense", cin),
            (name + ".bias", (cout,), "zero", 0)]


def _head_leaves(channels: int, encodings_len: int) -> List[Leaf]:
    return (_dense_leaves("head.dense_1", channels, encodings_len // 2)
            + _dense_leaves("head.dense_2", encodings_len // 2, encodings_len)
            + _dense_leaves("classifier.output_img", encodings_len, 1))


# -- ResNet-50 v1.5 ----------------------------------------------------------

def _resnet50_blocks():
    """(name, in channels, mid channels, stride) of each bottleneck."""
    blocks, cin = [], 64
    for i, count in enumerate(RESNET50_STAGES):
        mid = 64 * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            blocks.append((f"backbone.stage{i + 1}_block{j + 1}", cin, mid,
                           stride))
            cin = mid * 4
    return blocks


def resnet50_leaves(encodings_len: int) -> List[Leaf]:
    out = [_conv_leaf("backbone.stem_conv", 64, 3, 7)]
    out += _bn_leaves("backbone.stem_bn", 64)
    for name, cin, mid, stride in _resnet50_blocks():
        out += [_conv_leaf(name + ".conv1", mid, cin, 1)]
        out += _bn_leaves(name + ".bn1", mid)
        out += [_conv_leaf(name + ".conv2", mid, mid, 3)]
        out += _bn_leaves(name + ".bn2", mid)
        out += [_conv_leaf(name + ".conv3", mid * 4, mid, 1)]
        out += _bn_leaves(name + ".bn3", mid * 4)
        if stride != 1 or cin != mid * 4:
            out += [_conv_leaf(name + ".downsample_conv", mid * 4, cin, 1)]
            out += _bn_leaves(name + ".downsample_bn", mid * 4)
    return out + _head_leaves(2048, encodings_len)


# -- EfficientNet -------------------------------------------------------------

def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def effnet_blocks(name: str):
    """(name, in, out, expand ratio, kernel, stride, drop-connect rate) of
    each MBConv block."""
    width, depth = EFFNET_SCALING[name]
    repeats = [int(math.ceil(depth * r)) for _, _, r, _, _ in EFFNET_B0]
    total, idx, cin = sum(repeats), 0, round_filters(32, width)
    blocks = []
    for stage, ((expand, ch, _, stride, kernel), n) in enumerate(
            zip(EFFNET_B0, repeats)):
        cout = round_filters(ch, width)
        for rep in range(n):
            blocks.append((f"backbone.stage{stage + 1}_block{rep + 1}", cin,
                           cout, expand, kernel, stride if rep == 0 else 1,
                           0.2 * idx / total))
            cin = cout
            idx += 1
    return blocks


def effnet_leaves(name: str, encodings_len: int) -> List[Leaf]:
    width, _ = EFFNET_SCALING[name]
    stem = round_filters(32, width)
    out = [(f"backbone.stem_conv.weight", (stem, 3, 3, 3), "conv_fan_out",
            stem * 9)]
    out += _bn_leaves("backbone.stem_bn", stem)
    cin = stem
    for bname, cin, cout, expand, k, _, _ in effnet_blocks(name):
        mid = cin * expand
        if expand != 1:
            out += [(bname + ".expand_conv.weight", (mid, cin, 1, 1),
                     "conv_fan_out", mid)]
            out += _bn_leaves(bname + ".expand_bn", mid)
        out += [(bname + ".dw_conv.weight", (mid, 1, k, k), "conv_fan_out",
                 mid * k * k)]
        out += _bn_leaves(bname + ".dw_bn", mid)
        red = max(1, int(cin * 0.25))
        out += [(bname + ".se.reduce.weight", (red, mid, 1, 1),
                 "conv_fan_out", red), (bname + ".se.reduce.bias", (red,),
                                        "zero", 0),
                (bname + ".se.expand.weight", (mid, red, 1, 1),
                 "conv_fan_out", mid), (bname + ".se.expand.bias", (mid,),
                                        "zero", 0)]
        out += [(bname + ".project_conv.weight", (cout, mid, 1, 1),
                 "conv_fan_out", cout)]
        out += _bn_leaves(bname + ".project_bn", cout)
        cin = cout
    head = round_filters(1280, width)
    out += [("backbone.head_conv.weight", (head, cin, 1, 1), "conv_fan_out",
             head)]
    out += _bn_leaves("backbone.head_bn", head)
    return out + _head_leaves(head, encodings_len)


def leaves(backbone: str, encodings_len: int) -> List[Leaf]:
    """Every tensor of the encoder: ``(name, shape, kind, fan)``."""
    if backbone == "resnet50":
        return resnet50_leaves(encodings_len)
    if backbone in EFFNET_SCALING:
        return effnet_leaves(backbone, encodings_len)
    raise ValueError(f"no reference for backbone {backbone!r}")


# -- layers ------------------------------------------------------------------

def _q(quant, x):
    return x if quant is None else quant.operand(x)


def conv(P, name, x, stride=1, padding=0, groups=1, quant=None, bias=False):
    w = P[name + ".weight"]
    b = P[name + ".bias"] if bias else None
    y = F.conv2d(_q(quant, x), _q(quant, w), b, stride, padding, 1, groups)
    return y if quant is None else quant.output(y)


def dense(P, name, x, quant=None):
    y = F.linear(_q(quant, x), _q(quant, P[name + ".weight"]),
                 P[name + ".bias"])
    return y if quant is None else quant.output(y)


def batchnorm(P, name, x, eps, train, stats=None):
    """Train mode: the batch's mean and biased variance (kept in ``stats``
    by layer name, the first forward's, where a dict is given); eval mode:
    the running statistics."""
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        if stats is not None and name not in stats:
            stats[name] = var.detach()
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    scale = P[name + ".weight"] * torch.rsqrt(var + eps)
    return (x - mean[:, None, None]) * scale[:, None, None] \
        + P[name + ".bias"][:, None, None]


def same_pad(x, k, s):
    """TF "SAME" padding of an NCHW map for a k x k kernel at stride s."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def head(P, feats, quant=None):
    x = feats.mean((2, 3))
    x = F.relu(dense(P, "head.dense_1", x, quant))
    x = F.relu(dense(P, "head.dense_2", x, quant))
    return x / torch.sqrt(x.square().sum(-1, keepdim=True).clamp_min(1e-12))


def _maybe_checkpoint(fn, remat, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def resnet50(P, x, train, quant=None, remat=False, stats=None):
    """[B, 3, H, W] in [0, 1] -> [B, 2048, H/32, W/32]."""
    bn = lambda name, y: batchnorm(P, name, y, RESNET_BN_EPS, train,  # noqa
                                   stats)
    x = F.relu(bn("backbone.stem_bn", conv(P, "backbone.stem_conv", x, 2, 3,
                                           quant=quant)))
    x = F.max_pool2d(x, 3, 2, 1)

    def block(x, name, stride, down):
        y = F.relu(bn(name + ".bn1", conv(P, name + ".conv1", x,
                                          quant=quant)))
        y = F.relu(bn(name + ".bn2", conv(P, name + ".conv2", y, stride, 1,
                                          quant=quant)))
        y = bn(name + ".bn3", conv(P, name + ".conv3", y, quant=quant))
        if down:
            x = bn(name + ".downsample_bn",
                   conv(P, name + ".downsample_conv", x, stride,
                        quant=quant))
        return F.relu(x + y)

    for name, cin, mid, stride in _resnet50_blocks():
        x = _maybe_checkpoint(
            lambda x, n=name, s=stride, d=(stride != 1 or cin != mid * 4):
            block(x, n, s, d), remat, x)
    return x


def effnet(P, x, train, masks: Optional[Sequence[torch.Tensor]] = None,
           quant=None, remat=False, name="efficientnet-b3", stats=None):
    """[B, 3, H, W] in [0, 1] -> the head conv's map. ``masks``: the
    drop-connect keep masks [B] (bool), one per residual block with a
    positive rate; train mode needs them."""
    bn = lambda n, y: batchnorm(P, n, y, EFFNET_BN_EPS, train, stats)  # noqa
    x = F.silu(bn("backbone.stem_bn",
                  conv(P, "backbone.stem_conv", same_pad(x, 3, 2), 2,
                       quant=quant)))
    masks = list(masks or [])

    def block(x, bname, cin, cout, expand, k, stride, rate, keep):
        inputs = x
        if expand != 1:
            x = F.silu(bn(bname + ".expand_bn",
                          conv(P, bname + ".expand_conv", x, quant=quant)))
        x = F.silu(bn(bname + ".dw_bn",
                      conv(P, bname + ".dw_conv", same_pad(x, k, stride),
                           stride, groups=x.shape[1], quant=quant)))
        s = x.mean((2, 3))
        s = F.silu(F.linear(_q(quant, s), _q(
            quant, P[bname + ".se.reduce.weight"].flatten(1)),
            P[bname + ".se.reduce.bias"]))
        s = F.linear(_q(quant, s), _q(
            quant, P[bname + ".se.expand.weight"].flatten(1)),
            P[bname + ".se.expand.bias"])
        x = x * torch.sigmoid(s)[:, :, None, None]
        x = bn(bname + ".project_bn",
               conv(P, bname + ".project_conv", x, quant=quant))
        if stride == 1 and cin == cout:
            if train and rate > 0:
                x = torch.where(keep[:, None, None, None], x / (1.0 - rate),
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device))
            x = x + inputs
        return x

    used = 0
    for bname, cin, cout, expand, k, stride, rate in effnet_blocks(name):
        keep = None
        if train and stride == 1 and cin == cout and rate > 0:
            keep = masks[used]
            used += 1
        x = _maybe_checkpoint(
            lambda x, keep, a=(bname, cin, cout, expand, k, stride, rate):
            block(x, *a, keep), remat, x, keep)
    if train and used != len(masks):
        raise ValueError(f"{len(masks)} drop-connect masks for {used} blocks")
    return F.silu(bn("backbone.head_bn",
                     conv(P, "backbone.head_conv", x, quant=quant)))


def embed(P, backbone: str, x_nhwc: torch.Tensor, train: bool,
          masks=None, quant=None, remat=False, stats=None) -> torch.Tensor:
    """Images [B, H, W, 3] in [0, 1], float32 -> L2-normalised embeddings;
    ``stats``: a dict that takes each BatchNorm's batch variance."""
    x = x_nhwc.permute(0, 3, 1, 2).contiguous()
    if backbone == "resnet50":
        feats = resnet50(P, x, train, quant, remat, stats)
    else:
        feats = effnet(P, x, train, masks, quant, remat, backbone, stats)
    return head(P, feats, quant)


def parameter_names(backbone: str, encodings_len: int) -> List[str]:
    """The trainable leaves (not the BatchNorm statistics)."""
    return [n for n, _, kind, _ in leaves(backbone, encodings_len)
            if not n.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))]


def make_weights(backbone: str, encodings_len: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every leaf of the encoder from ``seed``, drawn on ``device`` in one
    call: convs He-normal (ResNet: variance 2 / fan-in; EfficientNet:
    2 / fan-out, each family's published initialiser), Dense layers
    variance 2 / fan-in, biases and BatchNorm shifts 0, scales 1, running
    statistics 0 and 1; but the last BatchNorm scale of each ResNet
    bottleneck is :data:`RESIDUAL_SCALE`."""
    spec = leaves(backbone, encodings_len)
    residual_scales = ({n for n, _, _, _ in spec if n.endswith(".bn3.weight")}
                       if backbone == "resnet50" else set())
    drawn = [(n, s, f) for n, s, kind, f in spec
             if kind in ("conv_fan_in", "conv_fan_out", "dense")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, fan in drawn:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape) * math.sqrt(2.0 / fan)
        at += n
    for name, shape, kind, _ in spec:
        if kind == "one" and name in residual_scales:
            out[name] = torch.full(shape, RESIDUAL_SCALE, device=device)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return {name: out[name] for name, _, _, _ in spec}
