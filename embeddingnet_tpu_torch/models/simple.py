"""The reference's two hand-built CNN backbones (port of
``embeddingnet_tpu/models/simple.py``).

``simple``  — 4x(Conv-ReLU-MaxPool) + Flatten + Dense head;
``simple2`` — a 7-conv stack with BatchNorm and Dropout + Dense(512) head.

Keras semantics, as in JAX: VALID convs (``simple2``'s two stride-2 5x5
convs SAME, padded as TF pads, :class:`~embeddingnet_tpu_torch.models.
efficientnet.SameConv2d`), 2x2 max-pool at stride 2, glorot-uniform
kernels with zero biases, BatchNorm (eps 1e-3) *after* the ReLU. The
Flatten is row-major NHWC, as JAX flattens: the NCHW map is permuted to
NHWC first, so converted ``embedding_dense``/``dense_512`` weights see their
inputs in the JAX order. Both carry their own embedding head (the registry
builds no :class:`~embeddingnet_tpu_torch.models.heads.EmbeddingHead` on
them), so their Dense widths are fixed by the input size, which they take
at construction; ``embedding_head=False`` builds the conv stack alone (the
softmax pretraining's backbone, as the JAX module creates no head
parameters when it only asks for features).

``simple2``'s three Dropout layers (0.4, 0.4, 0.5) take their masks from a
:class:`~embeddingnet_tpu_torch.models.stochastic.MaskSource`, in Flax's
shapes (NHWC for the conv maps).

The L2 kernel regularisers (2e-4 on the convs, 1e-3 on the embedding
Dense) are the train loop's :func:`~embeddingnet_tpu_torch.train.optim.
l2_penalty` with :data:`SIMPLE_REG_RULES` / :data:`SIMPLE2_REG_RULES`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.models.efficientnet import SameConv2d
from embeddingnet_tpu_torch.models.heads import (Dense, at_least_f32,
                                                 l2_normalize)
from embeddingnet_tpu_torch.models.resnet import BatchNorm, Conv2d
from embeddingnet_tpu_torch.models.stochastic import MaskSource, dropout

# path-regex -> coefficient, consumed by train.optim.l2_penalty
SIMPLE_REG_RULES = (
    (r".*conv_[1-4].*kernel", 2e-4),
    (r".*embedding_dense.*kernel", 1e-3),
)
SIMPLE2_REG_RULES = (
    (r".*conv_[1-7].*kernel", 2e-4),
    (r".*embedding_dense.*kernel", 1e-3),
)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _hw(input_shape: Optional[Sequence[int]], name: str):
    if input_shape is None:
        raise ValueError(f"backbone {name!r} needs input_shape: its Dense "
                         f"head is sized by the image")
    return int(input_shape[0]), int(input_shape[1])


class SimpleCNN(nn.Module):
    """``simple``: NCHW image batch -> embedding [B, encodings_len], or the
    Flatten (``return_features``)."""

    stochastic = False
    MIN_INPUT = 65  # below this the conv/pool stack collapses to zero

    def __init__(self, encodings_len: int = 256,
                 embeddings_normalization: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 input_shape: Optional[Sequence[int]] = None,
                 embedding_head: bool = True):
        super().__init__()
        self.embeddings_normalization = embeddings_normalization
        self.conv_1 = Conv2d(3, 64, 10, compute_dtype=dtype)
        self.conv_2 = Conv2d(64, 128, 7, compute_dtype=dtype)
        self.conv_3 = Conv2d(128, 128, 4, compute_dtype=dtype)
        self.conv_4 = Conv2d(128, 256, 4, compute_dtype=dtype)
        h, w = _hw(input_shape, "simple")

        def size(n):
            for k in (10, 7, 4):
                n = (n - k + 1) // 2
            return n - 3
        self.out_channels = 256 * max(size(h), 0) * max(size(w), 0)
        self.embedding_dense = (Dense(self.out_channels, encodings_len,
                                      dtype) if embedding_head else None)

    def forward(self, x: torch.Tensor, masks: Optional[MaskSource] = None,
                return_features: bool = False) -> torch.Tensor:
        if min(x.shape[2], x.shape[3]) < self.MIN_INPUT:
            raise ValueError(
                f"'simple' backbone needs input >= {self.MIN_INPUT}px "
                f"(got {x.shape[2]}x{x.shape[3]}); its 10/7/4/4 VALID conv "
                "stack collapses below that (backbones.py:19-41 spec)")
        x = F.max_pool2d(F.relu(self.conv_1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv_2(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv_3(x)), 2, 2)
        x = _flatten_nhwc(F.relu(self.conv_4(x)))
        if return_features:
            return x
        x = F.relu(self.embedding_dense(x))
        if self.embeddings_normalization:
            x = l2_normalize(at_least_f32(x))
        return x


class SimpleCNN2(nn.Module):
    """``simple2``: NCHW image batch -> embedding [B, encodings_len], or the
    last conv + BN map (``return_features``)."""

    stochastic = True
    MIN_INPUT = 24
    # (name, in, out, kernel, stride) of each conv; the stride-2 convs SAME
    _CONVS = (("conv_1", 3, 32, 3, 1), ("conv_2", 32, 32, 3, 1),
              ("conv_3", 32, 32, 5, 2), ("conv_4", 32, 64, 3, 1),
              ("conv_5", 64, 64, 3, 1), ("conv_6", 64, 64, 5, 2),
              ("conv_7", 64, 128, 4, 1))

    def __init__(self, encodings_len: int = 256,
                 embeddings_normalization: bool = True,
                 bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None,
                 input_shape: Optional[Sequence[int]] = None,
                 embedding_head: bool = True):
        super().__init__()
        self.embeddings_normalization = embeddings_normalization
        sizes = list(_hw(input_shape, "simple2"))
        for name, cin, cout, k, s in self._CONVS:
            conv = (SameConv2d(cin, cout, k, s, compute_dtype=dtype) if s > 1
                    else Conv2d(cin, cout, k, compute_dtype=dtype))
            self.add_module(name, conv)
            # Keras BatchNormalization defaults: eps 1e-3
            self.add_module(f"{name}_bn", BatchNorm(
                cout, eps=1e-3, momentum=bn_momentum, compute_dtype=dtype))
            sizes = [math.ceil(n / s) if s > 1 else n - k + 1 for n in sizes]
        self.out_channels = 128
        flat = 128 * max(sizes[0], 0) * max(sizes[1], 0)
        if embedding_head:
            self.dense_512 = Dense(flat, 512, dtype)
            self.embedding_dense = Dense(512, encodings_len, dtype)
        else:
            self.dense_512 = self.embedding_dense = None

    def _conv_bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(getattr(self, name)(x))
        return getattr(self, f"{name}_bn")(x)

    def forward(self, x: torch.Tensor, masks: Optional[MaskSource] = None,
                return_features: bool = False) -> torch.Tensor:
        if min(x.shape[2], x.shape[3]) < self.MIN_INPUT:
            raise ValueError(
                f"'simple2' backbone needs input >= {self.MIN_INPUT}px "
                f"(got {x.shape[2]}x{x.shape[3]})")
        masks = masks if masks is not None else MaskSource()

        def drop(x, rate, nhwc=True):
            return dropout(x, masks, rate, nhwc) if self.training else x

        for name in ("conv_1", "conv_2", "conv_3"):
            x = self._conv_bn(name, x)
        x = drop(x, 0.4)
        for name in ("conv_4", "conv_5", "conv_6"):
            x = self._conv_bn(name, x)
        x = drop(x, 0.4)
        x = self._conv_bn("conv_7", x)
        if return_features:
            return x
        x = F.relu(self.dense_512(_flatten_nhwc(x)))
        x = drop(x, 0.5, nhwc=False)
        x = F.relu(self.embedding_dense(x))
        if self.embeddings_normalization:
            x = l2_normalize(at_least_f32(x))
        return x


def init_glorot_(module: nn.Module, generator: torch.Generator) -> None:
    """Keras initialisation of every conv and Dense under ``module``:
    glorot-uniform kernels (fans from the kernel's shape, as Flax takes
    them), zero biases; BatchNorm 1/0 with statistics 0/1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
