"""Embedding and classification heads (port of
``embeddingnet_tpu/models/heads.py``).

* zoo backbones: GAP -> Dense(len//2, relu) -> Dense(len, relu) -> optional
  L2 normalisation;
* classification head: Dense(1, sigmoid) on the embedding;
* softmax-pretraining head: GAP -> Dense(n_classes) logits;
* siamese heads: |e1 - e2| -> Dense(1, sigmoid), or the euclidean distance.

Layers compute in ``compute_dtype`` (weights cast at use, parameters f32),
as Flax's ``dtype`` field does. Initialisers follow Keras (glorot-uniform
kernels, zero biases); the draws come from the caller's generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.ops.fused_conv import cast
from embeddingnet_tpu_torch.parallel.collectives import copy_to_model


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Keras ``K.l2_normalize``: x / sqrt(max(sum(x^2), eps))."""
    sq = x.square().sum(dim, keepdim=True)
    return x / torch.sqrt(sq.clamp_min(eps))


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or as it is when wider (float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (Flax ``nn.Dense``)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or torch.promote_types(x.dtype,
                                                          self.weight.dtype)
        return F.linear(*cast(dtype, x, self.weight, self.bias))


class EmbeddingHead(nn.Module):
    """GAP -> Dense(len//2) -> relu -> Dense(len) -> relu -> optional L2
    norm (in f32). Takes the backbone's NCHW feature map."""

    def __init__(self, in_channels: int, encodings_len: int = 256,
                 embeddings_normalization: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embeddings_normalization = embeddings_normalization
        self.dense_1 = Dense(in_channels, encodings_len // 2, compute_dtype)
        self.dense_2 = Dense(encodings_len // 2, encodings_len, compute_dtype)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features.mean((2, 3))                 # GlobalAveragePooling2D
        x = F.relu(self.dense_1(x))
        x = F.relu(self.dense_2(x))
        if self.embeddings_normalization:
            x = l2_normalize(at_least_f32(x))
        return x


class ClassificationHead(nn.Module):
    """Dense(1, sigmoid) on the embedding."""

    def __init__(self, encodings_len: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.output_img = Dense(encodings_len, 1, compute_dtype)

    def forward(self, embedding: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.output_img(embedding))


class SoftmaxHead(nn.Module):
    """GAP -> Dense(n_classes) logits (softmax is folded into the loss).
    With a model group in ``tp`` the Dense holds this rank's span of the
    classes (``parallel/tp.py``) and the logits are those classes'."""

    tp = None       # the model group of a split layer (parallel/tp.py)

    def __init__(self, in_channels: int, n_classes: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.logits = Dense(in_channels, n_classes, compute_dtype)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.logits(copy_to_model(features.mean((2, 3)), self.tp))


class SiameseL1Head(nn.Module):
    """|e1 - e2| -> Dense(1, sigmoid), one score per pair."""

    def __init__(self, encodings_len: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.output_siamese = Dense(encodings_len, 1, compute_dtype)

    def forward(self, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.output_siamese((e1 - e2).abs()))[:, 0]


def siamese_l2_distance(e1: torch.Tensor, e2: torch.Tensor,
                        eps: float = 1e-7) -> torch.Tensor:
    """sqrt(max(sum((e1-e2)^2), eps)), eps as Keras ``K.epsilon()``."""
    return torch.sqrt((e1 - e2).square().sum(-1).clamp_min(eps))


def init_keras_(module: nn.Module, generator: torch.Generator) -> None:
    """Keras initialisation of every :class:`Dense` under ``module``:
    glorot-uniform kernels, zero biases."""
    for m in module.modules():
        if isinstance(m, Dense):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)


def lecun_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default Dense/conv kernel init, ``lecun_normal``, on
    ``module``'s weight: a normal truncated at two standard deviations,
    scaled so the variance is 1 / fan_in; a zero bias."""
    std = math.sqrt(1.0 / module.weight[0].numel()) / .87962566103423978
    nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    if module.bias is not None:
        nn.init.zeros_(module.bias)
