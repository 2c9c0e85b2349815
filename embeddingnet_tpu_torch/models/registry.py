"""Backbone factory, the embedding module and the siamese module (port of
``embeddingnet_tpu/models/registry.py``).

One module exposes the embedding path (``forward``), the raw feature path
(``features``) and the Dense(1, sigmoid) classifier (``classify``) over
shared parameters. Its public methods take NHWC image batches, as the JAX
module does; inside, the backbone runs NCHW in ``torch.channels_last``
memory, which is the same bytes. :class:`SiameseModule` runs one shared
encoder on both images of a pair and a distance head on the two
embeddings.

Only the ResNet family is ported so far; every other backbone name of the
JAX registry raises ``NotImplementedError`` naming ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from embeddingnet_tpu_torch.models import resnet as _resnet
from embeddingnet_tpu_torch.models.heads import (ClassificationHead,
                                                 EmbeddingHead, SiameseL1Head,
                                                 init_keras_,
                                                 siamese_l2_distance)

_RESNETS = {
    "resnet18": _resnet.resnet18,
    "resnet34": _resnet.resnet34,
    "resnet50": _resnet.resnet50,
    "resnet101": _resnet.resnet101,
    "resnet152": _resnet.resnet152,
}


def list_backbones():
    return sorted(_RESNETS)


def _build_backbone(name: str, dtype: Optional[torch.dtype],
                    bn_momentum: float = 0.99, fast_conv: bool = False):
    """Backbone module for ``name``. ``fast_conv`` enables the
    small-spatial 3x3 conv kernels (``PERFORMANCE.pallas_conv``)."""
    if name in _RESNETS:
        return _RESNETS[name](bn_momentum=bn_momentum, dtype=dtype,
                              fast_conv=fast_conv)
    raise NotImplementedError(
        f"backbone {name!r} is not ported to PyTorch yet (see ROADMAP.md, "
        f"item 12); ported: {list_backbones()}")


class EmbeddingModule(nn.Module):
    """Backbone + embedding head + Dense(1, sigmoid) classifier.

    ``forward`` is the reference ``base_model`` (image -> embedding),
    ``features`` the ``backbone_model`` (image -> feature map), ``classify``
    the ``classification_model``. Images are float NHWC, already ``/255``.
    ``classifier=False`` leaves the classifier out, as a JAX module that
    never calls it has no parameters for it (the siamese encoder).
    """

    def __init__(self, backbone_name: str = "resnet50",
                 encodings_len: int = 256,
                 embeddings_normalization: bool = True,
                 bn_momentum: float = 0.99, fast_conv: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 classifier: bool = True):
        super().__init__()
        self.fast_conv = fast_conv
        self.dtype = dtype
        self.backbone = _build_backbone(backbone_name, dtype, bn_momentum,
                                        fast_conv)
        self.head = EmbeddingHead(self.backbone.out_channels, encodings_len,
                                  embeddings_normalization,
                                  compute_dtype=dtype)
        self.classifier = (ClassificationHead(encodings_len,
                                              compute_dtype=dtype)
                           if classifier else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialise as the JAX module does (He-normal convs, Keras Dense,
        BatchNorm 1/0 with running statistics 0/1), drawing from
        ``generator``."""
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        _resnet.init_he_(self.backbone, generator)
        init_keras_(self, generator)

    def _backbone(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view; a contiguous NHWC batch is channels_last
        return self.backbone(x.permute(0, 3, 1, 2)
                             .contiguous(memory_format=torch.channels_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Image batch [B, H, W, C] -> embeddings [B, encodings_len]."""
        return self.head(self._backbone(x))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-head feature map, NHWC [B, H/32, W/32, C]."""
        return self._backbone(x).permute(0, 2, 3, 1)

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """Dense(1, sigmoid) on the embedding."""
        return self.classifier(self(x))


class SiameseModule(nn.Module):
    """Two streams of one shared encoder plus a distance head (the JAX
    ``SiameseModule``): ``l1``, ``|e1 - e2|`` -> Dense(1, sigmoid)
    (``distance_head.output_siamese``); ``l2``, the euclidean distance.
    ``forward((x1, x2))`` returns ``(distance [B], e1, e2)``.

    The encoder runs once per stream, as the JAX module calls it twice: in
    train mode each stream normalises with its own batch statistics, and
    the running averages take two updates a step, the second on top of the
    first. (Concatenating the pair into one 2B batch would change both.)
    The encoder's names and parameters are a standalone
    :class:`EmbeddingModule`'s without the classifier, which the JAX tree
    lacks too; the encoder keeps the default BatchNorm momentum, 0.99, as
    the JAX ``SiameseModule`` passes none on (``ROADMAP.md``, F12)."""

    def __init__(self, backbone_name: str = "resnet50",
                 encodings_len: int = 256,
                 embeddings_normalization: bool = True,
                 distance_type: str = "l1", fast_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.distance_type = distance_type
        self.encoder = EmbeddingModule(
            backbone_name, encodings_len, embeddings_normalization,
            fast_conv=fast_conv, dtype=dtype, classifier=False)
        self.distance_head = (SiameseL1Head(encodings_len,
                                            compute_dtype=dtype)
                              if distance_type == "l1" else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The encoder's initialisation, then the head's Keras init."""
        self.encoder.reset_parameters(generator)
        if self.distance_head is not None:
            init_keras_(self.distance_head, generator)

    def forward(self, xs):
        x1, x2 = xs
        e1 = self.encoder(x1)
        e2 = self.encoder(x2)
        if self.distance_type == "l1":
            d = self.distance_head(e1.float(), e2.float())
        else:
            d = siamese_l2_distance(e1.float(), e2.float())
        return d, e1, e2


def backbone_param_mask(module: nn.Module, freeze_backbone
                        ) -> Dict[str, bool]:
    """``{parameter name: trainable}`` for ``MODEL.freeze_backbone`` (the
    JAX ``backbone_param_mask``):

    * ``False`` / ``None``: everything trains;
    * ``True`` / ``"all"``: every parameter under ``backbone`` is frozen,
      the head and the classifier train;
    * ``"except_last_2"``: the backbone's last two top-level submodules
      stay trainable. "Last" is in the JAX parameter tree's order, whose
      keys are sorted (``jax.jit`` hands back dicts with sorted keys), so
      for the ResNets these are ``stem_bn`` and ``stem_conv``, as in the
      JAX package.
    """
    names = [n for n, _ in module.named_parameters()]
    if not freeze_backbone:
        return {n: True for n in names}
    mode = "all" if freeze_backbone is True else str(freeze_backbone)
    if mode not in ("all", "except_last_2"):
        raise ValueError(
            f"freeze_backbone must be bool, 'all' or 'except_last_2'; "
            f"got {freeze_backbone!r}")

    def child(name):
        # the backbone's top-level submodule of a parameter, wherever the
        # backbone sits (``backbone.`` or the siamese ``encoder.backbone.``)
        parts = name.split(".")
        return parts[parts.index("backbone") + 1] if "backbone" in parts \
            else None

    tails = set()
    if mode == "except_last_2":
        tails = set(sorted({child(n) for n in names} - {None})[-2:])
    return {n: child(n) is None or child(n) in tails for n in names}
