"""Backbone factory and the embedding module (port of
``embeddingnet_tpu/models/registry.py``).

One module exposes the embedding path (``forward``), the raw feature path
(``features``) and the Dense(1, sigmoid) classifier (``classify``) over
shared parameters. Its public methods take NHWC image batches, as the JAX
module does; inside, the backbone runs NCHW in ``torch.channels_last``
memory, which is the same bytes.

Only the ResNet family is ported so far; every other backbone name of the
JAX registry raises ``NotImplementedError`` naming ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from embeddingnet_tpu_torch.models import resnet as _resnet
from embeddingnet_tpu_torch.models.heads import (ClassificationHead,
                                                 EmbeddingHead, init_keras_)

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
    """

    def __init__(self, backbone_name: str = "resnet50",
                 encodings_len: int = 256,
                 embeddings_normalization: bool = True,
                 bn_momentum: float = 0.99, fast_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fast_conv = fast_conv
        self.dtype = dtype
        self.backbone = _build_backbone(backbone_name, dtype, bn_momentum,
                                        fast_conv)
        self.head = EmbeddingHead(self.backbone.out_channels, encodings_len,
                                  embeddings_normalization,
                                  compute_dtype=dtype)
        self.classifier = ClassificationHead(encodings_len,
                                             compute_dtype=dtype)

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
    tails = set()
    if mode == "except_last_2":
        children = sorted({n.split(".")[1] for n in names
                           if n.startswith("backbone.")})
        tails = set(children[-2:])
    return {n: not n.startswith("backbone.")
            or n.split(".")[1] in tails for n in names}
