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

from typing import Optional

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
        f"'Modules to port'); ported: {list_backbones()}")


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
