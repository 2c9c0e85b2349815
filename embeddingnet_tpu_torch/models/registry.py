"""Backbone factory and the modules built on it (port of
``embeddingnet_tpu/models/registry.py``).

One module exposes the embedding path (``forward``), the raw feature path
(``features``) and the Dense(1, sigmoid) classifier (``classify``) over
shared parameters. Its public methods take NHWC image batches, as the JAX
module does; inside, the backbone runs NCHW in ``torch.channels_last``
memory, which is the same bytes. :class:`SiameseModule` runs one shared
encoder on both images of a pair and a distance head on the two
embeddings; :class:`ArcFaceModule` is an encoder and the ArcFace loss's
class-weight matrix; :class:`SoftmaxModule` a backbone and the softmax
pretraining head, whose backbone :func:`transfer_backbone_params` hands
to an encoder.

The ResNet (18-152) and ViT families (``vit-*``, ``clip-vit-*``) are
ported; every other backbone name of the JAX registry raises
``NotImplementedError`` naming ``ROADMAP.md``. A ViT is built for one
image size (its position embedding), so modules take ``input_shape``
[H, W, C], which the ResNets ignore.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from embeddingnet_tpu_torch.models import resnet as _resnet
from embeddingnet_tpu_torch.models import vit as _vit
from embeddingnet_tpu_torch.models.heads import (ClassificationHead,
                                                 EmbeddingHead, SiameseL1Head,
                                                 SoftmaxHead, init_keras_,
                                                 siamese_l2_distance)

_RESNETS = {
    "resnet18": _resnet.resnet18,
    "resnet34": _resnet.resnet34,
    "resnet50": _resnet.resnet50,
    "resnet101": _resnet.resnet101,
    "resnet152": _resnet.resnet152,
}


def list_backbones():
    return sorted(_RESNETS) + sorted(_vit._VARIANTS)


def _build_backbone(name: str, dtype: Optional[torch.dtype],
                    bn_momentum: float = 0.99, fast_conv: bool = False,
                    input_shape: Optional[Sequence[int]] = None):
    """Backbone module for ``name``. ``fast_conv`` enables the
    small-spatial 3x3 conv kernels (``PERFORMANCE.pallas_conv``) of the
    ResNets; the ViTs, which have no 3x3 conv, ignore it, as in JAX."""
    if name in _RESNETS:
        return _RESNETS[name](bn_momentum=bn_momentum, dtype=dtype,
                              fast_conv=fast_conv)
    if name.startswith("vit") or name.startswith("clip-vit"):
        if input_shape is None:
            raise ValueError(f"backbone {name!r} needs input_shape: its "
                             f"position embedding is sized by the image")
        return _vit.build_vit(name, input_shape, dtype=dtype)
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
                 classifier: bool = True,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.fast_conv = fast_conv
        self.dtype = dtype
        self.backbone = _build_backbone(backbone_name, dtype, bn_momentum,
                                        fast_conv, input_shape)
        self.head = EmbeddingHead(self.backbone.out_channels, encodings_len,
                                  embeddings_normalization,
                                  compute_dtype=dtype)
        self.classifier = (ClassificationHead(encodings_len,
                                              compute_dtype=dtype)
                           if classifier else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialise as the JAX module does, drawing from ``generator``:
        the backbone's own initialisers (ResNet: He-normal convs, BatchNorm
        1/0 with running statistics 0/1; ViT: :meth:`ViT.reset_parameters`),
        then the heads' Keras Dense."""
        _reset_backbone(self.backbone, generator)
        init_keras_(self.head, generator)
        if self.classifier is not None:
            init_keras_(self.classifier, generator)

    def _backbone(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(_nchw(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Image batch [B, H, W, C] -> embeddings [B, encodings_len]."""
        return self.head(self._backbone(x))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-head feature map, NHWC [B, H/32, W/32, C]."""
        return self._backbone(x).permute(0, 2, 3, 1)

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """Dense(1, sigmoid) on the embedding."""
        return self.classifier(self(x))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    # NHWC -> NCHW view; a contiguous NHWC batch is channels_last
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _reset_backbone(backbone: nn.Module, generator: torch.Generator) -> None:
    if isinstance(backbone, _vit.ViT):
        backbone.reset_parameters(generator)
        return
    for m in backbone.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    _resnet.init_he_(backbone, generator)


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
                 dtype: Optional[torch.dtype] = None,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.distance_type = distance_type
        self.encoder = EmbeddingModule(
            backbone_name, encodings_len, embeddings_normalization,
            fast_conv=fast_conv, dtype=dtype, classifier=False,
            input_shape=input_shape)
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


class ArcFaceModule(nn.Module):
    """An encoder and the ArcFace loss's class-weight matrix (the JAX
    ``ArcFaceModule``): ``forward(x)`` returns ``(embeddings,
    class_weights [n_classes, encodings_len])``. The encoder is a
    standalone :class:`EmbeddingModule`'s without the classifier, and keeps
    the default BatchNorm momentum, 0.99, as the JAX module passes none
    on."""

    def __init__(self, backbone_name: str = "vit-b16",
                 encodings_len: int = 512, n_classes: int = 1000,
                 embeddings_normalization: bool = False,
                 fast_conv: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.encoder = EmbeddingModule(
            backbone_name, encodings_len, embeddings_normalization,
            fast_conv=fast_conv, dtype=dtype, classifier=False,
            input_shape=input_shape)
        self.class_weights = nn.Parameter(torch.zeros(n_classes,
                                                      encodings_len))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The encoder's initialisation, then ``normal(0.01)`` class
        weights."""
        self.encoder.reset_parameters(generator)
        nn.init.normal_(self.class_weights, 0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor):
        return self.encoder(x), self.class_weights


class SoftmaxModule(nn.Module):
    """A backbone and the softmax pretraining head, GAP -> Dense(n_classes)
    logits (the JAX ``SoftmaxModule``). Its ``backbone`` is an
    :class:`EmbeddingModule`'s, built with the default BatchNorm momentum
    and the plain convs, as the JAX module builds it; pretrained, it moves
    into the encoder by :func:`transfer_backbone_params`."""

    def __init__(self, backbone_name: str = "resnet50",
                 n_classes: int = 1000,
                 dtype: Optional[torch.dtype] = None,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.backbone = _build_backbone(backbone_name, dtype,
                                        input_shape=input_shape)
        self.softmax_head = SoftmaxHead(self.backbone.out_channels,
                                        n_classes, compute_dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_backbone(self.backbone, generator)
        init_keras_(self.softmax_head, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Image batch [B, H, W, C] -> logits [B, n_classes]."""
        return self.softmax_head(self.backbone(_nchw(x)))


@torch.no_grad()
def transfer_backbone_params(source: nn.Module, target: nn.Module,
                             statistics: bool = False) -> None:
    """Copy ``source.backbone``'s parameters into ``target.backbone`` in
    place, and with ``statistics`` its BatchNorm statistics too. The JAX
    ``transfer_backbone_params`` copies the parameter tree alone, as the
    pretraining's seeding does; its handoff back carries the statistics."""
    if statistics:
        target.backbone.load_state_dict(source.backbone.state_dict())
        return
    params = dict(source.backbone.named_parameters())
    result = target.backbone.load_state_dict(params, strict=False)
    buffers = {name for name, _ in target.backbone.named_buffers()}
    if result.unexpected_keys or set(result.missing_keys) - buffers:
        raise KeyError(f"backbones differ: missing "
                       f"{sorted(set(result.missing_keys) - buffers)}, "
                       f"unexpected {result.unexpected_keys}")


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
