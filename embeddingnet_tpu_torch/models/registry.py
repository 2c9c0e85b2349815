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

Ported: ``simple`` and ``simple2`` (which carry their own embedding head),
the ResNets (18-152), EfficientNet-B0..B7, MobileNet v1 (``mobilenet``)
and v2 (``mobilenetv2``), and the ViTs (``vit-*``, ``clip-vit-*``); every
other backbone name of the JAX registry (DenseNet, VGG, Inception,
Xception, NASNet, the SE/ResNeXt/SENet-154 ResNets) raises
``NotImplementedError`` naming ``ROADMAP.md``. A ViT and the simple CNNs
are built for one image size (the position embedding, the Dense head), so
modules take ``input_shape`` [H, W, C], which the other families ignore.

The stochastic backbones (EfficientNet's drop-connect, ``simple2``'s
Dropout) take their train-mode masks from the ``masks``
(:class:`~embeddingnet_tpu_torch.models.stochastic.MaskSource`) that each
module's ``forward`` accepts and hands on; the others ignore it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from embeddingnet_tpu_torch.models import efficientnet as _efn
from embeddingnet_tpu_torch.models import remat
from embeddingnet_tpu_torch.models import mobilenet as _mobilenet
from embeddingnet_tpu_torch.models import resnet as _resnet
from embeddingnet_tpu_torch.models import simple as _simple
from embeddingnet_tpu_torch.models import vit as _vit
from embeddingnet_tpu_torch.models.heads import (ClassificationHead, Dense,
                                                 EmbeddingHead, SiameseL1Head,
                                                 SoftmaxHead, init_keras_,
                                                 lecun_normal_,
                                                 siamese_l2_distance)
from embeddingnet_tpu_torch.models.stochastic import MaskSource

_RESNETS = {
    "resnet18": _resnet.resnet18,
    "resnet34": _resnet.resnet34,
    "resnet50": _resnet.resnet50,
    "resnet101": _resnet.resnet101,
    "resnet152": _resnet.resnet152,
}
_MOBILENETS = {"mobilenet": _mobilenet.MobileNetV1,
               "mobilenetv2": _mobilenet.MobileNetV2}


def list_backbones():
    return (["simple", "simple2"] + sorted(_RESNETS) + sorted(_efn.SCALINGS)
            + sorted(_MOBILENETS) + sorted(_vit._VARIANTS))


def _build_backbone(name: str, dtype: Optional[torch.dtype],
                    bn_momentum: float = 0.99, fast_conv: bool = False,
                    input_shape: Optional[Sequence[int]] = None,
                    encodings_len: int = 256,
                    embeddings_normalization: bool = True,
                    embedding_head: bool = True):
    """``(backbone, integrated)``: the backbone module for ``name`` and
    whether it carries its own embedding head (``simple``, ``simple2``;
    ``embedding_head=False`` builds their conv stack alone). ``fast_conv``
    enables the small-spatial 3x3 conv kernels (``PERFORMANCE.pallas_conv``)
    of the ResNets; the other families, whose convs are depthwise, 1x1,
    5x5, biased or absent, ignore it, as in JAX."""
    if name == "simple":
        return _simple.SimpleCNN(
            encodings_len, embeddings_normalization, dtype=dtype,
            input_shape=input_shape, embedding_head=embedding_head), True
    if name == "simple2":
        return _simple.SimpleCNN2(
            encodings_len, embeddings_normalization, bn_momentum=bn_momentum,
            dtype=dtype, input_shape=input_shape,
            embedding_head=embedding_head), True
    if name in _RESNETS:
        return _RESNETS[name](bn_momentum=bn_momentum, dtype=dtype,
                              fast_conv=fast_conv), False
    if name in _efn.SCALINGS:
        return _efn.build_efficientnet(name, bn_momentum=bn_momentum,
                                       dtype=dtype), False
    if name in _MOBILENETS:
        return _MOBILENETS[name](bn_momentum=bn_momentum, dtype=dtype), False
    if name.startswith("vit") or name.startswith("clip-vit"):
        if input_shape is None:
            raise ValueError(f"backbone {name!r} needs input_shape: its "
                             f"position embedding is sized by the image")
        return _vit.build_vit(name, input_shape, dtype=dtype), False
    raise NotImplementedError(
        f"backbone {name!r} is not ported to PyTorch yet (see ROADMAP.md, "
        f"item 12: DenseNet, VGG, Inception, Xception, NASNet and the "
        f"SE/ResNeXt/SENet-154 ResNets wait there); ported: "
        f"{list_backbones()}")


def _run_backbone(backbone: nn.Module, x: torch.Tensor,
                  masks: Optional[MaskSource], **kw) -> torch.Tensor:
    """``backbone`` on an NHWC batch, handing ``masks`` to the stochastic
    families. Inside :func:`~embeddingnet_tpu_torch.models.remat.
    rematerialize` a backbone without blocks of its own (``simple``,
    ``simple2``, MobileNet v1) runs whole under one checkpoint."""
    stochastic = getattr(backbone, "stochastic", False)
    if getattr(backbone, "remat_blocks", False) or not remat.active():
        if stochastic:
            kw["masks"] = masks
        return backbone(_nchw(x), **kw)
    if stochastic:
        masks = masks if masks is not None else MaskSource()
        return remat.run(lambda x, m: backbone(x, masks=m, **kw), _nchw(x),
                         masks)
    return remat.run(lambda x: backbone(x, **kw), _nchw(x))


class EmbeddingModule(nn.Module):
    """Backbone + embedding head + Dense(1, sigmoid) classifier.

    ``forward`` is the reference ``base_model`` (image -> embedding),
    ``features`` the ``backbone_model`` (image -> feature map), ``classify``
    the ``classification_model``. Images are float NHWC, already ``/255``.
    ``classifier=False`` leaves the classifier out, as a JAX module that
    never calls it has no parameters for it (the siamese encoder). The
    simple CNNs carry their own head: no :class:`EmbeddingHead` is built on
    them (``head`` is None), as in JAX.
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
        self.backbone, integrated = _build_backbone(
            backbone_name, dtype, bn_momentum, fast_conv, input_shape,
            encodings_len, embeddings_normalization)
        self.head = None if integrated else EmbeddingHead(
            self.backbone.out_channels, encodings_len,
            embeddings_normalization, compute_dtype=dtype)
        self.classifier = (ClassificationHead(encodings_len,
                                              compute_dtype=dtype)
                           if classifier else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Initialise as the JAX module does, drawing from ``generator``:
        the backbone's own initialisers (:func:`_reset_backbone`), then the
        heads' Keras Dense."""
        _reset_backbone(self.backbone, generator)
        if self.head is not None:
            init_keras_(self.head, generator)
        if self.classifier is not None:
            init_keras_(self.classifier, generator)

    def forward(self, x: torch.Tensor,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """Image batch [B, H, W, C] -> embeddings [B, encodings_len]."""
        out = _run_backbone(self.backbone, x, masks)
        return out if self.head is None else self.head(out)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Pre-head features: the NHWC map [B, h, w, C], or the simple
        CNN's Flatten [B, F]."""
        if self.head is None:
            out = _run_backbone(self.backbone, x, None, return_features=True)
        else:
            out = _run_backbone(self.backbone, x, None)
        return out.permute(0, 2, 3, 1) if out.dim() == 4 else out

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """Dense(1, sigmoid) on the embedding."""
        return self.classifier(self(x))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    # NHWC -> NCHW view; a contiguous NHWC batch is channels_last
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _reset_backbone(backbone: nn.Module, generator: torch.Generator) -> None:
    """Each family's JAX initialisers: ViT :meth:`ViT.reset_parameters`;
    EfficientNet and MobileNet the untruncated fan-out normal
    (:func:`~embeddingnet_tpu_torch.models.efficientnet.init_fan_out_`);
    the simple CNNs glorot-uniform; the ResNets He-normal. BatchNorm 1/0
    with running statistics 0/1."""
    if isinstance(backbone, _vit.ViT):
        backbone.reset_parameters(generator)
        return
    if isinstance(backbone, (_efn.EfficientNet,) + tuple(
            _MOBILENETS.values())):
        _efn.init_fan_out_(backbone, generator)
        return
    if isinstance(backbone, (_simple.SimpleCNN, _simple.SimpleCNN2)):
        _simple.init_glorot_(backbone, generator)
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
    The two streams take their masks from one ``masks``, the first
    stream's first. The encoder's names and parameters are a standalone
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

    def forward(self, xs, masks: Optional[MaskSource] = None):
        x1, x2 = xs
        e1 = self.encoder(x1, masks)
        e2 = self.encoder(x2, masks)
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

    def forward(self, x: torch.Tensor, masks: Optional[MaskSource] = None):
        return self.encoder(x, masks), self.class_weights


class SoftmaxModule(nn.Module):
    """A backbone and the softmax pretraining head (the JAX
    ``SoftmaxModule``): GAP -> Dense(n_classes) logits. Its ``backbone``
    is an :class:`EmbeddingModule`'s, built with the default BatchNorm
    momentum and the plain convs, as the JAX module builds it; pretrained,
    it moves into the encoder by :func:`transfer_backbone_params`. On the
    simple CNNs the backbone is the conv stack alone and the logits are
    ``flat_logits``, a Flax-initialised Dense (``lecun_normal``) on the
    features, pooled when they are a map (``simple2``)."""

    def __init__(self, backbone_name: str = "resnet50",
                 n_classes: int = 1000,
                 dtype: Optional[torch.dtype] = None,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.backbone, self.integrated = _build_backbone(
            backbone_name, dtype, input_shape=input_shape,
            embeddings_normalization=False, embedding_head=False)
        if self.integrated:
            self.flat_logits = Dense(self.backbone.out_channels, n_classes,
                                     dtype)
        else:
            self.softmax_head = SoftmaxHead(self.backbone.out_channels,
                                            n_classes, compute_dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_backbone(self.backbone, generator)
        if self.integrated:
            lecun_normal_(self.flat_logits, generator)
        else:
            init_keras_(self.softmax_head, generator)

    def forward(self, x: torch.Tensor,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """Image batch [B, H, W, C] -> logits [B, n_classes]."""
        if self.integrated:
            feats = _run_backbone(self.backbone, x, masks,
                                  return_features=True)
            if feats.dim() > 2:
                feats = feats.mean((2, 3))
            return self.flat_logits(feats)
        return self.softmax_head(_run_backbone(self.backbone, x, masks))


@torch.no_grad()
def transfer_backbone_params(source: nn.Module, target: nn.Module,
                             statistics: bool = False) -> None:
    """Copy ``source.backbone``'s parameters into ``target.backbone`` in
    place, and with ``statistics`` its BatchNorm statistics too. The JAX
    ``transfer_backbone_params`` copies the parameter tree alone, as the
    pretraining's seeding does; its handoff back carries the statistics.

    On the simple CNNs one side's backbone has the embedding head and the
    other's does not: what both hold is copied, and the head stays where
    it is (the JAX handoff would leave the encoder without it)."""
    src = source.backbone.state_dict() if statistics else dict(
        source.backbone.named_parameters())
    tgt = target.backbone.state_dict()
    wanted = set(tgt) if statistics else {
        n for n, _ in target.backbone.named_parameters()}
    if not (wanted <= set(src) or set(src) <= wanted):
        raise KeyError(f"backbones differ: missing "
                       f"{sorted(wanted - set(src))[:8]}, unexpected "
                       f"{sorted(set(src) - wanted)[:8]}")
    for name in wanted & set(src):
        tgt[name].copy_(src[name])


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
