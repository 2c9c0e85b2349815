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

Every backbone name of the JAX registry is ported: ``simple`` and
``simple2`` (which carry their own embedding head), the ResNets (18-152,
the SE and ResNeXt variants, SENet-154), EfficientNet-B0..B7, MobileNet v1
(``mobilenet``) and v2 (``mobilenetv2``), InceptionV3, Inception-ResNet-v2,
Xception, NASNet (mobile, large), DenseNet-121/169/201, VGG-16/19 and the
ViTs (``vit-*``, ``clip-vit-*``). A ViT and the simple CNNs are built for
one image size (the position embedding, the Dense head), so modules take
``input_shape`` [H, W, C], which the other families ignore.
:func:`get_backbone` is the reference's factory, with its pretrained
weights from a local file (:mod:`~embeddingnet_tpu_torch.models.
pretrained`).

The stochastic backbones (EfficientNet's drop-connect, ``simple2``'s
Dropout) take their train-mode masks from the ``masks``
(:class:`~embeddingnet_tpu_torch.models.stochastic.MaskSource`) that each
module's ``forward`` accepts and hands on; the others ignore it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from embeddingnet_tpu_torch.models import densenet as _densenet
from embeddingnet_tpu_torch.models import efficientnet as _efn
from embeddingnet_tpu_torch.models import inception as _inception
from embeddingnet_tpu_torch.models import mobilenet as _mobilenet
from embeddingnet_tpu_torch.models import nasnet as _nasnet
from embeddingnet_tpu_torch.models import remat
from embeddingnet_tpu_torch.models import resnet as _resnet
from embeddingnet_tpu_torch.models import simple as _simple
from embeddingnet_tpu_torch.models import vgg as _vgg
from embeddingnet_tpu_torch.models import vit as _vit
from embeddingnet_tpu_torch.models import xception as _xception
from embeddingnet_tpu_torch.models.heads import (ClassificationHead, Dense,
                                                 EmbeddingHead, SiameseL1Head,
                                                 SoftmaxHead, init_keras_,
                                                 lecun_normal_,
                                                 siamese_l2_distance)
from embeddingnet_tpu_torch.models.stochastic import MaskSource

_RESNETS = {name: getattr(_resnet, name) for name in (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "seresnet18", "seresnet34", "seresnet50", "seresnet101", "seresnet152",
    "resnext50", "resnext101", "seresnext50", "seresnext101", "senet154")}
_MOBILENETS = {"mobilenet": _mobilenet.MobileNetV1,
               "mobilenetv2": _mobilenet.MobileNetV2}
# the other zoo families, in the JAX registry's order; each builder takes
# bn_momentum and dtype
_ZOO = {
    "inceptionv3": _inception.inceptionv3,
    "inceptionresnetv2": _inception.inceptionresnetv2,
    "xception": _xception.xception,
    "nasnetmobile": _nasnet.nasnetmobile,
    "nasnetlarge": _nasnet.nasnetlarge,
    "densenet121": _densenet.densenet121,
    "densenet169": _densenet.densenet169,
    "densenet201": _densenet.densenet201,
    "vgg16": _vgg.vgg16,
    "vgg19": _vgg.vgg19,
}


def list_backbones():
    """The JAX registry's names, in its order, then the ViTs (``vit-b32``
    and ``vit-l16`` beside JAX's four, which its ``build_vit`` builds
    too)."""
    return (["simple", "simple2"] + sorted(_RESNETS) + sorted(_efn.SCALINGS)
            + sorted(_MOBILENETS) + list(_ZOO) + sorted(_vit._VARIANTS))


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
    of the ResNets but SENet-154; the other families, whose convs are
    grouped, depthwise, 1x1, 5x5, biased or absent, ignore it, as in JAX.
    ``bn_momentum`` reaches every family with BatchNorm (NASNet's module
    default, 0.9997, is never used through here, as in JAX)."""
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
        kw = {} if name == "senet154" else {"fast_conv": fast_conv}
        return _RESNETS[name](bn_momentum=bn_momentum, dtype=dtype,
                              **kw), False
    if name in _efn.SCALINGS:
        return _efn.build_efficientnet(name, bn_momentum=bn_momentum,
                                       dtype=dtype), False
    if name in _MOBILENETS:
        return _MOBILENETS[name](bn_momentum=bn_momentum, dtype=dtype), False
    if name in _ZOO:
        return _ZOO[name](bn_momentum=bn_momentum, dtype=dtype), False
    if name.startswith("vit") or name.startswith("clip-vit"):
        if input_shape is None:
            raise ValueError(f"backbone {name!r} needs input_shape: its "
                             f"position embedding is sized by the image")
        return _vit.build_vit(name, input_shape, dtype=dtype), False
    raise ValueError(f"unknown backbone {name!r}; valid: {list_backbones()}")


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
    the simple CNNs glorot-uniform; the ResNets and SENet-154 He-normal
    convs (their squeeze-excitation Dense layers ``lecun_normal``); VGG,
    DenseNet, Xception, the Inceptions and NASNet Flax's default,
    ``lecun_normal``, on every conv, biases zero. BatchNorm 1/0 with
    running statistics 0/1."""
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
    if isinstance(backbone, (_resnet.ResNet, _resnet.SENet154)):
        _resnet.init_he_(backbone, generator)
        return
    for m in backbone.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m, generator)


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
    on. With a model group in ``tp`` (``parallel/tp.py``) ``class_weights``
    holds this rank's span of the classes, from :attr:`class_offset`."""

    tp = None       # the model group of a split layer (parallel/tp.py)

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
        self.n_classes = n_classes
        self.class_weights = nn.Parameter(torch.zeros(n_classes,
                                                      encodings_len))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The encoder's initialisation, then ``normal(0.01)`` class
        weights."""
        self.encoder.reset_parameters(generator)
        nn.init.normal_(self.class_weights, 0.0, 0.01, generator=generator)

    @property
    def class_offset(self) -> int:
        """The first class of this rank's rows of ``class_weights``."""
        return 0 if self.tp is None else self.tp.span(self.n_classes)[0]

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


def get_backbone(input_shape, encodings_len=4096, backbone_name="simple",
                 embeddings_normalization=True, backbone_weights=None,
                 freeze_backbone=False, dtype=None, generator=None,
                 device="cuda", **kwargs):
    """Reference-compatible factory (the JAX ``get_backbone``, after
    ``backbones.py:12-18``): ``(module, backbone)``, the
    :class:`EmbeddingModule` and its backbone over shared parameters (the
    reference's ``(base_model, backbone_model)``), on ``device``.

    The module is initialised from ``generator`` (seed 0 when None), then
    ``backbone_weights``, a local file or a named preset found through
    ``$EMBEDDINGNET_WEIGHTS_DIR``, is loaded into it (:func:`~embeddingnet_
    tpu_torch.models.pretrained.load_into`); an unresolvable preset raises
    ``FileNotFoundError``. ``freeze_backbone`` and other keyword arguments
    are accepted and ignored, as in JAX: freezing is the optimizer's mask
    (:func:`backbone_param_mask`)."""
    from embeddingnet_tpu_torch.models import pretrained
    path = pretrained.resolve_weights(backbone_weights, backbone_name)
    module = EmbeddingModule(backbone_name, encodings_len,
                             embeddings_normalization, dtype=dtype,
                             input_shape=input_shape)
    module.reset_parameters(generator if generator is not None
                            else torch.Generator().manual_seed(0))
    if path is not None:
        pretrained.load_into(module, path)
    module.to(device)
    return module, module.backbone


def backbone_param_mask(module: nn.Module, freeze_backbone
                        ) -> Dict[str, bool]:
    """``{parameter name: trainable}`` for ``MODEL.freeze_backbone`` (the
    JAX ``backbone_param_mask``):

    * ``False`` / ``None``: everything trains;
    * ``True`` / ``"all"``: every parameter under ``backbone`` is frozen,
      the head and the classifier train;
    * ``"except_last_2"``: the backbone's last two top-level submodules
      stay trainable. "Last" is in the JAX parameter tree's order, whose
      keys are sorted once a tree map has run over it (``jax.jit``, the
      weights file's ``load_into``, the bf16 cast), so for the ResNets
      these are ``stem_bn`` and ``stem_conv``, and counter-numbered names
      sort as strings (``conv93`` after ``conv100``), as in the JAX
      package (``ROADMAP.md``, F11).
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
