"""Pretrained backbone weights from local files (port of
``embeddingnet_tpu/models/pretrained.py``, its loading and its
torch-source converters).

No step downloads: ``MODEL.backbone_weights`` takes a local file, or a
named preset that :func:`resolve_weights` finds in
``$EMBEDDINGNET_WEIGHTS_DIR`` as ``<backbone>_<preset>.{npz,msgpack}``.
Both formats hold Flax's variables, so one file serves the JAX package and
the port:

* ``.npz``: a flat ``{"params/backbone/stem_conv/kernel": array, ...}``
  archive (the exchange format the converters write);
* ``.msgpack``: Flax's ``serialization.to_bytes`` of the variables, read
  here by a small reader of the msgpack subset Flax writes (maps, strings,
  arrays, and Flax's ndarray and numpy-scalar ext types), so neither
  ``flax`` nor ``msgpack`` is needed.

:func:`load_into` loads a file into a module through Flax's names
(:mod:`~embeddingnet_tpu_torch.models.convert`): a key in the file is
loaded, cast to the module's dtype; a key the file lacks keeps its value;
a key the file has and the module lacks is ignored; a shape mismatch
raises ``ValueError``. A ``.msgpack`` restore is Flax's: every key of the
module must be in the file (``ValueError`` otherwise).

Converters from a torch ``state_dict`` (numpy mappings, the port's own
copies): :func:`torch_resnet_to_flax` (torchvision ResNets),
:func:`hf_vit_to_flax` (``transformers.ViTModel``) and
:func:`clip_vit_to_flax` (a CLIP vision tower). The JAX package's Keras
converters need TensorFlow and stay there; the ``.npz`` its
``tools/convert_weights.py`` writes from them loads here.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from embeddingnet_tpu_torch.models.convert import (_leaves, flax_to_torch,
                                                   torch_to_flax)

NAMED_PRESETS = ("imagenet", "noisy-student")
WEIGHTS_DIR_ENV = "EMBEDDINGNET_WEIGHTS_DIR"


def resolve_weights(backbone_weights: Optional[str],
                    backbone_name: str) -> Optional[str]:
    """MODEL.backbone_weights as a loadable local file, or None.

    A path must exist. A named preset ('imagenet', 'noisy-student')
    resolves to ``$EMBEDDINGNET_WEIGHTS_DIR/<backbone>_<preset>.npz`` (or
    ``.msgpack``); with no such file it raises ``FileNotFoundError``
    rather than train from random weights while the config says
    'imagenet'."""
    if not backbone_weights:
        return None
    if backbone_weights not in NAMED_PRESETS:
        if not os.path.isfile(backbone_weights):
            raise FileNotFoundError(
                f"MODEL.backbone_weights file not found: "
                f"{backbone_weights!r}")
        return backbone_weights
    weights_dir = os.environ.get(WEIGHTS_DIR_ENV)
    if weights_dir:
        for ext in (".npz", ".msgpack"):
            cand = os.path.join(
                weights_dir, f"{backbone_name}_{backbone_weights}{ext}")
            if os.path.isfile(cand):
                return cand
    raise FileNotFoundError(
        f"MODEL.backbone_weights: {backbone_weights!r} is a named preset; "
        f"this framework performs no downloads. Convert a checkpoint with "
        f"the keras_*_to_flax / torch_resnet_to_flax converters "
        f"(embeddingnet_tpu.models.pretrained), save it as "
        f"<dir>/{backbone_name}_{backbone_weights}.npz, and set "
        f"{WEIGHTS_DIR_ENV}=<dir> — or set backbone_weights to a local "
        f"file path / null.")


def flatten_params(variables) -> Dict[str, np.ndarray]:
    """``{"params/a/b/kernel": array}`` of a variables tree (nested dicts),
    or of a module's (:func:`~embeddingnet_tpu_torch.models.convert.
    torch_to_flax`): the ``.npz`` exchange format."""
    if isinstance(variables, nn.Module):
        variables = torch_to_flax(variables)
    return {"/".join(path): np.asarray(value)
            for path, value in _leaves(variables)}


def _read_weights(weights_path: str) -> Tuple[Dict[str, np.ndarray], bool]:
    """The file's flat ``{path: array}`` and whether its restore is strict
    (``.msgpack``, Flax's ``from_bytes``) or partial (``.npz``)."""
    if weights_path.endswith(".msgpack"):
        with open(weights_path, "rb") as f:
            tree = msgpack_restore(f.read())
        return {"/".join(path): value
                for path, value in _leaves(tree)}, True
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as archive:
            return dict(archive), False
    raise ValueError(
        f"unsupported weights file {weights_path!r} (.msgpack or .npz; "
        f".h5 files go through the keras_*_to_flax converters)")


@torch.no_grad()
def load_into(module: nn.Module, weights_path: str) -> nn.Module:
    """Load a local weights file into ``module`` in place, by Flax names
    (the module docstring's semantics); returns ``module``."""
    flat, strict = _read_weights(weights_path)
    current = flatten_params(module)
    if strict:
        missing = sorted(set(current) - set(flat))
        if missing:
            raise ValueError(
                f"The target dict keys and state dict keys do not match: "
                f"{weights_path!r} lacks {missing[:8]}")
    for key, leaf in current.items():
        if key in flat:
            arr = np.asarray(flat[key])
            if arr.shape != leaf.shape:
                raise ValueError(
                    f"shape mismatch for {key}: file {arr.shape} vs "
                    f"model {leaf.shape}")
            current[key] = arr.astype(leaf.dtype)
    state = flax_to_torch(_unflatten(current), module)
    target = module.state_dict()
    for key, value in state.items():
        if not key.endswith("num_batches_tracked"):
            target[key].copy_(value)
    return module


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


# -- Flax's msgpack, read without msgpack --------------------------------

# Flax's ext type codes (flax.serialization._MsgpackExtType)
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """The msgpack subset that ``flax.serialization.msgpack_serialize``
    writes."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("msgpack data ends early")
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self):
        b = self.uint(1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode()
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        if b in (0xc4, 0xc5, 0xc6):                       # bin 8/16/32
            return bytes(self.take(self.uint(1 << (b - 0xc4))))
        if b in (0xc7, 0xc8, 0xc9):                       # ext 8/16/32
            n = self.uint(1 << (b - 0xc7))
            return self.ext(n)
        if b == 0xca:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xcb:
            return struct.unpack(">d", self.take(8))[0]
        if 0xcc <= b <= 0xcf:                             # uint 8-64
            return self.uint(1 << (b - 0xcc))
        if 0xd0 <= b <= 0xd3:                             # int 8-64
            n = 1 << (b - 0xd0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xd4 <= b <= 0xd8:                             # fixext 1-16
            return self.ext(1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):                       # str 8/16/32
            return bytes(self.take(self.uint(1 << (b - 0xd9)))).decode()
        if b in (0xdc, 0xdd):                             # array 16/32
            return [self.value() for _ in range(self.uint(2 << (b - 0xdc)))]
        if b in (0xde, 0xdf):                             # map 16/32
            return self.map(self.uint(2 << (b - 0xde)))
        raise ValueError(f"msgpack type byte {b:#x} is not in Flax's subset")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = int.from_bytes(self.take(1), "big", signed=True)
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not Flax's "
                             f"ndarray or numpy scalar")
        shape, dtype, buffer = _Reader(payload).value()
        if dtype == "bfloat16":
            words = np.frombuffer(buffer, np.uint16).astype(np.uint32)
            arr = (words << 16).view(np.float32)
        else:
            arr = np.frombuffer(buffer, np.dtype(dtype))
        arr = arr.reshape(shape).copy()
        return arr[()] if code == _EXT_NPSCALAR else arr


def _unchunk(tree):
    """Flax splits arrays over 2**30 bytes into a ``__msgpack_chunked_
    array__`` dict of flat chunks; join them back."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        chunks = tree["chunks"]
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
        return flat.reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def msgpack_restore(data: bytes) -> Dict[str, Any]:
    """Flax's ``serialization.msgpack_restore``: the nested dict of numpy
    arrays (bfloat16 leaves as float32) that ``to_bytes`` wrote."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


# -- converters from a torch state_dict ----------------------------------

def _array(state_dict, name: str) -> np.ndarray:
    v = state_dict[name]
    return v.detach().cpu().numpy() if hasattr(v, "detach") else \
        np.asarray(v)


def torch_resnet_to_flax(state_dict, stage_sizes):
    """torchvision-format ResNet ``state_dict`` -> (params, batch_stats) for
    the ResNet built with the torch conventions: ``stride_in_3x3=True``
    (v1.5), ``use_bias=False``, ``bn_epsilon=1e-5``.

    ``conv1``/``bn1`` -> ``stem_conv``/``stem_bn``;
    ``layer{s}.{b}.conv{i}``/``bn{i}`` -> ``stage{s}_block{b+1}/conv{i}``/
    ``bn{i}``; ``downsample.0``/``.1`` -> ``downsample_conv``/``_bn``.
    Kernels OIHW -> HWIO; the classifier ``fc.*`` is dropped. Values may be
    torch tensors or numpy arrays."""
    def conv(name):
        return {"kernel": np.transpose(_array(state_dict, name + ".weight"),
                                       (2, 3, 1, 0))}

    def bn(name):
        return ({"scale": _array(state_dict, name + ".weight"),
                 "bias": _array(state_dict, name + ".bias")},
                {"mean": _array(state_dict, name + ".running_mean"),
                 "var": _array(state_dict, name + ".running_var")})

    params: Dict[str, Any] = {"stem_conv": conv("conv1")}
    stats: Dict[str, Any] = {}
    params["stem_bn"], stats["stem_bn"] = bn("bn1")

    n_convs = 3 if any(k.startswith("layer1.0.conv3")
                       for k in state_dict) else 2
    for s, n_blocks in enumerate(stage_sizes, start=1):
        for b in range(n_blocks):
            prefix = f"layer{s}.{b}"
            fb: Dict[str, Any] = {}
            sb: Dict[str, Any] = {}
            for i in range(1, n_convs + 1):
                fb[f"conv{i}"] = conv(f"{prefix}.conv{i}")
                fb[f"bn{i}"], sb[f"bn{i}"] = bn(f"{prefix}.bn{i}")
            if f"{prefix}.downsample.0.weight" in state_dict:
                fb["downsample_conv"] = conv(f"{prefix}.downsample.0")
                fb["downsample_bn"], sb["downsample_bn"] = bn(
                    f"{prefix}.downsample.1")
            key = f"stage{s}_block{b + 1}"
            params[key] = fb
            stats[key] = sb
    return params, stats


def _attention(state_dict, names, dim, heads):
    """Flax ``MultiHeadDotProductAttention`` params from torch
    ``[D_out, D_in]`` q/k/v/out projections named ``names``."""
    hd = dim // heads

    def qkv(name):
        w = _array(state_dict, name + ".weight")
        return {"kernel": w.T.reshape(dim, heads, hd),
                "bias": _array(state_dict, name + ".bias").reshape(heads, hd)}

    q, k, v, out = names
    out_w = _array(state_dict, out + ".weight")
    return {"query": qkv(q), "key": qkv(k), "value": qkv(v),
            "out": {"kernel": out_w.T.reshape(heads, hd, dim),
                    "bias": _array(state_dict, out + ".bias")}}


def _ln(state_dict, name):
    return {"scale": _array(state_dict, name + ".weight"),
            "bias": _array(state_dict, name + ".bias")}


def _dense(state_dict, name):
    return {"kernel": _array(state_dict, name + ".weight").T,
            "bias": _array(state_dict, name + ".bias")}


def hf_vit_to_flax(state_dict, depth: int):
    """HuggingFace ``transformers.ViTModel`` state_dict -> params for the
    ViT: ``vit.embeddings.patch_embeddings.projection`` -> ``patch_embed``
    (OIHW -> HWIO); ``cls_token``/``position_embeddings`` as they are;
    ``vit.encoder.layer.{i}`` -> ``block{i+1}`` (``layernorm_before``/
    ``after`` -> ``ln1``/``ln2``, q/k/v/out to Flax's [D, H, hd] /
    [H, hd, D] layout, ``intermediate``/``output.dense`` -> ``mlp.fc1``/
    ``fc2``); ``vit.layernorm`` -> ``ln_final``; a pooler is dropped. The
    heads are ``dim // 64`` unless ``state_dict["__num_heads__"]`` says."""
    pe = _array(state_dict, "vit.embeddings.patch_embeddings.projection"
                            ".weight")
    dim = pe.shape[0]
    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": np.transpose(pe, (2, 3, 1, 0)),
            "bias": _array(state_dict,
                           "vit.embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": _array(state_dict, "vit.embeddings.cls_token"),
        "pos_embed": _array(state_dict, "vit.embeddings.position_embeddings"),
        "ln_final": _ln(state_dict, "vit.layernorm"),
    }
    heads = int(state_dict.get("__num_heads__", dim // 64))
    for i in range(depth):
        p = f"vit.encoder.layer.{i}"
        params[f"block{i + 1}"] = {
            "ln1": _ln(state_dict, f"{p}.layernorm_before"),
            "attn": _attention(state_dict, (
                f"{p}.attention.attention.query",
                f"{p}.attention.attention.key",
                f"{p}.attention.attention.value",
                f"{p}.attention.output.dense"), dim, heads),
            "ln2": _ln(state_dict, f"{p}.layernorm_after"),
            "mlp": {"fc1": _dense(state_dict, f"{p}.intermediate.dense"),
                    "fc2": _dense(state_dict, f"{p}.output.dense")},
        }
    return params


def clip_vit_to_flax(state_dict, depth: int):
    """HuggingFace CLIP vision tower state_dict (``vision_model.*`` keys,
    or a full ``CLIPModel``'s) -> params for the ViT with the CLIP flags:
    ``patch_embedding`` (OIHW, no bias) -> ``patch_embed``;
    ``class_embedding`` [D] -> ``cls_token`` [1, 1, D];
    ``position_embedding.weight`` [L, D] -> ``pos_embed`` [1, L, D];
    ``pre_layrnorm`` (HF's spelling) -> ``ln_pre``; ``encoder.layers.{i}``
    -> ``block{i+1}`` (``layer_norm1``/``2`` -> ``ln1``/``ln2``,
    ``self_attn.{q,k,v,out}_proj`` to Flax's attention layout, ``mlp.fc1``/
    ``fc2``); ``post_layernorm`` -> ``ln_final``;
    ``visual_projection.weight`` [P, D] -> ``proj.kernel`` [D, P] (left out
    when absent: load into a ``proj_dim=None`` module)."""
    vm = ("vision_model." if any(k.startswith("vision_model.")
                                 for k in state_dict) else "")
    pe = _array(state_dict, f"{vm}embeddings.patch_embedding.weight")
    dim = pe.shape[0]
    params: Dict[str, Any] = {
        "patch_embed": {"kernel": np.transpose(pe, (2, 3, 1, 0))},
        "cls_token": _array(state_dict, f"{vm}embeddings.class_embedding"
                            ).reshape(1, 1, dim),
        "pos_embed": _array(state_dict,
                            f"{vm}embeddings.position_embedding.weight")[
            None, :, :],
        "ln_pre": _ln(state_dict, f"{vm}pre_layrnorm"),
        "ln_final": _ln(state_dict, f"{vm}post_layernorm"),
    }
    for proj_key in ("visual_projection.weight",
                     f"{vm}visual_projection.weight"):
        if proj_key in state_dict:
            params["proj"] = {"kernel": _array(state_dict, proj_key).T}
            break
    heads = int(state_dict.get("__num_heads__", dim // 64))
    for i in range(depth):
        p = f"{vm}encoder.layers.{i}"
        params[f"block{i + 1}"] = {
            "ln1": _ln(state_dict, f"{p}.layer_norm1"),
            "attn": _attention(state_dict, (
                f"{p}.self_attn.q_proj", f"{p}.self_attn.k_proj",
                f"{p}.self_attn.v_proj", f"{p}.self_attn.out_proj"),
                dim, heads),
            "ln2": _ln(state_dict, f"{p}.layer_norm2"),
            "mlp": {"fc1": _dense(state_dict, f"{p}.mlp.fc1"),
                    "fc2": _dense(state_dict, f"{p}.mlp.fc2")},
        }
    return params
