"""Tensor parallelism over the model axis (port of
``embeddingnet_tpu/parallel/tp.py``).

JAX annotates parameter shardings over the mesh's ``model`` axis and lets
GSPMD insert the collectives. The port writes them out Megatron-style
over the ranks of a model group (:class:`~embeddingnet_tpu_torch.parallel.
collectives.ModelParallel`):

* a transformer MLP's ``fc1`` split by output features, ``fc2`` by input
  features (one all-reduce after ``fc2``);
* attention's ``query``/``key``/``value`` split by heads, ``out`` by its
  input features (one all-reduce after ``out``);
* the ArcFace ``class_weights`` and the softmax pretraining head's logits
  split by class (the softmax's max and sum of exponentials by
  all-reduce, ``ops/losses.py``).

Each rule names the suffix of a parameter's name (the port's names, which
are Flax's with ``weight`` for ``kernel``) and the dimension split; the
longest matching suffix wins, and a parameter of another rank than the
rule's, or matched by none, stays whole on every rank. So on a CNN no rule
matches and every rank of a model group computes the same thing. A split
follows ``torch.tensor_split``: where the size does not divide, the last
ranks hold one row fewer (GSPMD pads instead).

The layers that hold split parameters (``models/vit.py``
``MultiHeadDotProductAttention`` and ``MlpBlock``, ``models/heads.py``
``SoftmaxHead``, ``models/registry.py`` ``ArcFaceModule``) declare a
``tp`` attribute, which :func:`shard_module` sets. :func:`gather_state`
and :func:`slice_state` turn a train state's slices into whole tensors
and back (parameters, the optimizer's moments, the EMA; BatchNorm
statistics are never split), so a checkpoint holds whole tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from embeddingnet_tpu_torch.parallel.collectives import (ModelParallel,
                                                         gather_slices)

# (name suffix, the split dimension of the port's tensor, its rank). The
# JAX rule each row ports, in Flax's layout: Dense kernels are [in, out]
# where the port's weights are [out, in]; attention's DenseGeneral kernels
# [D, heads, head_dim] (query/key/value) and [heads, head_dim, D] (out)
# are the port's [heads * head_dim, D] and [D, heads * head_dim].
RULES: Tuple[Tuple[Tuple[str, ...], int, int], ...] = (
    # ("mlp", "fc1", "kernel"): P(None, "model")
    (("mlp", "fc1", "weight"), 0, 2),
    # ("mlp", "fc1", "bias"): P("model")
    (("mlp", "fc1", "bias"), 0, 1),
    # ("mlp", "fc2", "kernel"): P("model", None)
    (("mlp", "fc2", "weight"), 1, 2),
    # ("query" | "key" | "value", "kernel"): P(None, "model", None)
    (("attn", "query", "weight"), 0, 2),
    (("attn", "key", "weight"), 0, 2),
    (("attn", "value", "weight"), 0, 2),
    # ("query" | "key" | "value", "bias"): P("model", None)
    (("attn", "query", "bias"), 0, 1),
    (("attn", "key", "bias"), 0, 1),
    (("attn", "value", "bias"), 0, 1),
    # ("out", "kernel"): P("model", None, None)
    (("attn", "out", "weight"), 1, 2),
    # ("class_weights",): P("model", None)
    (("class_weights",), 0, 2),
    # ("softmax_head", "logits", "kernel"): P(None, "model")
    (("softmax_head", "logits", "weight"), 0, 2),
    # ("softmax_head", "logits", "bias"): P("model")
    (("softmax_head", "logits", "bias"), 0, 1),
)


def shard_dim(name: str, ndim: int) -> Optional[int]:
    """The dimension along which the parameter ``name`` of rank ``ndim``
    is split over the model group, or None (whole on every rank)."""
    keys = tuple(name.split("."))
    best = None
    for suffix, dim, rank in RULES:
        if keys[-len(suffix):] == suffix and (
                best is None or len(suffix) > len(best[0])):
            best = (suffix, dim, rank)
    if best is None or best[2] != ndim:
        return None
    return best[1]


def _owner(module: nn.Module, name: str) -> nn.Module:
    """The layer that computes with the parameter ``name``: the module
    holding it, or that module's parent when it is a Dense."""
    path = name.rsplit(".", 1)[0] if "." in name else ""
    owner = module.get_submodule(path)
    if isinstance(owner, nn.Linear):
        parent = path.rsplit(".", 1)[0] if "." in path else ""
        owner = module.get_submodule(parent)
    return owner


def shard_module(module: nn.Module, tp: Optional[ModelParallel]
                 ) -> nn.Module:
    """Keep this rank's slice of every parameter a rule matches, in place,
    and hand ``tp`` to the layers that hold them. A no-op without a model
    group (``tp`` None or of one rank) and where no rule matches (a CNN).
    Returns ``module``, which records
    the splits as ``tp_shards`` (name -> (dim, whole size)) and ``tp``
    as ``model_parallel``."""
    if tp is None or tp.size == 1:
        return module
    if getattr(module, "tp_shards", None):
        raise ValueError("the module is sharded already")
    shards: Dict[str, Tuple[int, int]] = {}
    for name, p in module.named_parameters():
        dim = shard_dim(name, p.ndim)
        if dim is None:
            continue
        owner = _owner(module, name)
        if not hasattr(owner, "tp"):
            raise TypeError(f"{name} matches a tensor-parallel rule, but "
                            f"{type(owner).__name__} does not compute "
                            f"with a slice of it")
        heads = getattr(owner, "heads", None)
        if heads is not None and heads % tp.size:
            raise ValueError(f"{heads} attention heads do not divide over "
                             f"MESH.model={tp.size}")
        owner.tp = tp
        shards[name] = (dim, p.shape[dim])
    if not shards:
        return module
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name in shards:
                dim, n = shards[name]
                lo, hi = tp.span(n)
                p.data = p.data.narrow(dim, lo, hi - lo).clone()
    module.tp_shards = shards
    module.model_parallel = tp
    return module


def _optimizer_names(state) -> Dict[int, str]:
    """The index of each parameter in the optimizer's ``state_dict`` ->
    its name in the module."""
    names = {id(p): n for n, p in state.module.named_parameters()}
    out, index = {}, 0
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            out[index] = names[id(p)]
            index += 1
    return out


def _map_sharded(state, tree: dict, fn) -> dict:
    """``tree`` (a :meth:`TrainState.state_dict`) with ``fn(tensor, dim,
    n)`` applied to every split tensor: the module's parameters, their
    optimizer moments (the entries of their parameter's shape) and the
    EMA."""
    shards = getattr(state.module, "tp_shards", None) or {}
    out = dict(tree)
    out["module"] = {k: fn(v, *shards[k]) if k in shards else v
                     for k, v in tree["module"].items()}
    if tree.get("ema") is not None:
        out["ema"] = {k: fn(v, *shards[k]) if k in shards else v
                      for k, v in tree["ema"].items()}
    names = _optimizer_names(state)
    opt = dict(tree["optimizer"])
    opt["state"] = {}
    for index, entry in tree["optimizer"]["state"].items():
        name = names[index]
        if name not in shards:
            opt["state"][index] = entry
            continue
        ndim = len(dict(state.module.named_parameters())[name].shape)
        opt["state"][index] = {
            k: fn(v, *shards[name]) if torch.is_tensor(v) and v.ndim == ndim
            else v for k, v in entry.items()}
    out["optimizer"] = opt
    return out


def gather_state(state) -> dict:
    """``state.state_dict()`` with whole tensors in place of this rank's
    slices (a collective: every rank of the model group calls it). Without
    a model group, ``state.state_dict()`` itself."""
    tp = getattr(state.module, "model_parallel", None)
    tree = state.state_dict()
    if tp is None:
        return tree
    return _map_sharded(state, tree,
                        lambda v, dim, n: gather_slices(v, dim, n, tp))


def slice_state(tree: dict, state) -> dict:
    """A state dict of whole tensors (:func:`gather_state`'s, or a
    one-process run's) cut to this rank's slices of ``state``'s module; as
    it is without a model group."""
    tp = getattr(state.module, "model_parallel", None)
    if tp is None:
        return tree

    def cut(v, dim, n):
        if v.shape[dim] != n:
            raise ValueError(f"a whole tensor of {n} along dim {dim} "
                             f"expected, got shape {tuple(v.shape)}")
        lo, hi = tp.span(n)
        return v.narrow(dim, lo, hi - lo).clone()
    return _map_sharded(state, tree, cut)


def gather_module_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with whole tensors (a collective over the
    model group; the state dict itself when the module is not sharded)."""
    tp = getattr(module, "model_parallel", None)
    shards = getattr(module, "tp_shards", None) or {}
    sd = module.state_dict()
    if tp is None:
        return dict(sd)
    return {k: gather_slices(v, *shards[k], tp) if k in shards else v
            for k, v in sd.items()}
