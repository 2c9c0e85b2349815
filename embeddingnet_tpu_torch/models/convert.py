"""JAX checkpoints <-> the port's ``state_dict`` (the inverse, in spirit,
of ``embeddingnet_tpu/models/pretrained.py`` ``torch_resnet_to_flax``).

It covers every family of the port's registry and the heads and modules
built on them. The port's modules carry the Flax module names, so the
mapping is by leaf:

* conv ``kernel`` [H, W, I, O] -> ``weight`` [O, I, H, W], a depthwise
  kernel [k, k, 1, C] to the ``groups=C`` weight [C, 1, k, k] alike;
* Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in] (the
  squeeze-excitation Dense layers of the SE ResNets too);
* attention's DenseGeneral kernels -> Linear ``weight`` [out, in]: the
  ``query``/``key``/``value`` kernel [D, heads, head_dim] as
  [D, heads * head_dim], the ``out`` kernel [heads, head_dim, D] as
  [heads * head_dim, D], each transposed; their [heads, head_dim] biases
  flattened;
* ``bias`` -> ``bias`` (the squeeze-excitation convs' too);
* BatchNorm and LayerNorm ``scale``/``bias`` (params) and BatchNorm
  ``mean``/``var`` (batch_stats) -> ``weight``/``bias``/``running_mean``/
  ``running_var``, plus a zero ``num_batches_tracked``. A BatchNorm
  without ``scale`` (Flax's ``use_scale=False``, the Inceptions') keeps a
  unit ``weight`` outside the ``state_dict``, so neither side has the leaf;
* the raw parameters ``cls_token``, ``pos_embed`` (ViT) and
  ``class_weights`` (ArcFace) keep their names and shapes.

:func:`torch_to_flax` maps back, as numpy in Flax's layouts: the port
writes the exchange format (``models/pretrained.py``) with it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from embeddingnet_tpu_torch.models.vit import MultiHeadDotProductAttention


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


# parameters that are neither a kernel nor a bias nor a scale
_RAW = ("cls_token", "pos_embed", "class_weights")


def flax_to_torch(variables: Mapping[str, Any],
                  module: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert ``{"params": ..., "batch_stats": ...}`` (numpy or JAX arrays)
    into a ``state_dict`` for ``module``.

    Raises ``KeyError`` if a key of ``module.state_dict()`` has no source
    in ``variables`` (a missing key) or a converted key has no place in
    ``module`` (an extra key), and ``ValueError`` on a shape mismatch.
    """
    out: Dict[str, np.ndarray] = {}
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            prefix, leaf = ".".join(path[:-1]), path[-1]
            if collection == "params" and leaf == "kernel":
                if value.ndim == 3:
                    # DenseGeneral: "out" contracts its first two axes,
                    # query/key/value produce their last two
                    value = (value.reshape(-1, value.shape[-1])
                             if path[-2] == "out"
                             else value.reshape(value.shape[0], -1))
                value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                         else value.T)
                name = "weight"
            elif collection == "params" and leaf in ("bias", "scale"):
                name = "weight" if leaf == "scale" else "bias"
                if value.ndim == 2:           # a DenseGeneral bias
                    value = value.reshape(-1)
            elif collection == "params" and leaf in _RAW:
                name = leaf
            elif collection == "batch_stats" and leaf in ("mean", "var"):
                name = "running_" + leaf
                out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
            else:
                raise KeyError(f"unknown leaf {collection}/{'/'.join(path)}")
            out[f"{prefix}.{name}" if prefix else name] = value

    template = module.state_dict()
    missing = sorted(set(template) - set(out))
    extra = sorted(set(out) - set(template))
    if missing or extra:
        raise KeyError(f"checkpoint does not fit the module: missing "
                       f"{missing[:8]}, extra {extra[:8]}")
    state = {}
    for key, ref in template.items():
        value = out[key]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} in the "
                             f"checkpoint, {tuple(ref.shape)} in the module")
        # a copy: JAX hands out read-only buffers
        state[key] = torch.from_numpy(np.array(value)).to(ref.dtype)
    return state


def _put(tree: Dict[str, Any], path: str, leaf: str, value) -> None:
    node = tree
    for key in path.split(".") if path else ():
        node = node.setdefault(key, {})
    node[leaf] = value


def torch_to_flax(module: nn.Module) -> Dict[str, Dict[str, Any]]:
    """``{"params": ..., "batch_stats": ...}`` of ``module`` as nested
    dicts of numpy arrays in Flax's layouts and dtypes (float32, or the
    module's), the inverse of :func:`flax_to_torch`; ``batch_stats`` is
    left out when the module has no BatchNorm."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    heads = {name: m.heads for name, m in module.named_modules()
             if isinstance(m, MultiHeadDotProductAttention)}

    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    for name, m in module.named_modules():
        own = dict(m.named_parameters(recurse=False))
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            for leaf, key in (("mean", "running_mean"),
                              ("var", "running_var")):
                _put(stats, name, leaf, arr(getattr(m, key)))
        parent, _, leaf_name = name.rpartition(".")
        for key, p in own.items():
            value = arr(p)
            if isinstance(m, (nn.Conv2d, nn.Linear)) and key == "weight":
                if value.ndim == 4:
                    value = value.transpose(2, 3, 1, 0)
                else:
                    value = value.T
                    if parent in heads:      # a DenseGeneral of attention
                        h = heads[parent]
                        value = (value.reshape(h, -1, value.shape[-1])
                                 if leaf_name == "out" else
                                 value.reshape(value.shape[0], h, -1))
                key = "kernel"
            elif key == "bias" and parent in heads and leaf_name != "out":
                value = value.reshape(heads[parent], -1)
            elif key == "weight":            # BatchNorm, LayerNorm
                key = "scale"
            _put(params, name, key, value)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
