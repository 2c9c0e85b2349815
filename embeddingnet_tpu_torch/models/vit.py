"""Vision Transformer backbones (port of ``embeddingnet_tpu/models/vit.py``).

Pre-norm encoder blocks, learned position embeddings and a class token.
The backbone returns the patch-token grid with the class token folded in
(``grid + cls / (gh * gw)``), so the GAP embedding head of the CNNs applies
unchanged; here the grid is NCHW, as the head takes it.

Two families share the module:

* plain ViT (``vit-b16``, ``vit-b32``, ``vit-l16``): exact (erf) GELU, a
  biased patch embed, no LayerNorm before the blocks, LayerNorm eps 1e-12;
* the CLIP vision tower (``vit-l14``, ``clip-vit-b16``, ``clip-vit-b32``):
  ``ln_pre`` after the embedding, quick-GELU (``x * sigmoid(1.702 x)``), a
  bias-free patch embed, the ``proj`` Dense applied to every token, eps 1e-5.

Submodules carry the Flax names (``patch_embed``, ``block3.attn.query``,
``ln_final``, ...). Attention follows Flax's ``MultiHeadDotProductAttention``:
``query``/``key``/``value``/``out`` projections (a torch ``Linear`` each,
whose weight :func:`~embeddingnet_tpu_torch.models.convert.flax_to_torch`
reshapes from Flax's ``[D, heads, head_dim]`` kernels), q divided by
``sqrt(head_dim)`` before ``q @ k^T``, a softmax, ``@ v``, then ``out``. The
core between the projections is :func:`~embeddingnet_tpu_torch.ops.
attention.attention`: on the card one hand-written kernel forward and one
backward (``csrc/attention_sm90.cu``; on tensor cores in bf16 or fp16, their
instances without in float32 or float64), reading the heads in place from
the projections' ``[B, N, heads * head_dim]`` and writing the merged
result; on the CPU the eager matmuls and softmax. Parameters are f32;
matmuls and activations run in the compute dtype; LayerNorm takes its
statistics and applies its affine in f32 (the two-pass variance, where
Flax takes E[x^2] - E[x]^2: about 1e-6 apart in f32) and rounds once to
the compute dtype: :func:`~embeddingnet_tpu_torch.ops.layernorm.
layer_norm`, on the card one hand-written kernel forward and one backward
(``csrc/layernorm_sm90.cu``) that read the input in its own dtype, on the
CPU ``F.layer_norm`` on an f32 copy.

Spans (:mod:`~embeddingnet_tpu_torch.utils.trace`): ``attn`` covers the
attention core (the q scaling, the scores, the softmax, the value product:
on the card one kernel), the projections outside it;
``ln`` one :class:`LayerNorm` forward (on the card one launch, the forward
kernel); ``mlp`` one :class:`MlpBlock`
forward (``fc1``, the GELU, ``fc2``, their ``cast`` spans inside). Each
span opens again in a remat recompute; the backward runs in autograd,
outside them. :data:`LAUNCHES` counts the attention cores and LayerNorms
run, one per forward call (a recompute counts again), with the spans on
or off.

The position embedding is sized by the input (``gh * gw + 1`` tokens), as
Flax sizes it at ``init``, so a ViT is built for one ``image_size``.

Tensor parallelism (:mod:`~embeddingnet_tpu_torch.parallel.tp`): with a
model group in ``tp``, attention runs ``heads / size`` heads on the rows of
``query``/``key``/``value`` that hold them and the matching columns of
``out``, and the MLP ``fc1``'s rows and ``fc2``'s columns; each takes its
input through ``copy_to_model``, sums the partial ``out``/``fc2`` products
over the group with ``reduce_from_model`` and adds their bias once, after
the sum. Without one (``tp`` None) the graph is the one-process graph.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.models import remat
from embeddingnet_tpu_torch.models.heads import Dense, lecun_normal_
from embeddingnet_tpu_torch.models.resnet import Conv2d
from embeddingnet_tpu_torch.ops.attention import attention
from embeddingnet_tpu_torch.ops.fused_conv import cast
from embeddingnet_tpu_torch.ops.layernorm import layer_norm
from embeddingnet_tpu_torch.parallel.collectives import (copy_to_model,
                                                         reduce_from_model)
from embeddingnet_tpu_torch.utils import trace

# Attention cores and LayerNorms run in this process, one per forward call
# (a remat recompute counts again); a run reads their rise beside its
# profile.
LAUNCHES = {"attention": 0, "layernorm": 0}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation, ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm``: the statistics and the f32 affine on the
    input in f32 (a float64 module keeps float64), the result rounded once
    to the input's dtype (:func:`~embeddingnet_tpu_torch.ops.layernorm.
    layer_norm`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        LAUNCHES["layernorm"] += 1
        with trace.span("ln"):
            return layer_norm(x, self.weight, self.bias, self.eps)


def row_parallel(dense: Dense, x: torch.Tensor, tp) -> torch.Tensor:
    """``dense(x)`` where ``dense`` holds the columns of its weight that
    this rank's slice of ``x``'s features meets: the partial products
    summed over the model group, then the bias."""
    dtype = dense.compute_dtype or torch.promote_types(x.dtype,
                                                       dense.weight.dtype)
    x, weight, bias = cast(dtype, x, dense.weight, dense.bias)
    y = reduce_from_model(F.linear(x, weight), tp)
    return y if bias is None else y + bias


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention with Flax's names and order of operations."""

    tp = None       # the model group of a split layer (parallel/tp.py)

    def __init__(self, dim: int, heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} does not divide into {heads} heads")
        self.heads = heads
        self.query = Dense(dim, dim, dtype)
        self.key = Dense(dim, dim, dtype)
        self.value = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        heads = self.heads // (self.tp.size if self.tp else 1)
        x = copy_to_model(x, self.tp)
        q, k, v = self.query(x), self.key(x), self.value(x)
        LAUNCHES["attention"] += 1
        with trace.span("attn"):
            y = attention(q, k, v, heads)
        if self.tp is None:
            return self.out(y)
        return row_parallel(self.out, y, self.tp)


class MlpBlock(nn.Module):
    tp = None       # the model group of a split layer (parallel/tp.py)

    def __init__(self, dim: int, hidden: int, use_quick_gelu: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_quick_gelu = use_quick_gelu
        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("mlp"):
            x = self.fc1(copy_to_model(x, self.tp))
            x = quick_gelu(x) if self.use_quick_gelu else F.gelu(x)
            if self.tp is None:
                return self.fc2(x)
            return row_parallel(self.fc2, x, self.tp)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 use_quick_gelu: bool = False, ln_eps: float = 1e-12,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln1 = LayerNorm(dim, eps=ln_eps)
        self.attn = MultiHeadDotProductAttention(dim, heads, dtype)
        self.ln2 = LayerNorm(dim, eps=ln_eps)
        self.mlp = MlpBlock(dim, dim * mlp_ratio, use_quick_gelu, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    """[B, C, H, W] image batch -> [B, D, H/p, W/p] token grid, the class
    token folded in (D is ``proj_dim`` when set, else ``dim``)."""

    remat_blocks = True

    def __init__(self, image_size: Sequence[int], in_channels: int = 3,
                 patch: int = 16, dim: int = 768, depth: int = 12,
                 heads: int = 12, ln_pre: bool = False,
                 use_quick_gelu: bool = False, patch_bias: bool = True,
                 proj_dim: Optional[int] = None, ln_eps: float = 1e-12,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        h, w = image_size
        if h % patch or w % patch:
            raise ValueError(f"input {h}x{w} not divisible by patch {patch}")
        self.patch, self.dim = patch, dim
        self.grid = (h // patch, w // patch)
        self.out_channels = proj_dim or dim
        self.patch_embed = Conv2d(in_channels, dim, patch, stride=patch,
                                  bias=patch_bias, compute_dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1] + 1, dim))
        self.ln_pre = LayerNorm(dim, eps=ln_eps) if ln_pre else None
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i + 1}", EncoderBlock(
                dim, heads, use_quick_gelu=use_quick_gelu, ln_eps=ln_eps,
                dtype=dtype))
        self.ln_final = LayerNorm(dim, eps=ln_eps)
        self.proj = (Dense(dim, proj_dim, dtype, bias=False)
                     if proj_dim is not None else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initialisers: ``lecun_normal`` (a normal truncated at two
        standard deviations, variance 1 / fan_in) for every Dense and the
        patch conv, zero biases, LayerNorm 1 / 0, ``normal(0.02)`` for the
        class token and the position embedding."""
        for m in self.modules():
            if isinstance(m, (Dense, nn.Conv2d)):
                lecun_normal_(m, generator)
            elif isinstance(m, LayerNorm):
                m.reset_parameters()
        nn.init.normal_(self.cls_token, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        gh, gw = h // self.patch, w // self.patch
        if (gh, gw) != self.grid or h % self.patch or w % self.patch:
            raise ValueError(f"ViT built for {self.grid[0] * self.patch}x"
                             f"{self.grid[1] * self.patch} inputs, got "
                             f"{h}x{w}")
        x = self.patch_embed(x).flatten(2).transpose(1, 2)   # [B, L, D]
        dtype = x.dtype
        cls = self.cls_token.to(dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        for i in range(self.depth):
            x = remat.run(getattr(self, f"block{i + 1}"), x)
        x = self.ln_final(x)
        if self.proj is not None:
            x = self.proj(x)
        grid = x[:, 1:].reshape(b, gh, gw, x.shape[-1])
        # the class token weighs 1 / (gh * gw) against each patch in GAP
        grid = grid + x[:, :1, None, :] / (gh * gw)
        return grid.permute(0, 3, 1, 2)


_VARIANTS = {
    "vit-b32": dict(patch=32, dim=768, depth=12, heads=12),
    "vit-b16": dict(patch=16, dim=768, depth=12, heads=12),
    "vit-l16": dict(patch=16, dim=1024, depth=24, heads=16),
    # ViT-L/14 is CLIP's vision tower; projection 768 = its joint space
    "vit-l14": dict(patch=14, dim=1024, depth=24, heads=16,
                    ln_pre=True, use_quick_gelu=True, patch_bias=False,
                    proj_dim=768, ln_eps=1e-5),
    "clip-vit-b32": dict(patch=32, dim=768, depth=12, heads=12,
                         ln_pre=True, use_quick_gelu=True, patch_bias=False,
                         proj_dim=512, ln_eps=1e-5),
    "clip-vit-b16": dict(patch=16, dim=768, depth=12, heads=12,
                         ln_pre=True, use_quick_gelu=True, patch_bias=False,
                         proj_dim=512, ln_eps=1e-5),
}


def build_vit(name: str, input_shape: Sequence[int], **kw) -> ViT:
    """The ViT variant ``name`` for images of ``input_shape`` [H, W, C]."""
    if name not in _VARIANTS:
        raise ValueError(f"unknown vit variant {name!r}; "
                         f"valid: {sorted(_VARIANTS)}")
    h, w, c = input_shape
    return ViT((h, w), in_channels=c, **_VARIANTS[name], **kw)
