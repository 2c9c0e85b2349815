"""Operation and byte counts of a ViT under the ArcFace loss, by the rules of
:mod:`benchmark.flops` (an operation is a multiply or an add; a training
step counts three forwards; no recompute, augmentation, LayerNorm, softmax,
GELU or pooling).

A transformer's forward has products that :mod:`benchmark.flops`'s CNN rule
has no need of: besides the patch embed and every Dense layer (the q, k, v
and out projections, the MLP's two layers, the embedding head), the
attention's two batched products (``q k^T`` and the weights times ``v``),
each ``N^2 d`` multiply-accumulates a head, and the ArcFace cosine product
of the embeddings with the class weights.

The attention core's least time per call (:func:`attention_cost`) is the
bound of a fused kernel, whatever implements the core: the two products at
the bf16 peak, or q, k and v read and the merged output written once in
bf16 at the memory peak, whichever is longer.
"""

from __future__ import annotations

from typing import Tuple

from benchmark.reference.vit_arcface import Shape


def tokens(shape: Shape, image_size: int) -> int:
    """Patches and the class token."""
    return (image_size // shape.patch) ** 2 + 1


def forward_flops(shape: Shape, image_size: int, encodings_len: int,
                  n_classes: int) -> int:
    """Operations of one image's forward."""
    n, d = tokens(shape, image_size), shape.dim
    macs = (n - 1) * 3 * shape.patch ** 2 * d                 # patch embed
    per_block = (4 * n * d * d                                 # q, k, v, out
                 + 2 * n * d * shape.mlp                       # fc1, fc2
                 + 2 * n * n * d)                              # q k^T, w v
    macs += shape.depth * per_block
    macs += d * (encodings_len // 2) + encodings_len // 2 * encodings_len
    macs += encodings_len * n_classes                          # cosines
    return 2 * macs


def train_flops(shape: Shape, image_size: int, encodings_len: int,
                n_classes: int) -> int:
    """Operations of one image's training step: three forwards."""
    return 3 * forward_flops(shape, image_size, encodings_len, n_classes)


def attention_cost(batch: int, n: int, heads: int, head_dim: int,
                   elem_bytes: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one attention core over a batch: ``4 B h N^2
    d`` operations; q, k and v read and the output written once."""
    flops = 4 * batch * heads * n * n * head_dim
    nbytes = 4 * batch * n * heads * head_dim * elem_bytes
    return flops, nbytes
