"""Pairwise distances (port of ``embeddingnet_tpu/ops/distances.py``).

The squared-L2 matrix is one Gram matmul plus rank-1 updates
(``d2 = |a|^2 + |b|^2 - 2 a.b^T``), in float32 whatever the input dtype.
The form cancels badly near the diagonal, so the Gram must run in full
float32: on a CUDA card that needs ``torch.backends.cuda.matmul.allow_tf32``
False (PyTorch's default; :class:`~embeddingnet_tpu_torch.models.api.
EmbeddingNet` sets it explicitly on a CUDA device).
"""

from __future__ import annotations

from typing import Optional

import torch


def pairwise_sq_l2(a: torch.Tensor,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared euclidean distance matrix ``[Na, Nb]`` in float32.

    Tiny negatives from cancellation are clamped to 0; with ``b`` omitted
    (the symmetric case) the diagonal is exactly 0, as sklearn has it.
    """
    symmetric = b is None
    a = a.float()
    b = a if symmetric else b.float()
    gram = a @ b.T
    d2 = (a.square().sum(-1)[:, None] + b.square().sum(-1)[None, :]
          - 2.0 * gram)
    d2 = d2.clamp_min(0.0)
    if symmetric:
        d2.fill_diagonal_(0.0)
    return d2


def pairwise_l2(a: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euclidean distance matrix, the square root of :func:`pairwise_sq_l2`
    (sklearn's default metric, which the reference mines with)."""
    return pairwise_sq_l2(a, b).sqrt()


def pairwise_l1(a: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Manhattan distance matrix ``[Na, Nb]`` in float32, elementwise
    (``O(Na Nb D)``; no matmul form exists for L1)."""
    a = a.float()
    b = a if b is None else b.float()
    return (a[:, None, :] - b[None, :, :]).abs().sum(-1)


def pairwise_cosine(a: torch.Tensor, b: Optional[torch.Tensor] = None,
                    eps: float = 1e-12) -> torch.Tensor:
    """Cosine distance (1 - cosine similarity) matrix ``[Na, Nb]``, each
    row normalised by ``max(|x|, eps)``."""
    a = a.float()
    b = a if b is None else b.float()
    a_n = a / a.norm(dim=-1, keepdim=True).clamp_min(eps)
    b_n = b / b.norm(dim=-1, keepdim=True).clamp_min(eps)
    return 1.0 - a_n @ b_n.T
