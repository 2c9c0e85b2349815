"""Loss functions (port of ``embeddingnet_tpu/ops/losses.py``).

Only the triplet hinge of the val epoch is ported so far; the other losses
are ``ROADMAP.md`` item 2.
"""

from __future__ import annotations

import torch


def triplet_hinge(emb_a: torch.Tensor, emb_p: torch.Tensor,
                  emb_n: torch.Tensor, margin: float = 0.5) -> torch.Tensor:
    """Per-sample ``max(|a - p|^2 - |a - n|^2 + margin, 0)`` over the last
    axis of the (anchor, positive, negative) embeddings."""
    pos_dist = (emb_a - emb_p).square().sum(-1)
    neg_dist = (emb_a - emb_n).square().sum(-1)
    return (pos_dist - neg_dist + margin).clamp_min(0.0)
