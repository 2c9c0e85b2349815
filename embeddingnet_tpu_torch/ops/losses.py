"""Loss functions and metrics (port of ``embeddingnet_tpu/ops/losses.py``):
the contrastive loss and pair accuracy of siamese training, the triplet
hinge on a concatenated ``[a‖p‖n]`` embedding and on separate ones.
``softmax_cross_entropy`` and ``arcface_loss`` come with their train steps
(``ROADMAP.md``, item 11).
"""

from __future__ import annotations

from typing import Callable

import torch


def contrastive_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
                     margin: float = 1.0) -> torch.Tensor:
    """Contrastive loss (Hadsell et al. 2006):
    ``mean(y d^2 + (1 - y) max(margin - d, 0)^2)``, ``y_pred`` the distance
    of each pair and ``y_true`` 1 for a same-class pair, 0 otherwise."""
    y_true = y_true.to(y_pred.dtype)
    margin_square = (margin - y_pred).clamp_min(0.0).square()
    return (y_true * y_pred.square()
            + (1.0 - y_true) * margin_square).mean()


def triplet_loss(margin: float = 0.5
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-sample triplet hinge on a concatenated ``[a‖p‖n]`` embedding: the
    last axis splits into thirds, distances are squared L2, and the result
    is ``max(d_ap - d_an + margin, 0)`` per sample (no mean)."""

    def loss_function(merged: torch.Tensor) -> torch.Tensor:
        third = merged.shape[-1] // 3
        return triplet_hinge(merged[:, :third], merged[:, third:2 * third],
                             merged[:, 2 * third:], margin)

    return loss_function


def triplet_hinge(emb_a: torch.Tensor, emb_p: torch.Tensor,
                  emb_n: torch.Tensor, margin: float = 0.5) -> torch.Tensor:
    """Per-sample ``max(|a - p|^2 - |a - n|^2 + margin, 0)`` over the last
    axis of the (anchor, positive, negative) embeddings."""
    pos_dist = (emb_a - emb_p).square().sum(-1)
    neg_dist = (emb_a - emb_n).square().sum(-1)
    return (pos_dist - neg_dist + margin).clamp_min(0.0)


def accuracy(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Pair accuracy with the reference's fixed 0.5 distance threshold: a
    pair closer than 0.5 is called same-class."""
    pred = (y_pred < 0.5).to(y_true.dtype)
    return (y_true == pred).float().mean()
