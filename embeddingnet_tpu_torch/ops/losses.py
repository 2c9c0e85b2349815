"""Loss functions and metrics (port of ``embeddingnet_tpu/ops/losses.py``):
the contrastive loss and pair accuracy of siamese training, the triplet
hinge on a concatenated ``[a‖p‖n]`` embedding and on separate ones, the
softmax cross-entropy of the pretraining phase and the ArcFace
additive-angular-margin loss.

The last two take a model group (``tp``, a :class:`~embeddingnet_tpu_torch.
parallel.collectives.ModelParallel`) when the class axis is split over it
(:mod:`~embeddingnet_tpu_torch.parallel.tp`): each rank then holds the
logits (or class weights) of its span of classes, the softmax's max and
sum of exponentials are all-reduced (MAX, then SUM), the target logit comes
from the rank that holds the label, and the gradient is the one-process
loss's, each rank's for its classes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from embeddingnet_tpu_torch.models.heads import at_least_f32
from embeddingnet_tpu_torch.parallel.collectives import copy_to_model


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


class _ClassParallelCrossEntropy(torch.autograd.Function):
    """Per-row cross-entropy of logits split by class over a model group:
    ``log(sum exp(z - m)) + m - z_target``, the sums over every rank's
    classes; backward ``(softmax - onehot) * g`` on this rank's classes."""

    @staticmethod
    def forward(ctx, logits, onehot, group):
        m = logits.detach().amax(-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m)
        total = e.sum(-1, keepdim=True)
        dist.all_reduce(total, group=group)
        target = (onehot * logits).sum(-1, keepdim=True)
        dist.all_reduce(target, group=group)
        ctx.save_for_backward(e / total, onehot)
        return (torch.log(total) + m - target)[:, 0]

    @staticmethod
    def backward(ctx, g):
        probs, onehot = ctx.saved_tensors
        return (probs - onehot) * g[:, None], None, None


def softmax_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor,
                          tp: Optional[object] = None) -> torch.Tensor:
    """Categorical cross-entropy, ``-mean(sum(onehot * log_softmax))``,
    with the log-softmax written as the JAX function writes it. With
    ``tp`` the class axis of ``logits`` and ``onehot`` is this rank's span
    of the classes (the module docstring)."""
    if tp is not None and tp.size > 1:
        return _ClassParallelCrossEntropy.apply(logits, onehot,
                                                tp.group).mean()
    m = logits.amax(-1, keepdim=True)
    log_probs = (logits - torch.log(torch.exp(logits - m).sum(
        -1, keepdim=True)) - m)
    return -(onehot * log_probs).sum(-1).mean()


def one_hot(labels: torch.Tensor, num_classes: int,
            offset: int = 0) -> torch.Tensor:
    """f32 ``[B, num_classes]`` one-hot rows of integer ``labels`` over the
    classes ``offset .. offset + num_classes - 1`` (a row is zero where its
    label lies outside them)."""
    classes = offset + torch.arange(num_classes, device=labels.device)
    return (labels[:, None] == classes[None, :]).float()


def arcface_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                 class_weights: torch.Tensor, *, margin: float = 0.5,
                 scale: float = 64.0, tp: Optional[object] = None,
                 class_offset: int = 0) -> torch.Tensor:
    """ArcFace (Deng et al. 2019): the embeddings [B, D] and the class
    weights [C, D] L2-normalised, ``cos`` their f32 product (float64 for
    float64 inputs) clipped to +-(1 - 1e-7), the target class's angle
    ``arccos(cos)`` widened by ``margin`` (no easy-margin branch), logits
    ``scale`` times the cosines, then :func:`softmax_cross_entropy`.

    ``cos`` wants f32 products: at scale 64 a TF32 ``cos`` moves the
    logits by about 0.06, so callers on a card keep TF32 off. At a cosine
    exactly on the clip, JAX's ``clip`` gives half the gradient to each
    side and ``torch.clamp`` all of it to one; the parity tests' inputs
    stay off the clip.

    With ``tp``, ``class_weights`` are this rank's rows, the classes from
    ``class_offset`` on, and ``embeddings`` (whole on every rank) enter
    through ``copy_to_model``: their gradient sums every rank's part."""
    if tp is not None and tp.size > 1:
        embeddings = copy_to_model(embeddings, tp)

    def normalize(x):
        return x / torch.linalg.vector_norm(x, dim=-1,
                                            keepdim=True).clamp_min(1e-12)

    cos = torch.clamp(at_least_f32(normalize(embeddings))
                      @ at_least_f32(normalize(class_weights)).T,
                      -1.0 + 1e-7, 1.0 - 1e-7)
    onehot = one_hot(labels, class_weights.shape[0], class_offset)
    target_cos = torch.cos(torch.arccos(cos) + margin)
    logits = scale * torch.where(onehot > 0, target_cos, cos)
    return softmax_cross_entropy(logits, onehot, tp)
