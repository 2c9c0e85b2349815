"""Batch-all online triplet mining on P-K batches (port of the batch-all
fast path of ``embeddingnet_tpu/ops/mining.py``).

For each anchor ``a``, positive ``p`` (same label, ``p != a``) and negative
``n`` (other label), the batch-all loss sums the hinges
``max(sq(a,p) - sq(a,n) + margin, 0)`` over every valid triplet (squared L2,
as the reference's loss) and divides by the number of active (positive)
hinges. On a grouped P-K batch (``k_classes`` blocks of ``k_samples``
adjacent images of one class, as ``PKSampler`` draws them) each anchor has
exactly ``K - 1`` positives, so the per-pair sums come from one [B, B, K]
compare of the negative distances against the ``K`` per-anchor thresholds
``sq(a,p) + margin``, with no [B, B, B] tensor. The gradient is analytic
(:class:`_BatchAllLoss`): with the per-pair active counts ``k`` and the
per-negative counts ``m`` as weights ``W``,
``dL/de = 2 * (rowsum(S) * e - S @ e)``, ``S = W + W^T``, as a few matmuls.

Passing ``max_positives = K - 1`` asserts the grouped layout: a batch that
breaks it poisons loss, gradient and stats with NaN (and the triplet counts
with -1), as in the JAX package.

This is eager PyTorch: at B=1024, K=4 the compare tensor is 16.8 MB. The
other mining modes, the generic-label path (``batch_all_rowblock``) and a
fused Triton miner are still to port (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from embeddingnet_tpu_torch.ops.distances import pairwise_sq_l2

PARITY_MODES = ("semihard", "hardest", "random_hard")
FAST_MODES = ("batch_hard", "batch_all")
ALL_MODES = PARITY_MODES + FAST_MODES


class MiningStats(NamedTuple):
    """Per-step observability of the miner (scalars on the device)."""

    n_triplets: torch.Tensor      # number of active triplets
    n_candidates: torch.Tensor    # number of valid (anchor, positive, negative)
    frac_mined: torch.Tensor      # n_triplets / n_candidates
    mean_pos_dist: torch.Tensor   # mean euclidean d(a, p) over valid pairs
    mean_neg_dist: torch.Tensor   # mean euclidean d(a, n) over valid pairs


def _masks(labels: torch.Tensor):
    """(positive-pair mask without self, negative mask)."""
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    return same & ~eye, ~same


def _stats(dist, pos_mask, neg_mask, n_triplets, n_candidates) -> MiningStats:
    pos_cnt = pos_mask.sum().clamp_min(1)
    neg_cnt = neg_mask.sum().clamp_min(1)
    return MiningStats(
        n_triplets=n_triplets,
        n_candidates=n_candidates,
        frac_mined=n_triplets.float() / n_candidates.float().clamp_min(1.0),
        mean_pos_dist=(dist * pos_mask).sum() / pos_cnt,
        mean_neg_dist=(dist * neg_mask).sum() / neg_cnt,
    )


def _pk_is_fast_path(b: int, max_positives: Optional[int]) -> bool:
    """The grouped P-K compare-reduce path applies."""
    k_samples = (max_positives + 1) if max_positives is not None else None
    return bool(k_samples and 1 < k_samples < b and b % k_samples == 0)


def _pk_grouped(labels: torch.Tensor, k_samples: int) -> torch.Tensor:
    """The batch is grouped P-K with no class split across groups (each
    anchor has exactly ``k_samples - 1`` positives); a bool on the
    device."""
    b = labels.shape[0]
    blocks = labels.reshape(b // k_samples, k_samples)
    grouped = (blocks == blocks[:, :1]).all()
    pos_counts = (labels[:, None] == labels[None, :]).sum(1) - 1
    return grouped & (pos_counts == k_samples - 1).all()


def _pk_group_sq(embeddings: torch.Tensor, k_samples: int) -> torch.Tensor:
    """[g, K, K] within-group squared L2 of a grouped P-K batch, from the
    embeddings (``|a|^2 + |b|^2 - 2ab``, f32, clamped at 0)."""
    b, d = embeddings.shape
    eg = embeddings.reshape(b // k_samples, k_samples, d).float()
    gram = eg @ eg.transpose(1, 2)
    n = eg.square().sum(-1)
    return (n[:, :, None] + n[:, None, :] - 2.0 * gram).clamp_min(0.0)


def _pk_group_thresholds(embeddings: torch.Tensor, margin: float,
                         k_samples: int) -> torch.Tensor:
    """[B, K] per-anchor thresholds ``sq(a, p) + margin`` (self: -inf)."""
    b = embeddings.shape[0]
    d2 = _pk_group_sq(embeddings, k_samples)
    eye = torch.eye(k_samples, dtype=torch.bool, device=embeddings.device)
    t = torch.where(eye[None], float("-inf"), d2 + margin)
    return t.reshape(b, k_samples)


def _pk_counts(sq: torch.Tensor, neg_mask: torch.Tensor,
               t_flat: torch.Tensor):
    """One [B, B, K] compare of the negative distances against the
    thresholds gives the per-threshold hinge sums ``pair_sum`` and active
    counts ``k`` ([B, K]) and the per-negative counts ``m`` ([B, B]).
    ``<=``: a tie is a zero hinge, counted as the JAX package counts it."""
    neg_sq = torch.where(neg_mask, sq, float("inf"))
    cmp = (neg_sq[:, :, None] <= t_flat[:, None, :]).float()
    k = cmp.sum(1)
    p_at_t = torch.einsum("an,anj->aj", torch.where(neg_mask, sq, 0.0), cmp)
    pair_sum = torch.where(torch.isfinite(t_flat), k * t_flat - p_at_t, 0.0)
    m = cmp.sum(2)
    return pair_sum, k, m


def _structured_w_grad(emb, k_flat, m, denom, poison, k_samples, g_loss):
    """Embedding gradient for ``W = (Kbd - M) / denom`` without building W:
    ``Kbd`` is the block-diagonal placement of ``k_flat`` [B, K], ``M`` the
    dense [B, B] per-negative counts; ``dL/de = 2 (rowsum(S) e - S e)``
    with ``S = W + W^T``."""
    b = emb.shape[0]
    g = b // k_samples
    eg = emb.reshape(g, k_samples, -1)
    k_blk = k_flat.reshape(g, k_samples, k_samples)
    pos_mv = (k_blk @ eg + k_blk.transpose(1, 2) @ eg).reshape(b, -1)
    pos_row = (k_blk.sum(2) + k_blk.sum(1)).reshape(b)
    neg_mv = m @ emb + m.T @ emb
    neg_row = m.sum(1) + m.sum(0)
    s_e = (pos_mv - neg_mv) / denom
    s_row = (pos_row - neg_row) / denom
    return g_loss * 2.0 * (s_row[:, None] * emb - s_e) * poison


def _batch_all_forward(embeddings: torch.Tensor, labels: torch.Tensor,
                       margin: float, max_positives: Optional[int]):
    """Loss, stats and the backward's residuals
    ``(emb, k [B, K], m [B, B], denom, poison)`` on the P-K fast path."""
    b = labels.shape[0]
    if not _pk_is_fast_path(b, max_positives):
        raise NotImplementedError(
            "batch_all without a grouped P-K layout (max_positives = "
            "k_samples - 1, B a multiple of k_samples) takes the generic "
            "rowblock path, which is not ported yet (see ROADMAP.md, item 3)")
    k_samples = max_positives + 1
    sq = pairwise_sq_l2(embeddings)
    dist = sq.sqrt()
    pos_mask, neg_mask = _masks(labels)
    n_candidates = (pos_mask.sum(1) * neg_mask.sum(1)).sum()

    fits = _pk_grouped(labels, k_samples)
    poison = torch.where(fits, 1.0, float("nan"))
    t_flat = _pk_group_thresholds(embeddings, margin, k_samples)
    pair_sum, k, m = _pk_counts(sq, neg_mask, t_flat)
    active = k.sum()
    denom = active.clamp_min(1.0)
    loss = pair_sum.sum() / denom * poison
    stats = _stats(dist, pos_mask, neg_mask, active.to(torch.int32),
                   n_candidates)
    minus_one = torch.tensor(-1, device=labels.device)
    stats = MiningStats(
        n_triplets=torch.where(fits, stats.n_triplets, minus_one),
        n_candidates=torch.where(fits, stats.n_candidates, minus_one),
        frac_mined=stats.frac_mined * poison,
        mean_pos_dist=stats.mean_pos_dist * poison,
        mean_neg_dist=stats.mean_neg_dist * poison)
    return loss, stats, (embeddings.float(), k, m, denom, poison)


class _BatchAllLoss(torch.autograd.Function):
    """``_batch_all_custom``: the forward above, the analytic backward."""

    @staticmethod
    def forward(ctx, embeddings, labels, margin, max_positives):
        loss, stats, (emb, k, m, denom, poison) = _batch_all_forward(
            embeddings, labels, margin, max_positives)
        ctx.save_for_backward(emb, k, m, denom, poison)
        ctx.k_samples = max_positives + 1
        ctx.mark_non_differentiable(*stats)
        return (loss,) + tuple(stats)

    @staticmethod
    def backward(ctx, g_loss, *_stat_grads):
        emb, k, m, denom, poison = ctx.saved_tensors
        grad = _structured_w_grad(emb, k, m, denom, poison, ctx.k_samples,
                                  g_loss)
        return grad, None, None, None


def batch_all_loss(embeddings: torch.Tensor, labels: torch.Tensor, *,
                   margin: float = 0.5, max_positives: Optional[int] = None):
    """Exact batch-all triplet loss on a grouped P-K batch; returns
    ``(loss, MiningStats)``. ``max_positives`` is ``k_samples - 1``; without
    it (the generic-label path) this raises ``NotImplementedError``."""
    loss, *stats = _BatchAllLoss.apply(embeddings.float(), labels, margin,
                                       max_positives)
    return loss, MiningStats(*stats)


def batch_all_loss_reference(embeddings: torch.Tensor,
                             labels: torch.Tensor, *, margin: float = 0.5):
    """Naive O(B^3) batch-all, differentiable by autograd — the oracle for
    tests; do not use at scale."""
    sq = pairwise_sq_l2(embeddings)
    dist = sq.sqrt()
    pos_mask, neg_mask = _masks(labels)
    lv = sq[:, :, None] - sq[:, None, :] + margin            # [a, p, n]
    valid = pos_mask[:, :, None] & neg_mask[:, None, :]
    hinge = torch.where(valid, lv.clamp_min(0.0), 0.0)
    active = ((hinge > 0.0) & valid).sum()
    loss = hinge.sum() / active.clamp_min(1)
    stats = _stats(dist, pos_mask, neg_mask, active, valid.sum())
    return loss, stats


def mined_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor, *,
                       margin: float = 0.5, mode: str = "semihard",
                       rng: Optional[torch.Generator] = None,
                       max_positives: Optional[int] = None):
    """Dispatch to a mining strategy; returns ``(loss, MiningStats)``. Only
    ``batch_all`` is ported; the other modes raise ``NotImplementedError``
    naming ``ROADMAP.md``."""
    if mode == "batch_all":
        return batch_all_loss(embeddings, labels, margin=margin,
                              max_positives=max_positives)
    if mode in ALL_MODES:
        raise NotImplementedError(
            f"mining mode {mode!r} is not ported to PyTorch yet (see "
            f"ROADMAP.md, item 11); ported: batch_all")
    raise ValueError(f"unknown mining mode {mode!r}; valid: {ALL_MODES}")
