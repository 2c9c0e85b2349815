"""Row-sharded mining over the ranks of a data-parallel step (port of
``sharded_batch_all_loss`` and ``sharded_batch_hard_loss`` in
``embeddingnet_tpu/parallel/sharded.py``).

Each rank holds its anchor rows (its block of the global batch) and
all-gathers the embeddings, so it computes only its [B/W, B] block of the
distance matrix; the scalar sums are all-reduced, and the loss is the
global batch's on every rank. The gradients follow
:mod:`~embeddingnet_tpu_torch.parallel.collectives`' convention: a rank
that back-propagates ``loss / world`` contributes its share, and the
embedding gradient of its rows is the one-device gradient's.

* :func:`sharded_batch_all_loss`: on a grouped P-K batch whose groups lie
  whole within each rank's rows, the [B/W, B, K] compare-reduce; else the
  generic-label sort (:func:`~embeddingnet_tpu_torch.ops.mining.
  batch_all_rowblock`) on the rank's rows. The backward is analytic
  (``dL/de = 2 (rowsum(S) e - S e)``, ``S = W + W^T``): the rank's rows of
  ``W`` give ``W e`` and the row sums, and the column sums and ``W^T e``
  are all-reduced (on the P-K path only the dense negative part crosses
  ranks, since every group is whole within its rank). ``max_positives``
  asserts the layout: a batch that breaks it on any rank poisons loss,
  gradient and stats with NaN (the counts with -1), as on one device.
* :func:`sharded_batch_hard_loss`: per anchor the farthest positive and
  the closest negative among the gathered embeddings; the mean's sums
  are all-reduced; gradient by autograd through the collectives.
"""

from __future__ import annotations

from typing import Optional

import torch

from embeddingnet_tpu_torch.ops.distances import pairwise_sq_l2
from embeddingnet_tpu_torch.ops.mining import (MiningStats, _pk_counts,
                                               _pk_group_thresholds,
                                               batch_all_rowblock)
from embeddingnet_tpu_torch.parallel.collectives import (
    DataParallel, all_gather_rows, all_reduce_sum, gather_rows, reduce_sum)


def _local_masks(emb_local, labels_local, emb, labels, row0):
    """The rank's [bl, B] squared distances and its pair masks."""
    bl, b = emb_local.shape[0], emb.shape[0]
    sq = pairwise_sq_l2(emb_local, emb)
    same = labels_local[:, None] == labels[None, :]
    cols = torch.arange(b, device=labels.device)
    rows = row0 + torch.arange(bl, device=labels.device)
    self_mask = rows[:, None] == cols[None, :]
    return sq, same & ~self_mask, ~same


def _stats_sums(sq, pos_mask, neg_mask, group):
    """All-reduced ``(pos_cnt, neg_cnt, n_candidates)`` (int64) and the
    distance sums over positive and negative pairs (f32)."""
    dist = sq.sqrt()
    counts = reduce_sum(torch.stack([
        pos_mask.sum(), neg_mask.sum(),
        (pos_mask.sum(1) * neg_mask.sum(1)).sum()]), group)
    dists = torch.stack([(dist * pos_mask).sum(), (dist * neg_mask).sum()])
    return counts, dists


def _stats(counts, dist_sums, active_int, poison):
    pos_cnt, neg_cnt, n_candidates = counts
    return MiningStats(
        n_triplets=active_int,
        n_candidates=n_candidates,
        frac_mined=active_int.float() / n_candidates.float().clamp_min(1.0)
        * poison,
        mean_pos_dist=dist_sums[0] / pos_cnt.clamp_min(1) * poison,
        mean_neg_dist=dist_sums[1] / neg_cnt.clamp_min(1) * poison)


def _pk_applicable(bl: int, max_positives: Optional[int]) -> bool:
    kk = (max_positives + 1) if max_positives is not None else None
    return bool(kk and 1 < kk < bl and bl % kk == 0)


class _ShardedBatchAll(torch.autograd.Function):
    """The rank's forward and the analytic backward; the loss is
    replicated, so the backward sums its cotangent over ranks."""

    @staticmethod
    def forward(ctx, emb_local, labels_local, dp, margin, max_positives):
        group = dp.group
        bl = emb_local.shape[0]
        row0 = dp.rank * bl
        emb = gather_rows(emb_local, group)
        labels = gather_rows(labels_local, group)
        sq, pos_mask, neg_mask = _local_masks(emb_local, labels_local, emb,
                                              labels, row0)
        pk = _pk_applicable(bl, max_positives)
        if pk:
            kk = max_positives + 1
            blocks = labels_local.reshape(bl // kk, kk)
            local_ok = ((blocks == blocks[:, :1]).all()
                        & (pos_mask.sum(1) == kk - 1).all())
            t_flat = _pk_group_thresholds(emb_local, margin, kk)
            pair_sum, k, m = _pk_counts(sq, neg_mask, t_flat)
        else:
            local_ok = torch.ones((), dtype=torch.bool, device=sq.device)
            pair_sum, k, m = batch_all_rowblock(sq, pos_mask, neg_mask,
                                                margin)
        counts, dists = _stats_sums(sq, pos_mask, neg_mask, group)
        # one all-reduce: the hinge sum, the active count, the distance
        # sums and the ranks whose layout is broken
        sums = reduce_sum(torch.cat([
            torch.stack([pair_sum.sum(), k.sum()]), dists,
            (~local_ok).float()[None]]), group)
        num, active_clean, dist_sums, broken = (sums[0], sums[1], sums[2:4],
                                                sums[4])
        all_ok = broken == 0
        poison = torch.where(all_ok, 1.0, float("nan"))
        active = active_clean * poison
        denom = active.clamp_min(1.0)
        loss = num * poison / denom
        minus_one = torch.tensor(-1, device=sq.device)
        stats = _stats(
            torch.where(all_ok, counts, minus_one), dist_sums,
            torch.where(all_ok, active_clean.to(torch.int32),
                        minus_one.to(torch.int32)), poison)
        if pk:
            w = (k * poison, m * poison)
        else:
            w = ((k * pos_mask - m * neg_mask) / denom,)
        ctx.save_for_backward(emb_local, emb, denom, *w)
        ctx.dp, ctx.pk, ctx.kk = dp, pk, (max_positives or 0) + 1
        ctx.mark_non_differentiable(*stats)
        return (loss,) + tuple(stats)

    @staticmethod
    def backward(ctx, g_loss, *_stat_grads):
        emb_local, emb, denom, *w = ctx.saved_tensors
        dp = ctx.dp
        g = reduce_sum(g_loss, dp.group)
        bl, d = emb_local.shape
        row0 = dp.rank * bl
        if ctx.pk:
            k, m = w
            kk = ctx.kk
            eg = emb_local.reshape(bl // kk, kk, d)
            k_blk = k.reshape(bl // kk, kk, kk)
            pos_mv = (k_blk @ eg + k_blk.transpose(1, 2) @ eg).reshape(bl, d)
            pos_row = (k_blk.sum(2) + k_blk.sum(1)).reshape(bl)
            cross = reduce_sum(torch.cat([m.T @ emb_local,
                                          m.sum(0)[:, None]], 1), dp.group)
            neg_mv = m @ emb + cross[row0:row0 + bl, :d]
            neg_row = m.sum(1) + cross[row0:row0 + bl, d]
            s_e = (pos_mv - neg_mv) / denom
            s_row = (pos_row - neg_row) / denom
            grad = 2.0 * (s_row[:, None] * emb_local - s_e)
        else:
            w_local, = w
            cross = reduce_sum(torch.cat([w_local.T @ emb_local,
                                          w_local.sum(0)[:, None]], 1),
                               dp.group)
            rowsum = w_local.sum(1) + cross[row0:row0 + bl, d]
            grad = 2.0 * (rowsum[:, None] * emb_local - w_local @ emb
                          - cross[row0:row0 + bl, :d])
        return g * grad, None, None, None, None


def sharded_batch_all_loss(dp: DataParallel, *, margin: float = 0.5,
                           max_positives: Optional[int] = None):
    """``fn(emb_local, labels_local) -> (loss, MiningStats)``: the global
    batch's batch-all loss and stats from each rank's rows (the rank's
    block of the global batch, in rank order), equal to the one-device
    ``batch_all_loss`` on the gathered batch up to the order of the sums.
    ``max_positives`` (``k_samples - 1``) takes the P-K path when each
    rank's rows are whole groups."""

    def fn(emb_local: torch.Tensor, labels_local: torch.Tensor):
        loss, *stats = _ShardedBatchAll.apply(emb_local.float(),
                                              labels_local, dp, margin,
                                              max_positives)
        return loss, MiningStats(*stats)

    return fn


def sharded_batch_hard_loss(dp: DataParallel, *, margin: float = 0.5):
    """``fn(emb_local, labels_local) -> (loss, MiningStats)``: row-parallel
    batch-hard over the gathered embeddings; the per-anchor hinges are the
    rank's, the mean's sums and the stats are all-reduced. The loss equals
    the one-device ``batch_hard_loss`` on the gathered batch."""

    def fn(emb_local: torch.Tensor, labels_local: torch.Tensor):
        group = dp.group
        emb_local = emb_local.float()
        bl = emb_local.shape[0]
        emb = all_gather_rows(emb_local, group)
        labels = gather_rows(labels_local, group)
        sq, pos_mask, neg_mask = _local_masks(emb_local, labels_local, emb,
                                              labels, dp.rank * bl)
        hardest_pos = torch.where(pos_mask, sq, float("-inf")).amax(1)
        hardest_neg = torch.where(neg_mask, sq, float("inf")).amin(1)
        valid = pos_mask.any(1) & neg_mask.any(1)
        per_anchor = torch.where(
            valid, (hardest_pos - hardest_neg + margin).clamp_min(0.0), 0.0)
        num = all_reduce_sum(per_anchor.sum(), group)
        n = reduce_sum(torch.stack([valid.sum(),
                                    ((per_anchor > 0.0) & valid).sum()]),
                       group)
        loss = num / n[0].clamp_min(1)
        counts, dists = _stats_sums(sq.detach(), pos_mask, neg_mask, group)
        stats = _stats(torch.stack([counts[0], counts[1], n[0]]),
                       reduce_sum(dists, group), n[1],
                       torch.ones((), device=sq.device))
        return loss, stats

    return fn
