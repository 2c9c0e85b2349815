"""Online triplet mining inside the train step (port of
``embeddingnet_tpu/ops/mining.py``).

The reference's selection semantics, as the JAX package reproduces them:

* anchor-positive pairs are unordered within-class combinations (label
  equal, ``a < p``);
* candidates are scored ``d(a, p) - d(a, n) + margin`` on **euclidean**
  distances;
* ``hardest``: the negative of the largest score, kept if it is > 0;
* ``random_hard``: a uniform choice among the negatives with score > 0;
* ``semihard``: a uniform choice among 0 < score < margin;
* the loss on the selected triplets is the hinge on **squared** L2, over
  the number selected; an all-easy batch gives 0.

For B <= 256 (``_PARITY_CUBE_MAX_B``) these enumerate a [B, B, B] score
tensor (:func:`_parity_mined_loss`), the uniform choice an argmax over
Gumbel draws, the gradient autograd's through the gather of
``sq[a, n*]``. Above, :func:`parity_mined_loss_large` sorts each anchor's
negatives once, so every candidate set is a window of ranks, counted by
``torch.searchsorted`` (or, on a grouped P-K batch, by a [B, B, K]
compare-reduce) and fetched by a gather at a uniform rank; its gradient is
analytic (:class:`_ParityLargeLoss`).

Two modes beyond the reference:

* ``batch_hard``: per anchor the farthest positive and the closest
  negative, O(B^2), gradient by autograd;
* ``batch_all``: every valid triplet. On a grouped P-K batch (``k_classes``
  blocks of ``k_samples`` adjacent images of one class, as ``PKSampler``
  draws them) each anchor has exactly ``K - 1`` positives, so the per-pair
  sums come from one [B, B, K] compare of the negative distances against
  the ``K`` per-anchor thresholds ``sq(a,p) + margin``. The gradient is
  analytic (:class:`_BatchAllLoss`): with the per-pair active counts ``k``
  and the per-negative counts ``m`` as weights ``W``,
  ``dL/de = 2 * (rowsum(S) * e - S @ e)``, ``S = W + W^T``.

  Without a grouped P-K layout (``max_positives`` None, or a batch that is
  not a multiple of ``K``) the generic-label path
  (:func:`batch_all_rowblock`) counts by one merged sort per anchor row;
  the gradient is the same analytic form on the dense ``W``.

Passing ``max_positives = K - 1`` asserts the grouped layout on the P-K
paths: a batch that breaks it poisons loss, gradient and stats with NaN
(and the triplet counts with -1), as in the JAX package.

The stochastic modes take their random draws as a tensor (``draws``):
Gumbel noise [B, B, B] on the enumeration path, uniforms [B, B] on the
dense path and [B, K] on the P-K path (:func:`draws_shape`); without them
they are drawn from a ``torch.Generator`` (:func:`sample_draws`).

This is eager PyTorch (at B=1024, K=4 a compare tensor is 16.8 MB); a
fused miner is still to write (``ROADMAP.md``).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from embeddingnet_tpu_torch.ops.distances import pairwise_sq_l2

PARITY_MODES = ("semihard", "hardest", "random_hard")
FAST_MODES = ("batch_hard", "batch_all")
ALL_MODES = PARITY_MODES + FAST_MODES
STOCHASTIC_MODES = ("semihard", "random_hard")

# parity-mode batches above this go to the sorted rank-window miner instead
# of the [B, B, B] enumeration
_PARITY_CUBE_MAX_B = 256


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


def batch_all_rowblock(sq: torch.Tensor, pos_mask: torch.Tensor,
                       neg_mask: torch.Tensor, margin: float):
    """Per-anchor-row batch-all counting over an [R, B] block of squared
    distances, for any labels (the core of the generic-label path, on one
    device and per rank).

    Each row's B negative distances (``+inf`` where not a negative) and B
    pair thresholds ``t = sq_ap + margin`` (``-inf`` where not a positive
    pair) are merged and sorted once (stable, negatives first among equal
    keys: a tie is a zero hinge); cumulative sums over the sorted row give,
    at every threshold, the count ``k`` and the value sum of the negatives
    below it, and at every negative the count of thresholds below it; the
    inverse permutation puts them back in column order.

    Returns ``(pair_sum [R, B], k [R, B], m [R, B])``: the per-pair hinge
    sums, the per-pair active-triplet counts and the per-negative counts of
    active thresholds (the weights of the analytic gradient)."""
    r, b = sq.shape
    neg_sq = torch.where(neg_mask, sq, float("inf"))
    t = torch.where(pos_mask, sq + margin, float("-inf"))
    vals_sorted, order = torch.cat([neg_sq, t], 1).sort(dim=1, stable=True)
    is_neg = (order < b).to(sq.dtype)
    # negatives strictly before each rank: count and value prefix sums
    cum_cnt = is_neg.cumsum(1) - is_neg
    neg_vals = torch.where((order < b) & torch.isfinite(vals_sorted),
                           vals_sorted, 0.0)
    cum_val = neg_vals.cumsum(1) - neg_vals
    # thresholds strictly before each rank (the -inf invalid ones included)
    is_t = 1.0 - is_neg
    cum_t = is_t.cumsum(1) - is_t

    def unsort(x):
        return torch.empty_like(x).scatter_(1, order, x)

    u_cnt, u_val, u_t = unsort(cum_cnt), unsort(cum_val), unsort(cum_t)
    k = torch.where(pos_mask, u_cnt[:, b:], 0.0)
    pair_sum = torch.where(pos_mask, k * t - u_val[:, b:], 0.0)
    # m[a, n] = valid thresholds of anchor a above sq_an: the valid ones
    # less those below it (cum_t counts the invalid ones, which sort first)
    n_pos = pos_mask.sum(1).to(sq.dtype)
    n_invalid_t = b - n_pos
    m = (n_pos[:, None] - (u_t[:, :b] - n_invalid_t[:, None])).clamp_min(0.0)
    m = torch.where(neg_mask, m, 0.0)
    return pair_sum, k, m


def _batch_all_forward(embeddings: torch.Tensor, labels: torch.Tensor,
                       margin: float, max_positives: Optional[int]):
    """Loss, stats and the backward's residuals: ``(emb, k [B, K], m [B, B],
    denom, poison)`` on the P-K fast path, ``(emb, w [B, B])`` on the
    generic-label path (:func:`batch_all_rowblock`)."""
    b = labels.shape[0]
    sq = pairwise_sq_l2(embeddings)
    dist = sq.sqrt()
    pos_mask, neg_mask = _masks(labels)
    n_candidates = (pos_mask.sum(1) * neg_mask.sum(1)).sum()
    if not _pk_is_fast_path(b, max_positives):
        if b >= 2048:
            warnings.warn(
                f"batch_all_loss at B={b} without max_positives takes the "
                "generic-label sort path, much slower than the grouped P-K "
                "compare-reduce: sample P-K batches (GENERATOR.k_samples) "
                "and pass max_positives=k_samples-1", stacklevel=3)
        pair_sum, k, m = batch_all_rowblock(sq, pos_mask, neg_mask, margin)
        active = k.sum()
        denom = active.clamp_min(1.0)
        loss = pair_sum.sum() / denom
        w = (k * pos_mask - m * neg_mask) / denom
        stats = _stats(dist, pos_mask, neg_mask, active.to(torch.int32),
                       n_candidates)
        return loss, stats, (embeddings.float(), w)
    k_samples = max_positives + 1

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
        loss, stats, res = _batch_all_forward(embeddings, labels, margin,
                                              max_positives)
        ctx.save_for_backward(*res)
        ctx.k_samples = (max_positives or 0) + 1
        ctx.mark_non_differentiable(*stats)
        return (loss,) + tuple(stats)

    @staticmethod
    def backward(ctx, g_loss, *_stat_grads):
        res = ctx.saved_tensors
        if len(res) == 5:
            emb, k, m, denom, poison = res
            grad = _structured_w_grad(emb, k, m, denom, poison,
                                      ctx.k_samples, g_loss)
        else:
            grad = _dense_w_grad(*res, g_loss)
        return grad, None, None, None


def _dense_w_grad(emb, w, g_loss):
    """Embedding gradient of ``loss = sum(W * sq)``: with ``S = W + W^T``,
    ``dL/de = 2 (rowsum(S) e - S e)``."""
    s = w + w.T
    return g_loss * 2.0 * (s.sum(1, keepdim=True) * emb - s @ emb)


def batch_all_loss(embeddings: torch.Tensor, labels: torch.Tensor, *,
                   margin: float = 0.5, max_positives: Optional[int] = None):
    """Exact batch-all triplet loss; returns ``(loss, MiningStats)``.
    ``max_positives`` (``k_samples - 1``) asserts a grouped P-K batch and
    takes the compare-reduce path; without it, or when B is not a multiple
    of ``k_samples``, the generic-label path (:func:`batch_all_rowblock`)
    runs."""
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




# -- batch-hard ---------------------------------------------------------------


def batch_hard_loss(embeddings: torch.Tensor, labels: torch.Tensor, *,
                    margin: float = 0.5, soft: bool = False):
    """Batch-hard triplet loss (Hermans et al. 2017), O(B^2): per anchor
    the farthest positive and the closest negative by squared L2, the
    hinge ``max(d_ap - d_an + margin, 0)`` (``soft``: ``softplus(d_ap -
    d_an)``) averaged over the anchors that have both. Gradient by
    autograd; ``amax``/``amin`` share it among ties, as JAX's max does."""
    sq = pairwise_sq_l2(embeddings)
    dist = sq.detach().sqrt()
    pos_mask, neg_mask = _masks(labels)
    hardest_pos = torch.where(pos_mask, sq, float("-inf")).amax(1)
    hardest_neg = torch.where(neg_mask, sq, float("inf")).amin(1)
    valid = pos_mask.any(1) & neg_mask.any(1)
    raw = hardest_pos - hardest_neg
    if soft:
        per_anchor = torch.logaddexp(torch.zeros_like(raw), raw)
    else:
        per_anchor = (raw + margin).clamp_min(0.0)
    per_anchor = torch.where(valid, per_anchor, 0.0)
    n_valid = valid.sum()
    loss = per_anchor.sum() / n_valid.clamp_min(1)
    active = ((per_anchor > 0.0) & valid).sum()
    return loss, _stats(dist, pos_mask, neg_mask, active, n_valid)


# -- the reference's modes: random draws --------------------------------------


def draws_shape(mode: str, b: int, max_positives: Optional[int] = None
                ) -> Optional[Tuple[int, ...]]:
    """The shape of the random draws ``mode`` takes at batch ``b``: Gumbel
    noise [B, B, B] on the enumeration path (B <= 256), uniforms [B, K] on
    the P-K path and [B, B] on the dense path; None for the modes that draw
    nothing."""
    if mode not in STOCHASTIC_MODES:
        return None
    if b <= _PARITY_CUBE_MAX_B:
        return (b, b, b)
    if _pk_is_fast_path(b, max_positives):
        return (b, max_positives + 1)
    return (b, b)


def sample_draws(mode: str, b: int, max_positives: Optional[int],
                 generator: torch.Generator,
                 device: Optional[torch.device] = None
                 ) -> Optional[torch.Tensor]:
    """The draws of :func:`draws_shape` from ``generator``, on its device
    (then moved to ``device``): on the enumeration path Gumbel noise
    ``-log(-log(u))`` of a uniform ``u`` in [tiny, 1), as
    ``jax.random.gumbel`` makes it, else the uniforms. None where the mode
    draws nothing (the generator does not advance)."""
    shape = draws_shape(mode, b, max_positives)
    if shape is None:
        return None
    u = torch.rand(shape, generator=generator, device=generator.device)
    if len(shape) == 3:
        tiny = torch.finfo(torch.float32).tiny
        u = -torch.log(-torch.log(u.clamp_min(tiny)))
    return u if device is None else u.to(device)


def _check_draws(draws, mode, b, max_positives):
    shape = draws_shape(mode, b, max_positives)
    if tuple(draws.shape) != shape:
        raise ValueError(f"mode={mode!r} at B={b} takes draws of shape "
                         f"{shape}, got {tuple(draws.shape)}")
    return draws.float()


# -- the reference's modes: enumeration (B <= 256) ----------------------------


def _uniform_choice(gumbel: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Uniform index among the True entries of the last axis: the argmax
    of the Gumbel draws there (an empty row gives 0; callers mask it)."""
    return torch.where(mask, gumbel, float("-inf")).argmax(-1)


def _parity_select(dist: torch.Tensor, labels: torch.Tensor, margin: float,
                   mode: str, draws: Optional[torch.Tensor]):
    """The enumeration's selection from the euclidean distances: ``(pair
    mask, pos mask, neg mask, selected [B, B], n_star [B, B])``, the chosen
    negative of each (anchor, positive) pair and whether it counts."""
    b = labels.shape[0]
    pos_mask, neg_mask = _masks(labels)
    idx = torch.arange(b, device=labels.device)
    pair_mask = pos_mask & (idx[:, None] < idx[None, :])
    # lv[a, p, n] = d(a, p) - d(a, n) + margin, for n of another label
    lv = dist[:, :, None] - dist[:, None, :] + margin
    neg3 = neg_mask[:, None, :].expand(lv.shape)
    if mode == "hardest":
        score = torch.where(neg3, lv, float("-inf"))
        n_star = score.argmax(-1)
        best = score.amax(-1)
        selected = pair_mask & (best > 0.0) & torch.isfinite(best)
    elif mode in STOCHASTIC_MODES:
        cand = neg3 & (lv > 0.0)
        if mode == "semihard":
            cand &= lv < margin
        n_star = _uniform_choice(draws, cand)
        selected = pair_mask & cand.any(-1)
    else:
        raise ValueError(f"unknown parity mining mode {mode!r}")
    return pair_mask, pos_mask, neg_mask, selected, n_star


def _parity_mined_loss(embeddings: torch.Tensor, labels: torch.Tensor, *,
                       margin: float, mode: str,
                       draws: Optional[torch.Tensor] = None):
    """The reference's modes by enumeration of the [B, B, B] scores; the
    gradient by autograd through the squared distances. ``draws``: Gumbel
    noise [B, B, B] (semihard, random_hard)."""
    b = labels.shape[0]
    if b > 512:
        raise ValueError(
            f"_parity_mined_loss materializes a [B,B,B] candidate tensor "
            f"(B={b} -> {b ** 3 * 4 / 1e9:.1f} GB); mined_triplet_loss "
            f"dispatches B>{_PARITY_CUBE_MAX_B} to parity_mined_loss_large "
            f"automatically.")
    sq = pairwise_sq_l2(embeddings)            # squared: the loss's metric
    dist = sq.detach().sqrt()                  # euclidean: the selection's
    pair_mask, pos_mask, neg_mask, selected, n_star = _parity_select(
        dist, labels, margin, mode, draws)
    sq_an = sq.gather(1, n_star)                 # sq[a, n*[a, p]]
    hinge = (sq - sq_an + margin).clamp_min(0.0)
    n_sel = selected.sum()
    loss = torch.where(selected, hinge, 0.0).sum() / n_sel.clamp_min(1)
    return loss, _stats(dist, pos_mask, neg_mask, n_sel, pair_mask.sum())


# -- the reference's modes: sorted rank windows (B > 256) ---------------------


def _count_sorted(sorted_keys: torch.Tensor, queries: torch.Tensor,
                  inclusive: bool) -> torch.Tensor:
    """``#{i : sorted_keys[r, i] <= queries[r, j]}`` (``<`` when not
    ``inclusive``) by binary search, as float32."""
    return torch.searchsorted(sorted_keys.contiguous(), queries.contiguous(),
                              right=inclusive).float()


def _count_below(keys: torch.Tensor, queries: torch.Tensor,
                 inclusive: bool = True) -> torch.Tensor:
    """``counts[r, j] = #{i : keys[r, i] <= queries[r, j]}`` per row (``<``
    when ``inclusive=False``), float32. Masked keys are ``+inf``, masked
    queries ``-inf``."""
    return _count_sorted(keys.sort(dim=1).values, queries, inclusive)


def _fetch_at_rank(sorted_vals: torch.Tensor, sorted_ids: torch.Tensor,
                   ranks: torch.Tensor):
    """Per row ``(sorted_vals[r, ranks[r, j]], sorted_ids[r, ranks[r, j]])``
    (ranks as floats, ids as int32)."""
    idx = ranks.long()
    return sorted_vals.gather(1, idx), sorted_ids.gather(1, idx).int()


def _row_histogram(ids: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``counts[r, b] = #{j : ids[r, j] == b}`` for integer ids in
    ``[0, n_bins]`` (``n_bins`` is the ignored sentinel), float32."""
    out = torch.zeros(ids.shape[0], n_bins + 1, device=ids.device)
    out.scatter_add_(1, ids.long(), torch.ones(ids.shape, device=ids.device))
    return out[:, :n_bins]


def _pk_place_grouped(x: torch.Tensor, k_samples: int) -> torch.Tensor:
    """Per-threshold values [B, K] placed block-diagonally in [B, B]."""
    b = x.shape[0]
    g = b // k_samples
    eye = torch.eye(g, dtype=x.dtype, device=x.device)
    return torch.einsum("gij,gh->gihj", x.reshape(g, k_samples, k_samples),
                        eye).reshape(b, b)


def _sorted_negatives(neg_d: torch.Tensor):
    """Each row's negative distances ascending, with their column ids."""
    sorted_d, order = neg_d.sort(dim=1, stable=True)
    return sorted_d, order.int()


def _parity_pk(dist, sq, pos_mask, neg_mask, u, margin, mode, kk, d2_blk):
    """P-K path of :func:`_parity_forward_large`: every anchor's positives
    sit in its group, so the window bounds are [B, K] compare-reduces of
    one [B, B, K] compare; one sort of the negatives remains for the fetch,
    and ``hardest`` needs none. ``d2_blk`` [g, K, K] holds the within-group
    squared distances. Returns ``(loss, stats, (active_f [B, K], w_neg
    [B, B], denom), aux)``; the aux in [B, B] as the dense path's."""
    b = dist.shape[0]
    g = b // kk
    dev = dist.device
    ar = torch.arange(kk, device=dev)
    pair_valid = (ar[:, None] < ar[None, :]).repeat(g, 1)       # [B, K]
    d_pair = torch.where(pair_valid, d2_blk.sqrt().reshape(b, kk),
                         float("-inf"))
    neg_d = torch.where(neg_mask, dist, float("inf"))
    has_neg = neg_mask.any(1)
    zeros = torch.zeros(b, kk, device=dev)

    if mode == "hardest":
        min_neg = neg_d.amin(1)
        k = torch.where(torch.isfinite(d_pair) & has_neg[:, None]
                        & (d_pair - min_neg[:, None] + margin > 0.0),
                        1.0, 0.0)
        k_lo = zeros
    else:
        # strict upper bound, inclusive lower bound, as the dense path
        k_hi = (neg_d[:, :, None] < (d_pair + margin)[:, None, :]).float() \
            .sum(1)
        if mode == "semihard":
            k_lo = (neg_d[:, :, None] <= d_pair[:, None, :]).float().sum(1)
        else:
            k_lo = zeros
        k = torch.where(pair_valid, (k_hi - k_lo).clamp_min(0.0), 0.0)
        ranks = (k_lo + torch.floor(u * k)).clamp(0.0, b - 1.0)
    selected = torch.isfinite(d_pair) & (k > 0)

    if mode == "hardest":
        # the rank-0 fetch is each anchor's closest negative: no sort
        d_star = neg_d.amin(1)[:, None].expand(b, kk)
        n_star = neg_d.argmin(1).int()[:, None].expand(b, kk)
    else:
        sorted_d, sorted_ids = _sorted_negatives(neg_d)
        d_star, n_star = _fetch_at_rank(sorted_d, sorted_ids,
                                        torch.where(selected, ranks, 0.0))

    sq_blk = d2_blk.reshape(b, kk)
    sq_an = torch.where(torch.isfinite(d_star), d_star * d_star,
                        float("inf"))
    hinge = (sq_blk - sq_an + margin).clamp_min(0.0)
    n_sel = selected.sum()
    denom = n_sel.clamp_min(1).float()
    loss = torch.where(selected, hinge, 0.0).sum() / denom

    active = selected & (hinge > 0.0)
    active_f = active.float()
    w_neg = torch.zeros(b, b, device=dev).scatter_add_(
        1, n_star.long(), active_f)
    stats = _stats(dist, pos_mask, neg_mask, n_sel, pair_valid.sum())

    def place(x):
        return _pk_place_grouped(x.float(), kk)

    aux = {"selected": place(selected) > 0, "active": place(active) > 0,
           "n_star": place(n_star).int(), "k": place(k),
           "k_lo": place(k_lo) if mode == "semihard" else None}
    return loss, stats, (active_f, w_neg, denom), aux


def _parity_dense(dist, sq, pos_mask, neg_mask, u, margin, mode):
    """The label-agnostic rank-window path (:func:`_parity_forward_large`):
    window counts by binary search in each row's sorted negatives, the
    negative fetched at ``k_lo + floor(u * k)``. Returns ``(loss, stats, w
    [B, B], aux)``."""
    b = dist.shape[0]
    dev = dist.device
    idx = torch.arange(b, device=dev)
    pair_mask = pos_mask & (idx[:, None] < idx[None, :])
    has_neg = neg_mask.any(1)
    neg_d = torch.where(neg_mask, dist, float("inf"))
    sorted_d, sorted_ids = _sorted_negatives(neg_d)
    d_ap = torch.where(pair_mask, dist, float("-inf"))
    k_lo = torch.zeros(b, b, device=dev)
    if mode == "hardest":
        # the closest negative; selected iff its score is > 0
        k = torch.where(pair_mask & has_neg[:, None]
                        & (dist - sorted_d[:, :1] + margin > 0.0), 1.0, 0.0)
    elif mode == "random_hard":
        # score > 0 <=> d_an < d_ap + margin, strict (a tie scores 0)
        k_hi = _count_sorted(sorted_d, d_ap + margin, inclusive=False)
        k = torch.where(pair_mask, k_hi, 0.0)
    elif mode == "semihard":
        # 0 < score < margin <=> d_ap < d_an < d_ap + margin, both strict
        k_hi = _count_sorted(sorted_d, d_ap + margin, inclusive=False)
        k_lo = _count_sorted(sorted_d, d_ap, inclusive=True)
        k = torch.where(pair_mask, (k_hi - k_lo).clamp_min(0.0), 0.0)
    else:
        raise ValueError(f"unknown parity mining mode {mode!r}")

    selected = pair_mask & (k > 0)
    if mode == "hardest":
        ranks = torch.zeros(b, b, device=dev)
    else:
        ranks = (k_lo + torch.floor(u * k)).clamp(0.0, b - 1.0)
    d_star, n_star = _fetch_at_rank(sorted_d, sorted_ids,
                                    torch.where(selected, ranks, 0.0))

    sq_an = torch.where(torch.isfinite(d_star), d_star * d_star,
                        float("inf"))
    hinge = (sq - sq_an + margin).clamp_min(0.0)
    n_sel = selected.sum()
    denom = n_sel.clamp_min(1).float()
    loss = torch.where(selected, hinge, 0.0).sum() / denom

    # W: +1/n at (a, p) and -1/n at (a, n*) of every active pair
    active = selected & (hinge > 0.0)
    w_neg = _row_histogram(torch.where(active, n_star, b), b)
    w = (active.float() - w_neg) / denom
    stats = _stats(dist, pos_mask, neg_mask, n_sel, pair_mask.sum())
    aux = {"selected": selected, "active": active, "n_star": n_star,
           "k": k, "k_lo": k_lo if mode == "semihard" else None}
    return loss, stats, w, aux


def _parity_forward_parts(embeddings: torch.Tensor, labels: torch.Tensor,
                          margin: float, mode: str,
                          draws: Optional[torch.Tensor],
                          k_samples: Optional[int]):
    """Loss, stats, the analytic backward's residuals and the aux of
    :func:`_parity_forward_large`: ``(emb, active_f [B, K], w_neg [B, B],
    denom, poison)`` on the grouped P-K path, ``(emb, w [B, B])`` on the
    dense path."""
    b = labels.shape[0]
    emb32 = embeddings.detach().float()
    sq = pairwise_sq_l2(emb32)
    dist = sq.sqrt()
    pos_mask, neg_mask = _masks(labels)
    if k_samples and 1 < k_samples < b and b % k_samples == 0:
        fits = _pk_grouped(labels, k_samples)
        d2_blk = _pk_group_sq(emb32, k_samples)
        loss, stats, parts, aux = _parity_pk(dist, sq, pos_mask, neg_mask,
                                             draws, margin, mode, k_samples,
                                             d2_blk)
        poison = torch.where(fits, 1.0, float("nan"))
        # a layout violation shows in the same step's metrics too
        minus_one = torch.tensor(-1, device=labels.device)
        stats = MiningStats(
            n_triplets=torch.where(fits, stats.n_triplets, minus_one),
            n_candidates=torch.where(fits, stats.n_candidates, minus_one),
            frac_mined=stats.frac_mined * poison,
            mean_pos_dist=stats.mean_pos_dist * poison,
            mean_neg_dist=stats.mean_neg_dist * poison)
        active_f, w_neg, denom = parts
        return (loss * poison, stats,
                (emb32, active_f, w_neg, denom, poison), aux)
    loss, stats, w, aux = _parity_dense(dist, sq, pos_mask, neg_mask, draws,
                                        margin, mode)
    return loss, stats, (emb32, w), aux


def _parity_forward_large(embeddings: torch.Tensor, labels: torch.Tensor,
                          margin: float, mode: str,
                          draws: Optional[torch.Tensor] = None,
                          k_samples: Optional[int] = None):
    """The reference's modes at production batch, O(B^2 log B), no
    [B, B, B]: each anchor's negatives sorted by euclidean distance once,
    every candidate set is a window of ranks —

    * ``hardest``: [0, 1), the closest negative;
    * ``random_hard``: [0, k), ``k = #{n : d_an < d_ap + m}``;
    * ``semihard``: [k_lo, k_hi), ``k_lo = #{n : d_an <= d_ap}``,
      ``k_hi = #{n : d_an < d_ap + m}``;

    and the uniform choice is the rank ``k_lo + floor(u * k)``. Returns
    ``(loss, stats, w, aux)`` with ``d loss / d sq[a, b] = w[a, b]`` and
    the selections in ``aux`` (``selected``, ``active``, ``n_star``, ``k``,
    ``k_lo``). With ``k_samples`` on a grouped P-K batch the window counts
    come from a [B, B, K] compare-reduce; ``k_samples`` asserts that layout
    (a batch that breaks it is poisoned with NaN)."""
    loss, stats, res, aux = _parity_forward_parts(
        embeddings, labels, margin, mode, draws, k_samples)
    if len(res) == 5:
        _, active_f, w_neg, denom, poison = res
        w = ((_pk_place_grouped(active_f, k_samples) - w_neg)
             / denom) * poison
    else:
        w = res[1]
    return loss, stats, w, aux


class _ParityLargeLoss(torch.autograd.Function):
    """``_parity_large_custom``: the rank-window forward, and the analytic
    backward of ``loss = sum(W * sq)``: with ``S = W + W^T``,
    ``dL/de = 2 (rowsum(S) e - S e)``; on the P-K path W is never built
    (:func:`_structured_w_grad`)."""

    @staticmethod
    def forward(ctx, embeddings, labels, draws, margin, mode, k_samples):
        loss, stats, res, _ = _parity_forward_parts(
            embeddings, labels, margin, mode, draws, k_samples)
        ctx.save_for_backward(*res)
        ctx.k_samples = k_samples
        ctx.mark_non_differentiable(*stats)
        return (loss,) + tuple(stats)

    @staticmethod
    def backward(ctx, g_loss, *_stat_grads):
        res = ctx.saved_tensors
        if len(res) == 5:
            emb, active_f, w_neg, denom, poison = res
            grad = _structured_w_grad(emb, active_f, w_neg, denom, poison,
                                      ctx.k_samples, g_loss)
        else:
            grad = _dense_w_grad(*res, g_loss)
        return grad, None, None, None, None, None


def parity_mined_loss_large(embeddings: torch.Tensor, labels: torch.Tensor,
                            *, margin: float, mode: str,
                            draws: Optional[torch.Tensor] = None,
                            max_positives: Optional[int] = None):
    """The reference's modes at production batch (see
    :func:`_parity_forward_large`); analytic gradient. ``max_positives``
    (``k_samples - 1`` of a P-K batch) arms the grouped compare-reduce
    path; ``draws`` are the uniforms of :func:`draws_shape`."""
    k_samples = (max_positives + 1) if max_positives is not None else None
    loss, *stats = _ParityLargeLoss.apply(embeddings.float(), labels, draws,
                                          margin, mode, k_samples)
    return loss, MiningStats(*stats)


def mined_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor, *,
                       margin: float = 0.5, mode: str = "semihard",
                       rng: Optional[torch.Generator] = None,
                       draws: Optional[torch.Tensor] = None,
                       max_positives: Optional[int] = None):
    """Dispatch to a mining strategy; returns ``(loss, MiningStats)``.

    ``mode`` is one of the reference's ``negatives_selection_mode`` values
    (``semihard``, ``hardest``, ``random_hard``) or ``batch_hard`` /
    ``batch_all``. The stochastic modes take ``draws`` (of
    :func:`draws_shape`), or draw them from ``rng``; one of the two is
    required. Parity modes at B > 256 take the rank-window miner, same
    selection semantics, analytic gradient."""
    b = labels.shape[0]
    if mode in PARITY_MODES:
        if mode in STOCHASTIC_MODES:
            if draws is None:
                if rng is None:
                    raise ValueError(f"mode={mode!r} requires an rng (a "
                                     f"torch.Generator) or its draws")
                draws = sample_draws(mode, b, max_positives, rng,
                                     embeddings.device)
            draws = _check_draws(draws, mode, b, max_positives)
        else:
            draws = None
        if b > _PARITY_CUBE_MAX_B:
            return parity_mined_loss_large(embeddings, labels, margin=margin,
                                           mode=mode, draws=draws,
                                           max_positives=max_positives)
        return _parity_mined_loss(embeddings, labels, margin=margin,
                                  mode=mode, draws=draws)
    if mode == "batch_hard":
        return batch_hard_loss(embeddings, labels, margin=margin)
    if mode == "batch_all":
        return batch_all_loss(embeddings, labels, margin=margin,
                              max_positives=max_positives)
    raise ValueError(f"unknown mining mode {mode!r}; valid: {ALL_MODES}")
