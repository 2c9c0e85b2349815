"""Exact kNN over an encodings DB whose rows are spread over the ranks
(port of ``embeddingnet_tpu/parallel/sharded_knn.py``).

Each rank holds N/W rows of the DB (and their labels); the queries are the
same on every rank. The search is the two-stage exact top-k: a local top-k
over the rank's rows, an all-gather of the W x k candidates, and the global
top-k of those on every rank. The results equal
:mod:`~embeddingnet_tpu_torch.ops.knn`'s on the whole DB, ties included:
both top-k's keep the lower index among equal distances, and the
candidates are gathered in rank order, which is DB order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from embeddingnet_tpu_torch.ops.distances import pairwise_sq_l2
from embeddingnet_tpu_torch.ops.knn import topk_lowest_index, vote
from embeddingnet_tpu_torch.parallel.collectives import (DataParallel,
                                                         gather_rows)


def _two_stage_topk(local_d2: torch.Tensor, local_ids: torch.Tensor,
                    local_labels: torch.Tensor, k: int, dp: DataParallel):
    """Local top-k -> all-gather of the candidates -> global top-k;
    returns ``(d2 [Q, k], ids [Q, k], labels [Q, k])``."""
    k_local = min(k, local_d2.shape[1])
    neg_d, idx = topk_lowest_index(-local_d2, k_local)
    cand_ids = local_ids[idx]
    cand_labels = local_labels[idx]
    q = neg_d.shape[0]

    def flat(x):
        # [W*Q, kl] in rank order -> [Q, W*kl], rank-major per query
        return x.reshape(dp.size, q, k_local).transpose(0, 1).reshape(q, -1)

    all_d = flat(gather_rows(neg_d, dp.group))
    all_ids = flat(gather_rows(cand_ids, dp.group))
    all_labels = flat(gather_rows(cand_labels, dp.group))
    neg_final, sel = topk_lowest_index(all_d, k)
    return (-neg_final, all_ids.gather(1, sel), all_labels.gather(1, sel))


def sharded_knn(dp: DataParallel, *, k: int = 5, n_classes: int = 1000):
    """``fn(db_local, labels_local, queries) -> (pred [Q], dists [Q, k],
    idx [Q, k])``: ``db_local`` is this rank's block of DB rows (equal
    blocks in rank order), ``idx`` global row numbers, ``pred`` the
    rank-weighted majority vote of :func:`~embeddingnet_tpu_torch.ops.knn.
    knn_classify`, ``dists`` euclidean as :func:`~embeddingnet_tpu_torch.
    ops.knn.knn_neighbors`'. A label -1 (padding rows) votes for no
    class."""

    @torch.no_grad()
    def fn(db_local: torch.Tensor, labels_local: torch.Tensor,
           queries: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        n_local = db_local.shape[0]
        local_ids = dp.rank * n_local + torch.arange(
            n_local, device=db_local.device)
        d2 = pairwise_sq_l2(queries.float(), db_local.float())
        d2_k, ids, labels = _two_stage_topk(d2, local_ids,
                                            labels_local.long(), k, dp)
        return vote(labels, n_classes), d2_k.clamp_min(0.0).sqrt(), ids

    return fn


def sharded_knn_quantized(dp: DataParallel, *, k: int = 5,
                          n_classes: int = 1000):
    """:func:`sharded_knn` over an int8 DB (:func:`~embeddingnet_tpu_torch.
    ops.knn.quantize_db`): each rank holds its int8 rows and their scales;
    ``fn(values_local, scales_local, labels_local, queries)``. The
    distances are :func:`~embeddingnet_tpu_torch.ops.knn.
    knn_classify_quantized`'s."""

    @torch.no_grad()
    def fn(values_local, scales_local, labels_local, queries):
        n_local = values_local.shape[0]
        local_ids = dp.rank * n_local + torch.arange(
            n_local, device=values_local.device)
        q32 = queries.float()
        v32 = values_local.float()
        d2 = (q32.square().sum(1, keepdim=True)
              + (scales_local.square() * v32.square().sum(1))[None, :]
              - 2.0 * scales_local[None, :] * (q32 @ v32.T))
        d2_k, ids, labels = _two_stage_topk(d2, local_ids,
                                            labels_local.long(), k, dp)
        return vote(labels, n_classes), d2_k.clamp_min(0.0).sqrt(), ids

    return fn
