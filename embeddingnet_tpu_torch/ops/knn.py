"""kNN classification over the encodings DB (port of
``embeddingnet_tpu/ops/knn.py``).

A matmul plus a top-k on the device that holds the DB: no host round trip
between encode and classify. Labels are integer class ids; callers map
them to class names. Among equal distances the lower DB row comes first,
as ``jax.lax.top_k`` orders them (``torch.topk`` leaves the order of ties
open), so a DB spread over ranks finds the same neighbours
(:mod:`~embeddingnet_tpu_torch.parallel.sharded_knn`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from embeddingnet_tpu_torch.ops.distances import pairwise_sq_l2


def topk_lowest_index(x: torch.Tensor, k: int):
    """The ``k`` largest entries of each row of ``x`` and their positions,
    ties to the lower position, in the total order of ``jax.lax.top_k``
    (-0.0 below 0.0, a NaN beyond the infinity of its sign). The values
    are ordered as integers (a float's bits, the negatives' flipped); for
    float32 and narrower, one ``torch.topk`` over int64 keys of that order
    in the high 32 bits and the position, lower first, in the low 32: the
    keys are distinct, so no tie is left open. float64 leaves no room for
    the position: a stable sort of its order."""
    wide = x.dtype == torch.float64
    bits = x.view(torch.int64) if wide else x.float().view(torch.int32)
    order = torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)
    if wide:
        idx = order.sort(dim=1, descending=True, stable=True).indices[:, :k]
    else:
        low = torch.arange(0xFFFFFFFF, 0xFFFFFFFF - x.shape[1], -1,
                           device=x.device)
        keys = order.long() * 2 ** 32 + low
        idx = 0xFFFFFFFF - (keys.topk(k, dim=1).values & 0xFFFFFFFF)
    return x.gather(1, idx), idx


def vote(neighbor_labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Majority vote over ``[Q, k]`` neighbour labels, with a rank-weighted
    epsilon so that a count tie goes to the class of the nearest tied
    neighbour (sklearn's uniform ``KNeighborsClassifier``). A label -1 (a
    padding row of a sharded DB) votes for no class, as JAX's one-hot of -1
    is zero."""
    k = neighbor_labels.shape[1]
    rank_eps = 1.0 / (torch.arange(k, dtype=torch.float32,
                                   device=neighbor_labels.device) + 2.0)
    labels = neighbor_labels.long()
    labels = torch.where(labels < 0, n_classes, labels)
    votes = F.one_hot(labels, n_classes + 1)[..., :n_classes].float()
    counts = (votes * (1.0 + 1e-3 * rank_eps)[None, :, None]).sum(1)
    return counts.argmax(-1)


def knn_classify(db_emb: torch.Tensor, db_labels: torch.Tensor,
                 queries: torch.Tensor, *, k: int = 1,
                 n_classes: int = 1000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Majority-vote kNN: ``(pred_label [Q], neighbor_idx [Q, k])``."""
    d2 = pairwise_sq_l2(queries, db_emb)                  # [Q, N]
    _, idx = topk_lowest_index(-d2, k)                    # [Q, k]
    return vote(db_labels[idx], n_classes), idx


def knn_neighbors(db_emb: torch.Tensor, queries: torch.Tensor, *,
                  k: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kneighbors``: distances and indices of the k nearest DB rows."""
    d2 = pairwise_sq_l2(queries, db_emb)
    neg_d2, idx = topk_lowest_index(-d2, k)
    return (-neg_d2).clamp_min(0.0).sqrt(), idx


def quantize_db(db_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantisation of the DB:
    ``(values int8 [N, D], scales f32 [N])``."""
    emb32 = db_emb.float()
    scales = emb32.abs().amax(1).clamp_min(1e-12) / 127.0
    values = torch.round(emb32 / scales[:, None]).clamp(-127, 127)
    return values.to(torch.int8), scales


def knn_classify_quantized(db_values: torch.Tensor, db_scales: torch.Tensor,
                           db_labels: torch.Tensor, queries: torch.Tensor, *,
                           k: int = 1, n_classes: int = 1000
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN over an int8 DB (:func:`quantize_db`): with ``e_n ~ s_n v_n``,
    ``d2(q, n) = |q|^2 + s_n^2 |v_n|^2 - 2 s_n (q . v_n)``."""
    q32 = queries.float()
    v32 = db_values.float()
    gram = q32 @ v32.T                                    # [Q, N]
    d2 = (q32.square().sum(1, keepdim=True)
          + (db_scales.square() * v32.square().sum(1))[None, :]
          - 2.0 * db_scales[None, :] * gram)
    _, idx = topk_lowest_index(-d2, k)
    return vote(db_labels[idx], n_classes), idx


def class_centers(db_emb: torch.Tensor, db_labels: torch.Tensor,
                  n_classes: int) -> torch.Tensor:
    """Per-class mean encodings (``ENCODINGS.centers_only``); a class with
    no rows gets a zero centre."""
    onehot = F.one_hot(db_labels.long(), n_classes).float()  # [N, C]
    sums = onehot.T @ db_emb.float()
    counts = onehot.sum(0).clamp_min(1.0)[:, None]
    return sums / counts
