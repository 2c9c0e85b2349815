"""kNN classification over the encodings DB (port of
``embeddingnet_tpu/ops/knn.py``).

A matmul plus ``torch.topk`` on the device that holds the DB: no host
round trip between encode and classify. Labels are integer class ids;
callers map them to class names.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from embeddingnet_tpu_torch.ops.distances import pairwise_sq_l2


def _vote(neighbor_labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Majority vote over ``[Q, k]`` neighbour labels, with a rank-weighted
    epsilon so that a count tie goes to the class of the nearest tied
    neighbour (sklearn's uniform ``KNeighborsClassifier``)."""
    k = neighbor_labels.shape[1]
    rank_eps = 1.0 / (torch.arange(k, dtype=torch.float32,
                                   device=neighbor_labels.device) + 2.0)
    votes = F.one_hot(neighbor_labels.long(), n_classes).float()  # [Q, k, C]
    counts = (votes * (1.0 + 1e-3 * rank_eps)[None, :, None]).sum(1)
    return counts.argmax(-1)


def knn_classify(db_emb: torch.Tensor, db_labels: torch.Tensor,
                 queries: torch.Tensor, *, k: int = 1,
                 n_classes: int = 1000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Majority-vote kNN: ``(pred_label [Q], neighbor_idx [Q, k])``."""
    d2 = pairwise_sq_l2(queries, db_emb)                  # [Q, N]
    _, idx = torch.topk(-d2, k, dim=1)                    # [Q, k]
    return _vote(db_labels[idx], n_classes), idx


def knn_neighbors(db_emb: torch.Tensor, queries: torch.Tensor, *,
                  k: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kneighbors``: distances and indices of the k nearest DB rows."""
    d2 = pairwise_sq_l2(queries, db_emb)
    neg_d2, idx = torch.topk(-d2, k, dim=1)
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
    _, idx = torch.topk(-d2, k, dim=1)
    return _vote(db_labels[idx], n_classes), idx


def class_centers(db_emb: torch.Tensor, db_labels: torch.Tensor,
                  n_classes: int) -> torch.Tensor:
    """Per-class mean encodings (``ENCODINGS.centers_only``); a class with
    no rows gets a zero centre."""
    onehot = F.one_hot(db_labels.long(), n_classes).float()  # [N, C]
    sums = onehot.T @ db_emb.float()
    counts = onehot.sum(0).clamp_min(1.0)[:, None]
    return sums / counts
