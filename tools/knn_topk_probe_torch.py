#!/usr/bin/env python
"""The kNN's top-k on the card, at serving shapes:
``python tools/knn_topk_probe_torch.py``.

Times, by CUDA events (the median of ``ITERS`` calls after ``WARMUP``),
``ops/knn.py`` ``topk_lowest_index`` (ties to the lower DB row, one
``torch.topk`` over int64 keys) against ``torch.topk`` (the order of ties
left open) and against a stable descending sort cut at k, on seeded f32
negated distances [Q, N]; and ``knn_classify`` (distances, top-k, vote)
end to end on a seeded f32 DB of 256-d rows. Prints the card's name and
power limit, then one JSON line of ms by shape. Needs a CUDA card.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, DIM, CLASSES = 5, 256, 1000
QUERIES = (32, 256)
DB_ROWS = (10240, 1048576)
WARMUP, ITERS = 5, 50


def cuda_ms(fn):
    import torch
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main():
    sys.path.insert(0, ROOT)
    import torch
    from embeddingnet_tpu_torch.ops.distances import pairwise_sq_l2
    from embeddingnet_tpu_torch.ops.knn import knn_classify, \
        topk_lowest_index
    if not torch.cuda.is_available():
        raise SystemExit("knn_topk_probe_torch: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n in DB_ROWS:
        db = torch.randn(n, DIM, device="cuda", generator=g)
        db = db / db.norm(dim=1, keepdim=True)
        labels = torch.randint(0, CLASSES, (n,), device="cuda", generator=g)
        for q in QUERIES:
            queries = db[torch.randint(0, n, (q,), device="cuda",
                                       generator=g)]
            neg = -pairwise_sq_l2(queries, db)
            want = neg.sort(dim=1, descending=True, stable=True)[1][:, :K]
            if not torch.equal(topk_lowest_index(neg, K)[1], want):
                raise AssertionError(f"Q={q}, N={n}: topk_lowest_index "
                                     f"differs from the stable sort")
            out[f"Q{q}_N{n}"] = {
                "topk_lowest_index_ms": cuda_ms(
                    lambda: topk_lowest_index(neg, K)),
                "torch_topk_ms": cuda_ms(lambda: torch.topk(neg, K, dim=1)),
                "stable_sort_ms": cuda_ms(
                    lambda: neg.sort(dim=1, descending=True, stable=True)),
                "knn_classify_ms": cuda_ms(
                    lambda: knn_classify(db, labels, queries, k=K,
                                         n_classes=CLASSES))}
            del neg
        del db, labels
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
