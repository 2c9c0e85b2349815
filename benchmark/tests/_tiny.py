"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same drivers, readers and comparisons, on tiny shapes."""

import copy
import types

from benchmark import harness


def train_cell(name: str, size: int = 32, compute_dtype=None):
    cell = harness.Cell(name)
    cfg = copy.deepcopy(cell.config)
    c = cfg["config"]
    c["MODEL"]["input_shape"] = [size, size, 3]
    c["GENERATOR"].update(k_classes=4, k_samples=4, batch_size=16,
                          n_batches=4)
    c["PERFORMANCE"]["decode_cache_mb"] = 64
    if compute_dtype:
        c["PERFORMANCE"]["compute_dtype"] = compute_dtype
    traffic = copy.deepcopy(cell.traffic)
    traffic["params"].update(classes=8, per_class=8)
    return types.SimpleNamespace(name=name, config=cfg, traffic=traffic,
                                 limits=cell.limits, chips=1,
                                 end_to_end=cell.end_to_end,
                                 per_layer=cell.per_layer)

