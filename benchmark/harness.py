"""What every cell shares: finding a cell's pieces by name, seeds, the
device block, the metric readers, the check that no JAX module was loaded,
and the result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``benchmark/configs/<config>.json`` (the entry's ``file``),
the traffic ``benchmark/traffic/<traffic>.json``, which names its driver
(``benchmark/drivers/<driver>.py``) and gives its parameters, a cell's
correctness limits ``benchmark/limits/<cell>.json``, and each metric's
reader ``benchmark/metrics/<metric>.py``, which defines ``read(rec)``: the
metric's value from the driver's record, or None when the record holds
nothing for it.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
SPEC = ROOT / "BENCHMARK.json"

# top-level module names that a run must not load: JAX and the package the
# port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "embeddingnet_tpu")


def load_spec(path: Path = SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic, limits
    and metrics."""

    def __init__(self, name: str, spec: Optional[dict] = None):
        spec = spec or load_spec()
        self.spec = spec
        self.entry = _by_name(spec["workloads"], name, "workload")
        self.name = name
        cfg_entry = _by_name(spec["configs"], self.entry["config"], "config")
        self.config = load_json(cfg_entry["file"])
        self.traffic = load_json(f"benchmark/traffic/"
                                 f"{self.entry['traffic']}.json")
        self.limits = load_json(f"benchmark/limits/{name}.json")
        self.chips = int(self.entry["chips"])

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        moves = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    words = [ord(c) for c in tag]
    ss = np.random.SeedSequence([int(seed) % 2 ** 64] + words)
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(metrics: List[dict], rec: dict) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def driver(name: str):
    path = BENCH_DIR / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.drivers.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_block(count: int, peak_bytes: int, profile=None) -> dict:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(peak_bytes)}
    if profile is not None:
        out["busy_s"] = profile["busy_s"]
        out["window_s"] = profile["wall_s"]
    return out


def check_numbers(numbers: Dict[str, float], limits: Dict[str, dict]
                  ) -> List[dict]:
    """Each number beside its limit: ``{"name", "value", "limit", "ok"}``.
    A number must not exceed its limit; a missing number fails."""
    out = []
    for name, lim in limits.items():
        value = numbers.get(name)
        ok = value is not None and np.isfinite(value) \
            and value <= lim["limit"]
        out.append({"name": name, "value": value, "limit": lim["limit"],
                    "ok": bool(ok)})
    return out
