"""The benchmark of ``embeddingnet_tpu_torch`` on NVIDIA H100 cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card(s) of this machine from the
root of a checkout and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, and with ``--trace 1`` ``breakdown``; the
numbers that decided ``correct``, each beside its limit, come last in that
line (``checks``) and as the last lines of standard error. It exits
non-zero without a result when the machine has fewer CUDA cards than the
cell asks for, when the directory is not a checkout of the repository, or
when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "embeddingnet_tpu_torch").is_dir():
        _fail(f"{ROOT} holds no embeddingnet_tpu_torch: run from a checkout "
              f"of the repository")
    # libraries that would load JAX by themselves stay off it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, str(ROOT))

    from benchmark import harness, trace

    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        _fail("CUDA is not available; the benchmark runs on a card only")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} CUDA cards, "
              f"{torch.cuda.device_count()} found")
    print(trace.card_line(), file=sys.stderr, flush=True)

    drv = harness.driver(cell.traffic["driver"])
    out = drv.run(cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device="cuda", t_start=T_START)

    loaded = harness.forbidden_loaded()
    if loaded:
        _fail(f"modules of JAX or of the JAX package were loaded: {loaded}")

    device = harness.device_block(cell.chips, out["peak_bytes"],
                                  out["rec"].get("profile_device"))
    result = build_result(cell, out, bool(args.trace), device)
    print("readings: " + json.dumps({k: _finite(v) for k, v in
                                     out["numbers"].items()}),
          file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def _finite(x):
    """A number JSON can hold: None for one that is missing or not
    finite."""
    return x if x is not None and math.isfinite(x) else None


def build_result(cell, out: dict, trace: bool, device: dict) -> dict:
    """The result line of a driver's output: the cell's end-to-end metrics
    (or per-layer ones when traced), and the numbers that decided
    ``correct`` last, each beside its limit."""
    from benchmark import harness

    metrics = cell.per_layer() if trace else cell.end_to_end()
    result = {
        "correct": all(c["ok"] for c in out["checks"]),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": harness.read_metrics(metrics, out["rec"]),
        "device": device,
    }
    if trace:
        result["breakdown"] = out["rec"]["profile"]["breakdown"]
    result["checks"] = {c["name"]: {"value": _finite(c["value"]),
                                    "limit": c["limit"]}
                        for c in out["checks"]}
    return result


if __name__ == "__main__":
    main()
