"""Reads the training path's spans (``embeddingnet_tpu_torch/utils/
trace.py``) on the card, in a cell of ``BENCHMARK.json`` set up as the
benchmark sets it up (``benchmark/drivers/train_epochs.py`` ``Run``):

    python tools/span_probe_torch.py --workload resnet50-train-warm \
        --seeds 11 12 13 [--seconds 15] [--costs]

For each seed it prints one JSON line:

* ``images_per_s``: training windows of ``--seconds`` in the order spans
  off, on, on, off (no profiler), so the two sides share the process, the
  card and the seed;
* from the windows with spans on: ``loader_wait_pct.train`` (``data.get``
  seconds over the epochs' wall), ``data_wait_pct.train`` (the Trainer's
  ``_data_wait_s`` over the same wall), ``pin_ms.train`` (``data.pin``
  seconds per batch) and ``spans_per_step``;
* ``trainer_init_s.setup``: the ``init`` span;
* from a traced window laid out as the cell's ``profile`` parameters lay
  out the benchmark's (stretches of the host and the card, and of the card
  alone, read until two agree, :func:`benchmark.trace.settled`), spans on:
  ``<range>_device_ms.train`` of ``bn``, ``cast``, ``optimizer``,
  ``augment`` and ``mining`` (the device time of the kernels launched
  inside the range, per step, forward only), and from a card-only stretch
  ``device_idle_pct.train`` with ``idle_in_data_wait_pct.train`` and
  ``idle_in_step_pct.train``: the stretch's wall with nothing on the card
  while the main thread is inside ``data.wait`` or ``step``, over the
  wall, and ``placed_busy_pct``, the stretch's busy share with its window
  put on the profiler's clock by ``clock_offset_ns()`` (a check of the
  placement: ``100 - device_idle_pct.train``);
* BatchNorm (``ops/batchnorm.py``): ``bn_launches_per_step``, its
  ``LAUNCHES`` over the spans-on windows per step, beside
  ``bn_layers`` (the model's BatchNorms and how many apply the affine),
  and ``bn_kernel_device_ms.train``, the device time per step of each of
  its kernels by symbol (forward and backward) in the host and card
  stretch, with ``top_device_ops``, that stretch's ten costliest device
  operations.

The names are those the metrics would take in ``BENCHMARK.json``.

``--costs`` then prints a span's cost in microseconds, off and on, with
no profiler, a card-only one and one of the host and the card. Card only:
it exits when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = ("bn", "cast", "optimizer", "augment", "mining")
BN_SYMBOLS = ("bn_stats_sm90_kernel", "bn_apply_sm90_kernel",
              "bn_bwd_reduce_sm90_kernel", "bn_bwd_dx_sm90_kernel",
              "bn_finalize_sm90_kernel")


def span_costs(n: int = 20000) -> dict:
    """Microseconds per ``with span(...)``, by state."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from embeddingnet_tpu_torch.utils import trace

    def per_span():
        for _ in range(200):
            with trace.span("probe"):
                pass
        t = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("probe"):
                pass
        return (time.perf_counter_ns() - t) / n / 1e3

    out = {}
    for profiler, acts in [("none", None),
                           ("card_only", [ProfilerActivity.CUDA]),
                           ("host_and_card", [ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])]:
        for on in (False, True):
            trace.enable() if on else trace.disable()
            if acts is None:
                value = per_span()
            else:
                with profile(activities=acts):
                    value = per_span()
            out[f"{profiler}/{'on' if on else 'off'}"] = value
            trace.reset()
    trace.disable()
    torch.cuda.synchronize()
    return out


def _stretch_class():
    from benchmark.trace import StretchProfiler

    class Stretches(StretchProfiler):
        """A StretchProfiler that keeps each read's start, on the host's
        ``perf_counter`` clock, beside it (``starts``)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.starts = []

        def end(self):
            t0 = getattr(self, "_t0", None)
            before = len(self.raw)
            super().end()
            if len(self.raw) > before:
                self.starts.append(t0)

    return Stretches


def _taken(profiler, summarize_fn):
    """The first read that :func:`benchmark.trace.settled` takes, as
    ``(index, summary)``."""
    from benchmark.trace import settled
    counts = []
    for i, (prof, wall, _) in enumerate(profiler.raw):
        summary = summarize_fn(prof, wall)
        counts.append(summary["kernels"])
        if settled(counts):
            return i, summary
    raise RuntimeError(f"no two of {len(counts)} reads agree: {counts}")


def probe(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    import torch
    from benchmark.drivers import train_epochs as te
    from benchmark.trace import summarize
    from embeddingnet_tpu_torch.ops import batchnorm, fused_conv
    from embeddingnet_tpu_torch.utils import trace

    main = threading.get_ident()
    trace.reset()
    trace.enable()
    r = te.Run(cell, seed, device)
    out = {"cell": cell.name, "seed": seed,
           "trainer_init_s.setup": trace.totals()["init"][1]}
    try:
        r.warm()
        bns = [m for m in r.trainer.module.modules()
               if isinstance(m, fused_conv.BNScaleBias)]
        out["bn_layers"] = {"all": len(bns), "affine_applied": sum(
            type(m) is not fused_conv.BNScaleBias for m in bns)}
        ips = []
        on_windows = []
        launches = dict.fromkeys(batchnorm.LAUNCHES, 0)
        for on in (False, True, True, False):
            trace.enable() if on else trace.disable()
            trace.reset()
            batchnorm.reset_launch_counts()
            win = r.window(seconds)
            if on:
                for k, v in batchnorm.LAUNCHES.items():
                    launches[k] += v
            ips.append({"spans": "on" if on else "off",
                        "images_per_s": win["images"] / win["window_s"]})
            if on:
                on_windows.append((win, trace.totals()))
        out["images_per_s"] = ips
        wall = sum(e["wall_s"] for w, _ in on_windows for e in w["epochs"])
        steps = sum(w["steps"] for w, _ in on_windows)

        def tot(name, k=1):
            return sum(t.get(name, [0, 0.0])[k] for _, t in on_windows)

        out["loader_wait_pct.train"] = 100 * tot("data.get") / wall
        out["data_wait_pct.train"] = 100 * sum(
            e["data_wait_s"] for w, _ in on_windows
            for e in w["epochs"]) / wall
        out["pin_ms.train"] = 1e3 * tot("data.pin") / steps
        out["bn_launches_per_step"] = {k: v / steps
                                       for k, v in launches.items()}
        out["spans_per_step"] = {
            name: sum(t.get(name, [0, 0.0])[0] for _, t in on_windows)
            / steps for name in set().union(*(t for _, t in on_windows))}

        pp = r.p["profile"]
        stretches = _stretch_class()
        host = stretches(cell.name, pp["units"], pp["start"], pp["every"],
                         pp["reads"])
        card = stretches(cell.name, pp["units"], pp["device_start"],
                         pp["every"], pp["reads"], device_only=True)
        trace.enable()
        trace.reset()
        while not (host.done and card.done):
            r.window(1e-3, profilers=[host, card])    # one epoch
        records = trace.spans()

        _, s = _taken(host, lambda prof, wall: summarize(
            prof, wall, pp["units"], ranges=RANGES))
        for name in RANGES:
            out[f"{name}_device_ms.train"] = (
                1e3 * s["range_device_s"][name] / pp["units"])
        by_symbol = {}
        for name, sec in s["device_s_by_name"].items():
            for sym in BN_SYMBOLS:
                if sym in name:
                    by_symbol[sym] = by_symbol.get(sym, 0.0) + sec
        out["bn_kernel_device_ms.train"] = {
            k: 1e3 * v / pp["units"] for k, v in by_symbol.items()}
        out["top_device_ops"] = [
            [name[:90], 1e3 * sec / pp["units"]]
            for name, sec in s["breakdown"]["device_ops"]]
        i, s = _taken(card, lambda prof, wall: summarize(
            prof, wall, pp["units"]))
        prof, wall, _ = card.raw[i]
        t0 = int(card.starts[i] * 1e9) + trace.clock_offset_ns()
        window = (t0, t0 + int(wall * 1e9))
        busy = trace.device_busy_ns(prof)
        out["device_idle_pct.train"] = 100 * (1 - s["busy_s"] / s["wall_s"])
        for name, key in (("data.wait", "idle_in_data_wait_pct.train"),
                          ("step", "idle_in_step_pct.train")):
            out[key] = 100 * trace.idle_ns(
                busy, trace.place(records, name, main), window) / (wall * 1e9)
        out["placed_busy_pct"] = 100 * (
            1 - trace.idle_ns(busy, [window]) / (wall * 1e9))
    finally:
        trace.disable()
        r.release()
        r.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--costs", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("span_probe_torch: needs a CUDA card")
    from benchmark import harness, trace as btrace
    print(btrace.card_line(), file=sys.stderr, flush=True)
    cell = harness.Cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(probe(cell, seed, args.seconds)), flush=True)
    if args.costs:
        print(json.dumps({"span_costs_us": span_costs()}), flush=True)


if __name__ == "__main__":
    main()
