"""The profiler reader: torch.profiler over a fixed stretch of steady units
(train steps), read again until a read can be taken, and reduced to what the
per-layer metrics need.

Tracing the host's operations slows the host several fold per launch, so a
host-bound step's device reads idle far longer under it than untraced. The
device's busy and idle time therefore come from stretches that trace the
card alone (``device_only``); the stretches that also trace the host give
the ``record_function`` ranges, the launch counts and the breakdown.

torch.profiler now and then loses kernel records, all of a read's or a
part, at times several reads in a row, while the same work may launch a few
kernels more or fewer from read to read (a training step does). So a read
counts only when it and an earlier read both come within ``COUNT_RTOL`` of
the most kernels any read saw (:func:`settled`); when no two reads agree
among its reads, :class:`StretchProfiler` raises, naming the cell: a lost
read is never a 0 ms or 0% metric.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, List, Optional

READS = 8
COUNT_RTOL = 0.01
TOP = 10


def settled(counts):
    """Whether the last of ``counts``, the kernel records of reads of the
    same work, can be taken: the read and an earlier one must both come
    within ``COUNT_RTOL`` of the most kernels any read saw."""
    top = max(counts)
    whole = [c > 0 and c >= (1 - COUNT_RTOL) * top for c in counts]
    return whole[-1] and any(whole[:-1])


def card_line() -> str:
    """The card's name, clocks and power limit, as nvidia-smi reads them
    (a line to print before a run's result)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.limit,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: not read ({e})"
    return "nvidia-smi: " + (out.stdout.strip().replace("\n", " | ")
                             or out.stderr.strip())


def _union(intervals):
    """Total length of the union of ``(start, end)`` intervals, and the
    merged intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def summarize(prof, wall_s: float, units: int,
              ranges=("augment", "mining")) -> dict:
    """A taken read, reduced: the device's busy seconds (the union of its
    kernels, copies and sets, user annotations excluded), the device time
    of the kernels launched inside each named ``record_function`` range,
    device seconds by kernel name, and the longest idle gaps named by the
    innermost host operation running when each began."""
    import torch
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_us, merged = _union((e.time_range.start, e.time_range.end)
                             for e in dev)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    range_s = {name: 0.0 for name in ranges}
    host = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name in range_s:
            range_s[e.name] += e.device_time_total * 1e-6
        host.append(e)
    gaps = []
    for (_, end), (start, _) in zip(merged, merged[1:]):
        gaps.append((start - end, end))
    gaps.sort(reverse=True)
    idle = []
    for length, at in gaps[:TOP]:
        inside = [e for e in host
                  if e.time_range.start <= at < e.time_range.end]
        name = (min(inside, key=lambda e: e.time_range.elapsed_us()).name
                if inside else "no host operation")
        idle.append([name, length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"wall_s": wall_s, "busy_s": busy_us * 1e-6, "units": units,
            "kernels": len(dev), "range_device_s": range_s,
            "device_s_by_name": {k: v * 1e-6 for k, v in by_name.items()},
            "breakdown": {"device_ops": [[k, v * 1e-6] for k, v in top],
                          "idle_gaps": idle}}


class StretchProfiler:
    """Profiles ``units`` consecutive units, from the ``start``-th unit seen
    and then every ``every`` units, for ``reads`` stretches; the reads are
    reduced once the window has closed (:meth:`result`), so that no parse
    runs inside it. The caller brackets each unit with :meth:`begin` and
    :meth:`end` (on the thread that runs it); ``counters()`` returns the
    program's launch counters, whose rise over each read is kept beside
    it. With ``device_only`` it traces the card's activity alone."""

    def __init__(self, cell: str, units: int, start: int, every: int,
                 reads: int = 3,
                 counters: Optional[Callable[[], Dict[str, int]]] = None,
                 device_only: bool = False):
        if reads < 2 or reads > READS:
            raise ValueError(f"reads must lie in [2, {READS}]")
        self.cell, self.units, self.start = cell, units, start
        self.every, self.reads = every, reads
        self.device_only = device_only
        self.counters = counters or (lambda: {})
        self.raw: List[tuple] = []
        self.counts: List[int] = []
        self._seen = 0
        self._prof = None
        self._in = 0

    @property
    def done(self) -> bool:
        return len(self.raw) >= self.reads

    def begin(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        idx = self._seen
        self._seen += 1
        if self.done or self._prof is not None:
            return
        if idx < self.start or (idx - self.start) % self.every:
            return
        torch.cuda.synchronize()
        self._before = dict(self.counters())
        self._prof = profile(activities=(
            [ProfilerActivity.CUDA] if self.device_only
            else [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self._in = 0

    def end(self):
        import torch
        if self._prof is None:
            return
        self._in += 1
        if self._in < self.units:
            return
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        after = self.counters()
        self.raw.append((prof, wall, {k: after[k] - self._before.get(k, 0)
                                      for k in after}))

    def result(self) -> dict:
        """The first read that :func:`settled` takes, reduced by
        :func:`summarize`; ``RuntimeError`` naming the cell when none is."""
        for prof, wall, launches in self.raw:
            summary = summarize(prof, wall, self.units)
            summary["launches"] = launches
            self.counts.append(summary["kernels"])
            if settled(self.counts):
                return summary
        raise RuntimeError(
            f"{self.cell}: torch.profiler"
            f"{' (card only)' if self.device_only else ''} saw no two of "
            f"{len(self.raw)} "
            f"reads of {self.units} units with the most kernels (kernel "
            f"counts of the reads {self.counts})")
