"""Spans: named ranges of host time at the training path's layer
boundaries, on the clock of the device trace.

``with span("bn"): ...`` marks one range. The program's spans are
``init`` (``Trainer.__init__``), ``data.wait`` (the fit loop's
``next(batches)``), ``data.get`` (``BatchLoader``'s wait on its producer),
``data.pin`` (``Trainer._to_device``'s ``pin_memory``), ``step`` (one
``train_step`` call), ``augment``, ``mining``, ``all_reduce_grads`` and
``optimizer`` (``train/steps.py``), ``arcface`` (the ArcFace step's loss),
``bn`` (one BatchNorm layer's forward: statistics, affine and output cast),
``cast`` (a layer's casts of its input and parameters to the compute dtype,
opened only when one of them is converted), and in a ViT
(``models/vit.py``) ``attn`` (the attention core, between the
projections), ``ln`` (one LayerNorm) and ``mlp`` (one MLP block).

A span does one or two things:

* **Spans on** (:func:`enable`): on exit it appends a :class:`Span` (name,
  the enclosing span's name on its thread, thread id, start and end from
  ``time.perf_counter_ns()``) to an in-memory list; :func:`spans` and
  :func:`totals` read it, :func:`reset` clears it.
* **A torch profiler running**: it enters a profiler range of its name,
  ``torch._C._profiler._RecordFunctionFast`` (the range PyTorch's own
  compiled kernels carry), which the profiler records when it traces the
  host's operations, so the range appears in the trace by name and
  ``FunctionEvent.device_time_total`` sums the kernels launched inside
  it, as for a ``record_function`` range. When the profiler traces the
  card alone, nothing is recorded and the entry is cheap.

Off and with no profiler running (the default), :func:`span` reads two
module flags (this module's and ``torch.autograd.profiler.
_is_profiler_enabled``) and returns one shared no-op object: it allocates
nothing. Measured per ``with span(...)`` on the host of an NVIDIA H100
80GB HBM3 (torch 2.11, two runs): off 0.45-0.49 us with no profiler,
1.3-1.9 us under a card-only profile, 2.2-3.1 us under one of the host and
the card; on 2.3-2.5, 3.7-3.9 and 5.7-8.1 us. A ``record_function`` range
costs 10.5, 12.4 and 11.5 us in those three states whether or not it is
recorded; the kernels of the same work read 156-173 us of
``device_time_total`` under either kind of range.

**Clock.** torch.profiler (Kineto, torch 2.11) stamps its host events and
the card's kernels, copies and sets in Unix-epoch nanoseconds (host
events from an approximate TSC clock converted to ``CLOCK_REALTIME``,
CUPTI records through the same converter): an event's absolute start is
``prof.profiler.kineto_results.trace_start_ns()`` plus its relative start,
which is what ``_KinetoEvent.start_ns()`` returns. ``perf_counter_ns()``
is ``CLOCK_MONOTONIC``. :func:`clock_offset_ns` is ``time.time_ns() -
time.perf_counter_ns()``, measured once by :func:`enable` (the tightest of
32 bracketing reads); add it to a span's stamps to put the span on the
trace's clock (:func:`place`). :func:`device_busy_ns` reads a profile's
merged device intervals on that clock and :func:`idle_ns` the idle time
inside a set of intervals.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import torch
import torch.autograd.profiler as _profiler

_on = False
_records: List["Span"] = []
_open = threading.local()      # per thread: the names of the open spans
_offset: Optional[int] = None


class Span(NamedTuple):
    name: str
    parent: Optional[str]       # the enclosing span on the same thread
    thread: int                 # threading.get_ident()
    start_ns: int               # time.perf_counter_ns()
    end_ns: int


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Live:
    __slots__ = ("name", "parent", "start", "range", "recording")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        self.recording = _on
        if self.recording:
            stack = getattr(_open, "names", None)
            if stack is None:
                stack = _open.names = []
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
        if _profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        if self.recording:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.recording:
            end = time.perf_counter_ns()
            _open.names.pop()
            _records.append(Span(self.name, self.parent,
                                 threading.get_ident(), self.start, end))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking ``name`` (see the module docstring)."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Live(name)


def enable() -> None:
    """Record spans from now on, and measure :func:`clock_offset_ns`."""
    global _on, _offset
    _offset = _measure_offset()
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop the recorded spans."""
    _records.clear()


def spans() -> List[Span]:
    """The recorded spans, in the order they ended."""
    return list(_records)


def totals() -> Dict[str, list]:
    """``{name: [count, seconds]}`` over the recorded spans."""
    out: Dict[str, list] = {}
    for s in list(_records):
        entry = out.setdefault(s.name, [0, 0.0])
        entry[0] += 1
        entry[1] += (s.end_ns - s.start_ns) * 1e-9
    return out


def _measure_offset(reads: int = 32) -> int:
    best = None
    for _ in range(reads):
        a = time.time_ns()
        p = time.perf_counter_ns()
        b = time.time_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2 - p)
    return best[1]


def clock_offset_ns() -> int:
    """Nanoseconds to add to a ``perf_counter_ns()`` stamp to put it on
    torch.profiler's clock (measured by :func:`enable`, or now)."""
    global _offset
    if _offset is None:
        _offset = _measure_offset()
    return _offset


def place(records: Iterable[Span], name: str,
          thread: Optional[int] = None) -> List[tuple]:
    """The ``(start, end)`` intervals of the spans named ``name`` (on
    ``thread`` when given) on torch.profiler's clock."""
    off = clock_offset_ns()
    return [(s.start_ns + off, s.end_ns + off) for s in records
            if s.name == name and (thread is None or s.thread == thread)]


def _merged(intervals: Iterable[Sequence[int]]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_busy_ns(prof) -> List[list]:
    """The merged intervals, on torch.profiler's clock, in which a kernel,
    copy or set ran on the card in the finished profile ``prof`` (user
    annotations left out)."""
    return _merged(
        (e.start_ns(), e.end_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation())


def idle_ns(busy: Sequence[Sequence[int]],
            intervals: Iterable[Sequence[int]],
            window: Optional[Sequence[int]] = None) -> int:
    """Nanoseconds of the union of ``intervals`` (clipped to ``window``)
    that no interval of ``busy`` (merged, in order) covers."""
    spans_ = _merged(intervals)
    if window is not None:
        spans_ = [[max(s, window[0]), min(e, window[1])] for s, e in spans_
                  if e > window[0] and s < window[1]]
    idle, j = 0, 0
    for s, e in spans_:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        covered, k = 0, j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (e - s) - covered
    return idle
