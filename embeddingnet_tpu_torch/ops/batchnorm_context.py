"""How train-mode BatchNorm (:class:`~embeddingnet_tpu_torch.ops.fused_conv.
BNScaleBias`) takes its statistics: one context that the train steps and
:mod:`~embeddingnet_tpu_torch.models.remat` set and BatchNorm reads.

* ``world``: a data-parallel world (:class:`~embeddingnet_tpu_torch.
  parallel.collectives.DataParallel`) whose ranks all-reduce their
  per-channel sums first, so the statistics are the global batch's, as
  JAX's over a data mesh (a world of 1 still issues the collective); None
  keeps them the local batch's;
* ``recomputing``: a rematerialised forward, which recomputes the
  statistics and leaves the running averages alone (the first forward
  updated them).

A module global, not a thread-local: the autograd engine may run a
rematerialised forward on another thread.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional


class BatchNormContext(NamedTuple):
    world: Optional[Any] = None
    recomputing: bool = False


_CURRENT = BatchNormContext()


def current() -> BatchNormContext:
    """The context in force."""
    return _CURRENT


@contextlib.contextmanager
def use(ctx: BatchNormContext):
    """Inside, BatchNorm follows ``ctx``."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, ctx
    try:
        yield
    finally:
        _CURRENT = prev


def global_statistics(world):
    """Inside, train-mode BatchNorm takes its statistics over ``world``'s
    global batch (None: the local batch)."""
    return use(BatchNormContext(world))
