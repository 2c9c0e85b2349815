"""Rematerialisation of the backbones' blocks (``PERFORMANCE.remat``; the
JAX step wraps its whole apply function in ``jax.checkpoint``).

Inside :func:`rematerialize` (with gradients on), each backbone block runs
under ``torch.utils.checkpoint`` (non-reentrant): the forward keeps only
the block's input, and the backward runs the block again to rebuild what
its gradient needs. Per-block checkpoints compute JAX's numbers and are
what frees memory in eager PyTorch. A block is a ResNet ``BasicBlock`` or
``BottleneckBlock``, an ``MBConv`` (EfficientNet, MobileNet v2), a ViT
``EncoderBlock``; the backbones without blocks (``simple``, ``simple2``,
MobileNet v1) run whole under one checkpoint.

The second run must compute what the first computed and change nothing:
it runs in the first run's :mod:`~embeddingnet_tpu_torch.ops.
batchnorm_context` with ``recomputing`` set, so BatchNorm takes its
statistics over the same world (the ranks issue the same collectives in
the same order) and leaves its running statistics alone (the first run
updated them); the drop-connect and Dropout masks are the first run's,
handed back through a :class:`~embeddingnet_tpu_torch.models.stochastic.
MaskSource` (no new draws from the generator).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from embeddingnet_tpu_torch.models.stochastic import MaskSource
from embeddingnet_tpu_torch.ops import batchnorm_context

# a module global, not a thread-local: the autograd engine may run the
# second forward on another thread
_ON = False


@contextlib.contextmanager
def rematerialize(on: bool = True):
    """Inside, the backbones' blocks run under checkpoints (when ``on``
    and gradients are enabled)."""
    global _ON
    prev, _ON = _ON, bool(on)
    try:
        yield
    finally:
        _ON = prev


def active() -> bool:
    return _ON and torch.is_grad_enabled()


def run(fn: Callable, x: torch.Tensor,
        masks: Optional[MaskSource] = None) -> torch.Tensor:
    """``fn(x)`` (``fn(x, masks)`` when ``masks`` is given), under a
    checkpoint inside :func:`rematerialize`."""
    if not active():
        return fn(x) if masks is None else fn(x, masks)
    again = batchnorm_context.current()._replace(recomputing=True)
    first = {}

    def body(x):
        if not first:
            start = len(masks.drawn) if masks is not None else 0
            out = fn(x) if masks is None else fn(x, masks)
            first["masks"] = (masks.drawn[start:] if masks is not None
                              else None)
            return out
        with batchnorm_context.use(again):
            if masks is None:
                return fn(x)
            replay = MaskSource(first["masks"], rows=masks.rows)
            out = fn(x, replay)
            replay.check_used()
            return out

    return checkpoint(body, x, use_reentrant=False,
                      preserve_rng_state=False)
