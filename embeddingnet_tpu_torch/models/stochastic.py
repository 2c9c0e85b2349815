"""The keep masks of the stochastic layers: drop-connect (EfficientNet's
stochastic depth) and Dropout (``simple2``).

``jax.random`` and torch draw different numbers from one seed, so these
layers take their masks as inputs (``ROADMAP.md``, "Shared random draws"):
one :class:`MaskSource` serves a forward pass, handing each layer, in the
order the layers run, either the next given mask or a fresh draw from the
caller's generator. A train step builds one from ``state.generator`` (or
from its ``drop_draws``), so its draws follow the augmentation's and come
before the miner's, and a resumed run draws what an uninterrupted one
would.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


class MaskSource:
    """Keep masks for one forward pass, in layer order.

    ``masks`` (bool tensors, each the shape the layer asks for) are handed
    out first, moved to the layer's device; with none given, each mask is
    ``rand < keep`` from ``generator`` (torch's default generator when
    None). Every mask handed out is kept in :attr:`drawn`, so a run can be
    replayed elsewhere with the same masks.

    ``rows = (lo, hi, global_batch)`` serves one rank of a data-parallel
    step: the masks (given or drawn) are the global batch's, leading axis
    ``global_batch``, and a layer gets rows ``[lo, hi)`` of each, so every
    rank draws what the one-process step draws; :attr:`drawn` keeps the
    global masks."""

    def __init__(self, masks: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 rows: Optional[Tuple[int, int, int]] = None):
        self.masks = None if masks is None else list(masks)
        self.generator = generator
        self.rows = rows
        self.drawn: List[torch.Tensor] = []

    def next(self, shape: Sequence[int], keep: float,
             device: torch.device) -> torch.Tensor:
        """The next keep mask of ``shape`` (a bool tensor on ``device``),
        each entry kept with probability ``keep``."""
        if self.rows is None:
            return self._next(tuple(shape), keep, device)
        lo, hi, global_batch = self.rows
        if shape[0] != hi - lo:
            raise ValueError(f"the layer's batch is {shape[0]} rows; this "
                             f"rank's block is [{lo}, {hi})")
        full = self._next((global_batch,) + tuple(shape[1:]), keep, device)
        return full[lo:hi]

    def _next(self, shape, keep, device):
        if self.masks is not None:
            if len(self.drawn) >= len(self.masks):
                raise ValueError(f"{len(self.masks)} masks given; the "
                                 f"forward asks for more")
            mask = self.masks[len(self.drawn)]
            if tuple(mask.shape) != tuple(shape):
                raise ValueError(f"mask {len(self.drawn)} has shape "
                                 f"{tuple(mask.shape)}; the layer needs "
                                 f"{tuple(shape)}")
            mask = mask.to(device=device, dtype=torch.bool)
        else:
            gen_device = (self.generator.device if self.generator is not None
                          else device)
            mask = (torch.rand(tuple(shape), generator=self.generator,
                               device=gen_device) < keep).to(device)
        self.drawn.append(mask)
        return mask

    def check_used(self) -> None:
        """Raise if given masks were left over: the forward needed fewer
        than it was given."""
        if self.masks is not None and len(self.drawn) != len(self.masks):
            raise ValueError(f"{len(self.masks)} masks given; the forward "
                             f"used {len(self.drawn)}")


def drop_connect(x: torch.Tensor, keep_mask: torch.Tensor,
                 rate: float) -> torch.Tensor:
    """Per-example stochastic depth on an NCHW batch (the JAX
    ``drop_connect``): ``where(mask, x / keep, 0)`` with the [B] mask
    broadcast over the rest."""
    keep = 1.0 - rate
    return torch.where(keep_mask[:, None, None, None], x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, masks: MaskSource, rate: float,
            nhwc: bool = False) -> torch.Tensor:
    """Flax ``nn.Dropout(rate)`` in train mode: ``where(mask, x / keep,
    0)``. The mask has Flax's shape, NHWC for an NCHW feature map
    (``nhwc``), so masks carry over between the packages."""
    keep = 1.0 - rate
    if nhwc:
        b, c, h, w = x.shape
        mask = masks.next((b, h, w, c), keep, x.device).permute(0, 3, 1, 2)
    else:
        mask = masks.next(tuple(x.shape), keep, x.device)
    return torch.where(mask, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))
