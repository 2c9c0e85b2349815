"""Ranks and row blocks of data-parallel training (port of
``embeddingnet_tpu/parallel/mesh.py``).

JAX spreads one step over a ``data`` mesh of devices; the port runs one
process per card under ``torch.distributed`` (``torchrun
--nproc_per_node=N``), each process a rank with its own card, and there is
no one-process-many-cards layout. A rank feeds one equal, contiguous block
of the global batch's rows (:func:`process_row_block`).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

# the variables torchrun sets for every rank
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


class World(NamedTuple):
    rank: int
    size: int


def torchrun_launched() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def maybe_initialize_distributed(device: str = "cuda") -> Optional[str]:
    """Join the process group that torchrun's environment describes;
    returns this rank's device (``cuda:LOCAL_RANK``, or ``cpu``), or None
    without that environment (a plain one-process run: nothing happens).

    NCCL on the card; gloo only when the caller asks for the CPU
    (``device="cpu"``). Call it before any other use of CUDA. A failed
    init raises: a rank that trained alone would fork the run. An already
    initialised group is kept."""
    if not torchrun_launched():
        return None
    if torch.device(device).type == "cpu":
        rank_device = "cpu"
        backend = "gloo"
    else:
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        rank_device = f"cuda:{local}"
        backend = "nccl"
    if not dist.is_initialized():
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = torch.device(rank_device)
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                **kwargs)
    return rank_device


def world() -> World:
    """``(rank, size)`` of the default process group; ``(0, 1)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return World(dist.get_rank(), dist.get_world_size())
    return World(0, 1)


def process_row_block(global_batch: int,
                      rank_world: Optional[Tuple[int, int]] = None,
                      spans=None) -> Tuple[int, int]:
    """``[lo, hi)``: the rows of the global batch that this rank feeds.

    Every rank draws the identical global batch (same seeds) and keeps its
    block, so the ranks' blocks must be contiguous, equal and in rank
    order. ``spans`` (the ``(start, stop)`` slices a rank owns, rank order
    by default) is checked as the JAX function checks its shardings: one
    contiguous block, no gap, the equal share."""
    rank, size = rank_world if rank_world is not None else world()
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} must divide by the "
                         f"world size {size}")
    share = global_batch // size
    if spans is None:
        spans = [(rank * share, (rank + 1) * share)]
    spans = sorted((int(s), int(h)) for s, h in spans)
    lo, hi = spans[0][0], max(h for _, h in spans)
    cover = lo
    for s, h in spans:
        if s > cover:
            raise ValueError(
                f"process {rank} owns non-contiguous batch rows {spans}; "
                f"per-process feeding needs one block")
        cover = max(cover, h)
    if cover != hi:
        raise ValueError(f"gap in process batch rows {spans}")
    if hi - lo != share:
        raise ValueError(
            f"process row block [{lo},{hi}) is not the equal {share}-row "
            f"share of global batch {global_batch}")
    return lo, hi
