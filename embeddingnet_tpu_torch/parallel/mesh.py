"""Ranks, the process grid and row blocks of parallel training (port of
``embeddingnet_tpu/parallel/mesh.py``).

JAX spreads one step over a ``(data, model)`` mesh of devices; the port
runs one process per card under ``torch.distributed`` (``torchrun
--nproc_per_node=N``), each process a rank, and there is no
one-process-many-cards layout. :func:`build_grid` lays the ranks out as
JAX's ``build_mesh`` lays out its devices, a ``(data, model)`` array in
rank order: rank ``r = d * model + m``, a model group is ``model``
consecutive ranks (they hold the slices of one model and see the same
rows), a data group the ranks with the same ``m``. A rank feeds one equal,
contiguous block of the global batch's rows by its data index
(:func:`process_row_block`).
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

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


def maybe_initialize_distributed(device: str = "cuda",
                                 backend: Optional[str] = None
                                 ) -> Optional[str]:
    """Join the process group that torchrun's environment describes;
    returns this rank's device (``cuda:LOCAL_RANK``, or ``cpu``), or None
    without that environment (a plain one-process run: nothing happens).

    ``backend``: NCCL on the card and gloo on the CPU unless the caller
    names one; gloo on the card runs ranks that share a card, which NCCL
    refuses (local rank ``r`` on card ``r % cards``). Call it before any
    other use of CUDA. A failed init raises: a
    rank that trained alone would fork the run. An already initialised
    group is kept."""
    if not torchrun_launched():
        return None
    if torch.device(device).type == "cpu":
        rank_device = "cpu"
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: only gloo "
                             f"runs there")
    else:
        backend = backend or "nccl"
        local = int(os.environ["LOCAL_RANK"])
        if backend == "gloo":
            local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
        rank_device = f"cuda:{local}"
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


class Grid(NamedTuple):
    """The ``(data, model)`` layout of the ranks, as seen by one rank: its
    data index ``d`` and model index ``m`` (``rank = d * model + m``), the
    group of its data row (the ranks with its ``m``; None for the default
    group when ``model == 1``) and of its model group (the ranks with its
    ``d``; None when ``model == 1``)."""

    data: int
    model: int
    d: int
    m: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None


_GRIDS: Dict[Tuple[int, int], Grid] = {}
_CURRENT: Optional[Grid] = None
# the default process group the grids were made in
_GRIDS_WORLD: Optional[object] = None


def _world_group():
    return (dist.group.WORLD if dist.is_available() and dist.is_initialized()
            else None)


def build_grid(data: int = -1, model: int = 1) -> Grid:
    """The grid of the initialised process group's ranks (``MESH.data``
    -1: ``world // model``), which becomes :func:`current_grid`. Every rank
    must call it with the same sizes: each group is made once, by
    ``dist.new_group`` on every rank, and kept for later calls."""
    global _CURRENT, _GRIDS_WORLD
    if _world_group() is None:
        raise RuntimeError("a process grid needs an initialised "
                           "torch.distributed process group")
    if _GRIDS_WORLD is not _world_group():
        _GRIDS.clear()
        _GRIDS_WORLD = _world_group()
    rank, size = world()
    if model < 1:
        raise ValueError(f"MESH.model={model} must be at least 1")
    if data == -1:
        if size % model:
            raise ValueError(f"{size} ranks not divisible by "
                             f"MESH.model={model}")
        data = size // model
    if data * model != size:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"the world has {size}")
    if (data, model) not in _GRIDS:
        d, m = divmod(rank, model)
        data_group = model_group = None
        if model > 1:
            # every rank makes every group, in one order
            for mi in range(model):
                g = dist.new_group([di * model + mi for di in range(data)])
                if mi == m:
                    data_group = g
            for di in range(data):
                g = dist.new_group([di * model + mi for mi in range(model)])
                if di == d:
                    model_group = g
        _GRIDS[(data, model)] = Grid(data, model, d, m, data_group,
                                     model_group)
    _CURRENT = _GRIDS[(data, model)]
    return _CURRENT


def current_grid() -> Optional[Grid]:
    """The grid :func:`build_grid` made last, while the process group it
    was made in lives; else None (every rank on the data axis)."""
    if _CURRENT is not None and _world_group() is not _GRIDS_WORLD:
        reset_grid()
    return _CURRENT


def reset_grid() -> None:
    """Forget the grids (a new process group makes its own)."""
    global _CURRENT, _GRIDS_WORLD
    _GRIDS.clear()
    _CURRENT = _GRIDS_WORLD = None


def data_world() -> World:
    """``(data index, data size)`` of this rank: the grid's, else
    :func:`world`'s."""
    grid = current_grid()
    if grid is None:
        return world()
    return World(grid.d, grid.data)


def process_row_block(global_batch: int,
                      rank_world: Optional[Tuple[int, int]] = None,
                      spans=None) -> Tuple[int, int]:
    """``[lo, hi)``: the rows of the global batch that this rank feeds, by
    its data index (every rank of a model group feeds the same rows).

    Every rank draws the identical global batch (same seeds) and keeps its
    block, so the data rows' blocks must be contiguous, equal and in order. ``spans`` (the ``(start, stop)`` slices a rank owns, rank order
    by default) is checked as the JAX function checks its shardings: one
    contiguous block, no gap, the equal share."""
    rank, size = rank_world if rank_world is not None else data_world()
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
