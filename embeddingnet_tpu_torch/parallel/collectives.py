"""The collectives of data- and tensor-parallel training, with their
gradients.

Data parallelism (the ranks of a data group, :class:`DataParallel`):

Gradient convention (SPMD, as ``shard_map`` transposes its collectives):
the objective is the **sum over ranks** of the scalar each rank
back-propagates, and the backward of every collective is its transpose —

* :func:`all_gather_rows` (every rank gets all ranks' rows): the backward
  sums the incoming row gradients over ranks and keeps this rank's rows
  (an all-reduce, then a slice);
* :func:`all_reduce_sum` (every rank gets the sum): the backward sums the
  incoming gradients over ranks.

So a loss that every rank computes whole (a replicated value) enters the
objective once only if each rank back-propagates ``loss / world``, and a
per-example mean is a per-rank sum over the rank's rows divided by the
global batch. ``torch.distributed.nn``'s collectives differ (their gather
sums the whole incoming gradient over ranks): a replicated loss
back-propagated as it is would come out ``world`` times too large.

:func:`all_reduce_grads` sums the parameter gradients over ranks in one
flat buffer per dtype, in the parameters' order, so every rank applies
the same update bit for bit.

Tensor parallelism (the ranks of a model group, :class:`ModelParallel`,
Megatron's convention): every rank of a model group computes the same loss
from the same rows and back-propagates all of it; a layer whose weight is
split over the group takes its input through :func:`copy_to_model`
(identity forward, the gradient summed over the group backward: each rank
holds the part of it that its slice produced) and sums its partial outputs
with :func:`reduce_from_model` (summed forward, identity backward).
:func:`gather_slices` puts the slices of a tensor back together.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from embeddingnet_tpu_torch.parallel.mesh import (current_grid,
                                                  process_row_block)


class DataParallel(NamedTuple):
    """A data-parallel world: this process's ``rank`` of ``size`` ranks in
    ``group`` (None: the default process group)."""

    rank: int
    size: int
    group: Optional[object] = None

    @classmethod
    def current(cls, group=None) -> "DataParallel":
        """The world of ``group``; by default this rank's data group: the
        data row of the current grid (:func:`~embeddingnet_tpu_torch.
        parallel.mesh.build_grid`) when it has a model axis, else the
        default process group."""
        if not dist.is_initialized():
            raise RuntimeError("data-parallel training needs an initialised "
                               "torch.distributed process group")
        grid = current_grid()
        if group is None and grid is not None and grid.model > 1:
            return cls(grid.d, grid.data, grid.data_group)
        return cls(dist.get_rank(group), dist.get_world_size(group), group)

    def rows(self, global_batch: int) -> Tuple[int, int]:
        """``[lo, hi)`` of the global batch that this rank holds."""
        return process_row_block(global_batch, (self.rank, self.size))


class ModelParallel(NamedTuple):
    """A model group: this process's ``rank`` of ``size`` ranks in
    ``group``, which hold the slices of one model."""

    rank: int
    size: int
    group: object

    @classmethod
    def current(cls) -> Optional["ModelParallel"]:
        """The current grid's model group, or None without a model axis."""
        grid = current_grid()
        if grid is None or grid.model == 1:
            return None
        return cls(grid.m, grid.model, grid.model_group)

    def span(self, n: int) -> Tuple[int, int]:
        """``[lo, hi)`` of this rank's slice of ``n`` (``torch.
        tensor_split``'s: the first ``n % size`` ranks one more)."""
        base, extra = divmod(n, self.size)
        lo = self.rank * base + min(self.rank, extra)
        return lo, lo + base + (self.rank < extra)


# -- with gradients -----------------------------------------------------------


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        size = dist.get_world_size(group)
        ctx.group, ctx.rank, ctx.n = group, dist.get_rank(group), x.shape[0]
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: Optional[ModelParallel]
                  ) -> torch.Tensor:
    """``x`` into a layer split over the model group: the identity; its
    gradient summed over the group (identity without a model group)."""
    if tp is None or tp.size == 1:
        return x
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[ModelParallel]
                      ) -> torch.Tensor:
    """The sum over the model group of the partial outputs ``x``; the
    gradient passes unchanged (identity without a model group)."""
    if tp is None or tp.size == 1:
        return x
    return _ReduceFromModel.apply(x, tp.group)


def gather_slices(x: torch.Tensor, dim: int, n: int,
                  tp: ModelParallel) -> torch.Tensor:
    """The whole tensor of which each rank of the model group holds its
    :meth:`ModelParallel.span` of ``n`` along ``dim`` (no gradient). The
    slices travel padded to the largest, as one all-gather."""
    x = x.detach()
    longest = -(-n // tp.size)
    pad = list(x.shape)
    pad[dim] = longest - x.shape[dim]
    padded = torch.cat([x, x.new_zeros(pad)], dim).contiguous()
    parts = [torch.empty_like(padded) for _ in range(tp.size)]
    dist.all_gather(parts, padded, group=tp.group)
    spans = [ModelParallel(r, tp.size, None).span(n) for r in range(tp.size)]
    return torch.cat([p.narrow(dim, 0, hi - lo)
                      for p, (lo, hi) in zip(parts, spans)], dim)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` stacked on the leading axis in rank order (equal
    row counts); differentiable under the module's convention."""
    return _AllGatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``x``, on every rank; differentiable under the
    module's convention."""
    return _AllReduceSum.apply(x, group)


# -- without gradients --------------------------------------------------------


def reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``x`` (a new tensor; no gradient)."""
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_gather_rows` without a gradient."""
    with torch.no_grad():
        return _AllGatherRows.apply(x.detach(), group)


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     group=None) -> None:
    """Sum every parameter's ``.grad`` over ranks, in place: one flat
    buffer per dtype, in the parameters' order."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n


def broadcast_module(module: torch.nn.Module, group=None) -> None:
    """Every tensor of ``module``'s state set to rank 0's, in place."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=src, group=group)


def state_digest(module: torch.nn.Module) -> torch.Tensor:
    """Two int64 words that every rank's identical state shares: sums of
    each tensor's bytes as 32-bit words, weighted by position (a cheap
    hash, computed on the tensors' device)."""
    total = None
    for i, t in enumerate(module.state_dict().values()):
        flat = t.detach().contiguous().reshape(-1)
        if flat.numel() == 0:
            continue
        b = flat.view(torch.uint8)
        pad = (-b.numel()) % 4
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        words = b.view(torch.int32).to(torch.int64)
        pos = torch.arange(1, words.numel() + 1, device=words.device)
        part = torch.stack([words.sum(), (words * (pos % 65521)).sum()])
        part = part * (i + 1)
        total = part if total is None else total + part
    return total


def check_replicated(module: torch.nn.Module, group=None,
                     what: str = "initial state") -> None:
    """Raise unless every rank holds a bit-identical ``module`` state (a
    digest compared with rank 0's)."""
    mine = state_digest(module)
    ref = mine.clone()
    dist.broadcast(ref, src=dist.get_global_rank(group, 0)
                   if group is not None else 0, group=group)
    same = torch.equal(mine, ref)
    flag = torch.tensor([0 if same else 1], device=mine.device)
    dist.all_reduce(flag, group=group)
    if int(flag.item()):
        raise RuntimeError(f"the ranks' {what} differs: the state digest of "
                           f"rank {dist.get_rank(group)} is {mine.tolist()}, "
                           f"rank 0's {ref.tolist()}")
