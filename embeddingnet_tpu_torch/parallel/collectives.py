"""The collectives of data-parallel training, with their gradients.

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
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from embeddingnet_tpu_torch.parallel.mesh import process_row_block


class DataParallel(NamedTuple):
    """A data-parallel world: this process's ``rank`` of ``size`` ranks in
    ``group`` (None: the default process group)."""

    rank: int
    size: int
    group: Optional[object] = None

    @classmethod
    def current(cls, group=None) -> "DataParallel":
        """The initialised process group's world (``group`` or the
        default)."""
        if not dist.is_initialized():
            raise RuntimeError("data-parallel training needs an initialised "
                               "torch.distributed process group")
        return cls(dist.get_rank(group), dist.get_world_size(group), group)

    def rows(self, global_batch: int) -> Tuple[int, int]:
        """``[lo, hi)`` of the global batch that this rank holds."""
        return process_row_block(global_batch, (self.rank, self.size))


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
