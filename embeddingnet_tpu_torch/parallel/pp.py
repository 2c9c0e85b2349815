"""Pipeline parallelism, GPipe style, over the model axis (port of
``embeddingnet_tpu/parallel/pp.py``).

Each rank of a model group holds one *stage*: a contiguous chunk of
``L / S`` blocks, their parameters stacked on a leading axis
(:func:`stack_stage_params`, :func:`place_stage_params`). The batch is
split into ``n_micro`` microbatches, and ``n_micro + S - 1`` ticks move
them along: at tick ``t`` stage 0 takes microbatch ``t``, each stage
applies its blocks to what it holds and sends the result to the next, and
the last stage keeps microbatch ``t - (S - 1)``. A stage idles where it
holds no microbatch yet or any more (the GPipe bubble, ``S - 1`` of the
``n_micro + S - 1`` ticks; JAX computes discarded values there instead).
The output is replicated over the model group by an all-reduce of the
last stage's output and the others' zeros. No 1F1B schedule, as in JAX.

The transfers are ``torch.autograd.Function``s whose backward sends the
gradient back along the pipe, so ``backward`` or ``torch.autograd.grad``
through :func:`pipeline_blocks_forward` gives every stage its blocks'
gradient of the loss (every rank of the group computes the same loss from
the replicated output and back-propagates it whole, as
``collectives.reduce_from_model`` has it). Under gloo on a card the
tensors cross through host memory (:func:`_send_via_host`,
:func:`_recv_via_host`); NCCL sends them from the card. With one stage
(no model group) the pipeline is the blocks applied in order. The Trainer
does not call it, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from embeddingnet_tpu_torch.parallel.collectives import (ModelParallel,
                                                         reduce_from_model)

Params = Dict[str, torch.Tensor]


def stack_stage_params(block_params_list: Sequence[Params],
                       n_stages: int) -> Params:
    """``[params(block 1) .. params(block L)]`` (each a name -> tensor
    dict, e.g. a block's ``state_dict``) -> one dict with tensors
    ``[S, L/S, ...]``, stage-major."""
    n = len(block_params_list)
    if n % n_stages:
        raise ValueError(f"{n} blocks not divisible into {n_stages} stages")
    per = n // n_stages
    return {name: torch.stack([p[name] for p in block_params_list]).reshape(
        (n_stages, per) + tuple(block_params_list[0][name].shape))
        for name in block_params_list[0]}


def place_stage_params(stacked: Params, grid=None,
                       device: Optional[torch.device] = None) -> Params:
    """This rank's stage of ``stacked`` (its model index; stage 0 without a
    model axis): ``[L/S, ...]`` tensors on ``device``."""
    tp = _pipe(grid)
    stage = tp.rank if tp is not None else 0
    size = tp.size if tp is not None else 1
    out = {}
    for name, value in stacked.items():
        if value.shape[0] != size:
            raise ValueError(f"{name}: {value.shape[0]} stages stacked, "
                             f"the pipe has {size}")
        out[name] = value[stage].to(device).clone()
    return out


def _pipe(grid) -> Optional[ModelParallel]:
    """The model group of ``grid`` (a ``mesh.Grid``, a ModelParallel, or
    None for one stage)."""
    if grid is None or isinstance(grid, ModelParallel):
        return grid if grid is None or grid.size > 1 else None
    if grid.model == 1:
        return None
    return ModelParallel(grid.m, grid.model, grid.model_group)


def _send_via_host(t: torch.Tensor, dst: int, group) -> None:
    """gloo: send ``t`` from host memory (gloo's point-to-point takes host
    tensors)."""
    dist.send(t.detach().to("cpu").contiguous(), dst=dst, group=group)


def _recv_via_host(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """gloo: receive into host memory, then copy to ``like``'s device."""
    buf = torch.empty(like.shape, dtype=like.dtype)
    dist.recv(buf, src=src, group=group)
    return buf.to(like.device)


def _send(t: torch.Tensor, dst: int, group) -> None:
    if t.device.type != "cpu" and dist.get_backend(group) == "gloo":
        _send_via_host(t, dst, group)
    else:
        dist.send(t.detach().contiguous(), dst=dst, group=group)


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    if like.device.type != "cpu" and dist.get_backend(group) == "gloo":
        return _recv_via_host(like, src, group)
    buf = torch.empty_like(like)
    dist.recv(buf, src=src, group=group)
    return buf


class _SendNext(torch.autograd.Function):
    """Forward: send ``y`` to the next stage; returns a zero token that the
    caller adds to its output, which puts this node on the backward path.
    Backward: receive the gradient of ``y`` from the next stage."""

    @staticmethod
    def forward(ctx, y, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.spec = (y.shape, y.dtype, y.device)
        _send(y, dst, group)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.spec
        like = torch.empty(shape, dtype=dtype, device=device)
        return _recv(like, ctx.dst, ctx.group), None, None


class _RecvPrev(torch.autograd.Function):
    """Forward: receive the previous stage's activations (``anchor`` ties
    the node to the stage's parameters, so that a ``torch.autograd.grad``
    on them runs its backward). Backward: send their gradient back."""

    @staticmethod
    def forward(ctx, anchor, like, src, group):
        ctx.src, ctx.group = src, group
        return _recv(like, src, group)

    @staticmethod
    def backward(ctx, g):
        _send(g, ctx.src, ctx.group)
        return None, None, None, None


def pipeline_blocks_forward(block_apply: Callable[[Params, torch.Tensor],
                                                  torch.Tensor],
                            stage_params: Params, x: torch.Tensor, grid=None,
                            *, n_micro: int) -> torch.Tensor:
    """Run ``x`` through the ``S * L/S`` blocks, pipelined over the model
    group of ``grid`` (a ``mesh.Grid``, a ``ModelParallel``, or None for
    one stage).

    ``block_apply(params, h) -> h`` applies one block (for a module,
    ``torch.func.functional_call(block, params, (h,))``);
    ``stage_params`` holds this rank's stage, ``[L/S, ...]`` tensors
    (:func:`place_stage_params`); ``x`` is this rank's ``[B, ...]`` batch
    (the same on every rank of the group), ``B`` divisible by ``n_micro``.
    Returns ``[B, ...]``, the same on every rank of the group."""
    tp = _pipe(grid)
    n_stages = tp.size if tp is not None else 1
    stage = tp.rank if tp is not None else 0
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"local batch {b} not divisible by "
                         f"n_micro={n_micro}")
    per = next(iter(stage_params.values())).shape[0]
    micro = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))

    def stage_fn(h):
        for i in range(per):
            h = block_apply({k: v[i] for k, v in stage_params.items()}, h)
        return h

    if tp is None:
        return torch.cat([stage_fn(micro[j]) for j in range(n_micro)])
    group = tp.group
    prev = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(group, stage + 1) \
        if stage < n_stages - 1 else None
    # any parameter that requires a gradient anchors the receives
    anchor = next((v for v in stage_params.values() if v.requires_grad),
                  x).reshape(-1)[:1].sum() * 0
    outs: List[torch.Tensor] = []
    tokens = []
    for t in range(n_micro + n_stages - 1):
        j = t - stage                   # the microbatch this stage holds
        if not 0 <= j < n_micro:
            continue
        cur = micro[j] if stage == 0 else _RecvPrev.apply(
            anchor, micro[0], prev, group)
        y = stage_fn(cur)
        if nxt is not None:
            tokens.append(_SendNext.apply(y, nxt, group))
        else:
            outs.append(y)
    if outs:
        out = torch.cat(outs)
    else:
        out = torch.zeros_like(x)
    for token in tokens:
        out = out + token
    # replicated over the group: the last stage's output, zeros elsewhere
    return reduce_from_model(out, tp)
