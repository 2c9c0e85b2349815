"""BatchNorm on the card: the statistics, the affine and their backward as
the hand-written Hopper kernels of ``csrc/batchnorm_sm90.cu``, for
:class:`~embeddingnet_tpu_torch.ops.fused_conv.BNScaleBias` (the effective
per-channel affine ``(scale, bias)``, which the fused BN-ReLU conv applies)
and :class:`~embeddingnet_tpu_torch.models.resnet.BatchNorm` (the affine
applied, the result in the compute dtype).

The arithmetic is Flax's ``nn.BatchNorm``, as :func:`plain_scale_bias`
computes it: train mode takes the batch mean and the biased variance
``E[x^2] - E[x]^2`` (f32, clamped at 0), ``scale = gamma * rsqrt(var +
eps)``, ``bias = beta - mean * scale``, and moves the running averages by
Flax's momentum (the module's ``momentum`` attribute holds torch's, ``1 -
momentum``); eval mode reads the running averages. It follows
:mod:`~embeddingnet_tpu_torch.ops.batchnorm_context`: with a ``world`` the
per-channel sums are all-reduced over the ranks first (forward, and the
backward's sums after them), and while ``recomputing`` the running averages
stay as they are.

A CPU tensor runs :func:`plain_scale_bias` and :func:`plain_batch_norm`, the
eager PyTorch the JAX parity tests hold, and so does a traced one
(``torch.export``'s or ``torch.compile``'s fake tensors, which hold no
memory to launch on): a traced program holds PyTorch's ops, not the
kernels, as ``EmbeddingNet.save_exported`` traces the convs on cuDNN. A
CUDA tensor launches the kernels or raises: bf16 or f32 inputs summed in f32, parameters and running averages
f32 or bf16; or a float64 input with float64 parameters (a module converted
with ``.double()``, the precision of the card-vs-CPU checks), one channel a
thread and every per-channel number in float64. A channels_last tensor, or
a contiguous NCHW one (taken through its strides, one channel a thread:
NASNet's stem adjusts feed one); another dtype, a float64 input to a module
that is not float64 (or the reverse), or another layout raises.
The launches of one layer: train forward ``bn_stats`` (statistics, affine,
running averages) and, for BatchNorm, ``bn_apply``; backward
``bn_bwd_reduce`` (BatchNorm's sums; BNScaleBias's incoming gradients are
per-channel, so ``bn_finalize``) and ``bn_bwd_dx``; eval forward
``bn_apply`` alone (BatchNorm) or ``bn_finalize`` (BNScaleBias). With a
world, ``bn_finalize`` finishes the all-reduced sums. :func:`plan_batchnorm`
lays each launch out from the rows, the channels and the SMs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from embeddingnet_tpu_torch.ops import _cuda, batchnorm_context
from embeddingnet_tpu_torch.parallel import collectives

# Launches of each kernel since the last reset_launch_counts(), counted
# where the wrapper launches.
LAUNCHES = {"bn_stats": 0, "bn_apply": 0, "bn_bwd_reduce": 0,
            "bn_bwd_dx": 0, "bn_finalize": 0}

THREADS = 256       # the kernels' kThreads: threads a block
VECTOR = 8          # kVec: channels a thread loads at once (16 bytes of bf16)
UNROLL = 4          # kUnroll: rows a thread has in flight
BLOCKS_PER_SM = 4   # blocks the plan aims at for each SM
MAX_TX = 8          # vectors along a slab: one 128-byte line of a bf16 row
MAX_TX_SCALAR = 32  # channels along a slab, one a thread
MAX_GROUPS = 256    # row groups: a slab's last block adds 256 partial rows

# the per-channel finish's flags (csrc/batchnorm_sm90.cu)
BACKWARD, TRAIN, UPDATE, DIRECT, SUMS = 1, 2, 4, 8, 16

# dtype codes (csrc/batchnorm_sm90.cu kF32, kBF16, kF64)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- the plain version -------------------------------------------------------


def plain_scale_bias(bn, x: torch.Tensor):
    """The eager ``(scale, bias)`` of ``bn`` (a ``BNScaleBias``) for ``x``,
    in f32 (f64 for a float64 input), updating the running averages in
    train mode."""
    # f32, or f64 for a float64 input (a module converted with .double())
    acc = torch.promote_types(x.dtype, torch.float32)
    if bn.training:
        xf = x.to(acc)
        ctx = batchnorm_context.current()
        if ctx.world is None:
            mean = xf.mean((0, 2, 3))
            ex2 = xf.square().mean((0, 2, 3))
        else:
            sums = collectives.all_reduce_sum(torch.cat(
                [xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))]),
                ctx.world.group)
            count = xf.numel() // xf.shape[1] * ctx.world.size
            mean, ex2 = (sums / count).chunk(2)
        var = (ex2 - mean.square()).clamp_min(0)
        if not ctx.recomputing:
            with torch.no_grad():
                bn.running_mean.lerp_(mean.to(bn.running_mean.dtype),
                                      bn.momentum)
                bn.running_var.lerp_(var.to(bn.running_var.dtype),
                                     bn.momentum)
                bn.num_batches_tracked += 1
    else:
        mean, var = bn.running_mean, bn.running_var
    scale = torch.rsqrt(var.to(acc) + bn.eps) * bn.weight.to(acc)
    bias = bn.bias.to(acc) - mean.to(acc) * scale
    return scale, bias


def plain_batch_norm(bn, x: torch.Tensor,
                     compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The eager BatchNorm: :func:`plain_scale_bias`'s affine applied in f32,
    the result in ``compute_dtype`` (the affine's dtype when None)."""
    scale, bias = plain_scale_bias(bn, x)
    y = (x.to(scale.dtype) * scale[:, None, None] + bias[:, None, None])
    return y.to(compute_dtype or scale.dtype)


# -- the launch plan ---------------------------------------------------------


class BNPlan(NamedTuple):
    """A launch over ``rows`` x ``channels``: ``groups`` x ``slabs`` blocks
    of THREADS, ``tx`` threads along a slab's channels, ``THREADS // tx``
    along the rows (the rest idle), each thread ``vec`` channels (VECTOR,
    one 16-byte load of bf16, or 1); block ``(g, s)`` covers rows ``[g *
    rows_per_block, (g + 1) * rows_per_block)`` and channels ``[s * tx *
    vec, (s + 1) * tx * vec)``, clipped to the tensor."""
    vec: int
    tx: int
    slabs: int
    groups: int
    rows_per_block: int

    @property
    def ty(self) -> int:
        return THREADS // self.tx


@functools.lru_cache(maxsize=4096)
def plan_batchnorm(rows: int, channels: int, vec: int,
                   sm_count: int) -> BNPlan:
    """The layout of every kernel's launch over a ``rows`` x ``channels``
    activation, ``vec`` channels a thread, on a card of ``sm_count`` SMs,
    and the one place where the kernels adapt to a layer's shape. The
    channels are cut into slabs of at most MAX_TX vectors (MAX_TX_SCALAR
    channels one a thread), balanced so that every slab has about as many;
    the rows into as many groups as bring the grid to about BLOCKS_PER_SM
    blocks an SM, at most MAX_GROUPS (so that a slab's last block adds at
    most 8 partial rows a thread) and each at least UNROLL of the block's
    row strides, which are whole."""
    if rows < 1 or channels < 1 or vec not in (1, VECTOR) or sm_count < 1:
        raise ValueError(f"plan_batchnorm: rows {rows}, channels {channels}, "
                         f"vec {vec}, sm_count {sm_count}")
    columns = -(-channels // vec)
    slabs = -(-columns // (MAX_TX if vec == VECTOR else MAX_TX_SCALAR))
    tx = -(-columns // slabs)
    ty = THREADS // tx
    groups = max(1, min(-(-sm_count * BLOCKS_PER_SM // slabs),
                        -(-rows // (ty * UNROLL)), MAX_GROUPS))
    rows_per_block = -(-(-(-rows // groups)) // ty) * ty
    groups = -(-rows // rows_per_block)
    return BNPlan(vec, tx, slabs, groups, rows_per_block)


class Geometry(NamedTuple):
    """An NCHW tensor as the kernels see it: ``rows`` = N*H*W of
    ``channels``, ``spatial`` = H*W, ``nchw`` 1 for a contiguous NCHW
    tensor, 0 for channels_last (a row-major [rows, channels] matrix)."""
    rows: int
    spatial: int
    channels: int
    nchw: int


def geometry(x: torch.Tensor) -> Geometry:
    """The kernels' view of ``x``; ValueError for a layout they do not
    take. A tensor that is both channels_last and contiguous (a size-1
    dimension) is read as channels_last: the two address alike."""
    if x.dim() != 4:
        raise ValueError(f"batchnorm: an NCHW tensor, got shape "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    if x.is_contiguous(memory_format=torch.channels_last):
        nchw = 0
    elif x.is_contiguous():
        nchw = 1
    else:
        raise ValueError(f"batchnorm: a channels_last or contiguous NCHW "
                         f"tensor, got strides {x.stride()} for shape "
                         f"{tuple(x.shape)}")
    return Geometry(n * h * w, h * w, c, nchw)


def vector_width(geo: Geometry, *tensors: Optional[torch.Tensor]) -> int:
    """VECTOR where every streamed tensor is channels_last bf16 or f32 with
    whole 16-byte vectors (C a multiple of 8, 16-byte aligned bases), else
    1 (float64 always)."""
    if geo.nchw or geo.channels % VECTOR:
        return 1
    if any(t is not None and (t.data_ptr() % 16 or t.dtype == torch.float64)
           for t in tensors):
        return 1
    return VECTOR


# -- the launches ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    return getattr(_cuda.library("batchnorm_sm90"), name)


_TICKETS = {}


def _tickets(device: torch.device, stream: int, slabs: int) -> torch.Tensor:
    """The reduce kernels' per-slab tickets on ``stream``: zeros, which
    every launch leaves zero (its last blocks set them back)."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < slabs:
        t = torch.zeros(max(slabs, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _code(dtype: torch.dtype, what: str) -> int:
    if dtype not in _CODES:
        raise ValueError(f"batchnorm: {what} must be float32, bfloat16 or "
                         f"float64 on the card, got {dtype}")
    return _CODES[dtype]


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"batchnorm: {name} launch failed, "
                           + ("arguments refused" if err < 0
                              else f"CUDA error {err}"))
    LAUNCHES[name] += 1


class _Call(NamedTuple):
    """What a layer's launches share: geometry, card, the addresses of the
    weight, bias, running mean and variance and batch count, the dtype of
    the per-channel numbers (``acc``, f32 or float64) and the per-channel
    constants."""
    geo: Geometry
    device: torch.device
    stream: int
    sm_count: int
    params: Tuple[int, int, int, int, int]
    param_type: int
    acc: torch.dtype
    eps: float
    momentum: float
    count: float


def _call(bn, x: torch.Tensor, world) -> _Call:
    geo = geometry(x)
    _code(x.dtype, "the input")
    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    dtype, device = params[0].dtype, x.device
    p = _code(dtype, "the parameters")
    if any(t.dtype != dtype or t.device != device for t in params):
        raise ValueError("batchnorm: weight, bias and running averages must "
                         "share one dtype and the input's device")
    if (x.dtype == torch.float64) != (dtype == torch.float64):
        raise ValueError(f"batchnorm: a float64 input takes float64 "
                         f"parameters and no other input does, got "
                         f"{x.dtype} and {dtype}")
    if not 1 <= geo.rows < 2 ** 31:
        raise ValueError(f"batchnorm: {geo.rows} rows; the kernels take 1 "
                         f"to 2^31 - 1")
    size = world.size if world is not None else 1
    return _Call(geo, device, _cuda.stream(device),
                 _cuda.sm_count(device.index),
                 tuple(t.data_ptr() for t in params)
                 + (bn.num_batches_tracked.data_ptr(),), p,
                 torch.promote_types(x.dtype, torch.float32), float(bn.eps),
                 float(bn.momentum), float(geo.rows * size))


def _stats(call: _Call, x: torch.Tensor, out: torch.Tensor,
           flags: int) -> None:
    g = call.geo
    plan = plan_batchnorm(g.rows, g.channels, vector_width(g, x),
                          call.sm_count)
    partial = torch.empty(plan.groups * 2 * g.channels, dtype=call.acc,
                          device=call.device)
    _check(_entry("embn_bn_stats")(
        x.data_ptr(), partial.data_ptr(),
        _tickets(call.device, call.stream, plan.slabs).data_ptr(),
        out.data_ptr(), *call.params, g.rows, g.spatial,
        plan.rows_per_block, g.channels, g.nchw, plan.vec, plan.tx,
        plan.groups, plan.slabs, _CODES[x.dtype], call.param_type, flags,
        call.eps, call.momentum, call.count, call.stream), "bn_stats")


def _finalize(call: _Call, out: torch.Tensor, flags: int,
              local=(None, None), world_sums=(None, None),
              stat: Optional[torch.Tensor] = None, dgamma=None,
              dbeta=None) -> None:
    _check(_entry("embn_bn_finalize")(
        _ptr(local[0]), _ptr(local[1]), _ptr(world_sums[0]),
        _ptr(world_sums[1]), out.data_ptr(), _ptr(stat), *call.params,
        _ptr(dgamma), _ptr(dbeta), call.geo.channels, _CODES[call.acc],
        call.param_type, flags, call.eps, call.momentum, call.count,
        call.stream), "bn_finalize")


def _apply(call: _Call, x: torch.Tensor, y: torch.Tensor,
           stat: Optional[torch.Tensor]) -> None:
    g = call.geo
    plan = plan_batchnorm(g.rows, g.channels, vector_width(g, x, y),
                          call.sm_count)
    _check(_entry("embn_bn_apply")(
        x.data_ptr(), y.data_ptr(), _ptr(stat), *call.params[:4], g.rows,
        g.spatial, plan.rows_per_block, g.channels, g.nchw, plan.vec, plan.tx,
        plan.groups, plan.slabs, _CODES[x.dtype], _CODES[y.dtype],
        call.param_type, call.eps, call.stream), "bn_apply")


def _bwd_reduce(call: _Call, x, dy, out, flags, stat=None, dgamma=None,
                dbeta=None) -> None:
    g = call.geo
    plan = plan_batchnorm(g.rows, g.channels, vector_width(g, x, dy),
                          call.sm_count)
    partial = torch.empty(plan.groups * 2 * g.channels, dtype=call.acc,
                          device=call.device)
    _check(_entry("embn_bn_bwd_reduce")(
        x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
        _tickets(call.device, call.stream, plan.slabs).data_ptr(),
        out.data_ptr(), _ptr(stat), call.params[0], _ptr(dgamma),
        _ptr(dbeta), g.rows, g.spatial, plan.rows_per_block, g.channels,
        g.nchw, plan.vec, plan.tx, plan.groups, plan.slabs, _CODES[x.dtype],
        _CODES[dy.dtype], call.param_type, flags, call.eps, call.count,
        call.stream), "bn_bwd_reduce")


def _bwd_dx(call: _Call, x, dy, coef) -> torch.Tensor:
    g = call.geo
    dx = torch.empty_like(x)
    plan = plan_batchnorm(g.rows, g.channels, vector_width(g, x, dy, dx),
                          call.sm_count)
    _check(_entry("embn_bn_bwd_dx")(
        x.data_ptr(), _ptr(dy), dx.data_ptr(), coef.data_ptr(), g.rows,
        g.spatial, plan.rows_per_block, g.channels, g.nchw, plan.vec,
        plan.tx, plan.groups, plan.slabs, _CODES[x.dtype],
        _CODES[(x if dy is None else dy).dtype], call.stream), "bn_bwd_dx")
    return dx


class _BatchNormFunction(torch.autograd.Function):
    """``x, gamma, beta`` -> BatchNorm's ``y`` in ``out_dtype``, or with
    ``out_dtype`` None BNScaleBias's ``(scale, bias)``; the backward runs
    the kernels too."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn, out_dtype, bctx):
        training = bn.training
        world = bctx.world if training else None
        call = _call(bn, x, world)
        C = call.geo.channels
        with _cuda.on_device(call.device):
            stat = None
            if training:
                stat = torch.empty((4, C), dtype=call.acc,
                                   device=call.device)
                flags = TRAIN | (0 if bctx.recomputing else UPDATE)
                if world is None:
                    _stats(call, x, stat, flags)
                else:
                    sums = torch.empty((2, C), dtype=call.acc,
                                       device=call.device)
                    _stats(call, x, sums, SUMS)
                    sums = collectives.reduce_sum(sums, world.group)
                    _finalize(call, stat, flags, local=sums)
            elif out_dtype is None:
                stat = torch.empty((4, C), dtype=call.acc,
                                   device=call.device)
                _finalize(call, stat, 0)
            if out_dtype is not None:
                out = torch.empty_like(x, dtype=out_dtype)
                _apply(call, x, out, stat)
        ctx.bn, ctx.call, ctx.training, ctx.world = bn, call, training, world
        ctx.out_dtype = out_dtype
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, weight, stat)
        return out if out_dtype is not None else (stat[2], stat[3])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        x, weight, stat = ctx.saved_tensors
        bn, training, world = ctx.bn, ctx.training, ctx.world
        call = ctx.call._replace(stream=_cuda.stream(ctx.call.device))
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        C = call.geo.channels
        flags = BACKWARD | (TRAIN if training else 0)
        dx = dgamma = dbeta = None
        with _cuda.on_device(call.device):
            if need_w:
                dgamma = torch.empty_like(bn.weight)
            if need_b:
                dbeta = torch.empty_like(bn.bias)
            coef = torch.empty((4, C), dtype=call.acc, device=call.device)
            if ctx.out_dtype is not None:
                dy, = grads
                if dy is None:
                    return None, None, None, None, None, None
                # in the layout the kernels read x in
                dy = dy.contiguous(memory_format=torch.contiguous_format
                                   if call.geo.nchw else torch.channels_last)
                if stat is None:        # eval mode: the running averages'
                    stat = torch.empty((4, C), dtype=call.acc,
                                       device=call.device)
                    _finalize(call, stat, 0)
                flags |= DIRECT
                if world is None:
                    _bwd_reduce(call, x, dy, coef, flags, stat, dgamma,
                                dbeta)
                else:
                    sums = torch.empty((2, C), dtype=call.acc,
                                       device=call.device)
                    _bwd_reduce(call, x, dy, sums, SUMS)
                    total = collectives.reduce_sum(sums, world.group)
                    _finalize(call, coef, flags, local=sums,
                              world_sums=total, stat=stat, dgamma=dgamma,
                              dbeta=dbeta)
                if need_x:
                    dx = _bwd_dx(call, x, dy, coef)
            else:
                dscale, dbias = (None if g is None
                                 else g.to(call.acc).contiguous()
                                 for g in grads)
                total = (None, None)
                if world is not None:
                    zeros = torch.zeros(C, dtype=call.acc, device=call.device)
                    total = collectives.reduce_sum(torch.stack([
                        zeros if dbias is None else dbias,
                        zeros if dscale is None else dscale]), world.group)
                _finalize(call, coef, flags, local=(dbias, dscale),
                          world_sums=total, stat=stat, dgamma=dgamma,
                          dbeta=dbeta)
                if need_x and training:
                    dx = _bwd_dx(call, x, None, coef)
        return dx, dgamma, dbeta, None, None, None


def _kernels(bn, x, out_dtype):
    if out_dtype is not None and (
            (out_dtype == torch.float64) != (x.dtype == torch.float64)):
        raise ValueError(f"batchnorm: a float64 input gives a float64 "
                         f"output and no other input does, got {x.dtype} "
                         f"to {out_dtype}")
    return _BatchNormFunction.apply(x, bn.weight, bn.bias, bn, out_dtype,
                                    batchnorm_context.current())


def _plain(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the plain version: a CPU or ``meta`` tensor (the
    zoo's modules trace their graph on one), or a traced one."""
    return (x.device.type != "cuda" or isinstance(x, FakeTensor)
            or torch.compiler.is_compiling())


def scale_bias(bn, x: torch.Tensor):
    """``bn``'s (a ``BNScaleBias``) effective affine ``(scale, bias)`` for
    ``x``: the kernels on a CUDA tensor, :func:`plain_scale_bias` where
    :func:`_plain`."""
    if _plain(x):
        return plain_scale_bias(bn, x)
    return _kernels(bn, x, None)


def batch_norm(bn, x: torch.Tensor,
               compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``bn`` (a ``BatchNorm``) applied to ``x``, in ``compute_dtype`` (when
    None f32, or float64 for a float64 input): the kernels on a CUDA tensor,
    :func:`plain_batch_norm` where :func:`_plain`."""
    if _plain(x):
        return plain_batch_norm(bn, x, compute_dtype)
    return _kernels(bn, x, compute_dtype
                    or torch.promote_types(x.dtype, torch.float32))
