"""Small-spatial 3x3 conv, plain and with a fused BN-apply + ReLU prologue,
forward and backward (port of ``embeddingnet_tpu/ops/fused_conv.py``).

On a CUDA tensor the ops launch the hand-written Hopper kernels; on a CPU
tensor they run their plain PyTorch versions, which the CPU tests hold
against the JAX package. There is no other route: a CUDA tensor the kernel
cannot take raises. Each op is a ``torch.autograd.Function`` whose backward
is the same on both routes: on the card it launches the backward kernels,
on the CPU their plain twins.

* :func:`conv3x3_small` — stride-1 SAME 3x3 conv: forward K1 (the TPU's
  ``_fwd_kernel``); backward K1 as the dgrad (the conv of the output
  gradient with the spatially flipped, in/out-swapped weight) and K2 (the
  TPU's ``_wgrad_kernel``) for the weight gradient.
* :func:`conv3x3_small_mixed` — the same op with the plain conv (cuDNN)
  as forward and the kernel backward, for the 8x8 maps where JAX keeps
  XLA's forward (:func:`eligible_mixed`).
* :func:`conv3x3_small_bn_relu` — ``conv3x3(relu(x*scale + bias), w)``:
  forward K3 (``_fwd_bn_kernel``); backward K1 as the dgrad, the affine and
  ReLU chain rule as plain tensor code (as JAX leaves it to XLA), and K4
  (``_wgrad_bn_kernel``), which recomputes the normalised input from the
  raw ``x`` so that it is never stored.
* :class:`FastConv3x3`, :class:`BNScaleBias`, :class:`FusedBNReluConv3x3` —
  the modules the ResNet blocks use. Their ``state_dict``s equal those of
  ``nn.Conv2d(bias=False)`` and ``nn.BatchNorm2d``, so the fast path never
  changes a checkpoint.

The public functions keep the JAX layout: NHWC activations, ``[3, 3, Cin,
Cout]`` weights. The modules take the ResNet's NCHW tensors in
``torch.channels_last`` memory, whose NHWC view is contiguous and goes to the
kernels without a copy. The kernels are in ``csrc/fused_conv3x3.cu`` (K1,
K3) and ``csrc/conv3x3_wgrad.cu`` (K2, K4).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.ops import _cuda

# Launches of each kernel since the last reset_launch_counts(), counted
# where the wrapper launches; a run reads them to show that its path went
# through the kernels. conv3x3_dgrad is K1 launched as the input gradient.
LAUNCHES = {"conv3x3_small": 0, "conv3x3_small_bn_relu": 0,
            "conv3x3_dgrad": 0, "conv3x3_wgrad": 0,
            "conv3x3_wgrad_bn_relu": 0}

# Map sizes the kernels take: the forward kernel is generic in S, and the
# backward runs at 8x8 too (the mixed path).
KERNEL_SPATIAL = (2, 4, 8)

# Blocks the weight-gradient kernel aims at: about four per SM of the
# H100's 132, reached by splitting the reduction over the B*S*S rows.
_WGRAD_TARGET_BLOCKS = 4 * 132
_WGRAD_MIN_CHUNKS = 16      # 64-row chunks a split reduces, at least


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _gate(x_shape: Sequence[int], w_shape: Sequence[int],
          strides: Sequence[int], groups: int, spatial: Tuple[int, ...],
          dtype: Optional[torch.dtype]) -> bool:
    if tuple(strides) != (1, 1) or groups != 1:
        return False
    if len(x_shape) != 4 or tuple(w_shape[:2]) != (3, 3):
        return False
    _, h, w, cin = x_shape
    if h != w or h not in spatial or cin != w_shape[2]:
        return False
    if cin % 128 != 0 or w_shape[3] % 128 != 0:
        return False
    return dtype is None or dtype == torch.bfloat16


def eligible(x_shape: Sequence[int], w_shape: Sequence[int],
             strides: Sequence[int] = (1, 1), groups: int = 1,
             dtype: Optional[torch.dtype] = None) -> bool:
    """Shape gate of the kernel path, in the JAX layout (x NHWC, w HWIO).

    Eligible: stride-1 SAME 3x3, ungrouped, square spatial S in {2, 4},
    Cin and Cout multiples of 128 — the JAX gate's shape conditions. On the
    card the compute ``dtype`` must also be bf16, the one type the kernels
    are built for (the JAX gate asks a 2-byte dtype on the TPU); pass
    ``None`` for a CPU tensor, where the plain versions take any float type,
    as the JAX gate does in interpret mode.

    Dropped from the JAX gate, because they are facts of the TPU's VMEM: the
    row budgets (``_MAX_ROWS``, ``_wgrad_rows``) and the weight-block cap
    (``_MAX_WEIGHT_BYTES``) — the CUDA kernels stream their operands through
    shared memory in chunks — and the batch-tile condition (``_batch_tile``):
    the kernels mask a ragged last tile, so any batch is eligible.
    """
    return _gate(x_shape, w_shape, strides, groups, (2, 4), dtype)


def _jax_batch_tile_fits(batch: int, s: int, cin: int, cout: int) -> bool:
    """The JAX gate's batch-tile condition (``_batch_tile`` under the plain
    wgrad's row budget ``_wgrad_rows``): some power-of-two tile of at least
    8 divides the batch."""
    rows = 128 if cin * cout >= 512 * 512 else 1024
    tile = min(128, rows // (s * s))
    while tile >= 8:
        if batch % tile == 0:
            return True
        tile //= 2
    return False


def eligible_mixed(x_shape: Sequence[int], w_shape: Sequence[int],
                   strides: Sequence[int] = (1, 1), groups: int = 1,
                   dtype: Optional[torch.dtype] = None) -> bool:
    """Gate of the mixed path at 8x8: the plain conv (cuDNN) forward, as JAX
    keeps XLA's, and the kernel backward. Same conditions as
    :func:`eligible`, plus the JAX gate's batch-tile condition, kept here so
    that the mixed path runs exactly where the JAX package runs it (a batch
    that is a multiple of 8; C=512 is refused at 8x8)."""
    if not _gate(x_shape, w_shape, strides, groups, (8,), dtype):
        return False
    return _jax_batch_tile_fits(x_shape[0], x_shape[1], x_shape[3],
                                w_shape[3])


# ---------------------------------------------------------------------------
# Plain versions: the CPU route and the reference the kernels are held to.
# ---------------------------------------------------------------------------


def _plain_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv, NHWC x HWIO -> NHWC, in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _affine_relu(x: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """relu(x*scale + bias) over the last (channel) axis: f32 math, cast
    back to x's dtype, as the kernels round before the product."""
    return (x.float() * scale + bias).clamp_min(0.0).to(x.dtype)


def _flip(w: torch.Tensor) -> torch.Tensor:
    """The dgrad's weight: spatially flipped, in/out swapped, HWIO."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _plain_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW[dy, dx] = sum over (b, y, x) of x_pad[b, y+dy, x+dx]^T g[b, y, x]:
    the weight gradient of the stride-1 SAME 3x3 conv, [3, 3, Cin, Cout]
    f32 (as JAX's ``_lax_wgrad``)."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([
        torch.stack([
            torch.einsum("bhwc,bhwo->co", xp[:, dy:dy + s, dx:dx + s, :],
                         g).float()
            for dx in range(3)])
        for dy in range(3)])


def _plain_wgrad_bn_relu(x: torch.Tensor, g: torch.Tensor,
                         scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """:func:`_plain_wgrad` of ``relu(x*scale + bias)``."""
    return _plain_wgrad(_affine_relu(x, scale, bias), g)


# ---------------------------------------------------------------------------
# Kernel wrappers. A CPU tensor takes the plain version; anything else goes
# to the kernel, which checks what it is given and raises on what it cannot
# take.
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, w_shape: Sequence[int],
           tensors: Sequence[torch.Tensor],
           scale: Optional[torch.Tensor]) -> None:
    if not _gate(tuple(x.shape), tuple(w_shape), (1, 1), 1, KERNEL_SPATIAL,
                 x.dtype):
        raise ValueError(
            f"{name}: the kernel takes bf16 x [B, S, S, Cin] with S in "
            f"{KERNEL_SPATIAL} and w [3, 3, Cin, Cout], channels multiples "
            f"of 128; got x {tuple(x.shape)} {x.dtype}, w {tuple(w_shape)}")
    cin = x.shape[3]
    if scale is not None:
        for t in tensors[-2:]:
            if t.dtype != torch.float32 or tuple(t.shape) != (cin,):
                raise ValueError(
                    f"{name}: scale and bias must be f32 [{cin}], got "
                    f"{t.dtype} {tuple(t.shape)}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: inputs must be contiguous and 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_conv(name: str, x: torch.Tensor, w: torch.Tensor,
                 scale: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 (no ``scale``) or K3: ``out = conv3x3([relu(x*scale+bias)], w)``,
    bf16 [B, S, S, Cout]; counted under ``name``."""
    tensors = [x, w] + ([scale, bias] if scale is not None else [])
    _check(name, x, tuple(w.shape), tensors, scale)
    if w.dtype != torch.bfloat16:
        raise ValueError(f"{name}: w must be bf16, got {w.dtype}")
    b, s, _, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((b, s, s, cout), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    fn = _cuda.library("fused_conv3x3").embn_conv3x3_small
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(bias),
                 out.data_ptr(), b, s, cin, cout, int(scale is not None),
                 _stream(x.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def wgrad_splits(batch: int, s: int, cin: int, cout: int) -> int:
    """Parts the weight-gradient kernel splits its reduction over the
    ``batch*s*s`` rows into: enough blocks to fill the card (about
    :data:`_WGRAD_TARGET_BLOCKS`), each part at least
    :data:`_WGRAD_MIN_CHUNKS` chunks of 64 rows. The parts' f32 sums are
    added in a fixed order, so the result does not depend on the launch."""
    tiles = (9 * cin // 64) * (cout // 64)
    chunks = -(-batch * s * s // 64)
    return max(1, min(chunks // _WGRAD_MIN_CHUNKS,
                      -(-_WGRAD_TARGET_BLOCKS // tiles)))


def _launch_wgrad(name: str, x: torch.Tensor, g: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 (no ``scale``) or K4: the [3, 3, Cin, Cout] f32 weight gradient of
    ``conv3x3([relu(x*scale+bias)], w)`` for the output gradient ``g``."""
    b, s, _, cin = x.shape
    cout = g.shape[3]
    tensors = [x, g] + ([scale, bias] if scale is not None else [])
    _check(name, x, (3, 3, cin, cout), tensors, scale)
    if g.dtype != x.dtype or tuple(g.shape) != (b, s, s, cout):
        raise ValueError(f"{name}: g must be {x.dtype} {(b, s, s, cout)}, "
                         f"got {g.dtype} {tuple(g.shape)}")
    out = torch.empty((3, 3, cin, cout), dtype=torch.float32,
                      device=x.device)
    if b == 0:
        return out.zero_()
    splits = wgrad_splits(b, s, cin, cout)
    ws = (torch.empty((splits, 9 * cin, cout), dtype=torch.float32,
                      device=x.device) if splits > 1 else out)
    fn = _cuda.library("conv3x3_wgrad").embn_conv3x3_wgrad
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), _ptr(scale), _ptr(bias),
                 ws.data_ptr(), out.data_ptr(), b, s, cin, cout, splits,
                 int(scale is not None), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _conv_fwd(x, w):
    return _plain_conv3x3(x, w) if _on_cpu(x) else \
        _launch_conv("conv3x3_small", x, w)


def _conv_bn_fwd(x, w, scale, bias):
    if _on_cpu(x):
        return _plain_conv3x3(_affine_relu(x, scale, bias), w)
    return _launch_conv("conv3x3_small_bn_relu", x, w, scale, bias)


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the stride-1 SAME 3x3 conv: the same conv of the
    output gradient ``g`` [B, S, S, Cout] with the flipped, transposed
    weight, [B, S, S, Cin] in g's dtype. A CUDA tensor launches K1."""
    wf = _flip(w)
    if _on_cpu(g):
        return _plain_conv3x3(g, wf)
    return _launch_conv("conv3x3_dgrad", g, wf)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME 3x3 conv, [3, 3, Cin, Cout]
    f32. A CUDA tensor launches K2."""
    if _on_cpu(x):
        return _plain_wgrad(x, g)
    return _launch_wgrad("conv3x3_wgrad", x, g)


def conv3x3_wgrad_bn_relu(x: torch.Tensor, g: torch.Tensor,
                          scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``conv3x3(relu(x*scale + bias), w)`` from the raw
    ``x``, [3, 3, Cin, Cout] f32. A CUDA tensor launches K4."""
    if _on_cpu(x):
        return _plain_wgrad_bn_relu(x, g, scale, bias)
    return _launch_wgrad("conv3x3_wgrad_bn_relu", x, g, scale, bias)


# ---------------------------------------------------------------------------
# The differentiable ops.
# ---------------------------------------------------------------------------


def _conv_backward(ctx, g):
    """``_conv_vjp_bwd``: dx by K1 on the flipped weight, dW by K2, rounded
    once to the weight's dtype. ``g`` may come as a channels_last view; the
    kernels take it contiguous."""
    x, w = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()
    dx = conv3x3_dgrad(g, w) if ctx.needs_input_grad[0] else None
    dw = (conv3x3_wgrad(x, g).to(w.dtype) if ctx.needs_input_grad[1]
          else None)
    return dx, dw


class _Conv3x3Small(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv_fwd(x, w)

    backward = staticmethod(_conv_backward)


class _Conv3x3SmallMixed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _plain_conv3x3(x, w)

    backward = staticmethod(_conv_backward)


class _Conv3x3SmallBNRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias):
        ctx.save_for_backward(x, w, scale, bias)
        return _conv_bn_fwd(x, w, scale, bias)

    @staticmethod
    def backward(ctx, g):
        """``_bn_vjp_bwd_common``: dz by K1 on the flipped weight, then the
        affine and ReLU chain rule in f32, dW by K4 from the raw x."""
        x, w, scale, bias = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dz = conv3x3_dgrad(g, w).float()
        xf = x.float()
        dpre = dz * (xf * scale + bias > 0)
        dx = (dpre * scale).to(x.dtype)
        ds = (dpre * xf).sum((0, 1, 2)).to(scale.dtype)
        db = dpre.sum((0, 1, 2)).to(bias.dtype)
        dw = None
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad_bn_relu(x, g, scale, bias).to(w.dtype)
        return dx, dw, ds, db


def conv3x3_small(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv on a small square map, differentiable.

    ``x`` [B, S, S, Cin], ``w`` [3, 3, Cin, Cout]; output [B, S, S, Cout] in
    x's dtype, f32-accumulated. A CUDA tensor launches the kernels (and must
    pass :func:`eligible` with its dtype); a CPU tensor runs the plain
    versions, forward and backward."""
    return _Conv3x3Small.apply(x, w)


def conv3x3_small_mixed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`conv3x3_small` with the plain conv as its forward and the
    kernel backward (the 8x8 maps of :func:`eligible_mixed`)."""
    return _Conv3x3SmallMixed.apply(x, w)


def conv3x3_small_bn_relu(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """``conv3x3(relu(x*scale + bias), w)`` in one kernel, differentiable in
    all four arguments.

    ``x`` [B, S, S, Cin] is the raw pre-BN activation; ``scale``/``bias``
    are the f32 effective affine of the preceding BatchNorm
    (:class:`BNScaleBias`). A CUDA tensor launches the kernels; a CPU tensor
    runs the plain versions."""
    return _Conv3x3SmallBNRelu.apply(x, w, scale, bias)


# ---------------------------------------------------------------------------
# Modules (NCHW tensors, channels_last memory).
# ---------------------------------------------------------------------------


def _compute_dtype(module_dtype: Optional[torch.dtype], x: torch.Tensor,
                   weight: torch.Tensor) -> torch.dtype:
    """Flax's rule: an explicit dtype wins, else the promoted input/param
    type."""
    return module_dtype or torch.promote_types(x.dtype, weight.dtype)


def _gate_dtype(x: torch.Tensor) -> Optional[torch.dtype]:
    return x.dtype if x.device.type != "cpu" else None


def _hwio(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # The kernel's [3, 3, Cin, Cout] weight is a per-call cast and permute
    # of the module's f32 OIHW parameter: one small copy per conv call,
    # counted in the module-level times of PERF.md. Autograd carries dW
    # back through it to the f32 parameter.
    return weight.to(dtype).permute(2, 3, 1, 0).contiguous()


class FastConv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, features, 3, strides, padding=1, bias=False)`` that
    takes the kernel path where the shape is :func:`eligible`, the mixed
    path where it is :func:`eligible_mixed`, and ``F.conv2d`` elsewhere.
    ``compute_dtype`` casts input and weight, as Flax's ``dtype`` field
    does; parameters stay f32."""

    def __init__(self, in_channels: int, features: int,
                 strides: Sequence[int] = (1, 1), groups: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, 3, tuple(strides), 1,
                         groups=groups, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(self.compute_dtype, x, self.weight)
        x = x.to(dtype)
        nhwc = x.permute(0, 2, 3, 1)
        w_shape = (3, 3, self.in_channels // self.groups, self.out_channels)
        args = (tuple(nhwc.shape), w_shape, self.stride, self.groups,
                _gate_dtype(x))
        if eligible(*args):
            op = conv3x3_small
        elif eligible_mixed(*args):
            op = conv3x3_small_mixed
        else:
            return F.conv2d(x, self.weight.to(dtype), None, self.stride, 1,
                            1, self.groups)
        return op(nhwc.contiguous(), _hwio(self.weight, dtype)).permute(
            0, 3, 1, 2)


class BNScaleBias(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that returns the effective per-channel affine
    ``(scale, bias)`` in f32 instead of applying it:
    ``scale = gamma * rsqrt(var + eps)``, ``bias = beta - mean * scale``.

    Statistics follow Flax's ``nn.BatchNorm``: eval mode reads the running
    statistics; train mode uses the batch mean and the biased batch variance
    (``E[x^2] - E[x]^2``, in f32) and updates the running averages with
    ``momentum`` in Flax's sense (``ra = momentum*ra + (1-momentum)*batch``;
    torch's own ``momentum`` attribute holds ``1 - momentum``), the running
    variance biased as Flax keeps it.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.training:
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = (xf.square().mean((0, 2, 3)) - mean.square()).clamp_min(0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var.float() + self.eps) * self.weight.float()
        bias = self.bias.float() - mean.float() * scale
        return scale, bias


class FusedBNReluConv3x3(nn.Conv2d):
    """The conv half of the fused ``bn -> relu -> 3x3 conv`` pair: takes the
    raw pre-BN activation and :class:`BNScaleBias`'s ``(scale, bias)`` and
    computes ``conv3x3(relu(x*scale + bias), weight)`` — through the fused
    kernel where the shape is :func:`eligible`, else through the affine and
    ReLU followed by the mixed op (:func:`eligible_mixed`) or ``F.conv2d``.
    Stride 1, ungrouped, no bias; the parameter is ``nn.Conv2d``'s."""

    def __init__(self, in_channels: int, features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, 3, 1, 1, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(self.compute_dtype, x, self.weight)
        nhwc = x.to(dtype).permute(0, 2, 3, 1)
        scale, bias = scale.float(), bias.float()
        args = (tuple(nhwc.shape), (3, 3, self.in_channels,
                                    self.out_channels))
        gate_dtype = _gate_dtype(nhwc)
        if eligible(*args, dtype=gate_dtype):
            y = conv3x3_small_bn_relu(nhwc.contiguous(),
                                      _hwio(self.weight, dtype), scale, bias)
            return y.permute(0, 3, 1, 2)
        z = _affine_relu(nhwc, scale, bias)
        if eligible_mixed(*args, dtype=gate_dtype):
            y = conv3x3_small_mixed(z.contiguous(),
                                    _hwio(self.weight, dtype))
            return y.permute(0, 3, 1, 2)
        return F.conv2d(z.permute(0, 3, 1, 2), self.weight.to(dtype), None,
                        1, 1)
