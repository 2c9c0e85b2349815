"""Small-spatial 3x3 conv, plain and with a fused BN-apply + ReLU prologue
(port of ``embeddingnet_tpu/ops/fused_conv.py``, forward only).

On a CUDA tensor the two ops launch the hand-written Hopper kernel of
``csrc/fused_conv3x3.cu``; on a CPU tensor they run their plain PyTorch
versions, which the CPU tests hold against the JAX package. There is no
other route: a CUDA tensor the kernel cannot take raises.

* :func:`conv3x3_small` — stride-1 SAME 3x3 conv (the TPU's ``_fwd_kernel``).
* :func:`conv3x3_small_bn_relu` — ``conv3x3(relu(x*scale + bias), w)``
  (the TPU's ``_fwd_bn_kernel``): the previous BatchNorm's per-channel
  affine and the ReLU run while the kernel stages its input, so the
  normalised activation never goes to device memory.
* :class:`FastConv3x3`, :class:`BNScaleBias`, :class:`FusedBNReluConv3x3` —
  the modules the ResNet blocks use. Their ``state_dict``s equal those of
  ``nn.Conv2d(bias=False)`` and ``nn.BatchNorm2d``, so the fast path never
  changes a checkpoint.

The public functions keep the JAX layout: NHWC activations, ``[3, 3, Cin,
Cout]`` weights. The modules take the ResNet's NCHW tensors in
``torch.channels_last`` memory, whose NHWC view is contiguous and goes to the
kernel without a copy.

The backward kernels (the TPU's ``_wgrad_kernel``, ``_wgrad_bn_kernel`` and
the dgrad use of ``_fwd_kernel``) come with the training port
(``ROADMAP.md``, "TPU kernels to port"); until then a CUDA input that
requires grad raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.ops import _cuda

# Launches of each kernel since the last reset_launch_counts(), counted
# where the wrapper launches; a run reads them to show that its path went
# through the kernels.
LAUNCHES = {"conv3x3_small": 0, "conv3x3_small_bn_relu": 0}


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
    card the compute ``dtype`` must also be bf16, the one type the kernel is
    built for (the JAX gate asks a 2-byte dtype on the TPU); pass ``None``
    for a CPU tensor, where the plain version takes any float type, as the
    JAX gate does in interpret mode.

    Dropped from the JAX gate, because they are facts of the TPU's VMEM: the
    row budgets (``_MAX_ROWS``, ``_wgrad_rows``) and the weight-block cap
    (``_MAX_WEIGHT_BYTES``) — the CUDA kernel streams the weight through
    shared memory in chunks — and the batch-tile condition (``_batch_tile``):
    the kernel masks a ragged last tile, so any batch is eligible.
    """
    return _gate(x_shape, w_shape, strides, groups, (2, 4), dtype)


def eligible_mixed(x_shape: Sequence[int], w_shape: Sequence[int],
                   strides: Sequence[int] = (1, 1), groups: int = 1,
                   dtype: Optional[torch.dtype] = None) -> bool:
    """Gate of the JAX mixed path at 8x8: there the forward is the plain
    conv (``F.conv2d``, as JAX keeps XLA's) and only the backward would take
    the kernels, which come with training. Same conditions as
    :func:`eligible` otherwise."""
    return _gate(x_shape, w_shape, strides, groups, (8,), dtype)


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
    back to x's dtype, as the kernel rounds before the product."""
    return (x.float() * scale + bias).clamp_min(0.0).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _launch(name: str, x: torch.Tensor, w: torch.Tensor,
            scale: Optional[torch.Tensor],
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    tensors = [x, w] + ([scale, bias] if scale is not None else [])
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel is forward-only; the backward kernels come "
            "with the training port (ROADMAP.md). Run under "
            "torch.inference_mode() or torch.no_grad().")
    if not eligible(tuple(x.shape), tuple(w.shape), dtype=x.dtype):
        raise ValueError(
            f"{name}: the kernel takes bf16 x [B, S, S, Cin] with S in "
            f"(2, 4) and w [3, 3, Cin, Cout], channels multiples of 128; "
            f"got x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)}")
    if w.dtype != torch.bfloat16:
        raise ValueError(f"{name}: w must be bf16, got {w.dtype}")
    cin = x.shape[3]
    if scale is not None:
        for t in (scale, bias):
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
    b, s, _, _ = x.shape
    cout = w.shape[3]
    out = torch.empty((b, s, s, cout), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    fn = _cuda.library().embn_conv3x3_small
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 scale.data_ptr() if scale is not None else None,
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), b, s, cin, cout, int(scale is not None),
                 stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def conv3x3_small(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv on a small square map.

    ``x`` [B, S, S, Cin], ``w`` [3, 3, Cin, Cout]; output [B, S, S, Cout] in
    x's dtype, f32-accumulated. A CUDA tensor launches the kernel (and must
    pass :func:`eligible` with its dtype); a CPU tensor runs the plain
    version."""
    if x.device.type == "cpu":
        return _plain_conv3x3(x, w)
    return _launch("conv3x3_small", x, w, None, None)


def conv3x3_small_bn_relu(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """``conv3x3(relu(x*scale + bias), w)`` in one kernel.

    ``x`` [B, S, S, Cin] is the raw pre-BN activation; ``scale``/``bias``
    are the f32 effective affine of the preceding BatchNorm
    (:class:`BNScaleBias`). A CUDA tensor launches the kernel; a CPU tensor
    runs the plain version."""
    if x.device.type == "cpu":
        return _plain_conv3x3(_affine_relu(x, scale, bias), w)
    return _launch("conv3x3_small_bn_relu", x, w, scale, bias)


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
    # counted in the module-level times of PERF.md.
    return weight.to(dtype).permute(2, 3, 1, 0).contiguous()


class FastConv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, features, 3, strides, padding=1, bias=False)`` that
    takes the kernel path where the shape is :func:`eligible` and
    ``F.conv2d`` elsewhere. ``compute_dtype`` casts input and weight, as
    Flax's ``dtype`` field does; parameters stay f32."""

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
        if eligible(tuple(nhwc.shape), w_shape, self.stride, self.groups,
                    _gate_dtype(x)):
            y = conv3x3_small(nhwc.contiguous(), _hwio(self.weight, dtype))
            return y.permute(0, 3, 1, 2)
        return F.conv2d(x, self.weight.to(dtype), None, self.stride, 1, 1,
                        self.groups)


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
    computes ``conv3x3(relu(x*scale + bias), weight)`` — through the kernel
    where the shape is :func:`eligible`, else through the affine and ReLU
    followed by ``F.conv2d``. Stride 1, ungrouped, no bias; the parameter
    is ``nn.Conv2d``'s."""

    def __init__(self, in_channels: int, features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, 3, 1, 1, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(self.compute_dtype, x, self.weight)
        nhwc = x.to(dtype).permute(0, 2, 3, 1)
        scale, bias = scale.float(), bias.float()
        w_shape = (3, 3, self.in_channels, self.out_channels)
        if eligible(tuple(nhwc.shape), w_shape, dtype=_gate_dtype(nhwc)):
            y = conv3x3_small_bn_relu(nhwc.contiguous(),
                                      _hwio(self.weight, dtype), scale, bias)
            return y.permute(0, 3, 1, 2)
        z = _affine_relu(nhwc, scale, bias).permute(0, 3, 1, 2)
        return F.conv2d(z, self.weight.to(dtype), None, 1, 1)
