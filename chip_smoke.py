#!/usr/bin/env python
"""Checks the PyTorch port on one CUDA card, in three parts:

    python3 chip_smoke.py             # all three
    python3 chip_smoke.py NAME ...    # the build, then the kernels and the
                                      # paths whose names contain a NAME

1. Build: every ``embeddingnet_tpu_torch/csrc/*.cu`` with ``nvcc``, ptxas's
   registers and spills printed for each kernel instance, and a failure if
   one spills; beside them the native decoder (``csrc/enloader.cpp``), or
   its documented ``native_decoder: unavailable: <reason>`` line.
2. The kernel table of ``PERF.md`` section 6: each hand-written kernel is
   one entry of :func:`registry` (its call, its plain twin, its yardstick,
   the TPU kernel it replaces, its shapes with their calls in one step of
   each run that launches it, its cost). At each shape the call is held to
   the plain twin's arithmetic in float32 and timed: CUDA events (``ms``),
   profiler device time under ``benchmark/trace.py``'s ``settled``
   (``device_ms``), the plain twin, the yardstick and the least time the
   card could take (``bound_ms``). One JSON line a kernel sums them over
   each step. Other shapes, dtypes and edges are the card tests'
   (``tests/test_torch_port_cuda.py``).
3. The paths: each entry of :data:`PATHS` runs a path of the program on the
   card through :func:`run_path`, which zeroes every kernel module's launch
   counts, runs the path with its own checks (losses, answers against
   direct calls, resumes bit for bit, exact launch counts where they are
   known), asserts that the kernels that launched are those the entry
   names, and that no attention or LayerNorm call took the plain version,
   and prints a JSON line of the launches. Any one path runs on its own.

The benchmark (``BENCHMARK.json``) measures the program's speed; nothing
here times a step or a fit. The last line of standard output is ``{"ok":
true, "device": {...}}`` and the line before it the card's name and power
limit; a failure (the table's or a path's; the other paths still run)
exits non-zero without them. ``--child KIND OUT [ARGS]`` runs one rank of
a path's ``torchrun`` launch.
"""

import collections
import dataclasses
import functools
import json
import os
import re
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.data import cell_images, write_dataset
from benchmark.flops import (PEAK_BF16_FLOPS, PEAK_BYTES_PER_S,
                             least_seconds, resnet50_conv3x3_launches)
from benchmark.vit_flops import attention_cost
from embeddingnet_tpu_torch.data.samplers import PKSampler
from embeddingnet_tpu_torch.models import vit
from embeddingnet_tpu_torch.models.api import EmbeddingNet
from embeddingnet_tpu_torch.models.registry import EmbeddingModule
from embeddingnet_tpu_torch.ops import _cuda
from embeddingnet_tpu_torch.ops import attention as att
from embeddingnet_tpu_torch.ops import augment as aug
from embeddingnet_tpu_torch.ops import batchnorm as bnk
from embeddingnet_tpu_torch.ops import fused_conv as fc
from embeddingnet_tpu_torch.ops import layernorm as ln
from embeddingnet_tpu_torch.ops import preprocess as pre
from embeddingnet_tpu_torch.ops.knn import knn_classify
from embeddingnet_tpu_torch.parallel.tp import shard_module
from embeddingnet_tpu_torch.serving import InferenceEngine
from embeddingnet_tpu_torch.train.optim import (get_optimizer,
                                                step_decay_schedule)
from embeddingnet_tpu_torch.train.state import TrainState
from embeddingnet_tpu_torch.train.steps import make_triplet_train_step

SEED = 0
DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(ROOT, "configs")
TOOLS = os.path.join(ROOT, "tools")
CSRC = "embeddingnet_tpu_torch/csrc"
JAX_CONV = "embeddingnet_tpu/ops/fused_conv.py"
TRAIN_BATCH = 1024

# bf16 output rounding: the JAX package's bound for the conv kernels
# (tests/test_fused_conv.py, test_forward_bf16)
RTOL = ATOL = 2e-2


# -- 1. the build ------------------------------------------------------------


def check_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card; the port has no CPU "
                         "route to smoke-test")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    return smi


def build():
    """Every kernel's library (one nvcc per source, in parallel) and, on a
    thread beside them, the native decoder (g++): where the libjpeg/libpng
    headers are missing, its ``unavailable`` line, the documented
    behaviour; any other build failure raises."""
    import threading
    from embeddingnet_tpu_torch.data import native_loader
    t0 = time.perf_counter()
    native = {}

    def build_native():
        try:
            native["ok"] = native_loader.available()
        except BaseException as e:      # raised below, in this thread
            native["error"] = e
    thread = threading.Thread(target=build_native)
    thread.start()
    paths = _cuda.build()
    for source in _cuda.SOURCES:
        _cuda.library(source.stem)
    thread.join()
    if "error" in native:
        raise native["error"]
    print(f"build: {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s")
    if native["ok"]:
        print(f"build: native decoder {native_loader.library_path().name}")
    else:
        print(f"native_decoder: unavailable: "
              f"{native_loader.unavailable_reason()}")
    spills = []
    for path in paths:
        log = path.with_suffix(".log")
        if not log.exists():
            continue
        kernel = "?"
        for line in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = _kernel_label(m.group(1))
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {kernel}: "
                      f"{line.replace('ptxas info    :', '').strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m and (int(m.group(1)) or int(m.group(2))):
                    spills.append(kernel)
    if spills:
        raise AssertionError(f"ptxas reports spills in {spills}")


def _kernel_label(mangled):
    """``conv3x3_sm90_kernel<false, 256, true>`` or
    ``normalize_u8_sm90_kernel`` from the mangled name of a kernel instance
    (bool and int template arguments)."""
    m = re.search(r"\d+((?:conv3x3|normalize_u8|bn|attention|layernorm)"
                  r"_\w*?_kernel)"
                  r"(?:I((?:L[bi]\d+E)+)E)?", mangled)
    if not m:
        return mangled
    args = [("true" if v == "1" else "false") if k == "b" else v
            for k, v in re.findall(r"L([bi])(\d+)E", m.group(2) or "")]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


# -- 2. the kernel table -----------------------------------------------------


def conv_cost(name, b, s, c):
    """(FLOPs, bytes) of one call of a conv kernel at [b, s, s, c], c -> c:
    each input read once, each output written once."""
    flops = 2 * b * s * s * 9 * c * c
    act = b * s * s * c * 2                       # a bf16 activation
    weight = 9 * c * c * 2                        # a bf16 weight
    affine = 2 * c * 4                            # f32 scale and bias
    nbytes = {
        "conv3x3_small": 2 * act + weight,
        "conv3x3_small_bn_relu": 2 * act + weight + affine,
        "conv3x3_dgrad": 2 * act + weight,
        "conv3x3_wgrad": 2 * act + 2 * weight,    # f32 dW
        "conv3x3_wgrad_bn_relu": 2 * act + 2 * weight + affine,
        "conv3x3_small_affine_relu": 2 * act + weight + affine,
    }[name]
    return flops, nbytes


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One hand-written kernel. ``make(gen, shape)`` draws inputs at
    ``shape`` on the card and returns ``(call, plain, want, yardstick)``:
    the launch (returning its output), its plain twin, the plain twin's
    arithmetic in float32, and the library call or eager sequence it
    replaces (or None). ``steps``: each run that launches it -> its shapes
    and their calls a step; ``cost(shape)``: a call's (operations, bytes),
    each input read and output written once; ``tol``: the largest error
    over the reference's largest entry; ``extra(call, yardstick)``: more
    columns at a shape."""
    name: str
    source: str
    replaces: str
    steps: Dict[str, List[Tuple[tuple, int]]]
    make: Callable
    cost: Callable
    tol: float
    extra: Optional[Callable] = None


@functools.lru_cache(maxsize=None)
def _ab_tool():
    return runpy.run_path(os.path.join(TOOLS, "conv3x3_kernels_ab_torch.py"))


def device_ms(fn):
    """Device time of one call of ``fn``: torch.profiler's kernel time from
    a read that ``settled`` takes, as the conv kernels' A/B tool reads
    it."""
    return _ab_tool()["device_ms"](fn)


def cuda_ms(fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# T2's cold reading writes FLUSH_BYTES, more than the 50 MB L2, before each
# launch; its host reading enqueues HOST_LAUNCHES launches
FLUSH_BYTES = 64 << 20
HOST_LAUNCHES = 200
SLEEP_CYCLES_PER_ITER = 200_000     # ~100 us at the H100's ~2 GHz


def cold_ms(fn, flush, iters=50, warmup=3):
    """Device time of one call of ``fn`` with L2 cold: ``flush()`` before
    each launch, the launch alone between two CUDA events, the mean over
    ``iters``. The device first sleeps about 100 us an iteration, so that
    the host has enqueued every launch before the device reaches it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(iters * SLEEP_CYCLES_PER_ITER)
    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def host_us(fn, launches=HOST_LAUNCHES):
    """The host's enqueue cost of one call of ``fn``: ``launches`` calls
    with no synchronize on the host clock, after one call and a
    synchronize; microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / launches * 1e6


def _cold_and_host(call, yardstick):
    """T2's columns beside its hot reading: L2 cold and the host's enqueue
    cost, for the kernel and ``torch.mul``."""
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    flush = lambda: scratch.fill_(1)  # noqa: E731
    return {"cold_ms": cold_ms(call, flush),
            "library_cold_ms": cold_ms(yardstick, flush),
            "host_us": host_us(call), "library_host_us": host_us(yardstick)}


def _randn(gen, shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device=DEVICE)
            * scale).to(dtype)


def _nchw(x):
    """An NHWC tensor as the NCHW view the library takes (channels_last)."""
    return x.permute(0, 3, 1, 2)


def _conv_inputs(gen, b, s, c):
    """x, g [b, s, s, c] and w [3, 3, c, c] in bf16, scale in [0.5, 1.5]
    and bias in f32; the library's NCHW views of x and g and OIHW w."""
    x, g = _randn(gen, (b, s, s, c)), _randn(gen, (b, s, s, c))
    w = _randn(gen, (3, 3, c, c), 0.05)
    scale = torch.rand(c, generator=gen, device=DEVICE) + 0.5
    bias = _randn(gen, (c,), 0.1, torch.float32)
    return x, g, w, scale, bias, _nchw(x), _nchw(g), \
        w.permute(3, 2, 0, 1).contiguous()


def _wgrad_library(g_nchw, x_nchw, w_oihw):
    """The weight gradient alone, in one library call."""
    return torch.ops.aten.convolution_backward(
        g_nchw, x_nchw, w_oihw, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
        1, [False, True, False])


def _conv3x3_small(gen, shape):
    x, _, w, _, _, xl, _, wl = _conv_inputs(gen, *shape)
    return (lambda: fc.conv3x3_small(x, w),
            lambda: fc._plain_conv3x3(x, w),
            fc._plain_conv3x3(x.float(), w.float()),
            lambda: F.conv2d(xl, wl, padding=1))


def _conv3x3_dgrad(gen, shape):
    _, g, w, _, _, _, gl, wl = _conv_inputs(gen, *shape)
    return (lambda: fc.conv3x3_dgrad(g, w),
            lambda: fc._plain_conv3x3(g, fc._flip(w)),
            fc._plain_conv3x3(g.float(), fc._flip(w).float()),
            lambda: F.conv_transpose2d(gl, wl, padding=1))


def _conv3x3_wgrad(gen, shape):
    x, g, _, _, _, xl, gl, wl = _conv_inputs(gen, *shape)
    return (lambda: fc.conv3x3_wgrad(x, g),
            lambda: fc._plain_wgrad(x, g),
            fc._plain_wgrad(x.float(), g.float()),
            lambda: _wgrad_library(gl, xl, wl))


def _conv3x3_small_bn_relu(gen, shape):
    x, _, w, scale, bias, _, _, wl = _conv_inputs(gen, *shape)
    return (lambda: fc.conv3x3_small_bn_relu(x, w, scale, bias),
            lambda: fc._plain_conv3x3(fc._affine_relu(x, scale, bias), w),
            fc._plain_conv3x3(fc._affine_relu(x, scale, bias).float(),
                              w.float()),
            # the eager two-call sequence the fusion replaces
            lambda: F.conv2d(_nchw(fc._affine_relu(x, scale, bias)), wl,
                             padding=1))


def _conv3x3_wgrad_bn_relu(gen, shape):
    x, g, _, scale, bias, _, gl, wl = _conv_inputs(gen, *shape)
    return (lambda: fc.conv3x3_wgrad_bn_relu(x, g, scale, bias),
            lambda: fc._plain_wgrad_bn_relu(x, g, scale, bias),
            fc._plain_wgrad(fc._affine_relu(x, scale, bias).float(),
                            g.float()),
            lambda: _wgrad_library(
                gl, _nchw(fc._affine_relu(x, scale, bias)), wl))


def _conv3x3_small_affine_relu(gen, shape):
    x, _, w, scale, bias, _, _, _ = _conv_inputs(gen, *shape)
    tool = runpy.run_path(os.path.join(TOOLS, "fused_conv_epilogue_torch.py"))
    return (lambda: fc.conv3x3_small_affine_relu(x, w, scale, bias),
            lambda: fc._plain_conv3x3_affine_relu(x, w, scale, bias),
            fc._plain_conv3x3_affine_relu(x.float(), w.float(), scale, bias),
            # the tool's eager conv -> affine -> ReLU
            tool["library_path"](x, w, scale, bias))


def _normalize_u8(gen, shape):
    x = torch.randint(0, 256, shape, generator=gen, device=DEVICE,
                      dtype=torch.uint8)
    out = torch.empty(shape, dtype=torch.bfloat16, device=DEVICE)
    return (lambda: pre.normalize_u8(x),
            lambda: pre._plain_normalize_u8(x),
            pre._plain_normalize_u8(x).float(),
            lambda: torch.mul(x, 1.0 / 255.0, out=out))


def _bn_state(gen, kind, b, c, h, w):
    """A train-mode layer of ``kind`` (BatchNorm or the fused conv's
    BNScaleBias) on a bf16 channels_last input [b, c, h, w], its launch
    state, its statistics ``[mean, var, scale, bias]`` as ``bn_stats``
    writes them, a bf16 cotangent, the mean and the reciprocal std."""
    x = _nchw(_randn(gen, (b, h, w, c), 2.0) + 1)
    from embeddingnet_tpu_torch.models.resnet import BatchNorm
    bn = (fc.BNScaleBias(c, momentum=0.9) if kind == "BNScaleBias"
          else BatchNorm(c, eps=1e-3, momentum=0.9,
                         compute_dtype=torch.bfloat16)).to(DEVICE).train()
    call = bnk._call(bn, x, None)
    stat = torch.empty((4, c), device=DEVICE)
    bnk._stats(call, x, stat, bnk.TRAIN)
    dy = _nchw(_randn(gen, (b, h, w, c)))
    return x, bn, call, stat, dy, stat[0], (stat[2] / bn.weight).detach()


def _per_channel(t):
    return t[:, None, None]


def _bn_stats(gen, shape):
    x, bn, call, stat, _, _, _ = _bn_state(gen, *shape)

    def run():
        bnk._stats(call, x, stat, bnk.TRAIN)
        return stat[2:]
    return (run, lambda: torch.stack(bnk.plain_scale_bias(bn, x)),
            torch.stack(bnk.plain_scale_bias(bn, x.float())),
            lambda: torch.batch_norm_stats(x, bn.eps))


def _bn_apply(gen, shape):
    x, bn, call, stat, _, mean, rstd = _bn_state(gen, *shape)
    y = torch.empty_like(x)

    def run():
        bnk._apply(call, x, y, stat)
        return y

    def plain():
        return x.float() * _per_channel(stat[2]) + _per_channel(stat[3])
    return (run, lambda: plain().bfloat16(), plain(),
            lambda: torch.batch_norm_elemt(x, bn.weight, bn.bias, mean,
                                           rstd, bn.eps))


def _bn_bwd_reduce(gen, shape):
    x, bn, call, stat, dy, mean, rstd = _bn_state(gen, *shape)
    coef = torch.empty_like(stat)
    dgamma, dbeta = torch.empty_like(bn.weight), torch.empty_like(bn.bias)
    flags = bnk.BACKWARD | bnk.TRAIN | bnk.DIRECT

    def run():
        bnk._bwd_reduce(call, x, dy, coef, flags, stat, dgamma, dbeta)
        return dgamma, dbeta

    def plain():
        xhat = (x.float() - _per_channel(mean)) * _per_channel(rstd)
        d = dy.float()
        return (d * xhat).sum((0, 2, 3)), d.sum((0, 2, 3))
    return (run, plain, plain(),
            lambda: torch.batch_norm_backward_reduce(
                dy, x, mean, rstd, bn.weight, True, True, True))


def _bn_bwd_dx(gen, shape):
    x, bn, call, stat, dy, mean, rstd = _bn_state(gen, *shape)
    coef = torch.empty_like(stat)
    library = None
    if shape[0] == "BatchNorm":
        bnk._bwd_reduce(call, x, dy, coef,
                        bnk.BACKWARD | bnk.TRAIN | bnk.DIRECT, stat)
        sums = torch.batch_norm_backward_reduce(dy, x, mean, rstd, bn.weight,
                                                True, False, False)
        count = torch.tensor([x.numel() // x.shape[1]], dtype=torch.int32,
                             device=DEVICE)
        library = lambda: torch.batch_norm_backward_elemt(  # noqa: E731
            dy, x, mean, rstd, bn.weight, sums[0], sums[1], count)
    else:       # the per-channel gradients of (scale, bias) alone
        dy = None
        bnk._finalize(call, coef, bnk.BACKWARD | bnk.TRAIN,
                      local=(stat[3], stat[2]), stat=stat)

    def plain():
        a, b, c, m = (_per_channel(t) for t in coef)
        dx = b * (x.float() - m) + c
        return dx if dy is None else dx + a * dy.float()
    return (lambda: bnk._bwd_dx(call, x, dy, coef),
            lambda: plain().bfloat16(), plain(), library)


def _bn_finalize(gen, shape):
    _, bn, call, stat, _, mean, rstd = _bn_state(gen, *shape)
    dbias, dscale = (_randn(gen, (shape[2],), dtype=torch.float32)
                     for _ in range(2))
    coef = torch.empty_like(stat)
    dgamma, dbeta = torch.empty_like(bn.weight), torch.empty_like(bn.bias)

    def run():
        bnk._finalize(call, coef, bnk.BACKWARD | bnk.TRAIN,
                      local=(dbias, dscale), stat=stat, dgamma=dgamma,
                      dbeta=dbeta)
        return dgamma, dbeta

    def plain():
        return rstd * (dscale - mean * dbias), dbias
    # per-channel arithmetic: the plain twin is the eager sequence
    return run, plain, plain(), None


# each BatchNorm kernel: (the layers that launch it, the passes over the
# activation it makes: x read, y, dx written, dy read)
BN_KERNELS = {"bn_stats": (("BatchNorm", "BNScaleBias"), {}),
              "bn_apply": (("BatchNorm",), {"BatchNorm": 2}),
              "bn_bwd_reduce": (("BatchNorm",), {"BatchNorm": 2}),
              "bn_bwd_dx": (("BatchNorm", "BNScaleBias"),
                            {"BatchNorm": 3, "BNScaleBias": 2}),
              "bn_finalize": (("BNScaleBias",), {"BNScaleBias": 0})}


def _bn_cost(name):
    def cost(shape):
        kind, b, c, h, w = shape
        return 0, BN_KERNELS[name][1].get(kind, 1) * b * c * h * w * 2
    return cost


def _bn_layer_shapes(name, size, fast_conv):
    """``{(kind, C, H, W): layers}`` of ``name``'s BatchNorms at ``size``
    px, from a train-mode forward of one image on the CPU: ``kind``
    BatchNorm (the affine applied) or BNScaleBias (the fused conv's)."""
    module = EmbeddingModule(name, encodings_len=256, fast_conv=fast_conv,
                             input_shape=(size, size, 3))
    shapes = collections.Counter()

    def hook(mod, args):
        kind = ("BNScaleBias" if type(mod) is fc.BNScaleBias
                else "BatchNorm")
        shapes[(kind,) + tuple(args[0].shape[1:])] += 1
    for mod in module.modules():
        if isinstance(mod, fc.BNScaleBias):
            mod.register_forward_pre_hook(hook)
    with torch.no_grad():
        module.train()(torch.rand(1, size, size, 3))
    return shapes


def _attention_inputs(gen, b, n, h, d):
    """q, k, v and an output gradient [b, n, h*d] in bf16; q's scores peak
    in some rows."""
    q, k, v, do = (_randn(gen, (b, n, h * d)) for _ in range(4))
    return (q.float() * 1.5).bfloat16(), k, v, do


def _heads(t, h):
    b, n, c = t.shape
    return t.view(b, n, h, c // h).transpose(1, 2)


def _attention_fwd(gen, shape):
    b, n, h, d = shape
    q, k, v, _ = _attention_inputs(gen, *shape)
    qh, kh, vh = (_heads(t, h) for t in (q, k, v))
    return (lambda: att._forward(q, k, v, h, d, keep_lse=True)[0],
            lambda: att.plain_attention(q, k, v, h),
            att.plain_attention(q.float(), k.float(), v.float(), h),
            lambda: F.scaled_dot_product_attention(qh, kh, vh))


def _attention_bwd(gen, shape):
    b, n, h, d = shape
    q, k, v, do = _attention_inputs(gen, *shape)
    out, lse = att._forward(q, k, v, h, d, keep_lse=True)
    f32 = [t.float() for t in (q, k, v)]
    out32, lse32 = att.plain_forward_lse(*f32, h)
    # the plain path's and the library's backward alone
    plain = [t.detach().requires_grad_() for t in (q, k, v)]
    y_plain = att.plain_attention(*plain, h)
    lib = [_heads(t, h).detach().requires_grad_() for t in (q, k, v)]
    y = F.scaled_dot_product_attention(*lib)
    return (lambda: att._backward(q, k, v, out, do, lse, h, d),
            lambda: torch.autograd.grad(y_plain, plain, do,
                                        retain_graph=True),
            att.plain_backward(*f32, out32, do.float(), lse32, h),
            lambda: torch.autograd.grad(y, lib, _heads(do, h),
                                        retain_graph=True))


def _attention_bwd_cost(shape):
    """q, k, v, O and dO read, dq, dk, dv written, the logsumexp read;
    2.5 times the forward's operations."""
    b, n, h, d = shape
    flops, nbytes = attention_cost(*shape)
    return 5 * flops // 2, 2 * nbytes + b * h * n * 4


def _layernorm_inputs(gen, shape):
    """x and an output gradient [*shape] in bf16 (rows of mean about 1 and
    unit spread), the weight about 1 and the bias about 0 in f32."""
    d = shape[-1]
    x, dy = _randn(gen, shape), _randn(gen, shape)
    x = (x.float() + 1.0).bfloat16()
    w = 1.0 + 0.1 * _randn(gen, (d,), dtype=torch.float32)
    b = 0.1 * _randn(gen, (d,), dtype=torch.float32)
    return x, dy, w, b


def _layernorm_fwd(gen, shape):
    x, _, w, b = _layernorm_inputs(gen, shape)
    return (lambda: ln._forward(x, w, b, VIT_LN_EPS, True)[0],
            lambda: ln.plain_forward(x, w, b, VIT_LN_EPS)[0],
            ln.plain_forward(x.float(), w, b, VIT_LN_EPS)[0],
            lambda: ln.plain_layer_norm(x, w, b, VIT_LN_EPS))


def _layernorm_bwd(gen, shape):
    x, dy, w, b = _layernorm_inputs(gen, shape)
    stats = ln._forward(x, w, b, VIT_LN_EPS, True)[1]
    _, mean32, rstd32 = ln.plain_forward(x.float(), w, b, VIT_LN_EPS)
    # the eager sequence's backward alone: autograd of cast, F.layer_norm,
    # cast
    leaves = [t.detach().requires_grad_() for t in (x, w, b)]
    y = ln.plain_layer_norm(*leaves, VIT_LN_EPS)
    return (lambda: ln._backward(x, dy, stats, w),
            lambda: ln.plain_backward(x, dy, *stats, w),
            ln.plain_backward(x.float(), dy.float(), mean32, rstd32, w),
            lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True))


def _layernorm_cost(backward):
    """x read and y written once (and the kept mean and rstd), or x and dy
    read and dx written once (the statistics read, the parameters'
    gradients written); the parameters read; in bf16, f32 beside."""
    def cost(shape):
        d = shape[-1]
        rows = int(np.prod(shape)) // d
        return 0, (rows * d * 2 * (3 if backward else 2) + rows * 2 * 4
                   + d * 4 * (3 if backward else 2))
    return cost


def _conv(make, replaces, steps=None, tol=RTOL):
    """The entry of the conv kernel that ``make`` (``_<its name>``) draws:
    its shapes (b, s, c) and calls in one step of the cell
    resnet50-train-warm (ResNet-50 at 64 px, B=1,024) where it runs there,
    and ``steps``."""
    name = make.__name__[1:]
    calls = collections.Counter(
        (b, s, c) for k, b, s, c in resnet50_conv3x3_launches(TRAIN_BATCH, 64)
        if k == name)
    cells = {"resnet50-train-warm": sorted(calls.items())} if calls else {}
    return Kernel(name, f"{CSRC}/conv3x3_sm90.cu", replaces,
                  {**cells, **(steps or {})}, make,
                  lambda shape: conv_cost(name, *shape), tol)


RESNET_CELLS = (("resnet50-train-warm", "resnet50", 64, True),
                ("effb3-train-warm", "efficientnet-b3", 96, False))
# the ViT cell's attention core (224 px: 197 tokens, 12 heads of 64) and its
# calls a step: 12 blocks, each forward twice under remat
ATT_CELL = (256, 197, 12, 64)
# its LayerNorms' input and their calls a step: 2 a block, each forward
# twice under remat, and ln_final
LN_CELL, VIT_LN_EPS = (256, 197, 768), 1e-12


def registry():
    """Every hand-written kernel of the port, one entry each."""
    bn_layers = {cell: _bn_layer_shapes(model, size, fast)
                 for cell, model, size, fast in RESNET_CELLS}

    def bn_steps(name):
        steps = {cell: [((kind, TRAIN_BATCH, c, h, w), n)
                        for (kind, c, h, w), n in sorted(layers.items())
                        if kind in BN_KERNELS[name][0]]
                 for cell, layers in bn_layers.items()}
        return {cell: calls for cell, calls in steps.items() if calls}
    # the f32 weight gradient: the same bf16 products summed in f32 in
    # another order; BatchNorm's f32 sums of up to a million terms in
    # another order; a bf16 output one rounding apart
    return [
        # ResNet-50 fuses every stride-1 3x3 conv it runs at 4x4 and 2x2;
        # ResNet-18's second block of a stage does not
        _conv(_conv3x3_small, f"K1, {JAX_CONV}:200 _fwd_kernel",
              {"siamese step (configs/siamese_resnet18_pairs.yml, two "
               "streams of B=8)": [((8, 4, 256), 2), ((8, 2, 512), 2)]}),
        _conv(_conv3x3_dgrad, f"K1 as the dgrad, {JAX_CONV}:200 _fwd_kernel"),
        _conv(_conv3x3_wgrad, f"K2, {JAX_CONV}:225 _wgrad_kernel", tol=1e-3),
        _conv(_conv3x3_small_bn_relu, f"K3, {JAX_CONV}:556 _fwd_bn_kernel",
              {"serving forward, B=32": [((32, 4, 256), 5),
                                         ((32, 2, 512), 2)]}),
        _conv(_conv3x3_wgrad_bn_relu, f"K4, {JAX_CONV}:575 _wgrad_bn_kernel",
              tol=1e-3),
        _conv(_conv3x3_small_affine_relu,
              "T1, tools/pallas_fused_conv.py:39 fused_kernel",
              {"tools/fused_conv_epilogue_torch.py's call": [
                  ((TRAIN_BATCH, 2, 512), 1)]}),
        Kernel("normalize_u8", f"{CSRC}/normalize_u8_sm90.cu",
               "T2, tools/perf_probe3.py:63 kern",
               {"flagship step without augmentation": [
                   ((TRAIN_BATCH, 64, 64, 3), 1)]},
               _normalize_u8, lambda s: (0, 3 * int(np.prod(s))), 0.0,
               _cold_and_host),
        *(Kernel(name, f"{CSRC}/batchnorm_sm90.cu",
                 "none: XLA fuses BatchNorm on the TPU; the port's eager "
                 "ops/batchnorm.py plain_scale_bias, plain_batch_norm",
                 bn_steps(name), make, _bn_cost(name), tol)
          for name, make, tol in (
              ("bn_stats", _bn_stats, 1e-4), ("bn_apply", _bn_apply, 1e-2),
              ("bn_bwd_reduce", _bn_bwd_reduce, 1e-4),
              ("bn_bwd_dx", _bn_bwd_dx, 1e-2),
              ("bn_finalize", _bn_finalize, 1e-4))),
        Kernel("attention_fwd", f"{CSRC}/attention_sm90.cu",
               "none: Flax's MultiHeadDotProductAttention, which XLA fuses; "
               "the port's eager ops/attention.py plain_attention",
               {"vit-b16-arcface-train": [(ATT_CELL, 24)]}, _attention_fwd,
               lambda s: attention_cost(*s), 2e-2),
        Kernel("attention_bwd", f"{CSRC}/attention_sm90.cu",
               "none: autograd of the same",
               {"vit-b16-arcface-train": [(ATT_CELL, 12)]}, _attention_bwd,
               _attention_bwd_cost, 2e-2),
        # bf16 outputs one rounding apart (dx), f32 parameter sums of 50,432
        # rows in another order
        Kernel("layernorm_fwd", f"{CSRC}/layernorm_sm90.cu",
               "none: Flax's nn.LayerNorm, which XLA fuses; the port's eager "
               "cast, F.layer_norm, cast (ops/layernorm.py plain_layer_norm)",
               {"vit-b16-arcface-train": [(LN_CELL, 49)]}, _layernorm_fwd,
               _layernorm_cost(False), 1e-2),
        Kernel("layernorm_bwd", f"{CSRC}/layernorm_sm90.cu",
               "none: autograd of the same",
               {"vit-b16-arcface-train": [(LN_CELL, 25)]}, _layernorm_bwd,
               _layernorm_cost(True), 1e-2),
    ]


def _error(got, want):
    """(largest absolute error, each output's largest error over its own
    largest entry in ``want``; NaN where an output is not finite): each
    output of a tuple is held to its own scale, so that a small one
    (LayerNorm's dx beside its parameter sums over 50,432 rows) cannot hide
    behind a large one."""
    err, rel = 0.0, []
    if torch.is_tensor(got):
        got, want = [got], [want]
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            return float("nan"), [float("nan")]
        e = (g.float() - w.float()).abs().max().item()
        err = max(err, e)
        rel.append(e / (w.float().abs().max().item() or 1.0))
    return err, rel


def _time_shape(kernel, gen, shape):
    """One shape's row: the call against the reference, then timed."""
    call, plain, want, yardstick = kernel.make(gen, shape)
    abs_err, rel_err = _error(call(), want)
    del want
    flops, nbytes = kernel.cost(shape)
    row = {"shape": list(shape), "max_abs_err": abs_err,
           "err_over_largest": max(rel_err), "each_output": rel_err,
           "ms": cuda_ms(call),
           "device_ms": device_ms(call), "plain_ms": cuda_ms(plain, iters=20),
           "library_ms": cuda_ms(yardstick) if yardstick else None,
           "bound_ms": least_seconds(flops, nbytes) * 1e3,
           "bound_by": ("operations" if flops / PEAK_BF16_FLOPS
                        >= nbytes / PEAK_BYTES_PER_S else "bytes")}
    if kernel.extra:
        row.update(kernel.extra(call, yardstick))
    return row


def _sum(rows, calls):
    """The readings summed over a step's calls (None where a shape lacks
    one), and what bounds most of its shapes."""
    out = {}
    for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [row[key] for row in rows]
        out[key] = (None if None in vals
                    else sum(v * n for v, n in zip(vals, calls)))
    bounds = [row["bound_by"] for row in rows]
    out["bound_by"] = max(set(bounds), key=bounds.count)
    return out


def kernel_table(kernels):
    """Times and checks each of ``kernels`` at each of its shapes; prints a
    JSON line a kernel; raises after the last if an error passed its
    entry's ``tol``."""
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    failures = []
    for kernel in kernels:
        rows = {}
        for calls in kernel.steps.values():
            for shape, _ in calls:
                if shape not in rows:
                    rows[shape] = _time_shape(kernel, gen, shape)
        bad = [r["shape"] for r in rows.values()
               if not r["err_over_largest"] <= kernel.tol]     # NaN too
        if bad:
            failures.append((kernel.name, bad))
        print(json.dumps({
            "kernel": kernel.name, "source": kernel.source,
            "replaces": kernel.replaces,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "err_over_largest": max(r["err_over_largest"]
                                    for r in rows.values()),
            "tol": kernel.tol,
            "steps": {step: {"calls": [[list(s), n] for s, n in calls],
                             **_sum([rows[s] for s, _ in calls],
                                    [n for _, n in calls])}
                      for step, calls in kernel.steps.items()},
            "shapes": list(rows.values())}), flush=True)
    if failures:
        raise AssertionError(f"kernels past their tolerance at these "
                             f"shapes: {failures}")


# -- 3. the paths ------------------------------------------------------------


# every kernel module's launch counts, and vit's core calls
COUNTERS = (fc.LAUNCHES, pre.LAUNCHES, bnk.LAUNCHES, att.LAUNCHES,
            ln.LAUNCHES, vit.LAUNCHES)


def _reset():
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0


def _launches():
    """Every kernel's launches since the last :func:`_reset`, by one name
    each (the attention and LayerNorm kernels' as ``attention_<fwd|bwd|
    plain>`` and ``layernorm_<...>``)."""
    return {**fc.LAUNCHES, **pre.LAUNCHES, **bnk.LAUNCHES,
            **{f"attention_{k}": v for k, v in att.LAUNCHES.items()},
            **{f"layernorm_{k}": v for k, v in ln.LAUNCHES.items()}}


def run_path(name, path, kernels, tmp):
    """The launch rule: zero the counts, run ``path(tmp)`` (which returns
    the launch counts of its child processes, if it has any), then assert
    that the kernels that launched are ``kernels``, every one of them and
    no other, and that no attention or LayerNorm call took the plain
    version."""
    _reset()
    counts = collections.Counter()
    for child in path(tmp) or ():
        counts.update(child)
    counts.update(_launches())
    plain = counts.pop("attention_plain") + counts.pop("layernorm_plain")
    launched = {k: n for k, n in counts.items() if n}
    print(json.dumps({"path": name, "launched": launched, "plain": plain}),
          flush=True)
    if set(launched) != set(kernels) or plain:
        raise AssertionError(f"{name}: launched {sorted(launched)}, named "
                             f"{sorted(kernels)}; {plain} attention or "
                             f"LayerNorm calls took the plain version")


# the ViT's layers with a kernel each way: vit.LAUNCHES's name, the kernel
# module's counts, the layer
VIT_KERNELS = (("attention", att.LAUNCHES, vit.MultiHeadDotProductAttention),
               ("layernorm", ln.LAUNCHES, vit.LayerNorm))


def _check_vit(label, module=None, steps=1):
    """Raises unless every attention core and LayerNorm call since the last
    :func:`_reset` launched its forward kernel, and each backward kernel
    launched once a layer of ``module`` a step (once a call where
    ``module`` is None)."""
    for name, launches, layer in VIT_KERNELS:
        calls = vit.LAUNCHES[name]
        bwd = calls if module is None else steps * sum(
            isinstance(m, layer) for m in module.modules())
        want = {"fwd": calls, "bwd": bwd, "plain": 0}
        print(f"{label}: {name} launches {dict(launches)} for {calls} "
              f"calls, predicted {want}")
        if dict(launches) != want or not calls:
            raise AssertionError(f"{label}: {name} launches "
                                 f"{dict(launches)}, predicted {want}")


def _check(label, got, want, atol, rtol):
    """Raises past ``atol + rtol * |want|`` anywhere."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    worst = (err / (atol + rtol * want.float().abs())).max().item()
    print(f"check {label}: max_abs_err {err.max().item():.3e}, tolerance "
          f"atol {atol:.3e} + rtol {rtol:g} * |ref|, worst ratio {worst:.3f}")
    if not torch.isfinite(got).all() or worst > 1.0:
        raise AssertionError(f"{label}: past the tolerance (worst ratio "
                             f"{worst:.3f})")


# the flagship: ResNet-50 v1.5 at 64 px, 256-d L2-normalised, kNN k=5
FLAGSHIP = {
    "model": {"backbone_name": "resnet50", "input_shape": [64, 64, 3],
              "encodings_len": 256, "embeddings_normalization": True,
              "mode": "triplet"},
    "general": {"seed": SEED},
    "encodings": {"knn_k": 5},
    "generator": {"augmentations": "default"},
}
N_CLASSES, PER_CLASS, DB_BATCH, MAX_BATCH = 1024, 10, 256, 32
NOISE = 8   # gray levels of per-image noise around each class's base image
# the flagship step (configs/resnet50_batchall_1024.yml): P-K 256 x 4,
# batch-all at margin 0.5, Adam 1e-3 decayed 0.99 per 500 steps
P_CLASSES, K_SAMPLES = 256, 4
MARGIN, LR, LR_DECAY, STEPS_PER_EPOCH = 0.5, 1e-3, 0.99, 500
BN_MOMENTUM = 0.9
WARMUP_STEPS, TIMED_STEPS = 3, 10
# ResNet-50's launches a training step at B=1,024 (fused conv on): the
# conv kernels by benchmark/flops.py's plan, T2 where the step divides
# uint8 (without augmentation; the augmented step divides in f32)
EXPECTED_PER_STEP = {
    **collections.Counter(k for k, _, _, _ in
                          resnet50_conv3x3_launches(TRAIN_BATCH, 64)),
    "normalize_u8": 1}
EXPECTED_AUG_PER_STEP = {**EXPECTED_PER_STEP, "normalize_u8": 0}
# One step from the same weights and batch through the kernel path and the
# cuDNN path, both bf16, and the cuDNN path in f32 as the reference: the
# two bf16 losses within 2e-2 relative of each other; the kernel path's
# gradient no further from the f32 gradient (relative L2) than GRAD_FACTOR
# times the cuDNN path's, over all parameters together, and for each conv
# weight no further than GRAD_FACTOR times the cuDNN path's plus
# GRAD_SLACK. Two bf16 implementations round at other places, and batch-all
# mining turns a rounding at a hinge's edge into a triplet in or out.
LOSS_RTOL, GRAD_FACTOR, GRAD_SLACK = 2e-2, 1.5, 0.05


def _noisy(rng, base, classes):
    """uint8 images of ``classes``: each class's base image plus noise."""
    noise = rng.integers(-NOISE, NOISE + 1, (len(classes),) + base.shape[1:],
                         dtype=np.int16)
    return np.clip(base[classes].astype(np.int16) + noise, 0,
                   255).astype(np.uint8)


def _serving_db():
    """The serving DB: N_CLASSES classes of uniform random base images x
    PER_CLASS noisy copies; (images, classes, the generator after them,
    the base images)."""
    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 256, (N_CLASSES, 64, 64, 3), dtype=np.uint8)
    classes = np.repeat(np.arange(N_CLASSES), PER_CLASS)
    return _noisy(rng, base, classes), classes, rng, base


def _direct(net, images):
    """Embeddings the way the collector makes them: batches padded to
    MAX_BATCH."""
    out = []
    for i in range(0, len(images), MAX_BATCH):
        chunk = images[i:i + MAX_BATCH]
        pad = np.zeros((MAX_BATCH,) + chunk.shape[1:], np.uint8)
        pad[:len(chunk)] = chunk
        out.append(net.encode(pad)[:len(chunk)])
    return np.concatenate(out)


def serve_path(tmp):
    """The flagship model (bf16, fused BN-ReLU conv on, seeded random
    weights) encodes the serving DB in batches of DB_BATCH, saves and
    reloads it, and answers requests of 1, 32 and 100 images through the
    micro-batching engine: K3's launches exact, the answers equal to a
    direct encode + kNN and the true classes, the embeddings unit-norm."""
    db_images, db_classes, rng, base = _serving_db()
    sizes = [1, 32, 100]
    query_classes = [rng.integers(0, N_CLASSES, n) for n in sizes]
    queries = [_noisy(rng, base, c) for c in query_classes]
    net = EmbeddingNet(FLAGSHIP, device=DEVICE, fast_conv=True,
                       dtype=torch.bfloat16)
    _reset()
    encodings = np.concatenate([
        net.encode(db_images[i:i + DB_BATCH])
        for i in range(0, len(db_images), DB_BATCH)])
    db = {"paths": [f"synthetic/{c}/{i}" for i, c in enumerate(db_classes)],
          "labels": [f"class_{c:04d}" for c in db_classes],
          "encodings": encodings,
          "weights_fingerprint": net.weights_fingerprint()}
    root = os.path.join(tmp, "serve")
    os.makedirs(root)
    net.save_encodings(db, root)
    net.load_encodings(os.path.join(root, "encodings.pkl"))
    engine = InferenceEngine(net, max_batch=MAX_BATCH)
    try:
        if not engine.ready.wait(600):
            raise TimeoutError("engine warm-up did not finish")
        answers = [engine.infer_arrays(list(images)) for images in queries]
        launches = _launches()
        device_batches = -(-len(db_images) // DB_BATCH) + \
            engine.device_batches
    finally:
        engine.close()
    fused = EXPECTED_PER_STEP["conv3x3_small_bn_relu"]
    if launches["conv3x3_small_bn_relu"] != fused * device_batches:
        raise AssertionError(
            f"serve: K3 launched {launches['conv3x3_small_bn_relu']} times, "
            f"expected {fused} x {device_batches} device batches")
    db_np, label_np, classes = net._db()
    db_emb = torch.as_tensor(db_np, device=DEVICE)
    label_ids = torch.as_tensor(label_np, device=DEVICE)
    correct = total = 0
    max_emb_diff = 0.0
    served = [encodings]
    for images, truth, got in zip(queries, query_classes, answers):
        emb = _direct(net, images)
        pred, _ = knn_classify(db_emb, label_ids,
                               torch.as_tensor(emb, device=DEVICE), k=5,
                               n_classes=len(classes))
        want = [classes[int(p)] for p in pred.tolist()]
        labels = [a["label"] for a in got]
        if labels != want:
            raise AssertionError(f"serve: engine answers {labels[:8]} differ "
                                 f"from direct encode + kNN {want[:8]}")
        served.append(np.stack([a["embedding"] for a in got]))
        max_emb_diff = max(max_emb_diff,
                           float(np.abs(served[-1] - emb).max()))
        correct += sum(l == f"class_{t:04d}" for l, t in zip(labels, truth))
        total += len(labels)
    all_emb = np.concatenate(served)
    norms = np.linalg.norm(all_emb, axis=1)
    if not np.isfinite(all_emb).all() or np.abs(norms - 1).max() > 1e-3:
        raise AssertionError(f"serve: embeddings not finite and unit norm: "
                             f"norms in [{norms.min()}, {norms.max()}]")
    print(f"serve: {total} answers equal direct encode + kNN (embeddings "
          f"within {max_emb_diff:.2e}); accuracy against the true classes "
          f"{correct / total:.3f}")
    if correct / total < 0.9:
        raise AssertionError(f"serve: kNN accuracy {correct / total} under "
                             f"0.9")


def tool_path(tmp):
    """T1's path: ``tools/fused_conv_epilogue_torch.py``'s ``main`` at B =
    1,024, its numerics check inside; no other conv kernel launches."""
    tool = runpy.run_path(os.path.join(TOOLS, "fused_conv_epilogue_torch.py"))
    os.environ["FC_BATCH"] = str(TRAIN_BATCH)
    result = tool["main"](["--device", DEVICE])
    if result["batch"] != TRAIN_BATCH:
        raise AssertionError(f"A/B tool: ran at B={result['batch']}")


def _pk_batches(images, classes, n, seed=SEED, k_classes=P_CLASSES):
    """``n`` P-K batches of uint8 ``images`` and int32 labels that
    ``PKSampler`` draws, on the host."""
    class_files = {}
    for i, c in enumerate(classes):
        class_files.setdefault(f"class_{c:04d}", []).append(str(i))
    sampler = PKSampler(class_files, sorted(class_files),
                        k_classes=k_classes, k_samples=K_SAMPLES, seed=seed)
    out = []
    for _ in range(n):
        paths, labels = sampler.sample()
        out.append((torch.from_numpy(images[[int(p) for p in paths]]),
                    torch.from_numpy(labels)))
    return out


def _card_batches(seed, n, batch, size, n_classes=1024,
                  per_class=K_SAMPLES):
    """``n`` P-K batches of ``batch`` images that ``PKSampler`` draws from a
    pool of ``n_classes`` colour-cell classes x ``per_class``, on the
    card."""
    classes = np.repeat(np.arange(n_classes), per_class)
    pool = cell_images(np.random.default_rng(seed), classes, size)
    return [(x.to(DEVICE), y.to(DEVICE)) for x, y in _pk_batches(
        pool, classes, n, seed=seed, k_classes=batch // K_SAMPLES)]


def _resnet50(fast_conv=True, dtype=torch.bfloat16):
    """The flagship's encoder (and configs/batch4096_sharded.yml's), random
    weights from SEED, on the card."""
    m = FLAGSHIP["model"]
    module = EmbeddingModule(
        backbone_name=m["backbone_name"], encodings_len=m["encodings_len"],
        embeddings_normalization=m["embeddings_normalization"],
        bn_momentum=BN_MOMENTUM, fast_conv=fast_conv, dtype=dtype)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    return module.to(DEVICE)


def _trainer(module, dtype=torch.bfloat16, augment_fn=None,
             mode="batch_all", max_positives=K_SAMPLES - 1):
    spec = get_optimizer("adam", step_decay_schedule(LR, LR_DECAY, 1,
                                                     STEPS_PER_EPOCH))
    state = TrainState.create(module, spec)
    step = make_triplet_train_step(
        module, spec, margin=MARGIN, mode=mode, augment_fn=augment_fn,
        compute_dtype=dtype, max_positives=max_positives)
    return state, step


def _run_steps(state, step, batches):
    """Takes the steps; their metrics as floats."""
    metrics = []
    for images, labels in batches:
        state, m = step(state, images, labels)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def _check_mined(label, metrics):
    """Finite losses, and triplets mined in every step; the losses."""
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses)) or not all(m["n_triplets"] > 0
                                               for m in metrics):
        raise AssertionError(f"{label}: a loss is not finite or a step "
                             f"mined nothing: {metrics}")
    return losses


def _check_training(label, metrics, launches, expected, steps):
    """Finite, falling loss, mined triplets, exact launches per step."""
    losses = _check_mined(label, metrics)
    print(f"{label}: losses " + " ".join(f"{l:.4f}" for l in losses))
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"{label}: the loss did not fall")
    _check_launches(label, launches, expected, steps)


def _check_launches(label, launches, expected, steps):
    """Exact launches per step on ResNet-50's training path."""
    for name, per_step in expected.items():
        if launches[name] != per_step * steps:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times over "
                f"{steps} steps, expected {per_step} per step")


def step_path(tmp):
    """The flagship step without augmentation on P-K batches of the serving
    DB's images: exact launches (T2 once a step), a finite and falling
    loss; then one step from the same weights and batch through the kernel
    path, the cuDNN path and the cuDNN path in f32, whose losses and
    gradients must agree (LOSS_RTOL, GRAD_FACTOR, GRAD_SLACK)."""
    db_images, db_classes, _, _ = _serving_db()
    batches = _pk_batches(db_images, db_classes,
                          WARMUP_STEPS + TIMED_STEPS + 1)
    probe = batches.pop()
    module = _resnet50()
    state, step = _trainer(module)
    _run_steps(state, step, batches[:WARMUP_STEPS])
    _reset()
    metrics = _run_steps(state, step, batches[WARMUP_STEPS:])
    _check_training("step", metrics, _launches(), EXPECTED_PER_STEP,
                    TIMED_STEPS)

    snapshot = {k: v.clone() for k, v in module.state_dict().items()}
    results = {}
    for label, mod, dtype in (
            ("kernel", module, torch.bfloat16),
            ("cudnn", _resnet50(fast_conv=False), torch.bfloat16),
            ("f32", _resnet50(False, dtype=None), torch.float32)):
        mod.load_state_dict(snapshot)
        st, stp = _trainer(mod, dtype)
        (m,) = _run_steps(st, stp, [probe])
        results[label] = (m["loss"], {n: p.grad.float().clone()
                                      for n, p in mod.named_parameters()})
    losses = {k: v[0] for k, v in results.items()}
    grads = {k: v[1] for k, v in results.items()}
    ref = grads["f32"]

    def rel(label, names):
        num = sum(((grads[label][n] - ref[n]) ** 2).sum() for n in names)
        den = sum((ref[n] ** 2).sum() for n in names)
        return (num / den.clamp_min(1e-30)).sqrt().item()

    loss_rel = abs(losses["kernel"] - losses["cudnn"]) / abs(
        losses["cudnn"])
    total_k, total_c = rel("kernel", list(ref)), rel("cudnn", list(ref))
    print(f"step: one step from the same weights and batch: loss kernel "
          f"{losses['kernel']:.6f}, cuDNN {losses['cudnn']:.6f} (relative "
          f"{loss_rel:.2e}, tolerance {LOSS_RTOL}), f32 {losses['f32']:.6f}"
          f"; gradient relative L2 to the f32 step over all parameters: "
          f"kernel {total_k:.4f}, cuDNN {total_c:.4f} (tolerance "
          f"{GRAD_FACTOR} x cuDNN)")
    bad = [n for n, g in ref.items() if g.dim() == 4 and rel("kernel", [n])
           > GRAD_FACTOR * rel("cudnn", [n]) + GRAD_SLACK]
    if loss_rel > LOSS_RTOL or total_k > GRAD_FACTOR * total_c or bad:
        raise AssertionError(f"step: the kernel path and the cuDNN path "
                             f"disagree (conv weights past tolerance: {bad})")


# the flagship config fitted through the Trainer, with these cuts:
# (section, key, value, why); dataset_path and work_dir are set to the
# path's temp dir
FIT_CONFIG = os.path.join(CONFIGS, "resnet50_batchall_1024.yml")
TRAIN_CLI = os.path.join(TOOLS, "train_torch.py")
FIT_CLASSES, FIT_PER_CLASS = 1024, 10
# the cuts that every fitted config takes; the paths' datasets are
# written in a temp dir
TAIL_CUTS = [("DATALOADER", "dataset_path", None, "no data on the machine"),
             ("TRAIN", "plot_history", False,
              "the card's machine has no matplotlib"),
             ("GENERAL", "work_dir", None, "a temp dir")]
FIT_CUTS = [
    ("GENERATOR", "n_batches", 4, "run time"),
    ("GENERATOR", "n_batches_val", 2, "run time"),
    ("TRAIN", "n_epochs", 2, "run time"),
    ("TRAIN", "eval_recall_every", 1, "so recall runs"),
    ("PERFORMANCE", "pallas_conv", True, "so the kernels run"),
    *TAIL_CUTS,
]


def _write_fit_dataset(root, n_classes=FIT_CLASSES, per_class=FIT_PER_CLASS,
                       size=64):
    """A folder dataset of ``n_classes`` x ``per_class`` colour-cell PNGs at
    ``size`` px; returns the images."""
    classes = np.repeat(np.arange(n_classes), per_class)
    images = cell_images(np.random.default_rng(SEED + 5), classes, size)
    write_dataset(root, images, classes, per_class)
    return images


def _fit_config(tmp, source=FIT_CONFIG, cuts=FIT_CUTS, settings=(),
                label="fit", work="work", name="config.yml", values=None):
    """``tmp/<name>``: the config at ``source`` with a path's ``cuts``
    ((section, key, value, why), printed as ``reduced`` lines) and
    ``settings`` ((section, key, value), printed as ``set`` lines); the
    dataset is ``tmp/dataset``, the work dir ``tmp/<work>``, ``values``
    the other keys whose cut is a path."""
    import yaml
    with open(source) as f:
        cfg = yaml.safe_load(f)
    values = {"dataset_path": os.path.join(tmp, "dataset"),
              "work_dir": os.path.join(tmp, work), **(values or {})}
    changes = [(s, k, v, "reduced", f" ({why})") for s, k, v, why in cuts]
    changes += [(s, k, v, "set", "") for s, k, v in settings]
    for section, key, value, verb, why in changes:
        value = values.get(key, value)
        cfg[section] = dict(cfg.get(section) or {})
        print(f"{label}: {verb} {section}.{key}: "
              f"{cfg[section].get(key, 'unset')!r} -> {value!r}{why}")
        cfg[section][key] = value
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _trainer_for(path, **kw):
    """The port's Trainer on the config at ``path``: (params, loader,
    trainer)."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    params = parse_params(path)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    return params, loader, Trainer(params, loader, device=DEVICE, **kw)


def _same(a, b, path):
    """Bit-for-bit equality of two nested state dicts, tensors compared on
    the host."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"resume: {path} keys differ")
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"resume: {path} lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"resume: {path} differs from the checkpoint")
    elif a != b:
        raise AssertionError(f"resume: {path} {a!r} != {b!r}")


def _resume_check(label, params, loader, trainer):
    """A second Trainer resumes ``trainer``'s epoch 0 and must hold its
    checkpoint bit for bit."""
    from embeddingnet_tpu_torch.train import checkpoint as ckpt
    from embeddingnet_tpu_torch.train.loop import Trainer
    second = Trainer(params, loader, device=DEVICE, log_fn=lambda *a: None)
    second.resume(0)
    if second.start_epoch != 1:
        raise AssertionError(f"{label}: resume: start_epoch "
                             f"{second.start_epoch}")
    saved = torch.load(os.path.join(trainer.paths["weights"], "0",
                                    ckpt.STATE_FILE),
                       map_location=DEVICE, weights_only=True)
    restored = second.state.state_dict()
    for key in ("module", "optimizer", "generator", "step",
                "plateau_scale"):
        _same(restored[key], saved[key], key)
    if second.state.generator.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"{label}: resume: the generator is not on the "
                             f"card")


def _cli_export(label, path, params, batch):
    """The CLI on the config at ``path``: resume the latest checkpoint, fit
    what is left, export; the exported base model, reloaded, must encode
    ``batch`` within bf16 rounding of the CLI's Trainer's recall encoder
    (the weights it exports, L2-normalised in arcface mode)."""
    from embeddingnet_tpu_torch.train.steps import make_eval_step
    cli = runpy.run_path(TRAIN_CLI)["main"]
    cli_trainer, _ = cli([path, "--device", DEVICE, "--resume_from",
                          "latest"])
    work = cli_trainer.paths["work_dir"]
    reloaded = EmbeddingNet(params, device=DEVICE, fast_conv=True,
                            dtype=cli_trainer.compute_dtype).load_model(
        os.path.join(work, "base_model.pt"))
    got = reloaded.encode(batch)
    want = make_eval_step(cli_trainer._recall_encoder(), compute_dtype=(
        cli_trainer.compute_dtype))(cli_trainer.state, torch.from_numpy(
            batch)).cpu().numpy()
    _check(f"{label}: the CLI's export reloaded against its Trainer's "
           f"encoder", torch.from_numpy(got), torch.from_numpy(want), ATOL,
           RTOL)


def _check_history(label, history, finite=("loss", "val_loss"),
                   unit=("val_recall1", "val_recall5"), evals=None):
    """Finite losses and recalls (or accuracies) in [0, 1], ``evals`` of
    each where given."""
    for key in finite:
        if not np.all(np.isfinite(history[key])):
            raise AssertionError(f"{label}: {key} not finite: "
                                 f"{history[key]}")
    for key in unit:
        if not all(0.0 <= v <= 1.0 for v in history[key]) or (
                evals is not None and len(history[key]) != evals):
            raise AssertionError(f"{label}: {key} {history[key]}")


@functools.lru_cache(maxsize=None)
def _fit_dataset(tmp):
    """The flagship fit's dataset, ``tmp/dataset``, written by the first
    path that reads it; its images."""
    return _write_fit_dataset(os.path.join(tmp, "dataset"))


@functools.lru_cache(maxsize=None)
def fit_path(tmp):
    """The flagship config fitted through the port's Trainer: two epochs
    with the val epoch, recall and the best checkpoint, every conv kernel's
    and T2's launches exact; a second Trainer resumes epoch 0; the CLI
    resumes the latest checkpoint, fits what is left and exports. Runs once
    a ``tmp``: the inference path reads its config and export."""
    from embeddingnet_tpu_torch.train import checkpoint as ckpt
    images = _fit_dataset(tmp)
    path = _fit_config(tmp)
    params, loader, trainer = _trainer_for(path)
    g, t = params.generator, params.train
    n_db = sum(min(len(v), t.eval_recall_max_per_class)
               for v in loader.train_data.values())
    n_val = len(loader.flat("val")[0])
    chunks = -(-n_db // 256) + -(-n_val // 256)
    steps = t.n_epochs * g.n_batches
    val_forwards = t.n_epochs * g.n_batches_val
    evals = t.n_epochs // t.eval_recall_every
    expected = {name: n * steps for name, n in EXPECTED_AUG_PER_STEP.items()}
    k3 = "conv3x3_small_bn_relu"
    expected[k3] += EXPECTED_AUG_PER_STEP[k3] * (val_forwards
                                                 + evals * chunks)
    expected["normalize_u8"] = val_forwards
    _reset()
    history = trainer.fit().history
    launches = _launches()
    _check_history("fit", history, evals=evals)
    for name, n in expected.items():
        if launches[name] != n:
            raise AssertionError(f"fit: {name} launched {launches[name]} "
                                 f"times, expected {n}")
    best = int(np.argmin(history[trainer.ckpt_mgr.monitor]))
    saved = os.path.join(trainer.paths["weights"], str(best),
                         ckpt.STATE_FILE)
    if trainer.ckpt_mgr.latest_epoch() != best or not os.path.exists(saved):
        raise AssertionError(f"fit: no checkpoint of the best epoch {best} "
                             f"({trainer.ckpt_mgr.epochs()})")
    _resume_check("fit", params, loader, trainer)
    del trainer
    _cli_export("fit", path, params, images[:256])


# the mining modes on the flagship step with its augmentation: (path, B,
# whether the batch keeps the grouped P-K layout, modes): the grouped P-K
# paths at B=1024 (batch_all the yardstick), the [B, B, B] enumeration at
# B=256, and at B=1024 the dense rank-window path on rows shuffled out of
# their groups
PARITY_MODES = ("semihard", "hardest", "random_hard")
MINING_RUNS = [("pk", TRAIN_BATCH, True, ("batch_all",) + PARITY_MODES
                + ("batch_hard",)),
               ("enumeration", 256, True, PARITY_MODES),
               ("dense", TRAIN_BATCH, False, PARITY_MODES)]
MINING_WARMUP, MINING_STEPS = 2, 10


def _bn_per_step(module):
    """BatchNorm's launches in one training step of ``module``: a
    BatchNorm layer launches bn_stats, bn_apply, bn_bwd_reduce and
    bn_bwd_dx once, a BNScaleBias (the fused conv's) bn_stats, bn_finalize
    and bn_bwd_dx."""
    fused = sum(type(m) is fc.BNScaleBias for m in module.modules())
    applied = sum(isinstance(m, fc.BNScaleBias)
                  for m in module.modules()) - fused
    return {"bn_stats": applied + fused, "bn_apply": applied,
            "bn_bwd_reduce": applied, "bn_bwd_dx": applied + fused,
            "bn_finalize": fused}


def _shuffled(batches, seed):
    """The batches with their rows in a random order: the labels leave
    their P-K groups."""
    rng = np.random.default_rng(seed)
    out = []
    for images, labels in batches:
        order = torch.from_numpy(rng.permutation(len(labels)))
        out.append((images[order], labels[order]))
    return out


def mining_path(tmp):
    """The flagship step with the ``default`` augmentation on colour-cell
    images under each mining mode on each of its paths: exact launches a
    step (BatchNorm's too), finite losses, mined triplets."""
    classes = np.repeat(np.arange(N_CLASSES), PER_CLASS)
    images = cell_images(np.random.default_rng(SEED + 3), classes, 64)
    augment_fn = aug.augment_from_params(FLAGSHIP)
    module = _resnet50()
    expected = {**EXPECTED_AUG_PER_STEP, **_bn_per_step(module)}
    for path, b, grouped, modes in MINING_RUNS:
        batches = _pk_batches(images, classes, MINING_WARMUP + MINING_STEPS,
                              seed=SEED + 7, k_classes=b // K_SAMPLES)
        max_positives = K_SAMPLES - 1 if grouped else None
        if not grouped:
            batches = _shuffled(batches, SEED + 8)
        for mode in modes:
            label = f"mining {path} B={b} {mode}"
            state, step = _trainer(module, augment_fn=augment_fn, mode=mode,
                                   max_positives=max_positives)
            if state.generator.device.type != "cuda":
                raise AssertionError(f"{label}: the augmentation's "
                                     f"generator is not on the card")
            _run_steps(state, step, batches[:MINING_WARMUP])
            _reset()
            metrics = _run_steps(state, step, batches[MINING_WARMUP:])
            _check_launches(label, _launches(), expected, MINING_STEPS)
            _check_mined(label, metrics)


# the warm-up fit: the fit's cuts at 2 steps an epoch, one semihard epoch
# before batch_hard
WARMUP_FIT_CUTS = [(s, k, 2 if k == "n_batches" else v, why)
                   for s, k, v, why in FIT_CUTS]
WARMUP_FIT_SETTINGS = [("TRAIN", "mining_warmup_epochs", 1),
                       ("TRAIN", "mining_warmup_mode", "semihard"),
                       ("GENERATOR", "negatives_selection_mode",
                        "batch_hard")]
WARMUP_SWITCH = ("epoch 1: mining mode semihard -> batch_hard "
                 "(TRAIN.mining_warmup_epochs=1)")


def warmup_fit_path(tmp):
    """The flagship config on the fit's dataset with one semihard warm-up
    epoch before batch_hard: the Trainer must log the switch at epoch 1."""
    _fit_dataset(tmp)
    path = _fit_config(tmp, cuts=WARMUP_FIT_CUTS,
                       settings=WARMUP_FIT_SETTINGS, label="warm-up fit",
                       work="work_warmup", name="warmup.yml")
    lines = []

    def log(line):
        lines.append(line)
        print(f"warm-up fit: {line}")
    _, _, trainer = _trainer_for(path, log_fn=log)
    history = trainer.fit().history
    if [l for l in lines if "mining mode" in l] != [WARMUP_SWITCH]:
        raise AssertionError("warm-up fit: the Trainer did not switch from "
                             "semihard to batch_hard at epoch 1")
    if trainer._mining_mode != "batch_hard" or not np.all(
            np.isfinite(history["loss"])):
        raise AssertionError(f"warm-up fit: mode {trainer._mining_mode}, "
                             f"losses {history['loss']}")


# configs/siamese_resnet18_pairs.yml fitted through the Trainer
SIAMESE_CONFIG = os.path.join(CONFIGS, "siamese_resnet18_pairs.yml")
SIAMESE_CLASSES, SIAMESE_STEPS = 128, 16
SIAMESE_CUTS = [
    ("TRAIN", "n_epochs", 2, "run time"),
    ("GENERATOR", "n_batches", SIAMESE_STEPS, "run time"),
    ("PERFORMANCE", "compute_dtype", "bfloat16", "the kernels take bf16; "
     "the gate sends f32 to F.conv2d"),
    ("PERFORMANCE", "pallas_conv", True, "so the kernels run"),
    *TAIL_CUTS,
]
# ResNet-18 at 64x64 has its stride-1 3x3 convs at 8x8x128 (stage 2: block
# 1's conv2, block 2's conv1 and conv2) and at 4x4x256 and 2x2x512 (stages
# 3 and 4 alike). At 8x8 all three take the mixed op (the cuDNN forward;
# backward K1-dgrad + K2: a stream of 8 passes the JAX batch-tile gate); at
# 4x4 and 2x2 each stage's two conv2s are fused (K3; backward K1-dgrad +
# K4) and block 2's conv1 is K1's forward (backward K1-dgrad + K2). So one
# stream's forward launches K1 2 and K3 4 times, its backward the dgrad
# 3 + 3 + 3, K2 3 + 1 + 1 and K4 2 + 2 times; a siamese train step runs two
# streams and divides in f32 after its augmentation (no T2); a val step's
# two eval forwards divide the uint8 batches by T2.
SIAMESE_PER_STEP = {"conv3x3_small": 4, "conv3x3_small_bn_relu": 8,
                    "conv3x3_dgrad": 18, "conv3x3_wgrad": 10,
                    "conv3x3_wgrad_bn_relu": 8}
SIAMESE_PER_VAL = {"conv3x3_small": 4, "conv3x3_small_bn_relu": 8,
                   "normalize_u8": 2}


def siamese_path(tmp):
    """configs/siamese_resnet18_pairs.yml fitted through the Trainer on
    PNGs in ``tmp/siamese``: finite losses, accuracies in [0, 1], the conv
    kernels' and T2's launches as the gate predicts them, a checkpoint, a
    resumed second Trainer and the CLI's export."""
    root = os.path.join(tmp, "siamese")
    images = _write_fit_dataset(os.path.join(root, "dataset"),
                                SIAMESE_CLASSES)
    path = _fit_config(root, source=SIAMESE_CONFIG, cuts=SIAMESE_CUTS,
                       label="siamese")
    params, loader, trainer = _trainer_for(path)
    g, t = params.generator, params.train
    steps, vals = t.n_epochs * g.n_batches, t.n_epochs * g.n_batches_val
    expected = {name: SIAMESE_PER_STEP.get(name, 0) * steps
                + SIAMESE_PER_VAL.get(name, 0) * vals
                for name in {**fc.LAUNCHES, **pre.LAUNCHES}}
    _reset()
    history = trainer.fit().history
    launches = {k: v for k, v in _launches().items() if k in expected}
    _check_history("siamese", history, unit=("accuracy", "val_accuracy"))
    if launches != expected:
        raise AssertionError(f"siamese: launches {launches}, predicted "
                             f"{expected}")
    if trainer.ckpt_mgr.latest_epoch() is None:
        raise AssertionError("siamese: no checkpoint")
    _resume_check("siamese", params, loader, trainer)
    del trainer
    _cli_export("siamese", path, params, images[:64])


# configs/vit_arcface_smoke.yml fitted through the Trainer with a softmax
# pretraining phase, on the dataset its comment names (107 classes x 40
# PNGs at 96 px)
VIT_SMOKE_CONFIG = os.path.join(CONFIGS, "vit_arcface_smoke.yml")
VIT_FIT_CLASSES, VIT_FIT_PER_CLASS, VIT_FIT_SIZE = 107, 40, 96
VIT_FIT_CUTS = [
    ("TRAIN", "n_epochs", 2, "run time"),
    ("GENERATOR", "n_batches", 8, "run time"),
    ("TRAIN", "eval_recall_every", 1, "so recall runs every epoch"),
    *TAIL_CUTS,
]
VIT_FIT_SETTINGS = [("SOFTMAX_PRETRAINING", "n_epochs", 1),
                    ("SOFTMAX_PRETRAINING", "steps_per_epoch", 4),
                    ("SOFTMAX_PRETRAINING", "val_steps", 2),
                    ("SOFTMAX_PRETRAINING", "batch_size", 128)]
HANDOFF_LOG = "handed to the model's encoder.backbone"


def vit_fit_path(tmp):
    """configs/vit_arcface_smoke.yml after a softmax pretraining phase,
    which must log its handoff: T2's launches exact (the pretraining's val
    batches), no conv kernel, every attention core and LayerNorm call on
    the kernels (a backward launch each layer a train step); a second
    Trainer's resume
    and the CLI's resume and export."""
    root = os.path.join(tmp, "vit")
    images = _write_fit_dataset(os.path.join(root, "dataset"),
                                VIT_FIT_CLASSES, VIT_FIT_PER_CLASS,
                                VIT_FIT_SIZE)
    path = _fit_config(root, source=VIT_SMOKE_CONFIG, cuts=VIT_FIT_CUTS,
                       settings=VIT_FIT_SETTINGS, label="vit fit")
    logs = []

    def log(line):
        logs.append(str(line))
        print(f"vit fit: {line}")
    params, loader, trainer = _trainer_for(path, log_fn=log)
    sp = params.softmax
    # T2 divides the pretraining's val batches (uint8 -> bf16, eval mode);
    # the train steps augment and divide in f32, the recall eval divides
    # in f32, and a ViT has no 3x3 conv
    t2 = sp.n_epochs * sp.val_steps
    train_steps = (sp.n_epochs * sp.steps_per_epoch
                   + params.train.n_epochs * params.generator.n_batches)
    _reset()
    trainer.pretrain_softmax()
    history = trainer.fit().history
    launches = _launches()["normalize_u8"]
    _check_vit("vit fit", trainer.module, train_steps)
    if not any(HANDOFF_LOG in line for line in logs):
        raise AssertionError("vit fit: the pretraining logged no handoff")
    _check_history("vit fit", history, finite=("loss",), evals=2)
    if launches != t2:
        raise AssertionError(f"vit fit: T2 launched {launches} times, "
                             f"predicted {t2}")
    if trainer.ckpt_mgr.latest_epoch() is None:
        raise AssertionError("vit fit: no checkpoint")
    _resume_check("vit fit", params, loader, trainer)
    del trainer
    _cli_export("vit fit", path, params, images[:64])


# configs/road_signs_tpu.yml on a CSV index of colour-cell PNGs
ROAD_CONFIG = os.path.join(CONFIGS, "road_signs_tpu.yml")
ROAD_CLASSES, ROAD_TRAIN, ROAD_VAL, ROAD_SIZE = 40, 8, 2, 48
ROAD_CUTS = [
    ("DATALOADER", "train_csv_file", None, "a CSV of the temp dataset"),
    ("DATALOADER", "val_csv_file", None, "a CSV of the temp dataset"),
    ("TRAIN", "n_epochs", 2, "run time"),
    ("GENERATOR", "n_batches", 8, "run time"),
    *TAIL_CUTS,
]


def _write_csv_dataset(root):
    """The road-signs layout: ROAD_CLASSES classes of colour-cell PNGs at
    ROAD_SIZE px, listed in ``train.csv`` and ``val.csv`` under the
    config's ``file_path``/``class_name`` columns."""
    per = ROAD_TRAIN + ROAD_VAL
    classes = np.repeat(np.arange(ROAD_CLASSES), per)
    write_dataset(root, cell_images(np.random.default_rng(SEED + 16),
                                    classes, ROAD_SIZE), classes, per)
    for split, train in (("train", True), ("val", False)):
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.write("file_path,class_name\n" + "".join(
                f"class_{c:04d}/{i % per}.png,sign_{c:03d}\n"
                for i, c in enumerate(classes)
                if (i % per < ROAD_TRAIN) == train))


def road_signs_path(tmp):
    """configs/road_signs_tpu.yml (EfficientNet-B1 at 48 px) fitted through
    the Trainer on a CSV dataset: finite losses, T2's launches exact (the
    val epochs' uint8 -> bf16), no conv kernel, a second Trainer's resume
    bit for bit."""
    root = os.path.join(tmp, "road")
    data = os.path.join(root, "dataset")
    _write_csv_dataset(data)
    path = _fit_config(root, source=ROAD_CONFIG, cuts=ROAD_CUTS,
                       label="road signs", values={
                           "train_csv_file": os.path.join(data, "train.csv"),
                           "val_csv_file": os.path.join(data, "val.csv")})
    params, loader, trainer = _trainer_for(
        path, log_fn=lambda line: print(f"road signs: {line}"))
    g, t = params.generator, params.train
    # the augmented train steps divide in f32; each val batch's eval
    # forward of 3 x batch_size divides by T2 (uint8 -> bf16)
    t2 = t.n_epochs * g.n_batches_val
    _reset()
    history = trainer.fit().history
    launches = _launches()["normalize_u8"]
    _check_history("road signs", history, unit=())
    if launches != t2:
        raise AssertionError(f"road signs: T2 launched {launches} times, "
                             f"predicted {t2}")
    _resume_check("road signs", params, loader, trainer)


def inference_path(tmp):
    """On the fit's CLI export (the flagship ResNet-50, pallas_conv on,
    bf16): encode_dataset over its PNGs, the evaluate CLI against
    calculate_prediction_accuracy, the test CLI against predict_knn, the
    .pt2 reloaded on the card against the module, with K3's launches
    predicted exactly."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    fit_path(tmp)
    path = os.path.join(tmp, "config.yml")
    params = parse_params(path)
    work = os.path.join(params.general.work_dir,
                        params.general.project_name)
    weights = os.path.join(work, "base_model.pt")
    encodings = os.path.join(work, "encodings", "encodings.pkl")
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    paths = loader.flat("train")[0] + loader.flat("val")[0]
    n_val = len(loader.flat("val")[0])
    net = EmbeddingNet.for_inference(params, weights, encodings,
                                     device=DEVICE)
    k3 = "conv3x3_small_bn_relu"
    # encode_dataset in DB_BATCH chunks, the evaluate CLI's val batches,
    # the test CLI's image, the module against the .pt2
    forwards = -(-len(paths) // DB_BATCH) + -(-n_val // DB_BATCH) + 1 + 1
    expected = EXPECTED_PER_STEP[k3] * forwards
    image = loader.flat("val")[0][0]
    _reset()
    emb = net.encode_dataset(paths, batch_size=DB_BATCH)
    acc = runpy.run_path(os.path.join(TOOLS, "evaluate_torch.py"))["main"](
        [path, "--weights", weights, "--encodings", encodings,
         "--device", DEVICE])
    label = runpy.run_path(os.path.join(TOOLS, "test_torch.py"))["main"](
        [path, "--weights", weights, "--encodings", encodings, "--image",
         image, "--device", DEVICE])
    exported = net.save_exported(os.path.join(tmp, "export"))
    x = torch.from_numpy(np.random.default_rng(SEED + 18).uniform(
        0, 1, (1, *params.model.input_shape)).astype(np.float32)).to(DEVICE)
    with torch.inference_mode():
        want = net.module(x).float()
    launches = _launches()[k3]
    if emb.shape != (len(paths), params.model.encodings_len) or \
            not np.isfinite(emb).all():
        raise AssertionError(f"inference: encode_dataset {emb.shape}")
    if launches != expected:
        raise AssertionError(f"inference: K3 launched {launches} times, "
                             f"predicted {expected}")
    direct_acc = net.calculate_prediction_accuracy(loader)
    direct_label = net.predict_knn(image)
    print(f"inference: the evaluate CLI {acc}, direct {direct_acc}; the "
          f"test CLI {label!r}, predict_knn {direct_label!r}")
    if acc != direct_acc or label != direct_label:
        raise AssertionError("inference: a CLI differs from the direct "
                             "call")
    program = torch.export.load(exported).module()
    with torch.inference_mode():
        got = program(x)
    _check("inference: .pt2 against the module", got, want, ATOL, RTOL)


# the data-parallel config: ResNet-50 at 64 px, B=4,096 as P-K 1,024 x 4,
# batch-all, the default preset, remat
SHARDED_CONFIG = os.path.join(CONFIGS, "batch4096_sharded.yml")
DP_WARMUP, DP_STEPS = 3, 10
DP_POOL_PER_CLASS = 8
# the flagship step, remat on against off, from the same state and batch:
# float64 (every op, the miner in f32 as the step casts) to 1e-12 of each
# tensor's largest entry, at B = REMAT_F64_BATCH; bf16 with the kernels at
# the flagship batch bit for bit (the same kernels on the same inputs,
# cuDNN held to its deterministic algorithms)
REMAT_F64_BATCH, REMAT_F64_TOL = 64, 1e-12
# the flagship step's launches under remat: the fused op's forward runs
# again in the backward (K3 twice); the backward kernels once
REMAT_PER_STEP = {**EXPECTED_PER_STEP, "conv3x3_small_bn_relu":
                  2 * EXPECTED_PER_STEP["conv3x3_small_bn_relu"]}
# the config fitted through torchrun and the CLI, with these cuts
DP_FIT_CUTS = [
    ("GENERATOR", "n_batches", 4, "run time"),
    ("GENERATOR", "n_batches_val", 1, "run time"),
    ("TRAIN", "n_epochs", 2, "run time"),
    ("TRAIN", "eval_recall_every", 1, "so the recall runs through the "
                                      "sharded kNN every epoch"),
    ("ENCODINGS", "save_encodings", False, "run time: the fit exports "
                                            "encodings"),
    *TAIL_CUTS,
]
DP_FIT_SETTINGS = [("PERFORMANCE", "async_checkpoint", True)]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config_step(params, module, mode=None, remat=False, parallel=None):
    """The config's triplet step in bf16 on ``module`` (its optimizer,
    schedule, margin, augmentation and mining mode, or ``mode``), the
    state's generator drawn from SEED: ``(state, step)``."""
    t, g = params.train, params.generator
    spec = get_optimizer(t.optimizer, step_decay_schedule(
        t.learning_rate, t.decay_factor, t.step_size, g.n_batches,
        warmup_epochs=t.warmup_epochs))
    state = TrainState.create(module, spec, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED + 1))
    step = make_triplet_train_step(
        module, spec, margin=g.margin,
        mode=mode or g.negatives_selection_mode,
        augment_fn=aug.get_aug(g.augmentations),
        compute_dtype=torch.bfloat16, max_positives=g.k_samples - 1,
        remat=remat, parallel=parallel)
    return state, step


def sharded_step_path(tmp):
    """configs/batch4096_sharded.yml's step at full width and global batch
    through the data-parallel path in an NCCL group of one rank (global
    BatchNorm, the row-sharded miner, the gradient all-reduce: the
    collectives run), remat on and off: finite losses, mined triplets, no
    conv kernel (the config sets pallas_conv off), and remat lowers the
    peak memory."""
    import torch.distributed as dist
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.parallel.collectives import DataParallel
    params = parse_params(SHARDED_CONFIG)
    g = params.generator
    batches = _card_batches(SEED + 14, DP_WARMUP + DP_STEPS,
                            g.k_classes * g.k_samples, 64, g.k_classes,
                            DP_POOL_PER_CLASS)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device(DEVICE, 0))
    peaks = {}
    try:
        for remat in (True, False):
            label = f"sharded step (remat {'on' if remat else 'off'})"
            # pallas_conv off, as the config sets it
            state, step = _config_step(params, _resnet50(fast_conv=False),
                                       remat=remat,
                                       parallel=DataParallel.current())
            _run_steps(state, step, batches[:DP_WARMUP])
            torch.cuda.reset_peak_memory_stats()
            metrics = _run_steps(state, step, batches[DP_WARMUP:])
            peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 30
            _check_mined(label, metrics)
            del state, step
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if not peaks[True] < peaks[False]:
        raise AssertionError(f"remat did not lower the peak: "
                             f"{peaks[True]:.2f} GiB against "
                             f"{peaks[False]:.2f}")


def remat_path(tmp):
    """Remat on the flagship step with the kernels (``pallas_conv`` on):
    remat on against off from the same state and batch, in float64 (every
    op) and in bf16 (K1-K4 under the recompute, their launches exact)."""
    import copy
    f64_batch, bf16_batch = (
        _card_batches(seed, 1, b, 64, P_CLASSES, 8)[0] for seed, b in
        ((SEED + 15, REMAT_F64_BATCH), (SEED + 16, TRAIN_BATCH)))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dtype, batch in ((torch.float64, f64_batch),
                             (torch.bfloat16, bf16_batch)):
            label = f"remat check ({str(dtype)[6:]}, B={len(batch[1])})"
            base = _resnet50(dtype=None if dtype == torch.float64 else dtype)
            if dtype == torch.float64:
                base.double()
            out = {}
            for remat in (False, True):
                module = copy.deepcopy(base)
                spec = get_optimizer("sgd", 0.05)
                state = TrainState.create(module, spec)
                step = make_triplet_train_step(
                    module, spec, margin=MARGIN, mode="batch_all",
                    compute_dtype=dtype, max_positives=K_SAMPLES - 1,
                    remat=remat)
                _reset()
                _, m = step(state, *batch)
                torch.cuda.synchronize()
                out[remat] = (m["loss"].double(),
                              {n: p.grad.double() for n, p in
                               module.named_parameters()},
                              {k: v.double() for k, v in
                               module.state_dict().items()}, _launches())
            (l0, g0, s0, c0), (l1, g1, s1, c1) = out[False], out[True]
            if dtype == torch.float64:
                worst = max(float((b[k] - v).abs().max()
                                  / v.abs().max().clamp_min(1e-300))
                            for a, b in ((g0, g1), (s0, s1))
                            for k, v in a.items() if v.numel())
                dl = float((l1 - l0).abs() / l0.abs())
                print(f"{label}: remat on against off: worst gradient, "
                      f"parameter or running statistic {worst:.3e} of its "
                      f"largest entry, loss {dl:.3e} (bound "
                      f"{REMAT_F64_TOL})")
                if worst > REMAT_F64_TOL or dl > REMAT_F64_TOL:
                    raise AssertionError(f"{label}: remat changes the step")
            else:
                differ = [k for k, v in g0.items()
                          if not torch.equal(g1[k], v)]
                differ += [k for k, v in s0.items()
                           if not torch.equal(s1[k], v)]
                print(f"{label}: remat on against off: {len(differ)} of "
                      f"{len(g0) + len(s0)} gradients, parameters and "
                      f"running statistics differ (bound: bit-equal)")
                if not torch.equal(l1, l0) or differ:
                    raise AssertionError(f"{label}: remat changes the step: "
                                         f"{differ[:8]}")
                _check_launches(label + " off", c0, EXPECTED_PER_STEP, 1)
                _check_launches(label + " on", c1, REMAT_PER_STEP, 1)
            del base
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _torchrun(kind, out, *args, nproc=1, timeout=600):
    """``torchrun --nproc_per_node=nproc chip_smoke.py --child KIND OUT
    ARGS``; each rank writes ``OUT.rank<r>.json``. Returns the ranks'
    JSON."""
    cmd = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={nproc}", "--master_port", str(_free_port()),
           os.path.abspath(__file__), "--child", kind, out, *args]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    for line in proc.stdout.splitlines():
        if line.startswith("epoch ") or "resumed" in line or \
                "launches" in line:
            print(f"  [{kind} rank] {line[:240]}")
    if proc.returncode:
        print(proc.stdout[-3000:])
        print(proc.stderr[-6000:])
        raise AssertionError(f"torchrun --child {kind} {' '.join(args)} "
                             f"exited {proc.returncode}")
    runs = []
    for r in range(nproc):
        with open(f"{out}.rank{r}.json") as f:
            runs.append(json.load(f))
    return runs


def _fit_child(out, cfg, *flags):
    """A rank of the data-parallel fit: the train CLI's ``main`` (its
    process group from torchrun's environment), the final live state's
    digest (taken as the CLI calls ``restore_best``), the history, and the
    recall of the restored best epoch by the plain kNN."""
    from embeddingnet_tpu_torch.parallel.collectives import state_digest
    from embeddingnet_tpu_torch.train.loop import Trainer
    # cuDNN's deterministic algorithms: a resumed run must match bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    digest = {}
    restore_best = Trainer.restore_best

    def wrapped(self):
        digest["final"] = state_digest(self.module).tolist()
        return restore_best(self)
    Trainer.restore_best = wrapped
    _reset()
    trainer, _ = runpy.run_path(TRAIN_CLI)["main"]([cfg, *flags])
    launches = _launches()
    trainer.parallel = None         # the plain kNN on the restored best
    return {"launches": launches, "digest": digest["final"],
            "history": trainer.history.history,
            "plain_recall": trainer.evaluate_recall(),
            "monitor": trainer.ckpt_mgr.monitor}


def sharded_fit_path(tmp):
    """The data-parallel config fitted through ``torchrun
    --nproc_per_node=1`` and the train CLI on the fit's PNGs: finite
    losses, T2's launches (the val batches), the recall through the
    sharded kNN equal to the plain kNN's on the restored best epoch, and a
    second torchrun run resumed from epoch 0's checkpoint ending bit for
    bit where the straight run ended."""
    from embeddingnet_tpu_torch.config import parse_params
    _fit_dataset(tmp)
    path = _fit_config(tmp, source=SHARDED_CONFIG, cuts=DP_FIT_CUTS,
                       settings=DP_FIT_SETTINGS, label="sharded fit",
                       work="sharded_work", name="sharded.yml")
    straight, = _torchrun("fit", os.path.join(tmp, "straight"), path)
    h = straight["history"]
    _check_history("sharded fit", h, unit=())
    cut = parse_params(path)
    val_batches = cut.generator.n_batches_val * cut.train.n_epochs
    if straight["launches"]["normalize_u8"] != val_batches:
        raise AssertionError(f"sharded fit: T2 launched "
                             f"{straight['launches']['normalize_u8']} times, "
                             f"expected {val_batches}")
    # the restored best epoch (first maximum of val_recall1) by the plain kNN
    best = int(np.argmax(h[straight["monitor"]]))
    for key in ("val_recall1", "val_recall5"):
        if straight["plain_recall"][key] != h[key][best]:
            raise AssertionError(
                f"sharded fit: {key} {h[key][best]} of epoch {best} through "
                f"the sharded kNN, {straight['plain_recall'][key]} through "
                f"the plain kNN")
    project = cut.general["project_name"]
    weights = os.path.join(tmp, "sharded_resume", project, "weights")
    os.makedirs(weights)
    shutil.copytree(os.path.join(tmp, "sharded_work", project, "weights",
                                 "0"), os.path.join(weights, "0"))
    resume_cfg = _fit_config(
        tmp, source=path, label="sharded fit", work="sharded_resume",
        name="resume.yml", cuts=[("GENERAL", "work_dir", None,
                                  "the resumed run's own dir")])
    resumed, = _torchrun("fit", os.path.join(tmp, "resume"), resume_cfg,
                         "--resume_from", "0")
    if resumed["digest"] != straight["digest"]:
        raise AssertionError(f"sharded fit: the run resumed from epoch 0 "
                             f"ends at {resumed['digest']}, the straight "
                             f"run at {straight['digest']}")
    for key, values in resumed["history"].items():
        if key.endswith("_s") or key == "images_per_sec":
            continue
        if values != h[key][1:]:
            raise AssertionError(f"sharded fit: resumed {key} {values}, "
                                 f"straight {h[key][1:]}")
    return [straight["launches"], resumed["launches"]]


def bf16_params_path(tmp):
    """The flagship config with ``params_dtype: bfloat16`` through the
    port's Trainer (the fit's cuts and dataset): one train step; every
    parameter, BatchNorm statistic and optimizer moment bf16, the loss
    finite, the launches exact."""
    _fit_dataset(tmp)
    path = _fit_config(tmp, settings=[("PERFORMANCE", "params_dtype",
                                       "bfloat16")],
                       label="bf16 params", work="bf16_work", name="bf16.yml")
    _, _, trainer = _trainer_for(path, log_fn=lambda *a: None)
    images, labels = next(trainer._device_prefetch(
        trainer._check_pk_layout(trainer._train_loader())))
    _reset()
    trainer.state, m = trainer.train_step(trainer.state, images, labels)
    torch.cuda.synchronize()
    floats = {v.dtype for v in trainer.module.state_dict().values()
              if v.is_floating_point()}
    moments = {v.dtype for s in trainer.state.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v) and v.ndim}
    if floats != {torch.bfloat16} or moments != {torch.bfloat16}:
        raise AssertionError(f"bf16 params: tensors of {floats}, moments "
                             f"of {moments}")
    if not np.isfinite(float(m["loss"])):
        raise AssertionError("bf16 params: the loss is not finite")
    _check_launches("bf16 params", _launches(), EXPECTED_AUG_PER_STEP, 1)


# the flagship config with backbone_name seresnet50 (the SE block sits after
# bn3, so each block's bn1 -> relu -> conv2 stays fused: the ResNet-50
# step's launches), from MODEL.backbone_weights 'imagenet', which resolves
# through $EMBEDDINGNET_WEIGHTS_DIR to a .npz of a seeded port model's
# backbone; the Trainer's own step on colour-cell P-K batches
ZOO_SETTINGS = [("MODEL", "backbone_name", "seresnet50"),
                ("MODEL", "backbone_weights", "imagenet")]
ZOO_CUTS = [
    ("PERFORMANCE", "pallas_conv", True, "so the kernels run"),
    *TAIL_CUTS,
]
ZOO_WARMUP, ZOO_STEPS = 3, 10
# an arcface fit from a weights preset: configs/vit_arcface_smoke.yml on a
# zoo backbone, cut to a small dataset
ZOO_FIT_CLASSES, ZOO_FIT_PER_CLASS = 32, 8
ZOO_FIT_SETTINGS = [("MODEL", "backbone_name", "densenet121"),
                    ("MODEL", "backbone_weights", "imagenet")]
ZOO_FIT_CUTS = [
    ("TRAIN", "n_epochs", 2, "run time"),
    ("GENERATOR", "n_batches", 4, "run time"),
    ("GENERATOR", "batch_size", 32, "the cut dataset"),
    ("TRAIN", "eval_recall_every", 1, "so recall runs every epoch"),
    *TAIL_CUTS,
]
# each zoo name, an eval forward in bf16 at its native input (Keras' default
# size), B=32
ZOO_NATIVE = {"inceptionv3": 299, "inceptionresnetv2": 299, "xception": 299,
              "nasnetlarge": 331}
ZOO_NAMES = ("seresnet18", "seresnet34", "seresnet50", "seresnet101",
             "seresnet152", "resnext50", "resnext101", "seresnext50",
             "seresnext101", "senet154", "inceptionv3", "inceptionresnetv2",
             "xception", "nasnetmobile", "nasnetlarge", "densenet121",
             "densenet169", "densenet201", "vgg16", "vgg19")
ZOO_EVAL_BATCH = 32


def _write_weights(root, name, seed, **kw):
    """``<root>/<name>_imagenet.npz``: the backbone of a port model drawn
    from ``seed`` (its BatchNorm statistics drawn too), as the converters
    write a preset; returns the file's arrays."""
    from embeddingnet_tpu_torch.models import pretrained
    source = EmbeddingModule(name, **kw)
    source.reset_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in source.backbone.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    flat = {k: v for k, v in pretrained.flatten_params(source).items()
            if k.split("/")[1] == "backbone"}
    os.makedirs(root, exist_ok=True)
    np.savez(os.path.join(root, f"{name}_imagenet.npz"), **flat)
    return flat


def _check_loaded(label, trainer, module, flat, seed):
    """Every backbone tensor of ``module`` equals the file's; every other
    one that of a fresh encoder the Trainer builds from ``seed``."""
    from embeddingnet_tpu_torch.models import pretrained
    fresh = trainer._new_encoder()
    fresh.reset_parameters(torch.Generator().manual_seed(seed))
    got = pretrained.flatten_params(module)
    want = pretrained.flatten_params(fresh)
    n_file = 0
    for key, value in got.items():
        ref = flat.get(key)
        if ref is None:
            ref = want[key]
        else:
            n_file += 1
        if not np.array_equal(value, ref):
            source = "the file" if key in flat else "its fresh value"
            raise AssertionError(f"{label}: {key} differs from {source}")
    if n_file != len(flat):
        raise AssertionError(f"{label}: {len(flat) - n_file} of the file's "
                             f"arrays have no place in the module")


def zoo_step_path(tmp):
    """The flagship config on SE-ResNet-50 through the Trainer, from a
    weights preset: the load checked bit for bit, then the Trainer's step
    on colour-cell batches with ResNet-50's exact launches and a falling
    loss."""
    from embeddingnet_tpu_torch.models import pretrained
    _fit_dataset(tmp)
    path = _fit_config(tmp, cuts=ZOO_CUTS, settings=ZOO_SETTINGS,
                       label="zoo step", work="zoo_work",
                       name="zoo_config.yml")
    from embeddingnet_tpu_torch.config import parse_params
    m = parse_params(path).model
    weights = os.path.join(tmp, "weights")
    flat = _write_weights(weights, m.backbone_name, SEED + 20,
                          encodings_len=m.encodings_len)
    os.environ[pretrained.WEIGHTS_DIR_ENV] = weights
    params, _, trainer = _trainer_for(path, log_fn=lambda *a: None)
    g = params.generator
    _check_loaded("zoo step", trainer, trainer.module, flat,
                  params.general.seed)
    batches = _card_batches(SEED + 21,
                            ZOO_WARMUP + ZOO_STEPS,
                            g.k_classes * g.k_samples, m.input_shape[0])
    state, step = trainer.state, trainer.train_step
    _run_steps(state, step, batches[:ZOO_WARMUP])
    _reset()
    metrics = _run_steps(state, step, batches[ZOO_WARMUP:])
    _check_training("zoo step", metrics, _launches(), EXPECTED_AUG_PER_STEP,
                    ZOO_STEPS)


def zoo_fit_path(tmp):
    """configs/vit_arcface_smoke.yml on DenseNet-121 from a weights preset,
    fitted through the Trainer in arcface mode (the file loads into the
    encoder): finite losses, recall in [0, 1], no conv kernel, a second
    Trainer's resume bit for bit."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.models import pretrained
    root = os.path.join(tmp, "zoo_fit")
    _write_fit_dataset(os.path.join(root, "dataset"), ZOO_FIT_CLASSES,
                       ZOO_FIT_PER_CLASS, VIT_FIT_SIZE)
    path = _fit_config(root, source=VIT_SMOKE_CONFIG, cuts=ZOO_FIT_CUTS,
                       settings=ZOO_FIT_SETTINGS, label="zoo fit")
    m = parse_params(path).model
    weights = os.path.join(root, "weights")
    flat = _write_weights(weights, m.backbone_name, SEED + 23,
                          encodings_len=m.encodings_len,
                          embeddings_normalization=False, classifier=False)
    os.environ[pretrained.WEIGHTS_DIR_ENV] = weights
    logs = []
    params, loader, trainer = _trainer_for(path, log_fn=logs.append)
    if trainer.mode != "arcface":
        raise AssertionError(f"zoo fit: mode {trainer.mode}")
    _check_loaded("zoo fit", trainer, trainer.encoder, flat,
                  params.general.seed)
    if not any("loaded backbone weights" in str(line) for line in logs):
        raise AssertionError("zoo fit: the Trainer logged no load")
    _reset()
    history = trainer.fit().history
    _check_history("zoo fit", history, finite=("loss",),
                   unit=("val_recall1",))
    _resume_check("zoo fit", params, loader, trainer)


def zoo_eval_path(tmp):
    """Each zoo name, an eval forward in bf16 at its native input, B=32:
    the embedding's shape, finite."""
    for name in ZOO_NAMES:
        size = ZOO_NATIVE.get(name, 224)
        with torch.device(DEVICE):
            module = EmbeddingModule(name, dtype=torch.bfloat16,
                                     classifier=False)
        module.reset_parameters(torch.Generator(DEVICE).manual_seed(SEED))
        x = torch.rand(ZOO_EVAL_BATCH, size, size, 3, device=DEVICE)
        with torch.inference_mode():
            out = module.eval()(x)
        if out.shape != (ZOO_EVAL_BATCH, 256) or not torch.isfinite(
                out.float()).all():
            raise AssertionError(f"zoo eval {name}: {tuple(out.shape)}")
        del module, x, out
        torch.cuda.empty_cache()


# the native decoder: the fit's PNGs plus seeded JPEGs (256 px, quality
# 90), decoded to the flagship's 64 px; its exact path within DECODE_MAX_DIFF
# gray levels of cv2 (the bilinear's rounding, F1)
DECODE_JPEGS, DECODE_JPEG_SIZE, DECODE_QUALITY, DECODE_SIZE = 512, 256, 90, 64
DECODE_MAX_DIFF = 1


def _write_jpegs(root):
    """DECODE_JPEGS seeded JPEGs of colour cells with noise, written with
    cv2."""
    import cv2
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(SEED + 60)
    images = cell_images(rng, rng.integers(0, 64, DECODE_JPEGS),
                         DECODE_JPEG_SIZE)
    paths = []
    for i, img in enumerate(images):
        path = os.path.join(root, f"{i}.jpg")
        if not cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY,
                                       DECODE_QUALITY]):
            raise OSError(f"cv2 could not write {path}")
        paths.append(path)
    return paths


def decoder_path(tmp):
    """The native decoder against cv2 on the fit's PNGs and DECODE_JPEGS
    JPEGs (exact within DECODE_MAX_DIFF, the fast path the same on PNGs),
    then the fit's config on it and ``encode_dataset``. Where it cannot be
    built (no libjpeg/libpng headers), the documented behaviour: its
    ``unavailable`` line, ``auto`` resolved to cv2."""
    from concurrent.futures import ThreadPoolExecutor
    from embeddingnet_tpu_torch.data import native_loader
    from embeddingnet_tpu_torch.data.images import get_image
    from embeddingnet_tpu_torch.data.pipeline import BatchLoader
    resolved = BatchLoader([], (DECODE_SIZE, DECODE_SIZE, 3)).backend
    if not native_loader.available():     # build() printed why
        if resolved != "python":
            raise AssertionError(f"decoder: auto resolved to {resolved} "
                                 f"without the native decoder")
        return
    if resolved != "native":
        raise AssertionError(f"decoder: auto resolved to {resolved} on "
                             f"{os.cpu_count()} cores")
    _fit_dataset(tmp)
    pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(
        os.path.join(tmp, "dataset")) for f in fs if f.endswith(".png"))
    paths = pngs + _write_jpegs(os.path.join(tmp, "jpegs"))
    with ThreadPoolExecutor(8) as pool:
        cv2_images = np.stack(list(pool.map(
            lambda p: get_image(p, (DECODE_SIZE, DECODE_SIZE, 3)), paths)))
    exact, fast = (native_loader.decode_batch(paths, DECODE_SIZE,
                                              DECODE_SIZE, n_threads=8,
                                              fast=f) for f in (False, True))
    worst = int(np.abs(exact.astype(int) - cv2_images.astype(int)).max())
    diff = np.abs(fast[len(pngs):].astype(int)
                  - exact[len(pngs):].astype(int))
    print(f"decoder: exact against cv2: largest difference {worst} gray "
          f"level(s) (at most {DECODE_MAX_DIFF}); fast against exact on the "
          f"JPEGs: mean {diff.mean():.3f}, p99 "
          f"{np.percentile(diff, 99):.0f} levels")
    if worst > DECODE_MAX_DIFF:
        raise AssertionError(f"decoder: exact path {worst} levels from cv2")
    if not np.array_equal(fast[:len(pngs)], exact[:len(pngs)]):
        raise AssertionError("decoder: the fast path changed a PNG")
    path = _fit_config(tmp, label="native fit", work="native_work",
                       name="native.yml")
    params, loader, trainer = _trainer_for(path)
    backend = trainer._train_loader().backend
    history = trainer.fit().history
    if backend != "native" or not np.all(np.isfinite(history["loss"])):
        raise AssertionError(f"native fit: {backend}, {history['loss']}")
    net = EmbeddingNet(params, device=DEVICE,
                       fast_conv=params.performance.pallas_conv,
                       dtype=trainer.compute_dtype)
    net.load_encoder_state(trainer.encoder_variables())
    emb = net.encode_dataset(loader.flat("train")[0] + loader.flat("val")[0],
                             batch_size=DB_BATCH)
    if not np.isfinite(emb).all():
        raise AssertionError("native fit: encodings not finite")


# the cells' steps at full size, and CLIP ViT-L/14's (B=32, 257 tokens):
# CELL_STEPS steps each; the ViTs' over VIT_CLASSES classes
VIT_CONFIG = os.path.join(CONFIGS, "vit_arcface.yml")
CLIP_CONFIG = os.path.join(CONFIGS, "clip_vitl14_arcface.yml")
B3_CONFIG = os.path.join(CONFIGS, "efficientnetb3_batchhard_1024.yml")
CELL_STEPS, VIT_CLASSES, VIT_POOL = 2, 1000, 1024
# configs/vit_arcface.yml (ViT-B/16 at 224 px, B=256, ArcFace, bf16, TF32
# off) with MESH.model 2 on 2 gloo ranks of the one card (NCCL refuses two
# ranks on one device), against the one-process step from the same weights
# and batch. bf16 on both sides, the TP side summing partial products of
# bf16 matmuls (each rounded to bf16) where one process rounds the whole
# product once: the loss to TP_LOSS_RTOL; the gradient, all parameters
# together, to TP_GRAD_REL in relative L2; the parameters after the step
# (Adam's first update is lr * sign(g) at the warm-up's lr0) differ by 2 *
# lr0 where the signs differ, on at most TP_FLIP_MAX of the entries
TP_VIT_BATCH = 256
TP_LOSS_RTOL, TP_GRAD_REL, TP_FLIP_MAX = 2e-2, 5e-2, 2e-2
TP_RESNET_CUTS = [
    ("GENERATOR", "n_batches", 2, "run time: 2 steps"),
    ("TRAIN", "n_epochs", 1, "run time"),
    ("PERFORMANCE", "pallas_conv", True, "so the kernels run"),
    *TAIL_CUTS,
]
TP_RESNET_SETTINGS = [("MESH", "model", 2), ("MESH", "data", -1)]
# GPipe: ViT-B/16's blocks, 2 stages, bf16, against the blocks in order on
# the whole batch: output and each stage's gradient to PIPE_TOL of the
# tensor's largest entry (bf16 products of microbatches of 8 rows against
# those of 32)
PIPE_BATCH, PIPE_MICRO, PIPE_TOL = 32, 4, 2e-2


def _arcface_from_config(path, batch=None, tp=None, parallel=None,
                         remat=False):
    """The ArcFace module, train state and step that the Trainer builds
    for the config at ``path`` (its backbone, widths, margin, optimizer,
    schedule, EMA, augmentation and compute dtype), over VIT_CLASSES
    classes, random weights drawn on the card from SEED, at ``batch`` (the
    config's where None); ``remat`` takes the config's PERFORMANCE.remat.
    ``tp`` splits the module over a model group before the state is built,
    ``parallel`` is the step's data group. Returns (module, state, step,
    input shape, batch)."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.models.registry import ArcFaceModule
    from embeddingnet_tpu_torch.train.steps import make_arcface_train_step
    params = parse_params(path)
    m, g, t, perf = (params.model, params.generator, params.train,
                     params.performance)
    dtype = (torch.bfloat16 if perf.compute_dtype == "bfloat16"
             else torch.float32)
    module = ArcFaceModule(m.backbone_name, encodings_len=m.encodings_len,
                           n_classes=VIT_CLASSES, dtype=dtype,
                           input_shape=m.input_shape).to(DEVICE)
    module.reset_parameters(torch.Generator(DEVICE).manual_seed(SEED))
    shard_module(module, tp)
    kw = {"weight_decay": t.weight_decay} if t.optimizer == "adamw" else {}
    spec = get_optimizer(t.optimizer, step_decay_schedule(
        t.learning_rate, t.decay_factor, t.step_size, g.n_batches,
        warmup_epochs=t.warmup_epochs), **kw)
    state = TrainState.create(
        module, spec, generator=torch.Generator(DEVICE).manual_seed(SEED + 1),
        ema_decay=perf.ema_decay)
    step = make_arcface_train_step(
        module, spec, n_classes=VIT_CLASSES, margin=g.margin,
        augment_fn=aug.get_aug(g.augmentations), compute_dtype=dtype,
        remat=remat and perf.remat, parallel=parallel)
    return module, state, step, tuple(m.input_shape), batch or g.batch_size


def _vit_batches(shape, batch, seed, n=1):
    """``n`` uniform batches of colour-cell images (a pool of VIT_POOL
    images of VIT_CLASSES classes) and their labels, on the card."""
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, VIT_CLASSES, VIT_POOL)
    pool = cell_images(rng, classes, shape[0])
    idx = [rng.integers(0, VIT_POOL, batch) for _ in range(n)]
    return [(torch.from_numpy(pool[i]).to(DEVICE),
             torch.from_numpy(classes[i]).to(DEVICE)) for i in idx]


def arcface_step_path(config, tmp):
    """``config``'s ArcFace step at full width and depth on one card, at
    its batch and under its remat, CELL_STEPS steps: finite losses, every
    attention core and LayerNorm call on the kernels (the recompute's
    too), a backward launch each layer a step."""
    label = f"{os.path.basename(config)} step"
    module, state, step, shape, batch = _arcface_from_config(config,
                                                              remat=True)
    batches = _vit_batches(shape, batch, SEED + 41, CELL_STEPS)
    _reset()
    losses = [m["loss"] for m in _run_steps(state, step, batches)]
    print(f"{label}: B={batch}, losses {losses}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{label}: a loss is not finite")
    _check_vit(label, module, CELL_STEPS)


def b3_step_path(tmp):
    """configs/efficientnetb3_batchhard_1024.yml's triplet step at full
    width and depth, B=1,024, as the Trainer builds it (its mining mode,
    augmentation, bf16, bn_momentum, Adam with its warm-up schedule,
    drop-connect drawn from the state's generator): CELL_STEPS steps, then
    one of the warm-up's mining mode, their losses finite."""
    from embeddingnet_tpu_torch.config import parse_params
    params = parse_params(B3_CONFIG)
    m, g, t = params.model, params.generator, params.train
    module = EmbeddingModule(
        m.backbone_name, encodings_len=m.encodings_len,
        bn_momentum=params.performance.bn_momentum, dtype=torch.bfloat16,
        input_shape=tuple(m.input_shape)).to(DEVICE)
    module.reset_parameters(torch.Generator(DEVICE).manual_seed(SEED))
    batches = _card_batches(SEED + 14,
                            CELL_STEPS + 1, g.k_classes * g.k_samples,
                            m.input_shape[0])
    losses = []
    for mode, run in ((g.negatives_selection_mode, batches[:-1]),
                      (t.mining_warmup_mode, batches[-1:])):
        state, step = _config_step(params, module, mode)
        losses += [(mode, x["loss"]) for x in _run_steps(state, step, run)]
    print(f"b3 step: B={g.k_classes * g.k_samples}, losses {losses}")
    if not all(np.isfinite(loss) for _, loss in losses):
        raise AssertionError("b3 step: a loss is not finite")


def _grads(module, tp=None):
    """Every parameter's gradient as a whole f32 host tensor (the slices of
    a split module gathered over ``tp``)."""
    from embeddingnet_tpu_torch.parallel.collectives import gather_slices
    shards = getattr(module, "tp_shards", None) or {}
    return {n: (gather_slices(p.grad, *shards[n], tp) if n in shards
                else p.grad).float().cpu()
            for n, p in module.named_parameters()}


def _tp_vit_step(label, tp=None, parallel=None):
    """configs/vit_arcface.yml's ArcFace step (its module from SEED, split
    over ``tp``) on one batch of TP_VIT_BATCH: the loss, the whole
    gradients and the parameters after it; every attention and LayerNorm
    call on the kernels."""
    from embeddingnet_tpu_torch.parallel.tp import gather_module_state
    module, state, step, shape, _ = _arcface_from_config(
        VIT_CONFIG, TP_VIT_BATCH, tp=tp, parallel=parallel)
    batch = _vit_batches(shape, TP_VIT_BATCH, SEED + 40)[0]
    _reset()
    state, metrics = step(state, *batch)
    loss = metrics["loss"].item()
    _check_vit(label, module)
    return {"loss": loss, "grads": _grads(module, tp),
            "after": {k: v.float().cpu()
                      for k, v in gather_module_state(module).items()}}


def _tp_vit_child(grid, out):
    import torch.distributed as dist
    from embeddingnet_tpu_torch.parallel.collectives import (DataParallel,
                                                             ModelParallel)
    run = _tp_vit_step(f"tp rank {dist.get_rank()}",
                       ModelParallel.current(), DataParallel.current())
    if dist.get_rank() == 0:
        torch.save(run, out + ".pt")
    return {"loss": run["loss"]}


def tp_vit_path(tmp):
    """ViT-B/16 ArcFace at MESH.model 2 on two gloo ranks of the card
    against the one-process step from the same weights and batch: the
    loss, the gradient and the parameters after it within their limits,
    the ranks' losses equal."""
    one = _tp_vit_step("tp one-process")
    from embeddingnet_tpu_torch.config import parse_params
    cfg = parse_params(VIT_CONFIG)
    t, g = cfg.train, cfg.generator
    lr0 = step_decay_schedule(t.learning_rate, t.decay_factor, t.step_size,
                              g.n_batches, warmup_epochs=t.warmup_epochs)(0)
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "tp_vit")
    runs = _torchrun("vit", out, nproc=2)
    tp = torch.load(out + ".pt", weights_only=True)
    loss_gap = abs(tp["loss"] - one["loss"]) / abs(one["loss"])
    num = sum(float((tp["grads"][n] - g).square().sum())
              for n, g in one["grads"].items())
    den = sum(float(g.square().sum()) for g in one["grads"].values())
    grad_rel = (num / den) ** 0.5
    total = sum(v.numel() for v in one["after"].values())
    flips = sum(int(((tp["after"][n] - v).abs() > lr0).sum())
                for n, v in one["after"].items())
    print(f"tp: first-step loss {tp['loss']:.6f} against one process "
          f"{one['loss']:.6f} (relative {loss_gap:.2e}, limit "
          f"{TP_LOSS_RTOL}); gradient relative L2 {grad_rel:.3e} (limit "
          f"{TP_GRAD_REL}); parameters after it: {flips} of {total} entries "
          f"({flips / total:.2e}, limit {TP_FLIP_MAX}) apart by more than "
          f"lr0 {lr0:.1e}")
    if (loss_gap > TP_LOSS_RTOL or grad_rel > TP_GRAD_REL
            or flips / total > TP_FLIP_MAX):
        raise AssertionError("tp: the two-rank step is not the one-process "
                             "step")
    if any(run["loss"] != runs[0]["loss"] for run in runs):
        raise AssertionError("tp: the ranks' losses differ")
    return [run["launches"] for run in runs]


def _tp_resnet_child(grid, out, cfg):
    """The flagship config at MESH.model 2 through the Trainer: its train
    epoch of 2 steps."""
    _, _, trainer = _trainer_for(cfg, log_fn=lambda *a, **k: None)
    trainer._current_epoch = 0
    _reset()
    metrics = trainer._run_train_epoch()
    torch.cuda.synchronize()
    return {"loss": metrics["loss"],
            "split": sorted(getattr(trainer.module, "tp_shards", None)
                            or {})}


def tp_resnet_path(tmp):
    """The flagship config at MESH.model 2 (no rule matches a CNN: each
    rank runs the whole step) through the Trainer on 2 gloo ranks: each
    rank's conv-kernel launches exactly ResNet-50's a step, the ranks'
    losses equal."""
    from embeddingnet_tpu_torch.config import parse_params
    _fit_dataset(tmp)
    path = _fit_config(tmp, cuts=TP_RESNET_CUTS,
                       settings=TP_RESNET_SETTINGS, label="tp resnet",
                       work="tp_resnet_work", name="tp_resnet.yml")
    steps = parse_params(path).generator.n_batches
    runs = _torchrun("resnet", os.path.join(tmp, "tp_resnet"), path,
                     nproc=2)
    for run in runs:
        _check_launches(f"tp resnet rank {run['rank']}", run["launches"],
                        EXPECTED_AUG_PER_STEP, steps)
        if run["split"]:
            raise AssertionError("tp resnet: a rule split a CNN")
    if runs[0]["loss"] != runs[1]["loss"]:
        raise AssertionError("tp resnet: the ranks' losses differ")
    return [run["launches"] for run in runs]


def _pipeline_child(grid, out):
    """ViT-B/16's 12 blocks through 2 stages against the blocks applied in
    order on the whole batch, on this rank: the output and this stage's
    gradient of ``sum(y ** 2)``."""
    from embeddingnet_tpu_torch.models.vit import build_vit
    from embeddingnet_tpu_torch.parallel import pp
    net = build_vit("vit-b16", (224, 224, 3), dtype=torch.bfloat16)
    net.reset_parameters(torch.Generator().manual_seed(SEED))
    net.to(DEVICE)
    blocks = [getattr(net, f"block{i + 1}") for i in range(net.depth)]
    x = torch.randn((PIPE_BATCH, 197, 768),
                    generator=torch.Generator().manual_seed(SEED + 70)
                    ).to(DEVICE, torch.bfloat16)
    stacked = pp.stack_stage_params(
        [{k: v.detach() for k, v in b.named_parameters()} for b in blocks],
        grid.model)
    params = pp.place_stage_params(stacked, grid, device=DEVICE)
    for v in params.values():
        v.requires_grad_(True)
    _reset()
    y = pp.pipeline_blocks_forward(
        lambda p, h: torch.func.functional_call(blocks[0], p, (h,)), params,
        x, grid, n_micro=PIPE_MICRO)
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(
        (y.float() ** 2).sum(), [params[n] for n in names])))
    want_y = x
    for b in blocks:
        want_y = b(want_y)
    want_g = torch.autograd.grad((want_y.float() ** 2).sum(),
                                 [p for b in blocks for p in b.parameters()])
    stage, per = grid.m, len(blocks) // grid.model
    block_names = [n for n, _ in blocks[0].named_parameters()]
    worst = {"out": float((y.float() - want_y.float()).abs().max()
                          / want_y.float().abs().max())}
    for i in range(per):
        for j, n in enumerate(block_names):
            ref = want_g[(stage * per + i) * len(block_names) + j].float()
            gap = float((grads[n][i].float() - ref).abs().max()
                        / ref.abs().max().clamp_min(1e-30))
            worst[n] = max(worst.get(n, 0.0), gap)
    _check_vit(f"pipeline stage {stage}")
    return {"worst": worst, "stage": stage}


def pipeline_path(tmp):
    """GPipe over 2 gloo ranks: ViT-B/16's 12 blocks, n_micro 4, B=32,
    bf16, output and each stage's gradient against the blocks in order."""
    runs = _torchrun("pipeline", os.path.join(tmp, "pipeline"), nproc=2)
    for run in runs:
        worst = max(run["worst"].items(), key=lambda kv: kv[1])
        print(f"pipeline: stage {run['stage']}: output and gradient against "
              f"the sequential blocks, worst {worst[0]} {worst[1]:.3e} of "
              f"the largest entry (limit {PIPE_TOL})")
        if worst[1] > PIPE_TOL:
            raise AssertionError(f"pipeline: {worst}")
    return [run["launches"] for run in runs]


def quickstart_path(tmp):
    """``examples/quickstart_torch.py`` on the card, end to end."""
    main = runpy.run_path(os.path.join(ROOT, "examples",
                                       "quickstart_torch.py"))["main"]
    out = main(["--device", DEVICE, "--work_dir",
                os.path.join(tmp, "quickstart")])
    h = out["history"]
    if not np.all(np.isfinite(h["loss"])):
        raise AssertionError("quickstart: loss not finite")
    for key in ("weights", "encodings"):
        if not os.path.exists(out[key]):
            raise AssertionError(f"quickstart: no {key}")


def _child(argv):
    """``--child KIND OUT [ARGS]``: one rank of a path's torchrun launch;
    writes ``OUT.rank<r>.json`` with the rank's launches. ``fit`` runs the
    train CLI in torchrun's process group; the others join two gloo ranks
    that share the card in a (1, 2) grid, TF32 off."""
    import torch.distributed as dist
    from embeddingnet_tpu_torch.parallel import mesh
    kind, out, args = argv[0], argv[1], argv[2:]
    if kind == "fit":
        result = _fit_child(out, *args)
    else:
        mesh.maybe_initialize_distributed(DEVICE, backend="gloo")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        grid = mesh.build_grid(1, 2)
        try:
            result = {"vit": _tp_vit_child, "resnet": _tp_resnet_child,
                      "pipeline": _pipeline_child}[kind](grid, out, *args)
        finally:
            mesh.reset_grid()
    rank = dist.get_rank() if dist.is_initialized() else int(
        os.environ.get("RANK", "0"))
    result["rank"] = rank
    result.setdefault("launches", _launches())
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(result, f)
    if dist.is_initialized() and kind != "fit":
        dist.destroy_process_group()


# ResNet-50's training step: the conv kernels and BatchNorm's (the fused
# conv's BNScaleBias among them)
RESNET_CONV = ("conv3x3_small_bn_relu", "conv3x3_dgrad", "conv3x3_wgrad",
               "conv3x3_wgrad_bn_relu")
BN_APPLIED = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")
BN_ALL = BN_APPLIED + ("bn_finalize",)
VIT = ("attention_fwd", "attention_bwd", "layernorm_fwd", "layernorm_bwd")
# (name, path, the kernels it launches: every one of them and no other)
PATHS = [
    ("serving engine", serve_path,
     ("conv3x3_small_bn_relu", "bn_apply", "bn_finalize")),
    ("A/B tool", tool_path, ("conv3x3_small_affine_relu",)),
    ("flagship step", step_path, RESNET_CONV + BN_ALL + ("normalize_u8",)),
    ("flagship fit and CLI", fit_path,
     RESNET_CONV + BN_ALL + ("normalize_u8",)),
    ("mining modes", mining_path, RESNET_CONV + BN_ALL),
    ("mining warm-up fit", warmup_fit_path,
     RESNET_CONV + BN_ALL + ("normalize_u8",)),
    ("siamese fit", siamese_path,
     RESNET_CONV + BN_ALL + ("conv3x3_small", "normalize_u8")),
    ("ViT-B/16 ArcFace step at 224 px",
     functools.partial(arcface_step_path, VIT_CONFIG), VIT),
    ("CLIP ViT-L/14 ArcFace step",
     functools.partial(arcface_step_path, CLIP_CONFIG), VIT),
    ("EfficientNet-B3 step", b3_step_path, BN_APPLIED),
    ("ViT and ArcFace fit", vit_fit_path, VIT + ("normalize_u8",)),
    ("road-signs fit", road_signs_path, BN_APPLIED + ("normalize_u8",)),
    ("inference tools", inference_path,
     ("conv3x3_small_bn_relu", "bn_apply", "bn_finalize")),
    ("data-parallel step, remat on and off", sharded_step_path, BN_ALL),
    ("remat on the flagship step", remat_path,
     RESNET_CONV + BN_ALL + ("normalize_u8",)),
    ("data-parallel fit through torchrun", sharded_fit_path,
     BN_ALL + ("normalize_u8",)),
    ("bf16 master weights", bf16_params_path, RESNET_CONV + BN_ALL),
    ("zoo step", zoo_step_path, RESNET_CONV + BN_ALL),
    ("zoo fit", zoo_fit_path, BN_APPLIED),
    ("zoo eval", zoo_eval_path, ("bn_apply",)),
    ("native decoder", decoder_path, ()),
    ("tensor-parallel ViT", tp_vit_path, VIT),
    ("tensor-parallel ResNet", tp_resnet_path,
     RESNET_CONV + BN_ALL),
    ("GPipe", pipeline_path, VIT),
    ("quickstart", quickstart_path, BN_APPLIED),
]


def main(names):
    smi = check_card()
    # f32 references in full f32: cuDNN's convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build()

    def chosen(name):
        return not names or any(n in name for n in names)
    parts = [("kernel table", kernel_table,
              [k for k in registry() if chosen(k.name)])]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    parts += [(name, functools.partial(run_path, name, path, kernels), tmp)
              for name, path, kernels in PATHS if chosen(name)]
    failures = []
    try:
        for name, part, arg in parts:
            try:
                part(arg)
            except Exception:       # report it, and go on to the next part
                traceback.print_exc()
                failures.append(name)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise SystemExit(f"chip_smoke: failed: {failures}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        _child(sys.argv[2:])
    else:
        main(sys.argv[1:])
