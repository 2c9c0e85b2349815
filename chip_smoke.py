#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card: the serving path and the
triplet training step, each through the hand-written kernels.

    python3 chip_smoke.py

1. Checks for a CUDA card (there is no CPU route) and prints its name and
   power limit as ``nvidia-smi`` reports them.
2. Builds the kernels: every ``embeddingnet_tpu_torch/csrc/*.cu`` with
   ``nvcc`` (one process per source, in parallel), and the Triton kernel T2
   at its first launch.
3. Kernel phase: each kernel against its plain PyTorch version on the same
   inputs, in f32 with TF32 off, at the shapes ResNet-50 at 64x64 gives it
   (the forward K3/K1 at B = 3, 32, 256 and 1024; the backward K1-as-dgrad,
   K2, K4 and the normalisation T2 at B = 1024 and the conv kernels at
   B = 8), each check printed with its tolerance and its worst ratio to it.
   Times with CUDA events, against the plain version in bf16 and, where one
   PyTorch call computes the same function, against that call.
4. Serving phase: the flagship model (ResNet-50 v1.5, 64x64x3, 256-d
   L2-normalised embedding, kNN k=5, bf16, fused BN-ReLU conv on), with
   seeded random weights, encodes a DB of 10,240 synthetic images
   (1,024 classes x 10) in batches of 256, saves and reloads it, and answers
   requests of 1, 32 and 100 decoded images through the micro-batching
   engine. The answers are checked against a direct encode + kNN, against
   the true classes, and the embeddings against the cuDNN path.
5. Training phase: the flagship triplet step (ResNet-50 as above,
   bn_momentum 0.9, batch-all mining with margin 0.5 on P-K batches of
   256 classes x 4 drawn by ``PKSampler`` from the serving DB's images,
   Adam at 1e-3 with step decay 0.99 per 500 steps, bf16, fused conv on),
   through ``TrainState.create`` and ``make_triplet_train_step``: 3 warm-up
   steps, then 20 timed steps with exact launch counts, finite and falling
   loss; one step from the same weights and batch on the cuDNN path must
   agree on the loss and the gradients; the cuDNN path's step time; the
   device-busy share from ``torch.profiler``; peak memory.

The last line of standard output is the result,
``{"ok": true, "device": {...}}``. The line before it lists each kernel:
its launches during the training run (K3 also during the serving run),
its worst error, and ``ms`` / ``plain_ms`` / ``bound_ms`` / ``library_ms``,
the device time of the kernel, its plain version, the card's bound and the
library call, summed over the calls one training step makes at B = 1024;
K3's serving numbers (per B=32 forward) are under ``serve``. The line
before that is the card's name and power limit. Any failure raises, and
the script exits non-zero without the last line.
"""

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from embeddingnet_tpu_torch.data.samplers import PKSampler
from embeddingnet_tpu_torch.models.api import EmbeddingNet
from embeddingnet_tpu_torch.models.registry import EmbeddingModule
from embeddingnet_tpu_torch.ops import _cuda
from embeddingnet_tpu_torch.ops import fused_conv as fc
from embeddingnet_tpu_torch.ops import preprocess as pre
from embeddingnet_tpu_torch.ops.knn import knn_classify
from embeddingnet_tpu_torch.serving import InferenceEngine
from embeddingnet_tpu_torch.train.optim import (get_optimizer,
                                                step_decay_schedule)
from embeddingnet_tpu_torch.train.state import TrainState
from embeddingnet_tpu_torch.train.steps import make_triplet_train_step

SEED = 0
DEVICE = "cuda"
CONV_SRC = "embeddingnet_tpu_torch/csrc/fused_conv3x3.cu"
WGRAD_SRC = "embeddingnet_tpu_torch/csrc/conv3x3_wgrad.cu"
JAX_CONV = "embeddingnet_tpu/ops/fused_conv.py"
# name -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "conv3x3_small_bn_relu": ("cuda", CONV_SRC, f"{JAX_CONV}:556"),
    "conv3x3_dgrad": ("cuda", CONV_SRC, f"{JAX_CONV}:200"),
    "conv3x3_wgrad": ("cuda", WGRAD_SRC, f"{JAX_CONV}:225"),
    "conv3x3_wgrad_bn_relu": ("cuda", WGRAD_SRC, f"{JAX_CONV}:575"),
    "normalize_u8": ("triton", "embeddingnet_tpu_torch/ops/preprocess.py",
                     "tools/perf_probe3.py:63"),
    # K1's forward: built and checked, but ResNet-50 does not reach it (its
    # stride-1 3x3 convs all follow a BatchNorm, so all are fused)
    "conv3x3_small": ("cuda", CONV_SRC, f"{JAX_CONV}:200"),
}
OFF_PATH = ("conv3x3_small",)
# ResNet-50 at 64x64: (S, C, stride-1 3x3 convs per forward). Stage 2's
# blocks 2-4 run the mixed op at 8x8 (cuDNN forward, K1-dgrad + K2), stages
# 3 and 4 the fused op (K3, K1-dgrad + K4).
MIXED_SHAPES = [(8, 128, 3)]
FUSED_SHAPES = [(4, 256, 5), (2, 512, 2)]
SERVE_BATCHES = [3, 32, 256]
TRAIN_BATCH = 1024
SMALL_BATCH = 8     # JAX's 8x8 gate needs a multiple of 8
# per training step at B = 1024: kernel -> [(S, C, calls)]
PER_STEP = {
    "conv3x3_small_bn_relu": FUSED_SHAPES,
    "conv3x3_dgrad": MIXED_SHAPES + FUSED_SHAPES,
    "conv3x3_wgrad": MIXED_SHAPES,
    "conv3x3_wgrad_bn_relu": FUSED_SHAPES,
}
EXPECTED_PER_STEP = {name: sum(n for _, _, n in shapes)
                     for name, shapes in PER_STEP.items()}
EXPECTED_PER_STEP["normalize_u8"] = 1
# bf16 output rounding: the JAX package's bf16 bound for these kernels
# (tests/test_fused_conv.py, test_forward_bf16)
RTOL = ATOL = 2e-2
# the f32 weight gradient: the same bf16 products summed in f32 in another
# order, to 1e-3 of the largest entry
WGRAD_REL = 1e-3
# H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FLAGSHIP = {
    "model": {"backbone_name": "resnet50", "input_shape": [64, 64, 3],
              "encodings_len": 256, "embeddings_normalization": True,
              "mode": "triplet"},
    "general": {"seed": SEED},
    "encodings": {"knn_k": 5},
}
N_CLASSES, PER_CLASS, DB_BATCH, MAX_BATCH = 1024, 10, 256, 32
NOISE = 8   # gray levels of per-image noise around each class's base image

# the training phase (configs/resnet50_batchall_1024.yml, augmentation off)
P_CLASSES, K_SAMPLES = 256, 4
MARGIN, LR, LR_DECAY, STEPS_PER_EPOCH = 0.5, 1e-3, 0.99, 500
BN_MOMENTUM = 0.9
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS, CUDNN_STEPS = 3, 20, 3, 5
# One step from the same weights and batch through the kernel path and the
# cuDNN path, both bf16, and the cuDNN path in f32 as the reference: the
# two bf16 losses within 2e-2 relative of each other; the kernel path's
# gradient no further from the f32 gradient (relative L2) than GRAD_FACTOR
# times the cuDNN path's, over all parameters together, and for each conv
# weight no further than GRAD_FACTOR times the cuDNN path's plus
# GRAD_SLACK. Two bf16 implementations round at other places, and batch-all
# mining turns a rounding at a hinge's edge into a triplet in or out.
LOSS_RTOL, GRAD_FACTOR, GRAD_SLACK = 2e-2, 1.5, 0.05


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


def bound(flops, nbytes):
    """(ms, what bounds it): the least time the card could take for
    ``flops`` bf16 operations moving ``nbytes``."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


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
    }[name]
    return flops, nbytes


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
    t0 = time.perf_counter()
    paths = _cuda.build()
    for source in _cuda.SOURCES:
        _cuda.library(source.stem)
    print(f"build: {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for path in paths:
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    print(f"  ptxas {path.stem}: {line.strip()}")


def _tensor(rng, shape, scale=1.0):
    return torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).cuda()


def _affine(rng, c):
    scale = torch.from_numpy(
        rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)).cuda()
    bias = torch.from_numpy(
        (rng.normal(size=(c,)) * 0.1).astype(np.float32)).cuda()
    return scale, bias


def _check(label, got, want, atol, rtol):
    """Worst error of ``got`` against the f32 ``want`` and its ratio to
    ``atol + rtol * |want|``; raises past 1."""
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    max_err = err.max().item()
    worst = (err / (atol + rtol * want.abs())).max().item()
    print(f"check {label}: max_abs_err {max_err:.3e}, tolerance atol "
          f"{atol:.3e} + rtol {rtol:g} * |ref|, worst ratio {worst:.3f}")
    if not torch.isfinite(got).all() or worst > 1.0:
        raise AssertionError(f"{label}: max abs err {max_err} exceeds the "
                             f"tolerance (worst ratio {worst:.3f})")
    return max_err, worst


def _record(records, name, row):
    rec = records.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
    rec["shapes"].append(row)
    rec["max_abs_err"] = max(rec["max_abs_err"], row["max_abs_err"])


def forward_kernel_phase(records):
    """K3 and K1's forward against their plain version, at the serving
    batches and the training batch."""
    rng = np.random.default_rng(SEED)
    for s, c, _ in FUSED_SHAPES:
        w32 = _tensor(rng, (3, 3, c, c), 0.05)
        scale, bias = _affine(rng, c)
        w = w32.bfloat16()
        oihw = w32.permute(3, 2, 0, 1).contiguous()
        prep_ms = cuda_ms(lambda: fc._hwio(oihw, torch.bfloat16))
        w_lib = w.permute(3, 2, 0, 1).contiguous()
        for b in SERVE_BATCHES + [TRAIN_BATCH]:
            x = _tensor(rng, (b, s, s, c)).bfloat16()
            for name in ("conv3x3_small_bn_relu", "conv3x3_small"):
                if name == "conv3x3_small_bn_relu":
                    run = lambda: fc.conv3x3_small_bn_relu(  # noqa: E731
                        x, w, scale, bias)
                    z = fc._affine_relu(x, scale, bias)
                    plain = lambda: fc._plain_conv3x3(  # noqa: E731
                        fc._affine_relu(x, scale, bias), w)
                    library = None
                else:
                    run = lambda: fc.conv3x3_small(x, w)  # noqa: E731
                    z = x
                    plain = lambda: fc._plain_conv3x3(x, w)  # noqa: E731
                    xl = x.permute(0, 3, 1, 2)
                    library = lambda: F.conv2d(  # noqa: E731
                        xl, w_lib, padding=1)
                max_err, worst = _check(
                    f"{name} B={b} S={s} C={c}", run(),
                    fc._plain_conv3x3(z.float(), w.float()), ATOL, RTOL)
                _time_row(records, name, b, s, c, run, plain, library,
                          max_err, worst, weight_prep_ms=prep_ms)


def _time_row(records, name, b, s, c, run, plain, library, max_err, worst,
              **extra):
    plain_ms1 = cuda_ms(plain)
    ms = cuda_ms(run)
    plain_ms2 = cuda_ms(plain)
    library_ms = cuda_ms(library) if library is not None else None
    bound_ms, bound_by = bound(*conv_cost(name, b, s, c))
    row = {"B": b, "S": s, "C": c, "max_abs_err": max_err,
           "err_over_bound": worst, "ms": ms,
           "plain_ms": (plain_ms1 + plain_ms2) / 2, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms, **extra}
    _record(records, name, row)
    lib = f"{library_ms * 1e3:.1f} us" if library_ms is not None else "-"
    print(f"time {name:22s} B={b:4d} S={s} C={c}: kernel {ms * 1e3:.1f} us, "
          f"plain bf16 {plain_ms1 * 1e3:.1f}/{plain_ms2 * 1e3:.1f} us, "
          f"library {lib}, bound {bound_ms * 1e3:.2f} us ({bound_by})"
          + "".join(f", {k} {v * 1e3:.1f} us" for k, v in extra.items()))


def backward_kernel_phase(records):
    """K1 as the dgrad, K2 and K4 against their plain versions at the
    training shapes, and T2 at the training batch."""
    rng = np.random.default_rng(SEED + 1)
    for s, c, _ in MIXED_SHAPES + FUSED_SHAPES:
        w = _tensor(rng, (3, 3, c, c), 0.05).bfloat16()
        w_lib = w.permute(3, 2, 0, 1).contiguous()
        scale, bias = _affine(rng, c)
        for b in (TRAIN_BATCH, SMALL_BATCH):
            x = _tensor(rng, (b, s, s, c)).bfloat16()
            g = _tensor(rng, (b, s, s, c)).bfloat16()
            x_lib, g_lib = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

            # K1 as the dgrad: the conv of g with the flipped weight
            max_err, worst = _check(
                f"conv3x3_dgrad B={b} S={s} C={c}", fc.conv3x3_dgrad(g, w),
                fc._plain_conv3x3(g.float(), fc._flip(w).float()), ATOL,
                RTOL)
            _time_row(records, "conv3x3_dgrad", b, s, c,
                      lambda: fc.conv3x3_dgrad(g, w),
                      lambda: fc._plain_conv3x3(g, fc._flip(w)),
                      lambda: F.conv_transpose2d(g_lib, w_lib, padding=1),
                      max_err, worst)

            # K2 at 8x8 (the mixed op), K4 at 4x4 and 2x2 (the fused op)
            if s == 8:
                name, z = "conv3x3_wgrad", x
                run = lambda: fc.conv3x3_wgrad(x, g)  # noqa: E731
                plain = lambda: fc._plain_wgrad(x, g)  # noqa: E731
                library = lambda: torch.ops.aten.convolution_backward(  # noqa
                    g_lib, x_lib, w_lib, None, [1, 1], [1, 1], [1, 1],
                    False, [0, 0], 1, [False, True, False])
            else:
                name, z = ("conv3x3_wgrad_bn_relu",
                           fc._affine_relu(x, scale, bias))
                run = lambda: fc.conv3x3_wgrad_bn_relu(  # noqa: E731
                    x, g, scale, bias)
                plain = lambda: fc._plain_wgrad_bn_relu(  # noqa: E731
                    x, g, scale, bias)
                library = None
            want = fc._plain_wgrad(z.float(), g.float())
            got = run()
            if s == 8:
                det = torch.equal(got, run())
                if not det:
                    raise AssertionError(f"{name}: two launches differ")
            max_err, worst = _check(
                f"{name} B={b} S={s} C={c}", got, want,
                WGRAD_REL * want.abs().max().item(), 0.0)
            _time_row(records, name, b, s, c, run, plain, library, max_err,
                      worst)

    # T2: u8 [1024, 64, 64, 3] -> bf16 x / 255, exact
    x = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, 64, 64, 3),
                                      np.uint8)).cuda()
    got = pre.normalize_u8(x)
    every = torch.arange(256, dtype=torch.uint8, device=DEVICE)
    exact = torch.equal(got, pre._plain_normalize_u8(x)) and torch.equal(
        pre.normalize_u8(every), (every.float() / 255.0).bfloat16())
    print(f"check normalize_u8 B={TRAIN_BATCH} [64, 64, 3] and all 256 u8 "
          f"values: tolerance exact (0), equal {exact}")
    if not exact:
        raise AssertionError("normalize_u8 differs from its plain version")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=DEVICE)
    plain_ms1 = cuda_ms(lambda: pre._plain_normalize_u8(x))
    ms = cuda_ms(lambda: pre.normalize_u8(x))
    plain_ms2 = cuda_ms(lambda: pre._plain_normalize_u8(x))
    library_ms = cuda_ms(lambda: torch.mul(x, 1.0 / 255.0, out=out))
    bound_ms, bound_by = bound(0, x.numel() * 3)
    _record(records, "normalize_u8", {
        "B": TRAIN_BATCH, "shape": [64, 64, 3], "max_abs_err": 0.0,
        "err_over_bound": 0.0, "ms": ms, "plain_ms": (plain_ms1 + plain_ms2)
        / 2, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms})
    print(f"time normalize_u8 B={TRAIN_BATCH}: kernel {ms * 1e3:.1f} us, "
          f"plain bf16 {plain_ms1 * 1e3:.1f}/{plain_ms2 * 1e3:.1f} us, "
          f"library (torch.mul into bf16) {library_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by})")


def _sum(rec, b, per):
    """ms / plain_ms / bound_ms / library_ms summed over ``per`` = [(S, C,
    calls)] at batch ``b``."""
    rows = {(r["S"], r["C"]): r for r in rec["shapes"] if r["B"] == b}
    out = {}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        vals = [rows[(s, c)][key] for s, c, _ in per]
        out[key] = (None if any(v is None for v in vals)
                    else sum(v * n for v, (_, _, n) in zip(vals, per)))
    bounds = [rows[(s, c)]["bound_by"] for s, c, _ in per]
    out["bound_by"] = max(set(bounds), key=bounds.count)
    return out


def synthetic(rng, base, classes):
    """uint8 images of ``classes``: each class's base image plus noise."""
    noise = rng.integers(-NOISE, NOISE + 1, (len(classes),) + base.shape[1:],
                         dtype=np.int16)
    return np.clip(base[classes].astype(np.int16) + noise, 0,
                   255).astype(np.uint8)


def direct(net, images):
    """Embeddings the way the collector makes them: batches padded to
    MAX_BATCH."""
    out = []
    for i in range(0, len(images), MAX_BATCH):
        chunk = images[i:i + MAX_BATCH]
        pad = np.zeros((MAX_BATCH,) + chunk.shape[1:], np.uint8)
        pad[:len(chunk)] = chunk
        out.append(net.encode(pad)[:len(chunk)])
    return np.concatenate(out)


def serving_phase():
    rng = np.random.default_rng(SEED)
    h, w, _ = FLAGSHIP["model"]["input_shape"]
    base = rng.integers(0, 256, (N_CLASSES, h, w, 3), dtype=np.uint8)
    db_classes = np.repeat(np.arange(N_CLASSES), PER_CLASS)
    db_images = synthetic(rng, base, db_classes)
    sizes = [1, 32, 100]
    query_classes = [rng.integers(0, N_CLASSES, n) for n in sizes]
    queries = [synthetic(rng, base, c) for c in query_classes]

    t0 = time.perf_counter()
    net = EmbeddingNet(FLAGSHIP, device=DEVICE, fast_conv=True,
                       dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"serve: model built in {time.perf_counter() - t0:.1f} s")

    # ---- the main path: every launch count from here to the reading ----
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    encodings = np.concatenate([
        net.encode(db_images[i:i + DB_BATCH])
        for i in range(0, len(db_images), DB_BATCH)])
    encode_s = time.perf_counter() - t0
    db_batches = -(-len(db_images) // DB_BATCH)
    print(f"serve: encoded {len(db_images)} images in {db_batches} batches "
          f"of {DB_BATCH} in {encode_s:.2f} s "
          f"({len(db_images) / encode_s:.0f} img/s, first batch included)")
    db = {"paths": [f"synthetic/{c}/{i}" for i, c in enumerate(db_classes)],
          "labels": [f"class_{c:04d}" for c in db_classes],
          "encodings": encodings,
          "weights_fingerprint": net.weights_fingerprint()}
    with tempfile.TemporaryDirectory() as tmp:
        net.save_encodings(db, tmp)
        net.load_encodings(f"{tmp}/encodings.pkl")
    engine = InferenceEngine(net, max_batch=MAX_BATCH)
    try:
        if not engine.ready.wait(600):
            raise TimeoutError("engine warm-up did not finish")
        answers, latencies = [], []
        for images in queries:
            t0 = time.perf_counter()
            answers.append(engine.infer_arrays(list(images)))
            latencies.append(time.perf_counter() - t0)
        launches = dict(fc.LAUNCHES)
        device_batches = db_batches + engine.device_batches
        # ---- end of the main path ----
        print(f"serve: request latencies (ms) for {sizes} images: "
              + ", ".join(f"{t * 1e3:.2f}" for t in latencies)
              + f"; engine device batches {engine.device_batches} "
                f"(warm-up included)")
        repeat = []
        for _ in range(20):
            t0 = time.perf_counter()
            engine.infer_arrays(list(queries[1]))
            repeat.append(time.perf_counter() - t0)
        print(f"serve: 32-image request, 20 repeats: median "
              f"{np.median(repeat) * 1e3:.2f} ms, min "
              f"{min(repeat) * 1e3:.2f} ms, max {max(repeat) * 1e3:.2f} ms")
    finally:
        engine.close()

    # ---- checks ----
    fused_per_forward = sum(n for _, _, n in FUSED_SHAPES)
    expected = fused_per_forward * device_batches
    if launches["conv3x3_small_bn_relu"] != expected:
        raise AssertionError(
            f"fused kernel launched {launches['conv3x3_small_bn_relu']} "
            f"times, expected {fused_per_forward} x {device_batches} device "
            f"batches = {expected}")
    db_np, label_np, classes = net._db()
    db_emb = torch.as_tensor(db_np, device=DEVICE)
    label_ids = torch.as_tensor(label_np, device=DEVICE)
    correct = total = 0
    max_emb_diff = 0.0
    served = [encodings]
    for images, truth, got in zip(queries, query_classes, answers):
        emb = direct(net, images)
        pred, _ = knn_classify(db_emb, label_ids,
                               torch.as_tensor(emb, device=DEVICE), k=5,
                               n_classes=len(classes))
        want = [classes[int(p)] for p in pred.tolist()]
        labels = [a["label"] for a in got]
        if labels != want:
            raise AssertionError(f"engine answers {labels[:8]} differ from "
                                 f"direct encode + kNN {want[:8]}")
        if not set(labels) <= set(classes):
            raise AssertionError("an answer is not a class of the DB")
        served.append(np.stack([a["embedding"] for a in got]))
        max_emb_diff = max(max_emb_diff,
                           float(np.abs(served[-1] - emb).max()))
        correct += sum(l == f"class_{t:04d}" for l, t in zip(labels, truth))
        total += len(labels)
    all_emb = np.concatenate(served)
    norms = np.linalg.norm(all_emb, axis=1)
    if not np.isfinite(all_emb).all() or np.abs(norms - 1).max() > 1e-3:
        raise AssertionError(f"embeddings not finite and unit norm: norms in "
                             f"[{norms.min()}, {norms.max()}]")
    accuracy = correct / total
    print(f"serve: {total} answers equal direct encode + kNN (embeddings "
          f"within {max_emb_diff:.2e}); accuracy against the true classes "
          f"{accuracy:.3f}")
    if accuracy < 0.9:
        raise AssertionError(f"kNN accuracy {accuracy} under 0.9")

    # the same weights through cuDNN (fast_conv off)
    plain = EmbeddingNet(FLAGSHIP, device=DEVICE, fast_conv=False,
                         dtype=torch.bfloat16)
    plain.module.load_state_dict(net.module.state_dict())
    sample = db_images[:DB_BATCH]
    diff = float(np.abs(plain.encode(sample) - net.encode(sample)).max())
    print(f"serve: kernel path vs cuDNN path, max abs embedding diff "
          f"{diff:.3e} (bound 2e-2)")
    if diff > 2e-2:
        raise AssertionError(f"kernel path differs from cuDNN by {diff}")
    x = torch.as_tensor(queries[1], device=DEVICE)
    with torch.inference_mode():
        fwd = {name: cuda_ms(lambda: n.embed(x), iters=20)
               for name, n in (("cudnn", plain), ("kernel", net),
                               ("cudnn_again", plain))}
    print(f"serve: B=32 device forward (embed): kernel path "
          f"{fwd['kernel']:.3f} ms, cuDNN path {fwd['cudnn']:.3f}/"
          f"{fwd['cudnn_again']:.3f} ms")
    return launches, db_images, db_classes



def _batches(sampler, images, n):
    """``n`` P-K batches of uint8 images and int32 labels, drawn on the
    host before the run (loading is set-up)."""
    out = []
    for _ in range(n):
        paths, labels = sampler.sample()
        out.append((torch.from_numpy(images[[int(p) for p in paths]]),
                    torch.from_numpy(labels)))
    return out


def _train_module(fast_conv, dtype=torch.bfloat16):
    m = FLAGSHIP["model"]
    return EmbeddingModule(
        backbone_name=m["backbone_name"], encodings_len=m["encodings_len"],
        embeddings_normalization=m["embeddings_normalization"],
        bn_momentum=BN_MOMENTUM, fast_conv=fast_conv, dtype=dtype)


def _trainer(module, dtype=torch.bfloat16):
    spec = get_optimizer("adam", step_decay_schedule(LR, LR_DECAY, 1,
                                                     STEPS_PER_EPOCH))
    state = TrainState.create(module, spec)
    step = make_triplet_train_step(
        module, spec, margin=MARGIN, mode="batch_all",
        compute_dtype=dtype, max_positives=K_SAMPLES - 1)
    return state, step


def _timed_steps(state, step, batches):
    """Runs the steps; (per-step wall seconds, metrics as floats)."""
    times, metrics = [], []
    for images, labels in batches:
        t0 = time.perf_counter()
        state, m = step(state, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return times, metrics


def _device_busy(state, step, batches):
    """(device-busy share, device ms per step, top kernels) over the
    steps, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for images, labels in batches:
            step(state, images, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device activity: kernels, copies and sets, not the annotations that
    # span them on the device's timeline
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    ours = {name: us for name, us in by_name.items()
            if "conv3x3" in name or "sum_splits" in name
            or "normalize_u8" in name}
    return (busy_us * 1e-6 / wall, busy_us * 1e-3 / len(batches),
            ours, top, wall)


def training_phase(db_images, db_classes):
    class_files = {}
    for i, c in enumerate(db_classes):
        class_files.setdefault(f"class_{c:04d}", []).append(str(i))
    sampler = PKSampler(class_files, sorted(class_files),
                        k_classes=P_CLASSES, k_samples=K_SAMPLES, seed=SEED)
    batches = _batches(sampler, db_images, WARMUP_STEPS + TIMED_STEPS
                       + PROFILED_STEPS + 1)
    warmup = batches[:WARMUP_STEPS]
    timed = batches[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS]
    profiled = batches[WARMUP_STEPS + TIMED_STEPS:-1]
    probe = batches[-1]

    t0 = time.perf_counter()
    module = _train_module(fast_conv=True)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    module.to(DEVICE)
    state, step = _trainer(module)
    _timed_steps(state, step, warmup)
    print(f"train: model built and {WARMUP_STEPS} warm-up steps in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- the main path: every launch count from here to the reading ----
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = _timed_steps(state, step, timed)
    launches = {**fc.LAUNCHES, **pre.LAUNCHES}
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    med = float(np.median(times))
    print(f"train: {TIMED_STEPS} steps of B={P_CLASSES * K_SAMPLES}, "
          f"kernel path: step median {med * 1e3:.2f} ms (min "
          f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
          f"{P_CLASSES * K_SAMPLES / med:.0f} img/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    print("train: losses " + " ".join(f"{l:.4f}" for l in losses))
    print("train: n_triplets " + " ".join(str(int(m["n_triplets"]))
                                         for m in metrics))
    print(f"train: last step frac_mined {metrics[-1]['frac_mined']:.4f}, "
          f"mean_pos_dist {metrics[-1]['mean_pos_dist']:.4f}, "
          f"mean_neg_dist {metrics[-1]['mean_neg_dist']:.4f}")
    print(f"train: launches over {TIMED_STEPS} steps: {launches}")

    # ---- checks ----
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not all(m["n_triplets"] > 0 for m in metrics):
        raise AssertionError("a step mined no triplet")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"train: mean loss of the first 5 steps {first:.4f}, of the last "
          f"5 {last:.4f}")
    if not last < first:
        raise AssertionError("the loss did not fall")
    for name, per_step in EXPECTED_PER_STEP.items():
        if launches[name] != per_step * TIMED_STEPS:
            raise AssertionError(
                f"{name} launched {launches[name]} times over {TIMED_STEPS} "
                f"steps, expected {per_step} per step")
    for name in OFF_PATH:
        if launches[name]:
            raise AssertionError(f"{name} launched on the training path")

    busy, device_ms, ours, top, wall = _device_busy(state, step, profiled)
    ours_ms = sum(ours.values()) * 1e-3 / PROFILED_STEPS
    print(f"train: torch.profiler over {PROFILED_STEPS} steps: device busy "
          f"{busy:.3f} of {wall * 1e3:.1f} ms wall (profiled), "
          f"{device_ms:.2f} ms of device time per step, "
          f"{device_ms / (med * 1e3):.3f} of the unprofiled step median; "
          f"the port's kernels {ours_ms:.2f} ms per step")
    for label, rows in (("top", top), ("port kernel", sorted(ours.items()))):
        for name, us in rows:
            print(f"  profile {label}: {us / PROFILED_STEPS / 1e3:8.3f} "
                  f"ms/step  {name[:90]}")

    # the same weights and batch through the cuDNN path (fast_conv off), in
    # bf16 and in f32
    snapshot = {k: v.clone() for k, v in module.state_dict().items()}
    plain = _train_module(fast_conv=False).to(DEVICE)
    results = {}
    for label, mod, dtype in (
            ("kernel", module, torch.bfloat16),
            ("cudnn", plain, torch.bfloat16),
            ("f32", _train_module(False, dtype=None).to(DEVICE),
             torch.float32)):
        mod.load_state_dict(snapshot)
        st, stp = _trainer(mod, dtype)
        _, (m,) = _timed_steps(st, stp, [probe])
        results[label] = (m["loss"], {n: p.grad.float().clone()
                                      for n, p in mod.named_parameters()})
        if label == "f32":
            del mod, st, stp
    losses3 = {k: v[0] for k, v in results.items()}
    grads = {k: v[1] for k, v in results.items()}
    ref = grads["f32"]

    def rel(label, names):
        num = sum(((grads[label][n] - ref[n]) ** 2).sum() for n in names)
        den = sum((ref[n] ** 2).sum() for n in names)
        return (num / den.clamp_min(1e-30)).sqrt().item()

    loss_rel = abs(losses3["kernel"] - losses3["cudnn"]) / abs(
        losses3["cudnn"])
    every = list(ref)
    total_k, total_c = rel("kernel", every), rel("cudnn", every)
    print(f"train: one step from the same weights and batch: loss kernel "
          f"{losses3['kernel']:.6f}, cuDNN {losses3['cudnn']:.6f} (relative "
          f"{loss_rel:.2e}, tolerance {LOSS_RTOL}), f32 {losses3['f32']:.6f}"
          f"; gradient relative L2 to the f32 step over all parameters: "
          f"kernel {total_k:.4f}, cuDNN {total_c:.4f} (tolerance "
          f"{GRAD_FACTOR} x cuDNN)")
    rows = []
    for n, g in ref.items():
        if g.dim() == 4:
            kc = ((grads["kernel"][n] - grads["cudnn"][n]).norm()
                  / grads["cudnn"][n].norm().clamp_min(1e-30)).item()
            rows.append((rel("kernel", [n]), rel("cudnn", [n]), kc, n))
    rows.sort(key=lambda r: r[1] * GRAD_FACTOR + GRAD_SLACK - r[0])
    for ek, ec, kc, n in rows[:5]:
        print(f"  conv weight gradient, closest to its tolerance: {n}: to "
              f"f32 kernel {ek:.4f}, cuDNN {ec:.4f}; kernel to cuDNN "
              f"{kc:.4f}")
    bad = [n for ek, ec, _, n in rows
           if ek > GRAD_FACTOR * ec + GRAD_SLACK]
    if loss_rel > LOSS_RTOL or total_k > GRAD_FACTOR * total_c or bad:
        raise AssertionError(f"the kernel path and the cuDNN path disagree "
                             f"(conv weights past tolerance: {bad})")

    # the cuDNN path's step time, in the same call
    st, stp = _trainer(plain)
    _timed_steps(st, stp, warmup[:2])
    c_times, _ = _timed_steps(st, stp, timed[:CUDNN_STEPS])
    c_med = float(np.median(c_times))
    print(f"train: cuDNN path: step median {c_med * 1e3:.2f} ms over "
          f"{CUDNN_STEPS} steps ({P_CLASSES * K_SAMPLES / c_med:.0f} img/s) "
          f"against the kernel path's {med * 1e3:.2f} ms")
    return launches


def main():
    smi = check_card()
    # f32 references in full f32: cuDNN's convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    records = {}
    forward_kernel_phase(records)
    backward_kernel_phase(records)
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    serve_launches, db_images, db_classes = serving_phase()
    train_launches = training_phase(db_images, db_classes)

    lines, step_sum = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, (route, source, replaces) in KERNELS.items():
        rec = records[name]
        if name == "normalize_u8":
            row = rec["shapes"][0]
            sums = {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "library_ms", "bound_by")}
        elif name in OFF_PATH:
            sums = _sum(rec, TRAIN_BATCH, FUSED_SHAPES)
        else:
            sums = _sum(rec, TRAIN_BATCH, PER_STEP[name])
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces, "launches": train_launches[name],
                 "max_abs_err": rec["max_abs_err"], **sums,
                 "per": f"training step, B={TRAIN_BATCH}"}
        if name == "conv3x3_small_bn_relu":
            entry["serve"] = {"launches": serve_launches[name],
                              "per": "serving forward, B=32",
                              **_sum(rec, 32, FUSED_SHAPES)}
        if name not in OFF_PATH:
            for key in step_sum:
                step_sum[key] += sums[key]
        lines.append(entry)
    print(json.dumps({"kernels": [e for e in lines
                                  if e["name"] not in OFF_PATH],
                      "off_path_kernels": [e for e in lines
                                           if e["name"] in OFF_PATH],
                      "training_step_kernels_sum": step_sum}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
