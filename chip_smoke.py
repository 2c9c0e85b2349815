#!/usr/bin/env python
"""Smoke run of the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

1. Checks for a CUDA card (there is no CPU route) and prints its name and
   power limit as ``nvidia-smi`` reports them.
2. Builds the kernels of ``embeddingnet_tpu_torch/csrc`` with ``nvcc``.
3. Kernel phase: each kernel of the serving path against its plain PyTorch
   version, at the shapes ResNet-50 at 64x64 gives it, for a ragged batch
   of 3, the serving batch of 32 and the bulk-encode batch of 256. Errors
   are taken against the plain version in f32 (TF32 off); times, with CUDA
   events, against the plain version in bf16.
4. Serving phase: the flagship model (ResNet-50 v1.5, 64x64x3, 256-d
   L2-normalised embedding, kNN k=5, bf16, fused BN-ReLU conv on), with
   seeded random weights, encodes a DB of 10,240 synthetic images
   (1,024 classes x 10) in batches of 256, saves and reloads it, and answers
   requests of 1, 32 and 100 decoded images through the micro-batching
   engine. The answers are checked against a direct encode + kNN, against
   the true classes, and the embeddings against the cuDNN path.

The last line of standard output is the result,
``{"ok": true, "device": {...}}``. The line before it lists each kernel:
its launches during the serving run, its worst error, and ``ms`` /
``plain_ms``, the kernel's and the plain version's device time summed over
the calls one ResNet-50 forward makes at the serving batch (5 at stage 3,
2 at stage 4), with the per-shape rows under ``shapes``. Any failure
raises, and the script exits non-zero without the last line.
"""

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from embeddingnet_tpu_torch.models.api import EmbeddingNet
from embeddingnet_tpu_torch.ops import _cuda
from embeddingnet_tpu_torch.ops import fused_conv as fc
from embeddingnet_tpu_torch.ops.knn import knn_classify
from embeddingnet_tpu_torch.serving import InferenceEngine

SEED = 0
SOURCE = "embeddingnet_tpu_torch/csrc/fused_conv3x3.cu"
# (name, TPU kernel body it replaces, prologue on?, on the serving path?)
# conv3x3_small, the prologue-free instance, is built and checked too, but
# ResNet-50's forward does not reach it (its stride-1 3x3 convs all follow
# a BatchNorm, so all are fused).
KERNELS = [
    ("conv3x3_small_bn_relu", "embeddingnet_tpu/ops/fused_conv.py:556", True,
     True),
    ("conv3x3_small", "embeddingnet_tpu/ops/fused_conv.py:200", False,
     False),
]
DEVICE = "cuda"
# ResNet-50 at 64x64: stage 3 (blocks 2-6) and stage 4 (blocks 2-3)
PATH_SHAPES = [(4, 256, 5), (2, 512, 2)]    # (S, C, fused convs/forward)
BATCHES = [3, 32, 256]
# bf16 output rounding: the JAX package's bf16 bound for these kernels
# (tests/test_fused_conv.py, test_forward_bf16)
RTOL = ATOL = 2e-2

FLAGSHIP = {
    "model": {"backbone_name": "resnet50", "input_shape": [64, 64, 3],
              "encodings_len": 256, "embeddings_normalization": True,
              "mode": "triplet"},
    "general": {"seed": SEED},
    "encodings": {"knn_k": 5},
}
N_CLASSES, PER_CLASS, DB_BATCH, MAX_BATCH = 1024, 10, 256, 32
NOISE = 8   # gray levels of per-image noise around each class's base image


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
    path = _cuda.build()
    _cuda.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")


def kernel_phase():
    """Each kernel against its plain version; returns per-kernel records."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    records = {name: {"max_abs_err": 0.0, "shapes": []}
               for name, _, _, _ in KERNELS}
    for s, c, _ in PATH_SHAPES:
        w32 = torch.from_numpy(
            (rng.normal(size=(3, 3, c, c)) * 0.05).astype(np.float32)).cuda()
        scale = torch.from_numpy(
            rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)).cuda()
        bias = torch.from_numpy(
            (rng.normal(size=(c,)) * 0.1).astype(np.float32)).cuda()
        w = w32.bfloat16()
        oihw = w32.permute(3, 2, 0, 1).contiguous()
        prep_ms = cuda_ms(lambda: fc._hwio(oihw, torch.bfloat16))
        for b in BATCHES:
            x = torch.from_numpy(
                rng.normal(size=(b, s, s, c)).astype(np.float32)).cuda()
            x = x.bfloat16()
            for name, _, prologue, _ in KERNELS:
                if prologue:
                    run = lambda: fc.conv3x3_small_bn_relu(  # noqa: E731
                        x, w, scale, bias)
                    z = fc._affine_relu(x, scale, bias)
                    plain = lambda: fc._plain_conv3x3(  # noqa: E731
                        fc._affine_relu(x, scale, bias), w)
                else:
                    run = lambda: fc.conv3x3_small(x, w)  # noqa: E731
                    z = x
                    plain = lambda: fc._plain_conv3x3(x, w)  # noqa: E731
                got = run().float()
                want = fc._plain_conv3x3(z.float(), w.float())
                torch.cuda.synchronize()
                err = (got - want).abs()
                bound = ATOL + RTOL * want.abs()
                max_err = err.max().item()
                worst = (err / bound).max().item()
                if not torch.isfinite(got).all() or worst > 1.0:
                    raise AssertionError(
                        f"{name} B={b} S={s} C={c}: max abs err {max_err} "
                        f"exceeds atol {ATOL} + rtol {RTOL} * |ref| "
                        f"(worst ratio {worst:.3f})")
                plain_ms1 = cuda_ms(plain)
                ms = cuda_ms(run)
                plain_ms2 = cuda_ms(plain)
                row = {"B": b, "S": s, "C": c, "max_abs_err": max_err,
                       "err_over_bound": worst, "ms": ms,
                       "plain_ms": (plain_ms1 + plain_ms2) / 2,
                       "weight_prep_ms": prep_ms}
                records[name]["shapes"].append(row)
                records[name]["max_abs_err"] = max(
                    records[name]["max_abs_err"], max_err)
                print(f"kernel {name:22s} B={b:3d} S={s} C={c}: "
                      f"max_abs_err {max_err:.3e} (ratio to bound "
                      f"{worst:.3f}), kernel {ms * 1e3:.1f} us, plain bf16 "
                      f"{plain_ms1 * 1e3:.1f}/{plain_ms2 * 1e3:.1f} us, "
                      f"weight cast+permute {prep_ms * 1e3:.1f} us")
    # per ResNet-50 forward at the serving batch: 5 calls at stage 3 and
    # 2 at stage 4
    for rec in records.values():
        per = {(r["S"], r["C"]): r for r in rec["shapes"] if r["B"] == 32}
        rec["ms"] = sum(per[(s, c)]["ms"] * n for s, c, n in PATH_SHAPES)
        rec["plain_ms"] = sum(per[(s, c)]["plain_ms"] * n
                              for s, c, n in PATH_SHAPES)
    return records


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
    fused_per_forward = sum(n for _, _, n in PATH_SHAPES)
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
    return launches


def main():
    check_card()
    build()
    records = kernel_phase()
    launches = serving_phase()
    on_path, off_path = [], []
    for name, replaces, _, path in KERNELS:
        rec = records[name]
        (on_path if path else off_path).append({"name": name, "route": "cuda",
                        "source": SOURCE, "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "shapes": rec["shapes"]})
    print(json.dumps({"kernels": on_path, "off_path_kernels": off_path}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
