#!/usr/bin/env python
"""A/B of the 3x3 conv with a fused BN-apply + ReLU epilogue on the
PyTorch port: ``relu(conv3x3_SAME(x, W)*scale + bias)`` at the worst stage
of ResNet-50 at 64 px (stage 4: 2x2 maps, 512 channels), the port of
``tools/pallas_fused_conv.py``.

    python tools/fused_conv_epilogue_torch.py                # on the card
    python tools/fused_conv_epilogue_torch.py --device cpu   # plain version

Two paths compute the same function on the same seeded inputs
([B, 2, 2, 512] bf16 activations, [3, 3, 512, 512] bf16 weights, f32 scale
and bias; ``B`` from ``FC_BATCH``, default 1024 on the card and 16 on the
CPU):

* library: ``F.conv2d`` in bf16 on ``channels_last`` tensors, then the
  affine and the ReLU, each an eager PyTorch op;
* T1: ``conv3x3_small_affine_relu`` of ``embeddingnet_tpu_torch.ops.
  fused_conv`` — on the card the hand-written CUDA kernel (the epilogue
  applied to the f32 accumulator before the single bf16 store), on the CPU
  its plain version.

The tool first checks T1 against the plain version (f32 accumulation, the
affine in f32, one bf16 rounding) to bf16 output rounding, atol = rtol =
2e-2, then times three interleaved repetitions of both paths (CUDA events
over ``N_STEPS`` calls on the card, the host clock on the CPU) and prints
the best of three of each, in ms and TFLOP/s, and the speedup. It imports
PyTorch and the port only.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from embeddingnet_tpu_torch.ops import fused_conv as fc  # noqa: E402

S = 2            # stage-4 spatial
C = 512          # channels (3x3 conv of the stage-4 bottleneck)
N_STEPS = 20
REPS = 3
# bf16 output rounding: the port's bound for its conv kernels in bf16
ATOL = RTOL = 2e-2


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; cpu runs the "
                             "plain version)")
    return parser.parse_args(argv)


def inputs(batch, device):
    """``main``'s inputs of ``tools/pallas_fused_conv.py``, drawn from the
    same seeded generator in the same order: x [B, S, S, C] and w [3, 3, C, C]
    bf16, scale and bias [C] f32."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, S, S, C))
    w = rng.normal(size=(3, 3, C, C)) * 0.02
    scale = rng.uniform(0.5, 1.5, (1, C))
    bias = rng.normal(size=(1, C)) * 0.1

    def to(a, dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)

    return (to(x, torch.bfloat16), to(w, torch.bfloat16),
            to(scale[0], torch.float32), to(bias[0], torch.float32))


def library_path(x, w, scale, bias):
    """The library sequence, NHWC in and out: ``F.conv2d`` in bf16 on the
    channels_last view, then the affine and the ReLU as eager ops."""
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x_nchw = x.permute(0, 3, 1, 2)              # channels_last view
    scale4, bias4 = scale.view(1, -1, 1, 1), bias.view(1, -1, 1, 1)

    def run():
        y = F.conv2d(x_nchw, w_oihw, padding=1)
        return torch.relu(y * scale4 + bias4).to(x.dtype).permute(0, 2, 3, 1)

    return run


def timeit(fn, device):
    """Seconds per call: CUDA events around N_STEPS calls on the card, the
    host clock on the CPU (a CPU number, not a device time)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(N_STEPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / N_STEPS
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv=None):
    """Runs the A/B; returns ``{"batch", "device", "max_abs_err",
    "library_s", "t1_s"}`` (the best-of-three times in seconds)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card; pass --device cpu for the plain "
                         "version")
    batch = int(os.environ.get("FC_BATCH",
                               1024 if device.type == "cuda" else 16))
    x, w, scale, bias = inputs(batch, device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    library = library_path(x, w, scale, bias)

    def t1():
        return fc.conv3x3_small_affine_relu(x, w, scale, bias)

    with torch.no_grad():
        want = fc._plain_conv3x3_affine_relu(x, w, scale, bias).float()
        err = {}
        for label, fn in (("T1", t1), ("library", library)):
            got = fn().float()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label}: output not finite")
            diff = (got - want).abs()
            err[label] = diff.max().item()
            worst = (diff / (ATOL + RTOL * want.abs())).max().item()
            print(f"numerics: max |{label} - plain| = {err[label]:.4f} "
                  f"(bf16 outputs, atol = rtol = {ATOL}; worst ratio to the "
                  f"tolerance {worst:.3f})")
            if worst > 1.0:
                raise AssertionError(f"{label} differs from the plain "
                                     f"version by {err[label]}")

        flops = 2 * batch * S * S * 9 * C * C
        print(f"\nstage-4 3x3 conv + BN-apply + ReLU, B={batch}, "
              f"{S}x{S}x{C}, on {name}:")
        times = {"library": [], "T1": []}
        for rep in range(REPS):
            for label, fn in (("library", library), ("T1", t1)):
                dt = timeit(fn, device)
                times[label].append(dt)
                print(f"{label + f' [{rep}]':14s} {dt * 1e3:8.3f} ms  "
                      f"{flops / dt / 1e12:7.2f} TFLOP/s")
    lib, ours = min(times["library"]), min(times["T1"])
    print(f"\nbest-of-{REPS} on {name}: library {lib * 1e3:.3f} ms, T1 "
          f"{ours * 1e3:.3f} ms -> speedup {lib / ours:.2f}x")
    return {"batch": batch, "device": name, "max_abs_err": err["T1"],
            "library_s": lib, "t1_s": ours}


if __name__ == "__main__":
    main()
