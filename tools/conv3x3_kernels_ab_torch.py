#!/usr/bin/env python
"""Device time of the port's small-map 3x3 conv kernels on the card, and an
A/B of two checkouts of the repo on the same card.

    python tools/conv3x3_kernels_ab_torch.py                 # this checkout
    python tools/conv3x3_kernels_ab_torch.py --against DIR   # A/B

Times, by ``torch.profiler`` device time over ``ITERS`` calls after a
warm-up, the port's small-map conv kernels on seeded bf16 inputs at
ResNet-50's fused shapes at 64 px (S=4, C=256 and S=2, C=512): K3
(``conv3x3_small_bn_relu``) and K1's forward (``conv3x3_small``) at B =
1,024 and the serving batch 32, K4 (``conv3x3_wgrad_bn_relu``, its part sum
included), K2 (``conv3x3_wgrad``) and T1 (``conv3x3_small_affine_relu``,
the conv with the affine-ReLU epilogue) at B = 1,024. Each run of a
checkout prints the card's name and power limit, then one JSON object of
times in ms.

``--against DIR`` names the root of another checkout (for example a
``git archive`` of the parent commit unpacked into a directory that
``.gitignore`` lists): the two are run in separate processes in the order
DIR, this, this, DIR, so that a drift of the card's clock during the call
shows. Each process builds its checkout's kernels. It imports PyTorch, the
port and ``benchmark/trace.py`` only, and needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark.trace import READS, settled  # noqa: E402

ITERS = 30
SEED = 0
SHAPES = [(1024, 4, 256), (1024, 2, 512), (32, 4, 256), (32, 2, 512)]


def device_ms(fn, iters=ITERS):
    """Device time of one call of ``fn``: profiler kernel time over
    ``iters`` calls, after one untraced call, from a read that
    :func:`settled` takes, up to ``READS`` reads; else ``RuntimeError``,
    naming ``fn``: a read of nothing, or of a part, is not a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(READS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        counts.append(len(kernels))
        if settled(counts):
            return sum(e.device_time_total for e in kernels) * 1e-3 / iters
    name = getattr(fn, "__qualname__", repr(fn))
    raise RuntimeError(f"device_ms: torch.profiler saw no two reads of "
                       f"{iters} calls of {name} with the most kernels "
                       f"(kernel counts of the reads {counts})")


def measure(tag, root):
    """The kernels' device times with the port of the checkout at
    ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from embeddingnet_tpu_torch.ops import fused_conv as fc
    if not torch.cuda.is_available():
        raise SystemExit("conv3x3_kernels_ab_torch: needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(SEED)

    def tensor(shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    out = {"tag": tag}
    for b, s, c in SHAPES:
        x = tensor((b, s, s, c)).bfloat16()
        g = tensor((b, s, s, c)).bfloat16()
        w = tensor((3, 3, c, c), 0.05).bfloat16()
        scale = tensor((c,)).abs() + 0.5
        bias = tensor((c,)) * 0.1
        key = f"B{b}_S{s}_C{c}"
        out[f"{key}_K3"] = device_ms(
            lambda: fc.conv3x3_small_bn_relu(x, w, scale, bias))
        out[f"{key}_K1"] = device_ms(lambda: fc.conv3x3_small(x, w))
        if b == 1024:
            out[f"{key}_K4"] = device_ms(
                lambda: fc.conv3x3_wgrad_bn_relu(x, g, scale, bias))
            out[f"{key}_K2"] = device_ms(lambda: fc.conv3x3_wgrad(x, g))
            out[f"{key}_T1"] = device_ms(
                lambda: fc.conv3x3_small_affine_relu(x, w, scale, bias))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", help="root of another checkout")
    parser.add_argument("--tag", default="this", help=argparse.SUPPRESS)
    parser.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.against is None:
        print(json.dumps(measure(args.tag, args.root)), flush=True)
        return
    other = os.path.abspath(args.against)
    for tag, root in (("against", other), ("this", ROOT), ("this", ROOT),
                      ("against", other)):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--tag",
                        tag, "--root", root], check=True, cwd=root)


if __name__ == "__main__":
    main()
