#!/usr/bin/env python
"""Augmented training by kind of synthetic class image, on the card.

    python tools/augment_probe_torch.py [--steps 40] [kind ...]

For each kind of class image — ``noise`` (uniform noise per class, the
serving DB of ``chip_smoke.py``) or an integer ``g`` (a g x g grid of random
colours per class, scaled up to 64 px) — builds 1,024 classes x 10 images
(each the class image plus 8 gray levels of noise) and trains the flagship
step of ``chip_smoke.py`` (ResNet-50, bf16, fused conv kernels, batch-all
on P-K batches of 256 x 4, Adam at 1e-3) from the same initial weights,
with the ``default`` augmentation preset and without, printing per step
the loss, the fraction of triplets mined, the mean positive and negative
distances and the step's wall time (host clock, the step ended by a
synchronise), and the median wall time of the steps after the first three. It shows on which data 20 augmented steps can show
learning: a net at initialisation separates classes only by what survives
the preset's colour and noise ops. Needs the card (and ``chip_smoke.py``'s
helpers, imported from the repository's root).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from embeddingnet_tpu_torch.ops import augment as aug  # noqa: E402

METRICS = ("loss", "frac_mined", "mean_pos_dist", "mean_neg_dist")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("kinds", nargs="*", default=["noise", "8"])
    parser.add_argument("--steps", type=int, default=40)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    classes = np.repeat(np.arange(cs.N_CLASSES), cs.PER_CLASS)
    for kind in args.kinds:
        rng = np.random.default_rng(cs.SEED)
        if kind == "noise":
            base = rng.integers(0, 256, (cs.N_CLASSES, 64, 64, 3),
                                dtype=np.uint8)
            images = cs.synthetic(rng, base, classes)
        else:
            images = cs.cell_images(rng, classes, cells=int(kind))
        for preset in ("default", None):
            module = cs._train_module(fast_conv=True)
            module.reset_parameters(torch.Generator().manual_seed(cs.SEED))
            module.to("cuda")
            state, step = cs._trainer(
                module, augment_fn=aug.get_aug(preset) if preset else None)
            times = []
            for i, (imgs, labels) in enumerate(cs._pk_batches(
                    images, classes, args.steps, seed=cs.SEED + 1)):
                t0 = time.perf_counter()
                state, m = step(state, imgs, labels)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                print(f"{kind} {preset} step {i}: " + ", ".join(
                    f"{k} {float(m[k]):.4f}" for k in METRICS)
                    + f", {times[-1] * 1e3:.2f} ms", flush=True)
            print(f"{kind} {preset}: step median {np.median(times[3:]) * 1e3:.2f}"
                  f" ms over steps 3-{args.steps - 1} on "
                  f"{torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()
