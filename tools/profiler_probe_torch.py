#!/usr/bin/env python
"""How often a ``torch.profiler`` read of device time loses kernel
records, on the card: ``python tools/profiler_probe_torch.py [--reads N]``.

Reads ``N`` times each, ``CALLS`` calls a read, as ``device_ms`` in
``tools/conv3x3_kernels_ab_torch.py`` reads them: K1 as the dgrad
(``conv3x3_dgrad``, B=1,024, S=8, C=128, built from this checkout), T1's
yardsticks (``F.conv2d`` on a [1024, 512, 2, 2] bf16 channels-last batch,
and the eager conv -> affine -> ReLU sequence of
``tools/fused_conv_epilogue_torch.py``) and one elementwise kernel; with
the profiler recording the CUDA activity alone, and with the CPU activity
beside it. Prints, per function and setting, the reads that saw fewer
kernels than the most any read saw (their place among the reads, to show
whether losses come in bursts), those that saw none, and the median time
of the whole reads, then one JSON line.
"""

import argparse
import json
import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 30


def read(fn, activities):
    import torch
    from torch.profiler import profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return (sum(e.device_time_total for e in kernels) * 1e-3 / CALLS,
            len(kernels))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reads", type=int, default=100)
    args = parser.parse_args(argv)
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    sys.path.insert(0, ROOT)
    from embeddingnet_tpu_torch.ops import fused_conv as fc
    tool = runpy.run_path(os.path.join(ROOT, "tools",
                                       "fused_conv_epilogue_torch.py"))
    x, w, scale, bias = tool["inputs"](1024, torch.device("cuda"))
    w_lib = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    xl = x.permute(0, 3, 1, 2)
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(1024, 8, 8, 128)).astype(
        np.float32)).cuda().bfloat16()
    wd = torch.from_numpy(rng.normal(size=(3, 3, 128, 128)).astype(
        np.float32) * 0.05).cuda().bfloat16()
    y = torch.ones(1 << 24, device="cuda")
    fns = {"dgrad": lambda: fc.conv3x3_dgrad(g, wd),
           "conv2d": lambda: F.conv2d(xl, w_lib, padding=1),
           "eager_sequence": tool["library_path"](x, w, scale, bias),
           "mul": lambda: y.mul(2.0)}
    settings = {"cuda": [ProfilerActivity.CUDA],
                "cpu+cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    out = {"device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "reads": args.reads, "rows": []}
    for label, activities in settings.items():
        for name, fn in fns.items():
            reads = [read(fn, activities) for _ in range(args.reads)]
            full = max(n for _, n in reads)
            whole = sorted(t for t, n in reads if n == full)
            row = {"activities": label, "fn": name, "kernels": full,
                   "short_reads": [(i, n) for i, (_, n) in enumerate(reads)
                                   if n < full],
                   "empty_reads": sum(n == 0 for _, n in reads),
                   "ms_median": whole[len(whole) // 2]}
            out["rows"].append(row)
            print(row, flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
