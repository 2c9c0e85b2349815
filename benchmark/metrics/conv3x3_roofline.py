"""The port's 3x3 conv kernels (K1 as the dgrad, K2, K3, K4 of
``csrc/conv3x3_sm90.cu``) against their roofline, in the profiled steps:
the least time of every launch (the larger of its operations at the bf16
peak and its bytes at the memory peak, ``benchmark/flops.py``) summed, over
the kernels' summed device time, part sums included, in %. The launches are
the benchmark's plan of the step; a read whose launch counters disagree
with the plan is not taken."""

from collections import Counter

from benchmark import flops


def read(rec):
    prof = rec.get("profile")
    plan = rec.get("conv3x3_launches")
    if rec["kind"] != "train" or not prof or not plan:
        return None
    units = prof["units"]
    want = Counter(name for name, *_ in plan)
    got = {k: v for k, v in prof["launches"].items()
           if k in flops.CONV3X3_KERNELS and v}
    if got != {k: v * units for k, v in want.items()}:
        return None
    least = units * sum(flops.least_seconds(*flops.conv_cost(*launch))
                        for launch in plan)
    device = sum(s for name, s in prof["device_s_by_name"].items()
                 if any(sym in name for sym in flops.CONV3X3_SYMBOLS))
    return 100.0 * least / device if device > 0 else None
