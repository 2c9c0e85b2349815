"""The ViT's attention core against its roofline, in the host-traced
reads: the core's least time per call (``benchmark/vit_flops.py``: its two
products at the bf16 peak, or q, k and v read and the output written once
in bf16 at the memory peak, whichever is longer; the bound of a fused
kernel) times the calls the program counted (``vit.LAUNCHES["attention"]``'s
rise over the read, a remat recompute included), over the device time of
the kernels inside the ``attn`` ranges (forwards only: the backward runs in
autograd, outside them), in %."""

from benchmark import flops, vit_flops


def read(rec):
    prof = rec.get("profile")
    shape = rec.get("attention_shape")
    if rec["kind"] != "train" or not prof or not shape:
        return None
    calls = prof["launches"].get("attention", 0)
    device = prof["range_device_s"].get("attn", 0.0)
    if not calls or device <= 0:
        return None
    least = flops.least_seconds(*vit_flops.attention_cost(*shape))
    return 100.0 * least * calls / device
