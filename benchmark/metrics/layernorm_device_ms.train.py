"""Device time per step of the kernels launched inside the ViT's ``ln``
ranges (each LayerNorm's forward, a remat recompute's again; the backward
runs in autograd, outside the ranges), in the host-traced reads."""


def read(rec):
    prof = rec.get("profile")
    if rec["kind"] != "train" or not prof:
        return None
    s = prof["range_device_s"].get("ln", 0.0)
    return s / prof["units"] * 1e3 if s > 0 else None
