"""Device time per step of the kernels launched inside the ViT's ``attn``
ranges (the attention core: the q scaling, the scores, the softmax and the
value product, the projections outside; a remat recompute's forward
inside again, the backward in autograd, outside), in the host-traced
reads."""


def read(rec):
    prof = rec.get("profile")
    if rec["kind"] != "train" or not prof:
        return None
    s = prof["range_device_s"].get("attn", 0.0)
    return s / prof["units"] * 1e3 if s > 0 else None
