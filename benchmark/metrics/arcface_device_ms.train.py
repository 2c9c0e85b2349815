"""Device time per step of the kernels launched inside the ArcFace step's
``arcface`` range (the loss's forward: the normalisations, the cosine
product, the margin and the cross-entropy; its backward runs in autograd,
outside the range), in the host-traced reads."""


def read(rec):
    prof = rec.get("profile")
    if rec["kind"] != "train" or not prof:
        return None
    s = prof["range_device_s"].get("arcface", 0.0)
    return s / prof["units"] * 1e3 if s > 0 else None
