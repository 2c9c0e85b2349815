"""Device time per step of the kernels launched inside the step's
``record_function("mining")`` range (the miner's forward; its backward runs
in autograd, outside the range), in the profiled steps."""


def read(rec):
    prof = rec.get("profile")
    if rec["kind"] != "train" or not prof:
        return None
    s = prof["range_device_s"].get("mining", 0.0)
    return s / prof["units"] * 1e3 if s > 0 else None
