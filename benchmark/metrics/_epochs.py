"""The window's epochs that a per-layer reading of the host's clock uses:
those in which the profiler did not run, when there are any."""


def unprofiled(rec):
    plain = [e for e in rec["epochs"] if not e.get("profiled")]
    return plain or rec["epochs"]
