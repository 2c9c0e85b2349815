"""Share of the profiled steps' wall time in which no kernel, copy or
memset ran on the card (the union of the device's intervals; user
annotations excluded), in %, from the stretches that trace the card alone
(tracing the host's operations too would slow the host and lengthen the
idle time it measures)."""


def read(rec):
    prof = rec.get("profile_device")
    if rec["kind"] != "train" or not prof:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
