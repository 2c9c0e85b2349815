"""The fit loop's wait for batches: the Trainer's own ``_data_wait_s`` (the
host's seconds blocked on the next batch: decode, pinning, the copy's
launch) summed over the window's epochs, over their wall time, in %."""

from benchmark.metrics._epochs import unprofiled


def read(rec):
    if rec["kind"] != "train" or not rec["epochs"]:
        return None
    epochs = unprofiled(rec)
    return 100.0 * sum(e["data_wait_s"] for e in epochs) / sum(
        e["wall_s"] for e in epochs)
