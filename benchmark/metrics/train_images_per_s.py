"""Training throughput: every image trained in the window's whole epochs
over the window's whole wall time (the epochs end on a read of the loss, so
the device has finished)."""


def read(rec):
    if rec["kind"] != "train" or not rec["epochs"]:
        return None
    return rec["images"] / rec["window_s"]
