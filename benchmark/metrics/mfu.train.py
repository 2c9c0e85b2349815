"""The training step's share of the card's peak: the model's operations
(three forwards of every conv and dense layer, ``benchmark/flops.py``) of
every image trained, over the wall time, over the dense bf16 peak of an
H100 SXM (989 TFLOP/s), in %."""

from benchmark import flops
from benchmark.metrics._epochs import unprofiled


def read(rec):
    if rec["kind"] != "train" or not rec["epochs"]:
        return None
    epochs = unprofiled(rec)
    ops = rec["flops_per_image"] * sum(e["images"] for e in epochs)
    seconds = sum(e["wall_s"] for e in epochs)
    return 100.0 * ops / seconds / flops.PEAK_BF16_FLOPS
