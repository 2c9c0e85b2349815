"""The cell ``vit-b16-arcface-train`` on the CPU at a tiny size (a ViT of
width 32, depth 2, 4 heads, patch 8, at 32 px; the program's and the
reference's ViT-B/16 entries replaced alike): the result line, ``correct``
false with a fault planted in the timed path and with the fp8 control in
the program's place; the cell's readers on a CNN record; and the ViT's
operation counts."""

import json
import time
import warnings

import pytest
import torch

from benchmark import flops, harness, run, vit_flops
from benchmark.reference import vit_arcface as ref_vit
from benchmark.reference.precision import Quant
from benchmark.tests import _tiny

CELL = "vit-b16-arcface-train"
FAKE_DEVICE = {"platform": "gpu", "kind": "none", "count": 1,
               "memory_peak_bytes": 0}
NEW_METRICS = ("attention_device_ms.train", "attention_roofline",
               "layernorm_device_ms.train", "arcface_device_ms.train")


@pytest.fixture
def tiny(monkeypatch):
    from embeddingnet_tpu_torch.models import vit
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    warnings.simplefilter("ignore", UserWarning)
    monkeypatch.setitem(vit._VARIANTS, "vit-b16",
                        dict(patch=8, dim=32, depth=2, heads=4))
    monkeypatch.setitem(ref_vit.VARIANTS, "vit-b16",
                        ref_vit.Shape(patch=8, dim=32, depth=2, heads=4,
                                      mlp=128))
    yield _tiny.train_cell(CELL, compute_dtype="float32")
    torch.set_num_threads(n)


def _run(cell, fault=None):
    drv = harness.driver(cell.traffic["driver"])
    return drv.run(cell, seed=2 ** 31 + 77, seconds=0.5, trace=False,
                   device="cpu", t_start=time.perf_counter(), fault=fault)


def test_result_line(tiny):
    out = _run(tiny)
    result = run.build_result(tiny, out, False, FAKE_DEVICE)
    assert result["correct"], out["numbers"]
    assert set(result["metrics"]) == {"train_images_per_s", "setup_s"}
    assert result["attempted"] >= 4 and result["failed"] == 0
    assert set(result["checks"]) == set(tiny.limits["limits"]) == {
        "loss1_gap", "emb1_gap", "grad_gap_median", "change_gap",
        "change_gap_median"}
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_arcface_step_is_not_correct(tiny, fault):
    out = _run(tiny, fault=fault)
    assert not all(c["ok"] for c in out["checks"]), out["numbers"]


def test_the_fp8_control_is_not_correct(tiny):
    drv = harness.driver(tiny.traffic["driver"])
    r = drv.Run(tiny, 5, "cpu")
    try:
        r.warm()
        r.release()
        ref = r.reference_readings()
        numbers = drv.compare(r.reference_readings(quant=Quant()), ref,
                              r.initial_params())
    finally:
        r.close()
    checks = harness.check_numbers(numbers, tiny.limits["limits"])
    assert not all(c["ok"] for c in checks), numbers


def _cnn_record():
    """A traced CNN cell's record, as ``train_epochs`` writes it."""
    profile = {"units": 5, "launches": {"conv3x3_dgrad": 50},
               "range_device_s": {"augment": 0.02, "mining": 0.002}}
    return {"kind": "train", "profile": profile, "epochs": [],
            "flops_per_image": 1}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_the_new_readers_find_nothing_in_a_cnn_record(name):
    assert harness.reader(name).read(_cnn_record()) is None


def test_the_new_readers_on_a_vit_record():
    profile = {"units": 5, "launches": {"attention": 120, "layernorm": 245},
               "range_device_s": {"attn": 0.125, "ln": 0.06,
                                  "arcface": 0.001}}
    rec = {"kind": "train", "profile": profile,
           "attention_shape": [256, 197, 12, 64]}
    got = {m: harness.reader(m).read(rec) for m in NEW_METRICS}
    assert got["attention_device_ms.train"] == pytest.approx(25.0)
    assert got["layernorm_device_ms.train"] == pytest.approx(12.0)
    assert got["arcface_device_ms.train"] == pytest.approx(0.2)
    least = flops.least_seconds(*vit_flops.attention_cost(256, 197, 12, 64))
    assert got["attention_roofline"] == pytest.approx(
        100 * 120 * least / 0.125)


def test_vit_b16_counts():
    """ViT-B/16 at 224 px: the published 17.6 G multiply-adds a forward
    (its 1,000-way head aside); the attention core at B=256 is bound by its
    bytes, 92.5 us against 30.9 us of operations."""
    s = ref_vit.VARIANTS["vit-b16"]
    assert vit_flops.tokens(s, 224) == 197
    macs = vit_flops.forward_flops(s, 224, 512, 1024) / 2
    assert macs == pytest.approx(17.6e9, rel=0.01)
    assert vit_flops.train_flops(s, 224, 512, 1024) == \
        3 * vit_flops.forward_flops(s, 224, 512, 1024)
    ops, nbytes = vit_flops.attention_cost(256, 197, 12, 64)
    us = 1e6 * flops.least_seconds(ops, nbytes)
    assert ops / flops.PEAK_BF16_FLOPS * 1e6 == pytest.approx(30.86,
                                                              abs=0.01)
    assert us == nbytes / flops.PEAK_BYTES_PER_S * 1e6 == pytest.approx(
        92.49, abs=0.01)
