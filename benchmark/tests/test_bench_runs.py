"""Whole runs of the drivers on the CPU at tiny sizes (the card's look
skipped): the result line's keys, and ``correct`` false with a fault
planted in the timed path and with the control (the reference in fp8) in
the program's place. The card's case runs ``benchmark/run.py`` itself."""

import json
import subprocess
import sys
import time
import warnings

import pytest
import torch

from benchmark import harness, run
from benchmark.reference.precision import Quant
from benchmark.tests import _tiny
from benchmark.tests.conftest import ROOT

FAKE_DEVICE = {"platform": "gpu", "kind": "none", "count": 1,
               "memory_peak_bytes": 0}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    warnings.simplefilter("ignore", UserWarning)
    yield
    torch.set_num_threads(n)


def _run(cell, fault=None, seconds=0.5):
    drv = harness.driver(cell.traffic["driver"])
    return drv.run(cell, seed=2 ** 31 + 77, seconds=seconds, trace=False,
                   device="cpu", t_start=time.perf_counter(), fault=fault)


def test_train_result_line():
    cell = _tiny.train_cell("resnet50-train-warm", compute_dtype="float32")
    result = run.build_result(cell, _run(cell), False, FAKE_DEVICE)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert set(result["metrics"]) == {"train_images_per_s", "setup_s"}
    assert result["attempted"] >= 4 and result["failed"] == 0
    assert set(result["checks"]) == set(cell.limits["limits"])
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("name,fault", [
    ("resnet50-train-warm", "unchanged"), ("resnet50-train-warm", "half"),
    ("effb3-train-warm", "half")])
def test_a_broken_train_step_is_not_correct(name, fault):
    cell = _tiny.train_cell(name, compute_dtype="float32")
    out = _run(cell, fault=fault)
    assert not all(c["ok"] for c in out["checks"]), out["numbers"]


@pytest.mark.parametrize("name", ["resnet50-train-warm", "effb3-train-warm"])
def test_the_fp8_control_is_not_correct(name):
    from benchmark.drivers import train_epochs as te
    cell = _tiny.train_cell(name, size=64)
    r = te.Run(cell, 5, "cpu")
    try:
        r.warm()
        r.release()
        ref = r.reference_readings()
        numbers = te.compare(r.reference_readings(quant=Quant()), ref,
                             r.initial_params())
    finally:
        r.close()
    checks = harness.check_numbers(numbers, cell.limits["limits"])
    assert not all(c["ok"] for c in checks), numbers


@pytest.mark.cuda
def test_a_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "resnet50-train-warm", "--seed", str(2 ** 31 + 5), "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert got.returncode == 0, got.stderr[-2000:]
    assert json.loads(got.stdout.strip().splitlines()[-1])["correct"]
