"""A later change adds a cell as data: one new traffic file, its limits
file and a ``BENCHMARK.json`` entry, and edits no file the benchmark
already has."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root / "benchmark"):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_is_data_only(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    os.symlink(ROOT / "embeddingnet_tpu_torch",
               tmp_path / "embeddingnet_tpu_torch")
    before = _digests(tmp_path)

    traffic = json.loads((tmp_path / "benchmark/traffic/"
                          "train-warm-cache.json").read_text())
    traffic["why"] = "shorter epochs, a smaller class count"
    traffic["params"]["per_class"] = 12
    (tmp_path / "benchmark/traffic/train-short.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/limits/resnet50-train-short.json").write_text(
        (tmp_path / "benchmark/limits/resnet50-train-warm.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({
        "name": "resnet50-train-short", "config": "resnet50-batchall-64",
        "traffic": "train-short", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "resnet50-train-warm" in m.get("workloads", []):
            m["workloads"].append("resnet50-train-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    probe = (
        "import sys, json; sys.path.insert(0, '.')\n"
        "from benchmark import harness\n"
        "c = harness.Cell('resnet50-train-short')\n"
        "d = harness.driver(c.traffic['driver'])\n"
        "print(json.dumps([c.traffic['params']['per_class'], d.__name__,\n"
        "  [m['name'] for m in c.end_to_end()], len(c.per_layer()),\n"
        "  str(harness.ROOT)]))\n")
    got = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, check=True)
    per_class, driver, e2e, n_layer, root = json.loads(got.stdout)
    assert per_class == 12 and driver.endswith("train_epochs")
    assert set(e2e) == {"train_images_per_s", "setup_s"} and n_layer == 6
    assert root == str(tmp_path)
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "benchmark/traffic/train-short.json",
        "benchmark/limits/resnet50-train-short.json"}


def test_a_bare_checkout_of_the_benchmark_refuses_to_run(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's files
    holds no program: the run exits non-zero and prints no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    got = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "resnet50-train-warm", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert got.returncode != 0 and got.stdout == ""
