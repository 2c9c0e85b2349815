"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``embeddingnet_tpu_torch`` begins with
``embeddingnet_tpu``); the plain reference imports nothing of the
program."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

BENCH = ROOT / "benchmark"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "." * node.level + (node.module or "")
            else:
                yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    ROOT)))
def test_no_source_imports_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert not name.startswith("."), name
        assert name.split(".")[0] != "embeddingnet_tpu_torch", name
        if name.startswith("benchmark"):
            assert name.startswith("benchmark.reference"), name


def test_a_run_loads_no_jax_module():
    """Import what a run imports (the harness, every driver and reader and
    the program's modules they call) in a fresh process, where JAX is
    installed, and look at ``sys.modules``."""
    probe = (
        "import sys, json; sys.path.insert(0, '.')\n"
        "import benchmark.run\n"
        "from benchmark import harness, trace, flops, data\n"
        "spec = harness.load_spec()\n"
        "for w in spec['workloads']:\n"
        "    c = harness.Cell(w['name']); harness.driver(c.traffic['driver'])\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "import embeddingnet_tpu_torch.config\n"
        "import embeddingnet_tpu_torch.train.loop\n"
        "import embeddingnet_tpu_torch.data.index\n"
        "import embeddingnet_tpu_torch.models.api\n"
        "import benchmark.control\n"
        "print(json.dumps(harness.forbidden_loaded()))\n")
    got = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert json.loads(got.stdout.strip().splitlines()[-1]) == []


def test_the_check_names_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "embeddingnet_tpu_torch_extra",
                        sys.modules[__name__])
    assert "embeddingnet_tpu_torch_extra" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules[__name__])
    assert "jax.numpy" in harness.forbidden_loaded()
