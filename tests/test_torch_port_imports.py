"""The port runs where neither JAX nor the JAX package's host dependencies
are installed: in a fresh interpreter with ``jax``, ``flax``, ``optax``,
``yaml``, ``cv2``, ``sklearn`` and ``triton`` blocked, every module of the
port imports, and a small CPU encode plus kNN vote, the HTTP server's
``/healthz`` and a small CPU triplet train step run. No file of the port
imports the JAX package, not even inside a function."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "embeddingnet_tpu_torch",
    "embeddingnet_tpu_torch.config",
    "embeddingnet_tpu_torch.data",
    "embeddingnet_tpu_torch.data.images",
    "embeddingnet_tpu_torch.data.samplers",
    "embeddingnet_tpu_torch.ops.distances",
    "embeddingnet_tpu_torch.ops.mining",
    "embeddingnet_tpu_torch.ops.preprocess",
    "embeddingnet_tpu_torch.ops.knn",
    "embeddingnet_tpu_torch.ops._cuda",
    "embeddingnet_tpu_torch.ops.fused_conv",
    "embeddingnet_tpu_torch.models.heads",
    "embeddingnet_tpu_torch.models.resnet",
    "embeddingnet_tpu_torch.models.registry",
    "embeddingnet_tpu_torch.models.convert",
    "embeddingnet_tpu_torch.models.api",
    "embeddingnet_tpu_torch.serving",
    "embeddingnet_tpu_torch.train",
    "embeddingnet_tpu_torch.train.optim",
    "embeddingnet_tpu_torch.train.state",
    "embeddingnet_tpu_torch.train.steps",
]

SCRIPT = f"""
import importlib, sys
for name in ("jax", "flax", "optax", "yaml", "cv2", "sklearn", "triton"):
    sys.modules[name] = None          # import of it raises ImportError
for name in {MODULES!r}:
    importlib.import_module(name)
assert not any(m == "embeddingnet_tpu" or m.startswith("embeddingnet_tpu.")
               for m in sys.modules), "the JAX package was imported"

import numpy as np, torch
from embeddingnet_tpu_torch.models.api import EmbeddingNet
from embeddingnet_tpu_torch.ops.knn import knn_classify
params = {{"model": {{"backbone_name": "resnet18", "encodings_len": 16,
                      "embeddings_normalization": True,
                      "input_shape": [32, 32, 3]}},
          "general": {{"seed": 3}}, "encodings": {{"knn_k": 3}}}}
net = EmbeddingNet(params, device="cpu", fast_conv=True)
imgs = np.random.default_rng(0).integers(0, 255, (6, 32, 32, 3), np.uint8)
emb = net.encode(imgs)
assert emb.shape == (6, 16) and np.isfinite(emb).all()
pred, idx = knn_classify(torch.from_numpy(emb), torch.arange(6),
                         torch.from_numpy(emb), k=1, n_classes=6)
assert pred.tolist() == list(range(6)), pred

# the HTTP server, the port's own copy
import json, threading, urllib.request
from embeddingnet_tpu_torch.serving import InferenceEngine, make_server
net.encoded_training_data = {{
    "paths": [str(i) for i in range(6)],
    "labels": [f"class_{{i}}" for i in range(6)], "encodings": emb}}
engine = InferenceEngine(net, max_batch=2)
server = make_server(engine, "127.0.0.1", 0)
threading.Thread(target=server.serve_forever, daemon=True).start()
try:
    assert engine.ready.wait(120)
    url = f"http://127.0.0.1:{{server.server_address[1]}}/healthz"
    with urllib.request.urlopen(url, timeout=60) as r:
        health = json.loads(r.read())
finally:
    server.shutdown()
    server.server_close()
    engine.close()
assert health["ready"] and health["db_size"] == 6, health

# the config, without PyYAML
from embeddingnet_tpu_torch.config import params_from_dict
cfg = params_from_dict({{"MODEL": {{"backbone_name": "resnet18",
                                    "input_shape": [32, 32, 3]}}}})
assert cfg.model.backbone_name == "resnet18"

# a triplet train step on the CPU, the kernels' plain versions
from embeddingnet_tpu_torch.models.registry import EmbeddingModule
from embeddingnet_tpu_torch.train.optim import get_optimizer
from embeddingnet_tpu_torch.train.state import TrainState
from embeddingnet_tpu_torch.train.steps import make_triplet_train_step
module = EmbeddingModule("resnet18", encodings_len=16, fast_conv=True)
spec = get_optimizer("adam", 1e-3)
state = TrainState.create(module, spec)
step = make_triplet_train_step(module, spec, mode="batch_all",
                               max_positives=3)
labels = torch.arange(2).repeat_interleave(4)
state, metrics = step(state, torch.from_numpy(imgs[np.arange(8) % 6]),
                      labels)
assert state.step == 1 and torch.isfinite(metrics["loss"])
assert int(metrics["n_triplets"]) > 0
print("ok")
"""


def test_slice_imports_without_jax_and_host_deps():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


# An import of the JAX package, at the top of a file or inside a function.
_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from\s+embeddingnet_tpu(\.|\s+import\b)|"
    r"import\s+embeddingnet_tpu(\.|\s*$|\s*,|\s+as\b))", re.M)


def test_port_files_never_import_the_jax_package():
    """Static: no file of the port, nor ``chip_smoke.py`` or
    ``tools/serve_torch.py``, imports ``embeddingnet_tpu`` (a lazy import
    inside a function would escape the run above)."""
    root = Path(ROOT)
    files = sorted((root / "embeddingnet_tpu_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", root / "tools" / "serve_torch.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(root)) for f in files
                 if _JAX_PACKAGE_IMPORT.search(f.read_text())]
    assert not offenders, offenders
    # the pattern does catch such imports
    for line in ("from embeddingnet_tpu.config import parse_params",
                 "    import embeddingnet_tpu.serving",
                 "from embeddingnet_tpu import ops", "import embeddingnet_tpu"):
        assert _JAX_PACKAGE_IMPORT.search(line), line
    assert not _JAX_PACKAGE_IMPORT.search(
        "from embeddingnet_tpu_torch.config import parse_params")
