"""The port runs where neither JAX nor the JAX package's host dependencies
are installed: in a fresh interpreter with ``jax``, ``flax``, ``yaml``,
``cv2`` and ``sklearn`` blocked, every slice module imports and a small
CPU encode plus kNN vote runs."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "embeddingnet_tpu_torch",
    "embeddingnet_tpu_torch.ops.distances",
    "embeddingnet_tpu_torch.ops.knn",
    "embeddingnet_tpu_torch.ops._cuda",
    "embeddingnet_tpu_torch.ops.fused_conv",
    "embeddingnet_tpu_torch.models.heads",
    "embeddingnet_tpu_torch.models.resnet",
    "embeddingnet_tpu_torch.models.registry",
    "embeddingnet_tpu_torch.models.convert",
    "embeddingnet_tpu_torch.models.api",
    "embeddingnet_tpu_torch.serving",
]

SCRIPT = f"""
import importlib, sys
for name in ("jax", "flax", "yaml", "cv2", "sklearn"):
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
print("ok")
"""


def test_slice_imports_without_jax_and_host_deps():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
