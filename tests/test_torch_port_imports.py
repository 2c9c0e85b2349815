"""The port runs where neither JAX nor the JAX package's host dependencies
are installed: in a fresh interpreter with ``jax``, ``flax``, ``optax``,
``orbax``, ``yaml``, ``cv2``, ``sklearn``, ``pandas``, ``matplotlib``,
``triton``, ``msgpack`` and ``tensorflow`` blocked, every module of the
port imports, and a small CPU
encode plus kNN vote, the HTTP server's ``/healthz``, the dataset index of
a folder and of a CSV, a small CPU triplet train step with the ``default``
augmentation, a ViT encode and an ArcFace step, an encode on each
EfficientNet/MobileNet/simple backbone, a ``simple2`` step with its Dropout
and a ``.pt2`` export, a NASNet loaded from a weights preset by
``get_backbone`` and ``tools/convert_weights_torch.py``'s refusal of a
Keras source, the T1 A/B tool run, and an encode and a
data-parallel step (remat on) in a world-1 gloo group; with cv2 allowed (it
decodes), a ``Trainer`` fits one epoch on the CPU and ``encode_dataset``
equals ``encode``, and so do a siamese ``Trainer``
(radam) and a triplet one whose warm-up switches its mining mode, after
every mining mode ran on each of its paths and rms_prop took a step. No
file of the port (its package, ``chip_smoke.py``,
``examples/quickstart_torch.py``, every ``tools/*_torch.py``) imports the
JAX package, JAX, Flax, msgpack or TensorFlow, not even inside a function,
nor do the parallel tests' worker modules (a spawned rank imports
them)."""

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
    "embeddingnet_tpu_torch.data.index",
    "embeddingnet_tpu_torch.data.images",
    "embeddingnet_tpu_torch.data.samplers",
    "embeddingnet_tpu_torch.data.pipeline",
    "embeddingnet_tpu_torch.data.native_loader",
    "embeddingnet_tpu_torch.ops.augment",
    "embeddingnet_tpu_torch.ops.distances",
    "embeddingnet_tpu_torch.ops.mining",
    "embeddingnet_tpu_torch.ops.preprocess",
    "embeddingnet_tpu_torch.ops.knn",
    "embeddingnet_tpu_torch.ops.losses",
    "embeddingnet_tpu_torch.ops._cuda",
    "embeddingnet_tpu_torch.ops.batchnorm_context",
    "embeddingnet_tpu_torch.ops.fused_conv",
    "embeddingnet_tpu_torch.models.heads",
    "embeddingnet_tpu_torch.models.resnet",
    "embeddingnet_tpu_torch.models.stochastic",
    "embeddingnet_tpu_torch.models.efficientnet",
    "embeddingnet_tpu_torch.models.mobilenet",
    "embeddingnet_tpu_torch.models.simple",
    "embeddingnet_tpu_torch.models.vit",
    "embeddingnet_tpu_torch.models.compact",
    "embeddingnet_tpu_torch.models.vgg",
    "embeddingnet_tpu_torch.models.densenet",
    "embeddingnet_tpu_torch.models.xception",
    "embeddingnet_tpu_torch.models.inception",
    "embeddingnet_tpu_torch.models.nasnet",
    "embeddingnet_tpu_torch.models.pretrained",
    "embeddingnet_tpu_torch.models.registry",
    "embeddingnet_tpu_torch.models.remat",
    "embeddingnet_tpu_torch.models.convert",
    "embeddingnet_tpu_torch.models.api",
    "embeddingnet_tpu_torch.parallel",
    "embeddingnet_tpu_torch.parallel.mesh",
    "embeddingnet_tpu_torch.parallel.collectives",
    "embeddingnet_tpu_torch.parallel.sharded",
    "embeddingnet_tpu_torch.parallel.sharded_knn",
    "embeddingnet_tpu_torch.parallel.tp",
    "embeddingnet_tpu_torch.parallel.pp",
    "embeddingnet_tpu_torch.serving",
    "embeddingnet_tpu_torch.train",
    "embeddingnet_tpu_torch.train.optim",
    "embeddingnet_tpu_torch.train.state",
    "embeddingnet_tpu_torch.train.steps",
    "embeddingnet_tpu_torch.train.callbacks",
    "embeddingnet_tpu_torch.train.checkpoint",
    "embeddingnet_tpu_torch.train.loop",
    "embeddingnet_tpu_torch.utils",
    "embeddingnet_tpu_torch.utils.logging",
    "embeddingnet_tpu_torch.utils.tb_writer",
    "embeddingnet_tpu_torch.utils.viz",
]

SCRIPT = f"""
import importlib, sys
for name in ("jax", "flax", "optax", "orbax", "yaml", "cv2", "sklearn",
             "pandas", "matplotlib", "triton", "msgpack", "tensorflow"):
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
import json, os, threading, urllib.request
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

# the dataset index, without sklearn and pandas: a folder and a CSV
import tempfile
from embeddingnet_tpu_torch.data import ENDataLoader
with tempfile.TemporaryDirectory() as tmp:
    rows = []
    for c in range(3):
        os.makedirs(f"{{tmp}}/images/class_{{c}}")
        for i in range(5):
            open(f"{{tmp}}/images/class_{{c}}/{{i}}.png", "wb").close()
            rows.append(f"class_{{c}}/{{i}}.png,{{c}}")
    folder = ENDataLoader(f"{{tmp}}/images", val_ratio=0.2)
    assert folder.n_samples == {{f"class_{{c}}": 5 for c in range(3)}}
    assert [len(v) for v in folder.val_data.values()] == [1, 1, 1]
    with open(f"{{tmp}}/train.csv", "w") as f:
        f.write("image_id,label\\n" + "\\n".join(rows) + "\\n")
    table = ENDataLoader(f"{{tmp}}/images", train_csv_file=f"{{tmp}}/train.csv",
                         val_ratio=0.2, cache_dir=f"{{tmp}}/cache")
    assert sorted(table.flat("val")[0]) == sorted(folder.flat("val")[0])

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
from embeddingnet_tpu_torch.ops.augment import get_aug
step = make_triplet_train_step(module, spec, mode="batch_all",
                               max_positives=3, augment_fn=get_aug("default"))
labels = torch.arange(2).repeat_interleave(4)
state, metrics = step(state, torch.from_numpy(imgs[np.arange(8) % 6]),
                      labels)
assert state.step == 1 and torch.isfinite(metrics["loss"])
assert int(metrics["n_triplets"]) > 0

# a small ViT: an arcface encode (unit norm) and one ArcFace step
from embeddingnet_tpu_torch.models import vit
from embeddingnet_tpu_torch.models.registry import ArcFaceModule
from embeddingnet_tpu_torch.train.steps import make_arcface_train_step
vit._VARIANTS["vit-b16"] = dict(patch=8, dim=32, depth=2, heads=4)
vparams = {{"model": {{"backbone_name": "vit-b16", "encodings_len": 16,
                       "embeddings_normalization": False, "mode": "arcface",
                       "input_shape": [32, 32, 3]}}, "general": {{"seed": 3}}}}
vemb = EmbeddingNet(vparams, device="cpu").encode(imgs)
assert vemb.shape == (6, 16)
norms = np.linalg.norm(vemb, axis=1)      # 0 where the ReLU zeroed a row
assert (norms > 0).any() and np.allclose(norms[norms > 0], 1.0, atol=1e-5)
arc = ArcFaceModule("vit-b16", encodings_len=16, n_classes=3,
                    input_shape=(32, 32, 3))
arc.reset_parameters(torch.Generator().manual_seed(0))
aspec = get_optimizer("adamw", 1e-3)
astate = TrainState.create(arc, aspec)
astep = make_arcface_train_step(arc, aspec, n_classes=3,
                                augment_fn=get_aug("deepfake"))
astate, ametrics = astep(astate, torch.from_numpy(imgs),
                         torch.arange(6) % 3)
assert astate.step == 1 and torch.isfinite(ametrics["loss"])

# the depthwise family and the simple CNNs: an encode each, a simple2
# train step (its Dropout drawn from the state's generator) and the .pt2
from embeddingnet_tpu_torch.models.registry import list_backbones
for name, size in (("efficientnet-b0", 32), ("mobilenet", 32),
                   ("mobilenetv2", 32), ("simple", 72), ("simple2", 32)):
    assert name in list_backbones()
    sparams = {{"model": {{"backbone_name": name, "encodings_len": 8,
                           "embeddings_normalization": True,
                           "input_shape": [size, size, 3]}},
               "general": {{"seed": 3}}}}
    snet = EmbeddingNet(sparams, device="cpu")
    semb = snet.encode(np.zeros((2, size, size, 3), np.uint8))
    assert semb.shape == (2, 8) and np.isfinite(semb).all(), name
s2 = EmbeddingModule("simple2", encodings_len=8, input_shape=(32, 32, 3))
s2.reset_parameters(torch.Generator().manual_seed(0))
sspec = get_optimizer("sgd", 1e-2)
sstate = TrainState.create(s2, sspec)
sstep = make_triplet_train_step(s2, sspec, mode="batch_hard",
                                reg_rules=(("conv_1.*kernel", 1e-3),))
before = sstate.generator.get_state()
sstate, smetrics = sstep(sstate, torch.from_numpy(
    np.random.default_rng(1).integers(0, 255, (4, 32, 32, 3), np.uint8)),
    torch.tensor([0, 0, 1, 1]))
assert torch.isfinite(smetrics["loss"])
assert not torch.equal(before, sstate.generator.get_state())
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    program = torch.export.load(snet.save_exported(tmp)).module()
    assert program(torch.zeros(1, 32, 32, 3)).shape == (1, 8)

# a world-1 gloo group: an encode, and a data-parallel step (remat on)
# equal to the one-process step
import copy, tempfile
import torch.distributed as dist
from embeddingnet_tpu_torch.parallel.collectives import DataParallel
with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("gloo", init_method=f"file://{{tmp}}/store",
                            rank=0, world_size=1)
    try:
        assert net.encode(imgs).shape == (6, 16)
        outs = []
        for dp in (DataParallel.current(), None):
            m = EmbeddingModule("resnet18", encodings_len=16)
            m.reset_parameters(torch.Generator().manual_seed(0))
            sp = get_optimizer("sgd", 1e-2)
            st = TrainState.create(m, sp)
            stp = make_triplet_train_step(m, sp, mode="batch_all",
                                          max_positives=3, remat=True,
                                          parallel=dp)
            _, met = stp(st, torch.from_numpy(imgs[np.arange(8) % 6]),
                         labels)
            outs.append(met["loss"])
        torch.testing.assert_close(outs[0], outs[1])
    finally:
        dist.destroy_process_group()

# the zoo: a weights file of the port's written, converted by the tool,
# and loaded through get_backbone's preset lookup on a zoo backbone
import os, runpy, tempfile
from embeddingnet_tpu_torch.models import pretrained
from embeddingnet_tpu_torch.models.registry import get_backbone
with tempfile.TemporaryDirectory() as tmp:
    zoo = EmbeddingModule("nasnetmobile", encodings_len=8)
    zoo.reset_parameters(torch.Generator().manual_seed(1))
    np.savez(f"{{tmp}}/nasnetmobile_imagenet.npz",
             **pretrained.flatten_params(zoo))
    os.environ[pretrained.WEIGHTS_DIR_ENV] = tmp
    loaded, _ = get_backbone((32, 32, 3), encodings_len=8,
                             backbone_name="nasnetmobile",
                             backbone_weights="imagenet", device="cpu")
    assert torch.equal(loaded.backbone.stem_conv1.weight,
                       zoo.backbone.stem_conv1.weight)
    zemb = loaded.eval()(torch.rand(2, 33, 33, 3))
    assert zemb.shape == (2, 8) and torch.isfinite(zemb).all()
    tool = runpy.run_path("tools/convert_weights_torch.py")
    try:
        tool["main"](["--backbone", "resnet18", "--source", "keras",
                      "--input", f"{{tmp}}/model.h5", "--out", tmp])
    except SystemExit as e:
        assert "convert_weights.py" in str(e)
    else:
        raise AssertionError("--source keras ran without TensorFlow")

# the T1 A/B tool, plain version
import os, runpy
os.environ["FC_BATCH"] = "2"
tool = runpy.run_path("tools/fused_conv_epilogue_torch.py")
assert tool["main"](["--device", "cpu"])["max_abs_err"] == 0.0
assert not any(m == "embeddingnet_tpu" or m.startswith("embeddingnet_tpu.")
               for m in sys.modules), "the JAX package was imported"
print("ok")
"""


TRAINER_SCRIPT = """
import sys
for name in ("jax", "flax", "optax", "orbax", "sklearn", "pandas",
             "matplotlib"):
    sys.modules[name] = None          # import of it raises ImportError
import os, tempfile
import cv2, numpy as np, torch
torch.set_num_threads(1)     # small ops; the suite runs files in parallel
from embeddingnet_tpu_torch.config import params_from_dict
from embeddingnet_tpu_torch.data import ENDataLoader
from embeddingnet_tpu_torch.train.loop import Trainer
with tempfile.TemporaryDirectory() as tmp:
    rng = np.random.default_rng(0)
    for c in range(4):
        os.makedirs(f"{tmp}/data/class_{c}")
        for i in range(6):
            cv2.imwrite(f"{tmp}/data/class_{c}/{i}.png",
                        rng.integers(0, 256, (16, 16, 3), np.uint8))
    params = params_from_dict({
        "MODEL": {"backbone_name": "resnet18", "input_shape": [32, 32, 3],
                  "encodings_len": 16, "backbone_weights": None},
        "DATALOADER": {"dataset_path": f"{tmp}/data", "val_ratio": 0.2},
        "GENERATOR": {"negatives_selection_mode": "batch_all",
                      "k_classes": 2, "k_samples": 3, "batch_size": 4,
                      "n_batches": 2, "n_batches_val": 1},
        "TRAIN": {"n_epochs": 1, "eval_recall_every": 1},
        "GENERAL": {"work_dir": f"{tmp}/work", "tensorboard_callback": True},
        "PERFORMANCE": {"compute_dtype": "float32", "pallas_conv": True}})
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    history = Trainer(params, loader, device="cpu").fit().history
    assert set(history) >= {"loss", "val_loss", "val_recall1"}, history
    assert os.path.isdir(f"{tmp}/work/project/weights/0")
    # the bulk encode decodes as its loader resolves (the native decoder on
    # a host of several cores, else cv2)
    from embeddingnet_tpu_torch.data import native_loader
    from embeddingnet_tpu_torch.data.images import get_images
    from embeddingnet_tpu_torch.data.pipeline import BatchLoader
    from embeddingnet_tpu_torch.models.api import EmbeddingNet
    net = EmbeddingNet(params, device="cpu")
    paths = loader.flat("train")[0]
    bulk = net.encode_dataset(paths, batch_size=5)
    native = BatchLoader([], (32, 32, 3)).backend == "native"
    decoded = (native_loader.decode_batch(paths, 32, 32) if native
               else get_images(paths, (32, 32, 3)))
    assert np.allclose(bulk, net.encode(decoded), atol=1e-6)
assert not any(m == "embeddingnet_tpu" or m.startswith("embeddingnet_tpu.")
               for m in sys.modules), "the JAX package was imported"
print("ok")
"""


MODES_SCRIPT = """
import sys
for name in ("jax", "flax", "optax", "orbax", "sklearn", "pandas",
             "matplotlib"):
    sys.modules[name] = None          # import of it raises ImportError
import os, tempfile
import cv2, numpy as np, torch
torch.set_num_threads(1)     # small ops; the suite runs files in parallel
from embeddingnet_tpu_torch.ops import mining
from embeddingnet_tpu_torch.train import optim

# every mining mode on each of its paths, draws from a generator
g = torch.Generator().manual_seed(0)
for b, k in ((32, 4), (264, 4), (264, None)):
    emb = torch.randn(b, 8, generator=g, requires_grad=True)
    labels = torch.arange(b // 4).repeat_interleave(4)
    for mode in mining.ALL_MODES:
        loss, stats = mining.mined_triplet_loss(
            emb, labels, margin=0.5, mode=mode, rng=g,
            max_positives=None if k is None else k - 1)
        loss.backward()
        assert torch.isfinite(loss) and torch.isfinite(emb.grad).all()
p = torch.nn.Parameter(torch.ones(3))
opt = optim.get_optimizer("rms_prop", 0.1).build([p])
p.grad = torch.ones(3)
opt.step()
assert (p < 1).all()

from embeddingnet_tpu_torch.config import params_from_dict
from embeddingnet_tpu_torch.data import ENDataLoader
from embeddingnet_tpu_torch.train.loop import Trainer
with tempfile.TemporaryDirectory() as tmp:
    rng = np.random.default_rng(0)
    for c in range(4):
        os.makedirs(f"{tmp}/data/class_{c}")
        for i in range(6):
            cv2.imwrite(f"{tmp}/data/class_{c}/{i}.png",
                        rng.integers(0, 256, (16, 16, 3), np.uint8))
    for mode, extra in (("siamese", {}),
                        ("triplet", {"mining_warmup_epochs": 1,
                                     "mining_warmup_mode": "random_hard"})):
        params = params_from_dict({
            "MODEL": {"backbone_name": "resnet18",
                      "input_shape": [32, 32, 3], "encodings_len": 16,
                      "backbone_weights": None, "mode": mode},
            "DATALOADER": {"dataset_path": f"{tmp}/data", "val_ratio": 0.2},
            "GENERATOR": {"negatives_selection_mode": "hardest",
                          "k_classes": 2, "k_samples": 3, "batch_size": 4,
                          "n_batches": 1, "n_batches_val": 1},
            "TRAIN": {"n_epochs": 2, "optimizer": "radam", **extra},
            "GENERAL": {"work_dir": f"{tmp}/{mode}"},
            "PERFORMANCE": {"compute_dtype": "float32",
                            "pallas_conv": True}})
        loader = ENDataLoader(**{k: params.dataloader[k]
                                 for k in params.dataloader.keys()})
        history = Trainer(params, loader, device="cpu",
                          log_fn=lambda *a: None).fit().history
        assert np.isfinite(history["loss"]).all() and "val_loss" in history
assert not any(m == "embeddingnet_tpu" or m.startswith("embeddingnet_tpu.")
               for m in sys.modules), "the JAX package was imported"
print("ok")
"""


def test_modes_run_without_jax_and_host_deps():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", MODES_SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_trainer_fits_without_jax_and_host_deps():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TRAINER_SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_slice_imports_without_jax_and_host_deps():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


# An import of JAX or Flax itself.
_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|msgpack|tensorflow)\b", re.M)
# An import of the JAX package, at the top of a file or inside a function.
_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from\s+embeddingnet_tpu(\.|\s+import\b)|"
    r"import\s+embeddingnet_tpu(\.|\s*$|\s*,|\s+as\b))", re.M)


def test_port_files_never_import_the_jax_package():
    """Static: no file of the port, nor ``chip_smoke.py``,
    ``examples/quickstart_torch.py`` or the port's tools (every
    ``tools/*_torch.py``), imports ``embeddingnet_tpu`` (a
    lazy import inside a function would
    escape the run above), and the T1 tool does not import the JAX tool
    it ports."""
    root = Path(ROOT)
    files = sorted((root / "embeddingnet_tpu_torch").rglob("*.py"))
    tools = sorted((root / "tools").glob("*_torch.py"))
    for cli in ("train_torch.py", "test_torch.py", "evaluate_torch.py",
                "serve_torch.py", "convert_weights_torch.py"):
        assert root / "tools" / cli in tools
    files += [root / "chip_smoke.py", root / "examples" /
              "quickstart_torch.py"] + tools
    for name in ("parallel/sharded.py", "parallel/tp.py", "parallel/pp.py",
                 "data/native_loader.py"):
        assert root / "embeddingnet_tpu_torch" / name in files
    # the worker modules of the data-, tensor- and pipeline-parallel tests,
    # which spawned ranks import
    files += [root / "tests" / "test_torch_port_ddp.py",
              root / "tests" / "_torch_port_spawn.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(root)) for f in files
                 if _JAX_PACKAGE_IMPORT.search(f.read_text())
                 or _JAX_IMPORT.search(f.read_text())]
    assert not offenders, offenders
    tool = (root / "tools" / "fused_conv_epilogue_torch.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|pallas_fused_conv)\b",
                         tool, re.M)
    # the pattern does catch such imports
    for line in ("from embeddingnet_tpu.config import parse_params",
                 "    import embeddingnet_tpu.serving",
                 "from embeddingnet_tpu import ops", "import embeddingnet_tpu"):
        assert _JAX_PACKAGE_IMPORT.search(line), line
    assert not _JAX_PACKAGE_IMPORT.search(
        "from embeddingnet_tpu_torch.config import parse_params")
    for line in ("import jax", "    from jax import numpy",
                 "import flax.linen as nn", "    import msgpack",
                 "import tensorflow as tf"):
        assert _JAX_IMPORT.search(line), line
    assert not _JAX_IMPORT.search("import jaxlib_free_module")
