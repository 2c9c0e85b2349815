"""The port's inference remainder against the JAX package:
``EmbeddingNet.encode_dataset`` (the bulk encode: equal to ``encode`` of
the same cv2-decoded images, in order, over a ragged tail, and (0, D) for
no paths), ``train_embeddings_classifier`` with a numpy nearest-centroid
stand-in for an sklearn model (equal to JAX's on the same weights),
``save_exported``'s ``.pt2`` reloaded (equal to the module), and the
CLIs ``tools/test_torch.py`` and ``tools/evaluate_torch.py`` printing what
``tools/test.py`` and ``tools/evaluate.py`` print for the same weights.

Small sizes: ``simple2`` at 32 px, 16-d embeddings, a folder dataset of 6
classes x 10 PNGs; one torch thread (a module fixture). The JAX CLIs run
in one subprocess (their compile cache in a temp dir)."""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu.models import api as japi  # noqa: E402
from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.data.images import get_images  # noqa: E402
from embeddingnet_tpu_torch.models import efficientnet as efn  # noqa: E402
from embeddingnet_tpu_torch.models.api import EmbeddingNet  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa

from _torch_port import numpy_tree  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 16
ENC_TOL = 1e-6          # the same f32 encoder, batched differently
CLASSIFIER_TOL = 1e-5   # JAX's and the port's encoders, f32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_dataset(root, classes=6, per_class=10):
    """``tests/conftest.py``'s ``tiny_dataset``, for a module fixture."""
    import cv2
    rng = np.random.default_rng(0)
    for cls in range(classes):
        d = os.path.join(root, f"class_{cls}")
        os.makedirs(d)
        for i in range(per_class):
            base = np.zeros((16, 16, 3), np.uint8)
            base[..., cls % 3] = 40 * (cls + 1)
            noise = rng.integers(0, 40, size=(16, 16, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(d, f"img_{i}.png"),
                        np.clip(base.astype(int) + noise, 0, 255)
                        .astype(np.uint8))
    return root


def _sections(dataset, work_dir):
    return {
        "MODEL": {"backbone_name": "simple2", "input_shape": [32, 32, 3],
                  "encodings_len": D, "embeddings_normalization": True,
                  "backbone_weights": None},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.3},
        "ENCODINGS": {"knn_k": 3},
        "GENERAL": {"work_dir": work_dir, "seed": 7},
        "PERFORMANCE": {"compute_dtype": "float32"},
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A dataset, its config (a YAML file and the parsed params of both
    packages), a JAX ``EmbeddingNet`` and a port one holding the same
    weights, and each one's base model and encodings DB on disk."""
    import yaml
    from embeddingnet_tpu.config import parse_params as jparse
    from embeddingnet_tpu_torch.config import parse_params

    tmp = tmp_path_factory.mktemp("inference")
    dataset = _write_dataset(str(tmp / "dataset"))
    config = tmp / "config.yml"
    config.write_text(yaml.safe_dump(_sections(dataset, str(tmp / "work"))))
    jnet = japi.EmbeddingNet(jparse(str(config)))
    params = parse_params(str(config))
    net = EmbeddingNet(params, device="cpu")
    net.load_encoder_state(flax_to_torch(numpy_tree(jnet.variables),
                                         net.module))
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    files = {}
    for side, model in (("jax", jnet), ("port", net)):
        folder = str(tmp / side)
        files[side] = {"weights": model.save_base_model(folder)}
        model.save_encodings(model.generate_encodings(loader, 5), folder)
        files[side]["encodings"] = os.path.join(folder, "encodings.pkl")
    return {"tmp": tmp, "config": str(config), "params": params,
            "jnet": jnet, "net": net, "loader": loader, "files": files,
            "image": loader.flat("val")[0][0]}


def test_encode_dataset_equals_encode_in_order(world):
    """The bulk encode against ``encode`` of the images its loader decodes
    (the native decoder on a host of several cores, else cv2; the two part
    by a gray level, ``ROADMAP.md`` F1)."""
    from embeddingnet_tpu_torch.data import native_loader
    from embeddingnet_tpu_torch.data.pipeline import BatchLoader
    net, loader = world["net"], world["loader"]
    paths = loader.flat("train")[0][:23]
    got = net.encode_dataset(paths, batch_size=5, num_workers=2)
    if BatchLoader([], net.input_shape).backend == "native":
        decoded = native_loader.decode_batch(paths, *net.input_shape[:2])
    else:
        decoded = get_images(paths, net.input_shape)
    want = net.encode(decoded)
    assert got.shape == (23, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ENC_TOL)
    reordered = net.encode_dataset(paths[::-1], batch_size=7)
    np.testing.assert_allclose(reordered, want[::-1], rtol=0, atol=ENC_TOL)
    empty = net.encode_dataset([])
    assert empty.shape == (0, D) and empty.dtype == np.float32


class _NearestCentroid:
    """The sklearn classifier protocol (``fit``/``predict``) in numpy."""

    def fit(self, x, labels):
        self.classes_ = sorted(set(labels))
        labels = np.asarray(labels)
        self.centroids_ = np.stack([np.asarray(x)[labels == c].mean(0)
                                    for c in self.classes_])
        return self

    def predict(self, x):
        d = ((np.asarray(x)[:, None] - self.centroids_[None]) ** 2).sum(-1)
        return [self.classes_[i] for i in d.argmin(1)]


def test_train_embeddings_classifier_matches_jax(world):
    """The same DB (per-class cap and shuffle from ``GENERAL.seed``) goes
    to the model's ``fit``; the fitted model is stored and returned."""
    net, jnet, loader = world["net"], world["jnet"], world["loader"]
    got = net.train_embeddings_classifier(loader, _NearestCentroid(),
                                          max_n_samples=4)
    want = jnet.train_embeddings_classifier(loader, _NearestCentroid(),
                                            max_n_samples=4)
    assert net.encoded_training_data["knn_classifier"] is got
    assert got.classes_ == want.classes_
    assert net.encoded_training_data["paths"] == \
        jnet.encoded_training_data["paths"]
    np.testing.assert_allclose(got.centroids_, want.centroids_, rtol=0,
                               atol=CLASSIFIER_TOL)
    val = get_images(loader.flat("val")[0], net.input_shape)
    assert got.predict(net.encode(val)) == want.predict(jnet.encode(val))


@pytest.mark.parametrize("name", ["simple2", "efficientnet-b0"])
def test_save_exported_round_trip(name, tmp_path, monkeypatch):
    """The ``.pt2`` file, reloaded, equals the module on the CPU (f32, a
    [1, H, W, 3] image already /255, eval mode), traced on the library
    path of a ``fast_conv`` encoder; ``save_onnx`` is the same method."""
    monkeypatch.setitem(efn.SCALINGS, "efficientnet-b0", (0.25, 0.5, 224))
    params = params_from_dict(_sections(None, str(tmp_path)))
    params.model.backbone_name = name
    net = EmbeddingNet(params, device="cpu", fast_conv=True)
    assert EmbeddingNet.save_onnx is EmbeddingNet.save_exported
    path = net.save_exported(str(tmp_path / "export"))
    assert path.endswith("base_model.pt2")
    program = torch.export.load(path).module()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        got, want = program(x), net.module(x)
    assert got.dtype == torch.float32 and got.shape == (1, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_cli_output(world):
    """What ``tools/test.py --top5`` and ``tools/evaluate.py`` print for
    the JAX base model and DB, run in one subprocess."""
    files = world["files"]["jax"]
    script = (
        "import runpy, sys\n"
        f"sys.argv = ['test.py', {world['config']!r}, '--weights', "
        f"{files['weights']!r}, '--encodings', {files['encodings']!r}, "
        f"'--image', {world['image']!r}, '--top5']\n"
        f"runpy.run_path({os.path.join(ROOT, 'tools', 'test.py')!r}, "
        "run_name='__main__')\n"
        f"sys.argv = ['evaluate.py', {world['config']!r}, '--weights', "
        f"{files['weights']!r}, '--encodings', {files['encodings']!r}]\n"
        f"runpy.run_path({os.path.join(ROOT, 'tools', 'evaluate.py')!r}, "
        "run_name='__main__')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               EMBEDDINGNET_COMPILE_CACHE=str(world["tmp"] / "jax_cache"))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def _port_cli(name, argv, capsys):
    capsys.readouterr()
    result = runpy.run_path(os.path.join(ROOT, "tools", name))["main"](argv)
    return result, capsys.readouterr().out.strip().splitlines()


def test_test_cli_prints_what_the_jax_cli_prints(world, jax_cli_output,
                                                 capsys):
    files = world["files"]["port"]
    (label, top5), lines = _port_cli("test_torch.py", [
        world["config"], "--weights", files["weights"], "--encodings",
        files["encodings"], "--image", world["image"], "--top5",
        "--device", "cpu"], capsys)
    assert lines == jax_cli_output[:2]
    assert label == world["net"].predict_knn(world["image"])
    assert label.startswith("class_") and len(top5) == 5


def test_evaluate_cli_prints_what_the_jax_cli_prints(world, jax_cli_output,
                                                     capsys):
    files = world["files"]["port"]
    acc, lines = _port_cli("evaluate_torch.py", [
        world["config"], "--weights", files["weights"], "--encodings",
        files["encodings"], "--device", "cpu"], capsys)
    assert lines == jax_cli_output[2:]
    assert lines[0].startswith("recall@1=")
    net = world["net"]
    net.load_encodings(files["encodings"])
    assert acc == net.calculate_prediction_accuracy(world["loader"])
