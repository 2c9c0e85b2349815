"""The serving slice as a whole: the port's EmbeddingNet, InferenceEngine
and HTTP server against the JAX package's, on a folder dataset, with the
JAX variables converted into the port. The JAX reference of the embeddings
runs ``EmbeddingModule(fast_conv=True)`` (Pallas in interpret mode); both
sides decode the same image files with the same cv2 calls."""

import json
import os
import struct
import threading
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.config import params_from_dict  # noqa: E402
from embeddingnet_tpu.data import ENDataLoader as JENDataLoader  # noqa
from embeddingnet_tpu.data.images import get_images  # noqa: E402
from embeddingnet_tpu.models import EmbeddingNet as JEmbeddingNet  # noqa
from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu.serving import InferenceEngine as JEngine  # noqa
from embeddingnet_tpu.serving import make_server as j_make_server  # noqa
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.models.api import EmbeddingNet  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.serving import (InferenceEngine,  # noqa: E402
                                            make_server)

from _torch_port import randomize_bn  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)   # f32, sums in another order
INPUT = 32   # resnet18 at 32px: stage 2 at 4x4x128, stage 3 at 2x2x256


def _make_dataset(root):
    """Folder-per-class PNGs, 6 classes x 10 (as conftest's tiny_dataset)."""
    rng = np.random.default_rng(0)
    for cls in range(6):
        cls_dir = root / f"class_{cls}"
        cls_dir.mkdir(parents=True)
        for i in range(10):
            base = np.zeros((16, 16, 3), np.uint8)
            base[..., cls % 3] = 40 * (cls + 1)
            noise = rng.integers(0, 40, size=(16, 16, 3), dtype=np.uint8)
            img = np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8)
            cv2.imwrite(str(cls_dir / f"img_{i}.png"), img)
    return str(root)


def _params(dataset, work_dir):
    return params_from_dict({
        "MODEL": {"input_shape": [INPUT, INPUT, 3], "encodings_len": 16,
                  "mode": "triplet", "backbone_name": "resnet18",
                  "backbone_weights": None},
        "DATALOADER": {"dataset_path": dataset},
        "ENCODINGS": {"knn_k": 3},
        "GENERAL": {"project_name": "serve_port", "work_dir": work_dir},
    })


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    """(params, the port's loader, JAX net, port net, JAX fast_conv
    embeddings of the train images, those images, the JAX loader). Each net
    is given its own package's loader; both hold the same DB."""
    tmp = tmp_path_factory.mktemp("serving")
    dataset = _make_dataset(tmp / "dataset")
    params = _params(dataset, str(tmp))
    loader = ENDataLoader(dataset, validate=True, val_ratio=0.2)
    jloader = JENDataLoader(dataset, validate=True, val_ratio=0.2)
    assert loader.flat("val") == jloader.flat("val")

    jnet = JEmbeddingNet(params)
    jnet.variables = randomize_bn(jnet.variables)
    tnet = EmbeddingNet(params, device="cpu", fast_conv=True)
    tnet.module.load_state_dict(flax_to_torch(jnet.variables, tnet.module))

    paths, _ = loader.flat("train")
    images = get_images(paths, (INPUT, INPUT, 3))
    fast = JEmbeddingModule(backbone_name="resnet18", encodings_len=16,
                            fast_conv=True)
    want = np.asarray(jax.jit(lambda v, x: fast.apply(v, x / 255.0))(
        jnet.variables, jnp.asarray(images, jnp.float32)))

    jnet.generate_encodings(jloader, max_n_samples=4)
    tnet.generate_encodings(loader, max_n_samples=4)
    return params, loader, jnet, tnet, want, images, jloader


def test_encode_matches_jax_fast_conv(slice_pair):
    _, _, _, tnet, want, images, _ = slice_pair
    got = tnet.encode(images)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_generate_encodings_matches_jax(slice_pair):
    _, _, jnet, tnet, _, _, _ = slice_pair
    j, t = jnet.encoded_training_data, tnet.encoded_training_data
    assert t["paths"] == j["paths"] and t["labels"] == j["labels"]
    np.testing.assert_allclose(t["encodings"], j["encodings"], **TOL)


def test_predict_knn_matches_jax(slice_pair):
    _, loader, jnet, tnet, _, _, jloader = slice_pair
    val_paths, _ = loader.flat("val")
    for path in val_paths:
        assert tnet.predict_knn(path, with_top5=True) == \
            jnet.predict_knn(path, with_top5=True)
        assert tnet.predict(path) == jnet.predict(path)
    assert (tnet.calculate_prediction_accuracy(loader)
            == jnet.calculate_prediction_accuracy(jloader))


def _serve(engine, make):
    server = make(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def test_http_server_matches_jax(slice_pair):
    _, loader, jnet, tnet, _, _, _ = slice_pair
    val_paths, _ = loader.flat("val")
    bodies = []
    for path in val_paths:
        with open(path, "rb") as f:
            bodies.append(f.read())
    batch = struct.pack(">I", len(bodies) + 1) + b"".join(
        struct.pack(">I", len(b)) + b for b in bodies + [b"not an image"])

    answers = []
    for engine, make in ((JEngine(jnet, max_batch=4), j_make_server),
                         (InferenceEngine(tnet, max_batch=4), make_server)):
        server, url = _serve(engine, make)
        try:
            assert engine.ready.wait(120)
            health = _get(f"{url}/healthz")
            classify = [_post(f"{url}/classify", b) for b in bodies]
            labels = _post(f"{url}/classify_batch", batch)["labels"]
            emb = np.array(_post(f"{url}/embed", bodies[0])["embedding"])
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{url}/classify", b"not an image")
            assert e.value.code == 400
            answers.append((health, classify, labels, emb))
        finally:
            server.shutdown()
            server.server_close()
            engine.close()

    (jh, jc, jl, je), (th, tc, tl, te) = answers
    assert th == jh and th["ready"] and th["backbone"] == "resnet18"
    assert tc == jc
    assert tl == jl and tl[-1] is None
    assert len(tl) == len(bodies) + 1
    np.testing.assert_allclose(te, je, **TOL)


def test_engine_quantized_db_matches_jax(slice_pair):
    _, _, jnet, tnet, _, images, _ = slice_pair
    jengine = JEngine(jnet, max_batch=4, quantize_db=True)
    tengine = InferenceEngine(tnet, max_batch=4, quantize_db=True)
    try:
        ok, buf = cv2.imencode(".png", images[0])
        assert ok
        want = jengine.infer_one(buf.tobytes())
        got = tengine.infer_one(buf.tobytes())
        assert (got["label"], got["top5"]) == (want["label"], want["top5"])
        # one warm-up batch plus the request's
        assert tengine.device_batches == 2
        # decoded arrays go in directly; a wrong shape is refused up front
        arrays = tengine.infer_arrays([images[1], None])
        assert arrays[1] is None and arrays[0]["label"] in tnet._db()[2]
        with pytest.raises(ValueError, match="uint8"):
            tengine.infer_arrays([images[1][:-1]])
        assert tengine.device_batches == 3
    finally:
        jengine.close()
        tengine.close()


def test_save_load_and_cli_build(slice_pair, tmp_path):
    """save_base_model/load_model and save/load_encodings round trip, and
    tools/serve_torch.py builds a server from the files that answers as the
    in-process engine does."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import serve_torch
    import yaml

    params, loader, _, tnet, _, images, _ = slice_pair
    weights = tnet.save_base_model(str(tmp_path))
    tnet.save_encodings(tnet.encoded_training_data, str(tmp_path))
    with open(weights + ".json") as f:
        assert json.load(f)["backbone_name"] == "resnet18"
    cfg = tmp_path / "serve.yml"
    cfg.write_text(yaml.safe_dump({
        "MODEL": {"input_shape": [INPUT, INPUT, 3], "encodings_len": 16,
                  "backbone_name": "resnet18", "backbone_weights": None},
        "ENCODINGS": {"knn_k": 3},
        "PERFORMANCE": {"compute_dtype": "float32", "pallas_conv": True},
    }))
    args = serve_torch.parse_args([
        str(cfg), "--weights", weights, "--encodings",
        str(tmp_path / "encodings.pkl"), "--device", "cpu", "--port", "0",
        "--max_batch", "4"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no fingerprint mismatch
        engine, server = serve_torch.build(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert engine.net.weights_fingerprint() == tnet.weights_fingerprint()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        val_paths, _ = loader.flat("val")
        with open(val_paths[0], "rb") as f:
            got = _post(f"{url}/classify", f.read())
        assert got["label"] == tnet.predict_knn(val_paths[0])
    finally:
        server.shutdown()
        server.server_close()
        engine.close()


def test_load_model_missing_keys(slice_pair, tmp_path):
    params, _, _, tnet, _, _, _ = slice_pair
    state = {k: v for k, v in tnet.module.state_dict().items()}
    other = EmbeddingNet(params, device="cpu")
    assert other.weights_fingerprint() != tnet.weights_fingerprint()

    # an encoder-only export (no classifier) loads
    torch.save({k: v for k, v in state.items()
                if not k.startswith("classifier.")}, tmp_path / "enc.pt")
    other.load_model(str(tmp_path / "enc.pt"))
    assert other.weights_fingerprint() == tnet.weights_fingerprint()
    # a missing backbone key fails
    del state["backbone.stem_bn.running_var"]
    torch.save(state, tmp_path / "bad.pt")
    with pytest.raises(KeyError, match="missing"):
        other.load_model(str(tmp_path / "bad.pt"))


def test_fingerprint_independent_of_compute_path(slice_pair):
    params, _, _, tnet, _, _, _ = slice_pair
    plain = EmbeddingNet(params, device="cpu")
    bf16 = EmbeddingNet(params, device="cpu", fast_conv=True,
                        dtype=torch.bfloat16)
    assert plain.weights_fingerprint() == bf16.weights_fingerprint()
    plain.module.load_state_dict(tnet.module.state_dict())
    assert plain.weights_fingerprint() == tnet.weights_fingerprint()
