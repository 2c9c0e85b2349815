"""The Trainer at ``MESH.model: 2`` on 2 gloo ranks (tensor parallelism,
``parallel/tp.py``): a CNN (``simple2``, no rule matches) trains as one
process does; the tiny ViT of ``tests/test_tp.py`` in arcface mode, with a
softmax pretraining phase, writes whole-tensor checkpoints (and a whole
pretrained backbone), and its epoch-0 checkpoint resumed in one process
continues as the 2-rank resume does (Adam; the metrics and the encoder to
1e-4, the key biases, which Adam moves by rounding alone, to its bound).

The ranks live in ``tests/_torch_port_spawn.py``, which imports no JAX;
nothing here imports JAX either.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.models import vit  # noqa: E402
from embeddingnet_tpu_torch.train.loop import Trainer  # noqa: E402

import _torch_port_spawn as ranks  # noqa: E402

SIZE = 16
TINY = dict(patch=8, dim=32, depth=2, heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cnn_cfg(dataset, work_dir, **mesh):
    return {
        "MODEL": {"backbone_name": "simple2", "input_shape": [32, 32, 3],
                  "encodings_len": 16, "backbone_weights": None,
                  "mode": "triplet"},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.2},
        "GENERATOR": {"k_classes": 4, "k_samples": 2, "batch_size": 8,
                      "n_batches": 2, "n_batches_val": 1,
                      "negatives_selection_mode": "batch_all",
                      "augmentations": None},
        "TRAIN": {"n_epochs": 1, "eval_recall_every": 1,
                  "plot_history": False, "learning_rate": 0.01},
        "GENERAL": {"work_dir": str(work_dir), "project_name": "run",
                    "seed": 3},
        "PERFORMANCE": {"compute_dtype": "float32"},
        "MESH": {"data": -1, "model": 1, **mesh},
    }


def _vit_cfg(dataset, work_dir, **mesh):
    return {
        "MODEL": {"backbone_name": "vit-b16", "input_shape": [SIZE, SIZE, 3],
                  "encodings_len": 16, "backbone_weights": None,
                  "mode": "arcface", "embeddings_normalization": False},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.2},
        "GENERATOR": {"batch_size": 6, "n_batches": 2, "margin": 0.3,
                      "augmentations": None},
        "TRAIN": {"n_epochs": 2, "eval_recall_every": 1,
                  "plot_history": False, "learning_rate": 0.01},
        "SOFTMAX_PRETRAINING": {"optimizer": "sgd", "learning_rate": 0.05,
                                "n_epochs": 1, "steps_per_epoch": 1,
                                "val_steps": 1, "batch_size": 6},
        "GENERAL": {"work_dir": str(work_dir), "project_name": "run",
                    "seed": 3},
        "PERFORMANCE": {"compute_dtype": "float32", "ema_decay": 0.9},
        "MESH": {"data": -1, "model": 1, **mesh},
    }


def _fit_alone(cfg, epochs=1, resume=None):
    params = params_from_dict(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device="cpu", log_fn=lambda *a: None)
    if resume is not None:
        trainer.resume(resume)
    return trainer, trainer.fit(epochs).history


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, tiny_dataset_module):
    root = tmp_path_factory.mktemp("tp_trainer")
    dataset = tiny_dataset_module
    cnn = _cnn_cfg(dataset, root / "cnn_tp", model=2)
    vit_tp = _vit_cfg(dataset, root / "vit_tp", model=2)
    vit_resume = _vit_cfg(dataset, root / "vit_tp", model=2)
    runs = ranks.spawn(ranks.trainer_cases_worker, 2, root / "spawn",
                       cnn, vit_tp, vit_resume, TINY)
    alone, alone_h = _fit_alone(_cnn_cfg(dataset, root / "cnn_alone"))
    # the TP run's epoch-0 checkpoint resumed in one process
    weights = root / "vit_one" / "run" / "weights"
    weights.mkdir(parents=True)
    shutil.copytree(root / "vit_tp" / "run" / "weights" / "0",
                    weights / "0")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(vit._VARIANTS, "vit-b16", TINY)
        one, one_h = _fit_alone(_vit_cfg(dataset, root / "vit_one"),
                                epochs=2, resume=0)
        one_vars = one.encoder_variables()
        whole = {k: tuple(v.shape) for k, v in one.state.state_dict()[
            "module"].items()}
    saved = torch.load(root / "vit_tp" / "run" / "weights" / "0" /
                       "state.pt", weights_only=True)
    return {"runs": runs, "cnn_alone": (alone_h, alone.encoder_variables()),
            "vit_one": (one_h, one_vars, whole), "saved": saved,
            "root": root}


@pytest.fixture(scope="module")
def tiny_dataset_module(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp("tp_dataset")
    rng = np.random.default_rng(0)
    for cls in range(6):
        d = root / f"class_{cls}"
        d.mkdir()
        for i in range(10):
            base = np.zeros((SIZE, SIZE, 3), np.uint8)
            base[..., cls % 3] = 40 * (cls + 1)
            noise = rng.integers(0, 40, (SIZE, SIZE, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"img_{i}.png"),
                        np.clip(base + noise, 0, 255).astype(np.uint8))
    return str(root)


def test_cnn_trains_at_model_2_as_one_process(trainer_runs):
    """No rule matches a CNN: each rank of the model group computes the
    one-process step on the whole batch."""
    h_alone, v_alone = trainer_runs["cnn_alone"]
    a, b = trainer_runs["runs"]
    for run in (a, b):
        cnn = run["cnn"]
        assert cnn["grid"][:2] == (1, 2) and cnn["split"] == []
        for key, values in h_alone.items():
            if key.endswith("_s") or key == "images_per_sec":
                continue
            np.testing.assert_allclose(cnn["h1"][key], values, rtol=1e-6,
                                       err_msg=key)
        for k, v in v_alone.items():
            torch.testing.assert_close(cnn["after1"][k], v, rtol=1e-6,
                                       atol=1e-7, msg=k)


def test_tp_checkpoint_is_whole_and_resumes_in_one_process(trainer_runs):
    runs = trainer_runs["runs"]
    one_h, one_vars, whole = trainer_runs["vit_one"]
    saved = trainer_runs["saved"]
    assert {k: tuple(v.shape) for k, v in saved["module"].items()} == whole
    for run in runs:
        v = run["vit"]
        assert "encoder.backbone.block1.mlp.fc1.weight" in v["split"]
        assert "class_weights" in v["split"]
        assert v["pretrained_whole"]
        for key, values in one_h.items():
            if key.endswith("_s") or key == "images_per_sec":
                continue
            np.testing.assert_allclose(v["h2"][key], values, rtol=1e-4,
                                       atol=1e-6, err_msg=key)
        for k, value in one_vars.items():
            if k.endswith(".attn.key.bias"):
                # Adam moves it by rounding alone: within its bound for
                # the epoch's 2 updates at lr 0.01
                gap = float((v["after2"][k] - value).abs().max())
                assert gap <= 2 * 3.2 * 0.01 * 2, (k, gap)
                continue
            torch.testing.assert_close(v["after2"][k], value, rtol=1e-4,
                                       atol=1e-6, msg=k)
    # one model: the ranks' whole encoders agree bit for bit
    for k, value in runs[0]["vit"]["after2"].items():
        assert torch.equal(value, runs[1]["vit"]["after2"][k]), k
    # rank 0 alone wrote the checkpoints
    weights = trainer_runs["root"] / "vit_tp" / "run" / "weights"
    assert not [e for e in os.listdir(weights) if e.startswith(".tmp")]
