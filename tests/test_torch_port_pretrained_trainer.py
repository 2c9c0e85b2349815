"""The Trainer's ``MODEL.backbone_weights`` in the port against the JAX
Trainer's (``embeddingnet_tpu_torch/train/loop.py``, the counterpart of
JAX ``Trainer._load_backbone_weights``).

A standalone encoder's backbone and head, written as ``.npz`` from seeded
random weights, land in the triplet module and in the siamese and arcface
modules' ``encoder`` equal to what the JAX Trainer loads; every other
tensor keeps the fresh initialisation of a Trainer without weights; with
bf16 master weights the file's f32 values are rounded once.

ResNet-18 at 32 px on ``tiny_dataset``; one torch thread."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from embeddingnet_tpu.config import params_from_dict as jparams  # noqa
from embeddingnet_tpu.data import ENDataLoader as JLoader  # noqa: E402
from embeddingnet_tpu.train.loop import Trainer as JTrainer  # noqa: E402
from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.models import pretrained  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.train.loop import Trainer  # noqa: E402

from _torch_port import numpy_tree, port_variables  # noqa: E402

SIZE, D = 32, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(
        leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _cfg(dataset, work_dir, mode, weights, **perf):
    return {
        "MODEL": {"backbone_name": "resnet18", "input_shape": [SIZE, SIZE, 3],
                  "encodings_len": D, "backbone_weights": weights,
                  "mode": mode, "embeddings_normalization": True},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.2},
        "GENERATOR": {"negatives_selection_mode": "batch_all",
                      "k_classes": 3, "k_samples": 2, "batch_size": 6,
                      "n_batches": 1, "n_batches_val": 1},
        "TRAIN": {"n_epochs": 1, "plot_history": False},
        "GENERAL": {"work_dir": str(work_dir), "project_name": "run",
                    "seed": 3},
        "PERFORMANCE": {"compute_dtype": "float32", **perf},
    }


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    """A standalone encoder's backbone and head, from seed 7, as the JAX
    tool and a JAX export write them."""
    path = tmp_path_factory.mktemp("weights") / "r18.npz"
    source = registry.EmbeddingModule("resnet18", encodings_len=D,
                                      classifier=False)
    port_variables(source, seed=7)
    np.savez(path, **pretrained.flatten_params(source))
    return str(path)


@pytest.mark.parametrize("mode", ["triplet", "siamese", "arcface"])
def test_trainer_loads_weights_as_the_jax_trainer(tiny_dataset, tmp_path,
                                                  weights_file, mode):
    """The file's keys land in the encoder (under ``encoder`` in siamese
    and arcface mode) equal to the JAX Trainer's; the rest keep the fresh
    initialisation of a Trainer without weights."""
    cfg = _cfg(tiny_dataset, tmp_path / "port", mode, weights_file)
    params = params_from_dict(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    logs = []
    trainer = Trainer(params, loader, device="cpu", log_fn=logs.append)
    assert any(weights_file in line for line in logs)
    fresh = Trainer(params_from_dict(_cfg(tiny_dataset, tmp_path / "fresh",
                                          mode, None)),
                    loader, device="cpu", log_fn=lambda *a: None)

    jp = jparams(_cfg(tiny_dataset, tmp_path / "jax", mode, weights_file))
    jtr = JTrainer(jp, JLoader(**{k: jp.dataloader[k]
                                  for k in jp.dataloader.keys()}),
                   log_fn=lambda *a: None)
    jflat = _flat(numpy_tree(jtr.variables))
    file = dict(np.load(weights_file))
    got = pretrained.flatten_params(trainer.module)
    untouched = pretrained.flatten_params(fresh.module)
    nest = "encoder/" if mode != "triplet" else ""
    for key, value in got.items():
        collection, rest = key.split("/", 1)
        inner = rest[len(nest):] if rest.startswith(nest) else None
        source = f"{collection}/{inner}" if inner else None
        if source in file:
            np.testing.assert_array_equal(value, file[source], err_msg=key)
            np.testing.assert_array_equal(value, jflat[key], err_msg=key)
        else:
            np.testing.assert_array_equal(value, untouched[key], err_msg=key)
    assert any(k.startswith(f"params/{nest}backbone/") for k in got)


def test_trainer_loads_before_the_bf16_cast(tiny_dataset, tmp_path,
                                            weights_file):
    """bf16 master weights: the file's f32 values rounded once."""
    cfg = _cfg(tiny_dataset, tmp_path, "triplet", weights_file,
               params_dtype="bfloat16")
    params = params_from_dict(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device="cpu", log_fn=lambda *a: None)
    file = dict(np.load(weights_file))
    w = trainer.module.backbone.stem_conv.weight
    assert w.dtype == torch.bfloat16
    want = torch.from_numpy(file["params/backbone/stem_conv/kernel"]
                            .transpose(3, 2, 0, 1).copy()).bfloat16()
    assert torch.equal(w.detach(), want)
