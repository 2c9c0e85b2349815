"""``PERFORMANCE.remat``, ``params_dtype: bfloat16`` and
``async_checkpoint`` in the port, on the CPU.

* Remat: the triplet step with its backbone's blocks under checkpoints
  against the step without, on ResNet-18, EfficientNet-B0 with
  drop-connect and a small ViT: loss, every gradient, the parameters and
  the running statistics bit-equal in float32 (the recompute runs the same
  ops), the statistics updated once, the generator advanced as without
  remat (the masks are not drawn again); ``simple2`` (one checkpoint over
  the whole backbone, Dropout on the same masks) against JAX's step with
  ``remat=True`` in float64, at the step parity tests' tolerances; the
  ArcFace step (which JAX does not rematerialise) against itself without
  remat in float64, within 1e-12, its attention cores run twice a step
  under remat; the siamese Trainer warns that it keeps its activations.
* bf16 master weights: the port's Trainer against JAX's with the same
  weights (JAX's, cast to bf16): parameters, BatchNorm statistics and the
  optimizer state bf16 on both sides, the first step's loss within 1e-2
  relative (measured 6.4e-3: the loss is the forward's, computed in bf16
  on both sides in another order of operations).
* Async checkpoints: the files byte-equal to a synchronous save, a resume
  from them bit for bit.
"""

import copy
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.models import vit as tvit  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.models.registry import (  # noqa: E402
    EmbeddingModule)
from embeddingnet_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from embeddingnet_tpu_torch.train import optim  # noqa: E402
from embeddingnet_tpu_torch.train.loop import Trainer  # noqa: E402
from embeddingnet_tpu_torch.train.state import TrainState  # noqa: E402
from embeddingnet_tpu_torch.train.steps import (  # noqa: E402
    make_triplet_train_step)

from test_torch_port_simple import (LOSS_RTOL, PARAM_TOL,  # noqa: E402
                                    SIZES, _close, _dropout_masks,
                                    _jax_dropout_masks, _jax_embedding,
                                    _port_embedding)

SHAPE = (32, 32, 3)
BF16_LOSS_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module(backbone):
    module = EmbeddingModule(backbone, encodings_len=16, input_shape=SHAPE)
    module.reset_parameters(torch.Generator().manual_seed(0))
    return module


def _step_once(module, remat):
    """One batch-all SGD step; the loss, the gradients, the state and the
    generator's state after it."""
    spec = optim.get_optimizer("sgd", 0.05)
    state = TrainState.create(module, spec,
                              generator=torch.Generator().manual_seed(3))
    step = make_triplet_train_step(module, spec, mode="batch_all",
                                   max_positives=3, remat=remat)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (16,) + SHAPE,
                                           dtype=np.uint8))
    labels = torch.from_numpy(np.repeat(np.arange(4), 4).astype(np.int32))
    _, metrics = step(state, images, labels)
    return (metrics["loss"], {n: p.grad.clone()
                              for n, p in module.named_parameters()},
            {k: v.clone() for k, v in module.state_dict().items()},
            state.generator.get_state())


@pytest.mark.parametrize("backbone", ["resnet18", "efficientnet-b0",
                                      "vit-b16"])
def test_remat_is_bit_equal_on_the_cpu(backbone, monkeypatch):
    monkeypatch.setitem(tvit._VARIANTS, "vit-b16",
                        dict(patch=16, dim=32, depth=2, heads=2))
    module = _module(backbone)
    plain = _step_once(copy.deepcopy(module), remat=False)
    calls = []
    from embeddingnet_tpu_torch.models import remat
    run = remat.run
    monkeypatch.setattr(remat, "run", lambda *a: calls.append(1) or run(*a))
    again = _step_once(module, remat=True)
    assert calls and torch.equal(plain[0], again[0])
    for k in plain[1]:
        assert torch.equal(plain[1][k], again[1][k]), k
    for k in plain[2]:
        assert torch.equal(plain[2][k], again[2][k]), k
        if k.endswith("num_batches_tracked"):
            assert int(again[2][k]) == 1, k        # one update, not two
    assert torch.equal(plain[3], again[3])     # no mask drawn twice
    if backbone == "efficientnet-b0":
        assert any(getattr(m, "drops", False) for m in module.modules())


def test_remat_step_matches_jax_float64():
    """``simple2`` (no blocks of its own: one checkpoint over the whole
    backbone, its Dropout masks replayed in the recompute): two batch-hard
    SGD steps against JAX's step with ``remat=True``, each from the JAX
    float64 trajectory's state."""
    from _torch_port import triplet_steps_against_jax
    jmodule, variables = _jax_embedding("simple2")
    size = SIZES["simple2"]
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 256, (8, size, size, 3), np.uint8),
                np.repeat(np.arange(4), 2).astype(np.int32))
               for _ in range(2)]
    module = _port_embedding("simple2")
    holder = {}
    results = triplet_steps_against_jax(
        jmodule, variables, module, batches,
        [_dropout_masks(size, seed=10 + i) for i in range(2)], holder,
        context=_jax_dropout_masks(holder),
        reg_rules=optim.reg_rules_for("simple2"), lr=0.05, remat=True)
    for loss, jloss, got, want in results:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        for name, _ in module.named_parameters():
            _close(got[name].numpy(), want[name].numpy(), PARAM_TOL, name)


# -- the Trainer ---------------------------------------------------------------


def _cfg(dataset, work_dir, **sections):
    cfg = {
        "MODEL": {"backbone_name": "resnet18", "input_shape": [32, 32, 3],
                  "encodings_len": 16, "backbone_weights": None,
                  "mode": "triplet", "embeddings_normalization": True},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.2},
        "GENERATOR": {"negatives_selection_mode": "batch_hard",
                      "k_classes": 3, "k_samples": 3, "batch_size": 6,
                      "n_batches": 2, "n_batches_val": 1},
        "TRAIN": {"n_epochs": 2, "eval_recall_every": 0,
                  "plot_history": False},
        "GENERAL": {"work_dir": str(work_dir), "project_name": "run",
                    "seed": 3},
        "PERFORMANCE": {"compute_dtype": "float32", "bn_momentum": 0.9},
    }
    for section, values in sections.items():
        cfg[section] = {**cfg.get(section, {}), **values}
    return cfg


def _trainer(cfg):
    params = params_from_dict(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    return Trainer(params, loader, device="cpu", log_fn=lambda *a: None)


def _arcface_steps(module, remat, n_steps=2):
    """Two float64 Adam steps of the ArcFace step on one batch: the losses,
    the parameters after, and the attention cores run per step."""
    from embeddingnet_tpu_torch.ops.augment import get_aug
    from embeddingnet_tpu_torch.train.steps import make_arcface_train_step
    spec = optim.get_optimizer("adam", 1e-3)
    state = TrainState.create(module, spec,
                              generator=torch.Generator().manual_seed(3))
    step = make_arcface_train_step(
        module, spec, n_classes=4, augment_fn=get_aug("deepfake", SHAPE),
        compute_dtype=torch.float64, remat=remat)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (8,) + SHAPE,
                                           dtype=np.uint8))
    labels = torch.arange(8) % 4
    losses, cores = [], []
    for _ in range(n_steps):
        before = tvit.LAUNCHES["attention"]
        _, metrics = step(state, images, labels)
        cores.append(tvit.LAUNCHES["attention"] - before)
        losses.append(metrics["loss"])
    return losses, {k: p.detach() for k, p in module.named_parameters()}, \
        cores


def test_arcface_step_under_remat_matches_without(monkeypatch):
    """The ArcFace step honours ``remat`` as the triplet step does: in
    float64 the loss and the parameters agree with the step without it
    within 1e-12, and each block's attention core runs twice a step (the
    recompute) against once."""
    from embeddingnet_tpu_torch.models.registry import ArcFaceModule
    monkeypatch.setitem(tvit._VARIANTS, "vit-b16",
                        dict(patch=16, dim=32, depth=2, heads=2))
    module = ArcFaceModule("vit-b16", 16, n_classes=4, input_shape=SHAPE)
    module.reset_parameters(torch.Generator().manual_seed(0))
    module.double()
    plain = _arcface_steps(copy.deepcopy(module), remat=False)
    again = _arcface_steps(module, remat=True)
    for a, b in zip(plain[0], again[0]):
        assert abs(float(a) - float(b)) <= 1e-12 * abs(float(a))
    for k, p in plain[1].items():
        gap = float((p - again[1][k]).abs().max())
        assert gap <= 1e-12 * max(float(p.abs().max()), 1e-3), k
    assert plain[2] == [2, 2] and again[2] == [4, 4]


def test_the_arcface_trainer_remats_and_the_siamese_one_warns(
        tiny_dataset, tmp_path, monkeypatch):
    """``PERFORMANCE.remat`` reaches the ArcFace Trainer's step without a
    warning (two attention cores a block a step); the siamese step keeps
    its activations and says so."""
    import warnings
    monkeypatch.setitem(tvit._VARIANTS, "vit-b16",
                        dict(patch=16, dim=32, depth=2, heads=2))
    sections = {"MODEL": {"mode": "arcface", "backbone_name": "vit-b16"},
                "GENERATOR": {"batch_size": 6},
                "PERFORMANCE": {"remat": True}}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="PERFORMANCE.remat")
        trainer = _trainer(_cfg(tiny_dataset, tmp_path / "arcface",
                                **sections))
    images, labels = next(iter(trainer._train_loader()))
    before = tvit.LAUNCHES["attention"]
    trainer.train_step(trainer.state, torch.from_numpy(images),
                       torch.from_numpy(labels))
    assert tvit.LAUNCHES["attention"] - before == 4
    with pytest.warns(UserWarning, match="PERFORMANCE.remat: the siamese"):
        _trainer(_cfg(tiny_dataset, tmp_path / "siamese",
                      MODEL={"mode": "siamese"},
                      PERFORMANCE={"remat": True}))


def test_bf16_params_match_the_jax_trainer(tiny_dataset, tmp_path,
                                           monkeypatch):
    """bf16 master weights: the JAX Trainer's dtypes, and one step's loss
    against its step on the same batch, decoded with cv2 as the JAX
    ``BatchLoader`` does without its native decoder (``ROADMAP.md`` F1:
    the batch-hard loss of two bf16 implementations parts by 0.6% on this
    batch and by 4% on its natively decoded twin, where float32 agrees to
    3e-5)."""
    import functools
    import jax
    import jax.numpy as jnp
    from embeddingnet_tpu.config import params_from_dict as jparams
    from embeddingnet_tpu.data import ENDataLoader as JLoader
    from embeddingnet_tpu.train.loop import Trainer as JTrainer
    perf = {"compute_dtype": "bfloat16", "params_dtype": "bfloat16"}
    cfg = _cfg(tiny_dataset, tmp_path / "port", PERFORMANCE=perf)
    jcfg = _cfg(tiny_dataset, tmp_path / "jax",
                PERFORMANCE={**perf, "param_packing": False})
    jp = jparams(jcfg)
    jtr = JTrainer(jp, JLoader(**{k: jp.dataloader[k]
                                  for k in jp.dataloader.keys()}),
                   log_fn=lambda *a: None)
    leaves = jax.tree.leaves({"params": jtr.state.params,
                              "batch_stats": jtr.state.batch_stats})
    assert {x.dtype for x in leaves} == {jnp.dtype(jnp.bfloat16)}
    assert {x.dtype for x in jax.tree.leaves(jtr.state.opt_state)
            if hasattr(x, "dtype") and x.ndim} == {jnp.dtype(jnp.bfloat16)}

    trainer = _trainer(cfg)
    for name, t in trainer.module.state_dict().items():
        assert t.dtype == (torch.int64 if name.endswith(
            "num_batches_tracked") else torch.bfloat16), name
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       {"params": jtr.state.params,
                        "batch_stats": jtr.state.batch_stats})
    trainer.module.load_state_dict(flax_to_torch(f32, trainer.module))
    from embeddingnet_tpu_torch.data.pipeline import BatchLoader
    from embeddingnet_tpu_torch.train import loop
    monkeypatch.setattr(loop, "BatchLoader",
                        functools.partial(BatchLoader, backend="python"))
    images, labels = next(iter(trainer._train_loader()))
    _, jmetrics = jtr.train_step(jtr.state, jnp.asarray(images),
                                 jnp.asarray(labels))
    _, metrics = trainer.train_step(trainer.state, torch.from_numpy(images),
                                    torch.from_numpy(labels))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]),
                               rtol=BF16_LOSS_RTOL)
    moments = [v for s in trainer.state.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v) and v.ndim]
    assert moments and {m.dtype for m in moments} == {torch.bfloat16}
    for name, t in trainer.module.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == torch.bfloat16, name


def test_async_checkpoint_is_byte_equal_and_resumes(tiny_dataset, tmp_path):
    files = {}
    trainers = {}
    for label, on in (("sync", False), ("async", True)):
        trainer = _trainer(_cfg(tiny_dataset, tmp_path / label,
                                PERFORMANCE={"async_checkpoint": on}))
        assert trainer.ckpt_mgr.async_save is on
        trainer.fit(1)
        files[label] = os.path.join(trainer.ckpt_mgr.directory, "0")
        trainers[label] = trainer
    for name in (ckpt.STATE_FILE, ckpt.HOST_FILE):
        a, b = (os.path.join(files[k], name) for k in ("sync", "async"))
        if name == ckpt.HOST_FILE:
            # the metrics hold the fit's wall-clock timings
            import json
            ha, hb = (json.load(open(p)) for p in (a, b))
            for h in (ha, hb):
                for key in [k for k in h["metrics"] if k.endswith("_s")
                            or k == "images_per_sec"]:
                    del h["metrics"][key]
            assert ha == hb
        else:
            assert filecmp.cmp(a, b, shallow=False), name
    resumed = _trainer(_cfg(tiny_dataset, tmp_path / "async",
                            PERFORMANCE={"async_checkpoint": True}))
    resumed.resume(0)
    want = trainers["async"].state.state_dict()
    got = resumed.state.state_dict()
    for k, v in want["module"].items():
        assert torch.equal(got["module"][k], v), k
    assert torch.equal(got["generator"], want["generator"])
    assert got["step"] == want["step"]
