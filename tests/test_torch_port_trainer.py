"""The port's ``Trainer`` (``embeddingnet_tpu_torch/train/loop.py``) and its
CLI (``tools/train_torch.py``) on the CPU, without the JAX package:
ResNet-18 at 32x32, 32-d embeddings, batch-all over P-K batches of 3 x 3
from the ``tiny_dataset`` fixture (6 classes x 10), 4 train and 2 val
batches an epoch, float32.

A fit reports its metrics and writes the work-dir tree; a run resumed from
its epoch-0 checkpoint ends bit for bit where an uninterrupted run does;
the plateau scale and early stopping act on the applied learning rate;
the EMA and the freeze mask do what the JAX optimizer chain does; what the
port lacks raises at construction, and the arcface mode and the softmax
pretraining construct; the CLI's exported model encodes as the
Trainer's encoder does."""

import json
import os
import pickle
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.data.pipeline import (BatchLoader,  # noqa: E402
                                                  DecodeCache)
from embeddingnet_tpu_torch.data.samplers import PKSampler  # noqa: E402
from embeddingnet_tpu_torch.models.api import EmbeddingNet  # noqa: E402
from embeddingnet_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from embeddingnet_tpu_torch.train.loop import Trainer  # noqa: E402
from embeddingnet_tpu_torch.train.steps import apply_update  # noqa: E402

N_BATCHES = 4
CLI = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "train_torch.py")


def _cli():
    """The CLI's functions (``tools/`` is not a package)."""
    return runpy.run_path(CLI)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the steps here are many small ops, which
    several threads per process only slow down when the suite runs its
    files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dataset, work_dir, project="run", **sections):
    cfg = {
        "MODEL": {"backbone_name": "resnet18", "input_shape": [32, 32, 3],
                  "encodings_len": 32, "backbone_weights": None,
                  "mode": "triplet", "embeddings_normalization": True},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.2},
        "GENERATOR": {"negatives_selection_mode": "batch_all",
                      "k_classes": 3, "k_samples": 3, "batch_size": 6,
                      "n_batches": N_BATCHES, "n_batches_val": 2},
        "TRAIN": {"n_epochs": 2, "eval_recall_every": 1,
                  "plot_history": False, "decay_factor": 0.5},
        "GENERAL": {"work_dir": str(work_dir), "project_name": project,
                    "seed": 3},
        "PERFORMANCE": {"compute_dtype": "float32", "bn_momentum": 0.9},
    }
    for section, values in sections.items():
        cfg[section] = {**cfg.get(section, {}), **values}
    return cfg


def _trainer(cfg, **kw):
    params = params_from_dict(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    return Trainer(params, loader, device="cpu", log_fn=lambda *a: None,
                   **kw)


def _state(trainer):
    """Everything a resumed run must reproduce, as host tensors."""
    s = trainer.state.state_dict()
    return {"module": s["module"], "optimizer": s["optimizer"]["state"],
            "generator": s["generator"], "step": s["step"],
            "plateau_scale": s["plateau_scale"]}


def _assert_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_fit_reports_metrics_and_writes_the_work_dir(tiny_dataset, tmp_path):
    trainer = _trainer(_cfg(tiny_dataset, tmp_path))
    history = trainer.fit().history
    for key in ("loss", "val_loss", "images_per_sec", "val_recall1",
                "val_recall5", "n_triplets", "recall_eval_s"):
        assert len(history[key]) == 2, key
        assert np.all(np.isfinite(history[key])), key
    for key in ("val_recall1", "val_recall5"):
        assert all(0.0 <= v <= 1.0 for v in history[key])
    assert all(v > 0 for v in history["images_per_sec"])
    assert trainer.state.step == 2 * N_BATCHES
    root = tmp_path / "run"
    for sub in ("weights", "pretraining_model/weights", "encodings",
                "plots", "tf_log", "pretraining_model/tf_log"):
        assert (root / sub).is_dir(), sub
    assert trainer.paths["work_dir"] == str(tmp_path / "run")
    assert (root / "weights" / "0" / ckpt.STATE_FILE).is_file()
    host = json.loads((root / "weights" / "0" / ckpt.HOST_FILE).read_text())
    assert host["epoch"] == 0 and host["best"] == history["val_loss"][0]
    assert set(host) >= {"metrics", "plateau", "early_stop"}
    assert not [d for d in os.listdir(root / "weights")
                if d.startswith(".tmp")]
    lines = (root / "tf_log" / "train_metrics.jsonl").read_text().split("\n")
    assert [json.loads(l)["step"] for l in lines if l] == [0, 1]
    assert [t["epoch"] for t in trainer.timings] == [0, 1]
    assert trainer.timings[0]["checkpoint_bytes"] > 0


def test_resume_is_bit_exact(tiny_dataset, tmp_path):
    """fit(1), then a fresh Trainer that resumes and runs epoch 1, ends with
    the parameters, optimizer state, generator state, step count and plateau
    scale of an uninterrupted fit(2); with the ``default`` augmentation, so
    that the generator's draws matter."""
    extra = {"GENERATOR": {"augmentations": "default"}}
    whole = _trainer(_cfg(tiny_dataset, tmp_path, "whole", **extra))
    whole.fit(2)
    first = _trainer(_cfg(tiny_dataset, tmp_path, "split", **extra))
    first.fit(1)
    second = _trainer(_cfg(tiny_dataset, tmp_path, "split", **extra))
    second.resume()
    assert second.start_epoch == 1
    _assert_equal(_state(second), _state(first))
    assert second.plateau.state_dict() == first.plateau.state_dict()
    assert second.early_stop.state_dict() == first.early_stop.state_dict()
    second.fit(2)
    _assert_equal(_state(second), _state(whole))
    assert second.history.history["loss"] == whole.history.history["loss"][1:]


def test_restore_best_loads_the_best_epoch(tiny_dataset, tmp_path):
    trainer = _trainer(_cfg(tiny_dataset, tmp_path))
    assert not trainer.restore_best()           # nothing saved yet
    trainer.fit()
    best = trainer.ckpt_mgr.latest_epoch()
    vals = trainer.history.history["val_loss"]
    assert best == (1 if vals[1] < vals[0] else 0)
    saved = torch.load(os.path.join(trainer.paths["weights"], str(best),
                                    ckpt.STATE_FILE), weights_only=True)
    with torch.no_grad():
        for p in trainer.module.parameters():
            p.add_(1.0)
    assert trainer.restore_best()
    _assert_equal(trainer.module.state_dict(), saved["module"])
    assert trainer.state.step == saved["step"]


def test_plateau_and_early_stop_set_the_applied_learning_rate(
        tiny_dataset, tmp_path):
    """A val loss that never improves after epoch 0: with plateau patience 1
    epoch 1 cuts the scale to 0.1, so epoch 2 trains at a tenth of the
    schedule; early stopping with patience 2 ends the run after epoch 2."""
    trainer = _trainer(_cfg(tiny_dataset, tmp_path, TRAIN={
        "n_epochs": 6, "plateau_patience": 1, "early_stopping_patience": 2,
        "eval_recall_every": 0}))
    trainer._run_val_epoch = lambda: {"val_loss": 1.0}
    lrs = []
    step = trainer.train_step

    def spy(state, images, labels):
        out = step(state, images, labels)
        lrs.append(state.optimizer.param_groups[0]["lr"])
        return out
    trainer.train_step = spy
    history = trainer.fit().history
    assert len(history["loss"]) == 3 and trainer.early_stop.stopped
    sched = trainer.optimizer.lr_at
    want = [sched(i) * (1.0 if i < 2 * N_BATCHES else 0.1)
            for i in range(3 * N_BATCHES)]
    np.testing.assert_allclose(lrs, want, rtol=1e-12)
    assert trainer.state.plateau_scale == pytest.approx(0.01)
    assert trainer.ckpt_mgr.epochs() == [0]      # only epoch 0 improved


def test_ema_export_and_freeze_mask(tiny_dataset, tmp_path):
    """``ema_decay``: the EMA follows d*ema + (1-d)*p after each update and
    :meth:`encoder_variables` exports it with the live BatchNorm
    statistics; ``freeze_backbone: all``: the backbone's parameters do not
    move, its running statistics do, the head trains."""
    trainer = _trainer(_cfg(
        tiny_dataset, tmp_path, PERFORMANCE={"ema_decay": 0.9},
        MODEL={"freeze_backbone": "all"}, TRAIN={"eval_recall_every": 0}))
    before = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    ema_before = {k: v.clone() for k, v in trainer.state.ema.items()}
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (9, 32, 32, 3), np.uint8))
    labels = torch.arange(3).repeat_interleave(3)
    trainer.train_step(trainer.state, images, labels)
    live = dict(trainer.module.named_parameters())
    for name, e in trainer.state.ema.items():
        want = 0.9 * ema_before[name] + 0.1 * live[name].detach()
        torch.testing.assert_close(e, want, rtol=1e-6, atol=1e-7)
    after = trainer.module.state_dict()
    frozen = [n for n in live if n.startswith("backbone.")]
    assert frozen and all(torch.equal(after[n], before[n]) for n in frozen)
    assert not torch.equal(after["head.dense_1.weight"],
                           before["head.dense_1.weight"])
    assert not torch.equal(after["backbone.stem_bn.running_mean"],
                           before["backbone.stem_bn.running_mean"])
    # only the trainable parameters are in the optimizer
    n_opt = sum(len(g["params"]) for g in trainer.state.optimizer.param_groups)
    assert n_opt == len(live) - len(frozen)
    exported = trainer.encoder_variables()
    assert torch.equal(exported["head.dense_1.weight"],
                       trainer.state.ema["head.dense_1.weight"])
    assert not torch.equal(exported["head.dense_1.weight"],
                           after["head.dense_1.weight"])
    assert torch.equal(exported["backbone.stem_bn.running_var"],
                       after["backbone.stem_bn.running_var"])
    # the recall encoder holds the exported weights
    encoder = trainer._recall_encoder()
    assert encoder is not trainer.module
    _assert_equal(encoder.state_dict(), exported)


def test_debug_nans_stops_on_a_nan_loss(tiny_dataset, tmp_path):
    trainer = _trainer(_cfg(tiny_dataset, tmp_path,
                            PERFORMANCE={"debug_nans": True}))
    step = trainer.train_step

    def nan_step(state, images, labels):
        state, metrics = step(state, images, labels)
        return state, {**metrics, "loss": metrics["loss"] * float("nan")}
    trainer.train_step = nan_step
    with pytest.raises(FloatingPointError, match="debug_nans"):
        trainer.fit(1)
    assert trainer.state.step == 1      # stopped at the first step


def test_resume_without_a_checkpoint_raises(tiny_dataset, tmp_path):
    trainer = _trainer(_cfg(tiny_dataset, tmp_path))
    with pytest.raises(FileNotFoundError):
        trainer.resume()
    with pytest.raises(FileNotFoundError):
        trainer.resume(3)


@pytest.mark.parametrize("sections,error,match", [
    ({"MODEL": {"backbone_weights": "imagenet"}}, FileNotFoundError,
     r"'imagenet' is a named preset; this framework performs no downloads"),
    ({"MESH": {"model": 2}}, NotImplementedError, r"ROADMAP\.md, item 13\b"),
    ({"MESH": {"data": 2}}, NotImplementedError, r"ROADMAP\.md, item 13\b"),
], ids=["backbone_weights", "mesh_model", "mesh_data"])
def test_unported_settings_raise_at_construction(tiny_dataset, tmp_path,
                                                 monkeypatch, sections,
                                                 error, match):
    """What the port cannot run raises before anything is written, and so
    does a weights preset with no file (JAX's ``FileNotFoundError``:
    without ``$EMBEDDINGNET_WEIGHTS_DIR``, 'imagenet' resolves to
    nothing)."""
    monkeypatch.delenv("EMBEDDINGNET_WEIGHTS_DIR", raising=False)
    cfg = _cfg(tiny_dataset, tmp_path, **sections)
    with pytest.raises(error, match=match):
        _trainer(cfg)
    assert not (tmp_path / "run").exists()      # nothing was written


@pytest.mark.parametrize("sections", [
    {"MODEL": {"mode": "arcface"}},
    {"SOFTMAX_PRETRAINING": {"n_epochs": 1}},
    {"PERFORMANCE": {"params_dtype": "bfloat16", "remat": True,
                     "async_checkpoint": True}},
], ids=["arcface", "softmax_pretraining", "bf16_params_remat_async"])
def test_ported_settings_construct_and_write_nothing_until_fit(
        tiny_dataset, tmp_path, sections):
    """The arcface mode, the softmax pretraining, bf16 master weights,
    remat and async checkpoints, which raised or warned before they were
    ported, construct; the Trainer writes nothing before it trains (the
    work-dir tree and an empty metrics log)."""
    trainer = _trainer(_cfg(tiny_dataset, tmp_path, **sections))
    assert trainer.mode == sections.get("MODEL", {}).get("mode", "triplet")
    assert (trainer.params.softmax is not None) == (
        "SOFTMAX_PRETRAINING" in sections)
    assert trainer.ckpt_mgr.latest_epoch() is None
    written = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "run")
               for f in fs if os.path.getsize(os.path.join(d, f))]
    assert not written, written


def test_trainer_and_cli_default_to_the_card(tiny_dataset, tmp_path):
    """No silent CPU fallback: without ``device`` the Trainer asks for
    ``cuda``."""
    import inspect
    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    assert _cli()["parse_args"](["c.yml"]).device == "cuda"
    if not torch.cuda.is_available():
        params = params_from_dict(_cfg(tiny_dataset, tmp_path))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(params, ENDataLoader(tiny_dataset, val_ratio=0.2))


@pytest.mark.parametrize("centers_only", [False, True])
def test_cli_end_to_end_exports_the_trainer_encoder(tiny_dataset, tmp_path,
                                                    capsys, centers_only):
    yaml = pytest.importorskip("yaml")
    main = _cli()["main"]
    cfg = _cfg(tiny_dataset, tmp_path, ENCODINGS={
        "save_encodings": True, "max_num_samples_of_each_class": 4,
        "centers_only": centers_only})
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    trainer, net = main([str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "recall@1=" in out and "base model saved" in out
    work = tmp_path / "run"
    with open(work / "encodings" / "encodings.pkl", "rb") as f:
        db = pickle.load(f)
    if centers_only:        # one mean per class
        assert np.asarray(db["encodings"]).shape == (6, 32)
        assert db["labels"] == sorted(trainer.data_loader.class_names)
    else:                   # 6 classes x 4
        assert np.asarray(db["encodings"]).shape == (24, 32)
    params = params_from_dict(cfg)
    reloaded = EmbeddingNet(params, device="cpu").load_model(
        str(work / "base_model.pt"))
    assert reloaded.weights_fingerprint() == db["weights_fingerprint"]
    images = np.random.default_rng(1).integers(0, 256, (5, 32, 32, 3),
                                               np.uint8)
    with torch.no_grad():
        want = trainer._recall_encoder()(
            torch.from_numpy(images).float() / 255.0).float().numpy()
    np.testing.assert_allclose(reloaded.encode(images), want, rtol=1e-5,
                               atol=1e-6)
    # a second run resumes after the latest (best) checkpoint
    latest = trainer.ckpt_mgr.latest_epoch()
    trainer2, _ = main([str(path), "--device", "cpu", "--resume_from",
                        "latest"])
    assert trainer2.start_epoch == latest + 1
    assert len(trainer2.history.history.get("loss", [])) == 1 - latest


def test_cli_without_matplotlib_fails_before_the_fit(tiny_dataset, tmp_path,
                                                    monkeypatch):
    """``TRAIN.plot_history`` without matplotlib stops the CLI at its start,
    naming the key, before any epoch runs."""
    import sys
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(_cfg(tiny_dataset, tmp_path,
                                        TRAIN={"plot_history": True})))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(Trainer, "fit", lambda *a, **k: pytest.fail(
        "the fit ran before the missing matplotlib was reported"))
    with pytest.raises(ImportError, match="TRAIN.plot_history"):
        _cli()["main"]([str(path), "--device", "cpu"])
    assert not (tmp_path / "run").exists()


def test_checkpoint_manager_keeps_and_falls_back(tmp_path):
    """Saves are best-only; ``max_to_keep`` drops the oldest; a missing
    monitored metric falls back to ``loss`` in min mode and never saves in
    max mode."""
    module = torch.nn.Linear(2, 2)
    from embeddingnet_tpu_torch.train.optim import get_optimizer
    from embeddingnet_tpu_torch.train.state import TrainState
    state = TrainState.create(module, get_optimizer("adam", 1e-3))
    mgr = ckpt.CheckpointManager(str(tmp_path / "w"), max_to_keep=2)
    for epoch in range(4):
        assert mgr.save(epoch, state, {"val_loss": 4.0 - epoch})
    assert not mgr.save(4, state, {"val_loss": 1.0})
    assert mgr.epochs() == [2, 3] and mgr.best == 1.0
    best = ckpt.CheckpointManager(str(tmp_path / "b"), monitor="val_loss")
    assert best.save(0, state, {"loss": 2.0}) and best.best == 2.0
    assert not best.save(1, state, {"loss": 3.0})
    top = ckpt.CheckpointManager(str(tmp_path / "r"), monitor="val_recall1",
                                 mode="max")
    assert not top.save(0, state, {"loss": 2.0})
    # an async manager keeps the same decisions and the same files
    # (byte for byte: tests/test_torch_port_remat.py)
    lazy = ckpt.CheckpointManager(str(tmp_path / "a"), max_to_keep=2,
                                  async_save=True)
    for epoch in range(4):
        assert lazy.save(epoch, state, {"val_loss": 4.0 - epoch})
    assert lazy.epochs() == [2, 3] and lazy.best == 1.0


def test_batch_loader_backends_and_decode_cache(tiny_dataset):
    loader = ENDataLoader(tiny_dataset, val_ratio=0.2)
    sampler = PKSampler(loader.train_data, loader.class_names, 3, 3, seed=1)
    # auto: the native decoder on a host of several cores (JAX's rule;
    # tests/test_torch_port_native_loader.py holds the rest)
    assert BatchLoader(sampler, (32, 32, 3)).backend == (
        "native" if (os.cpu_count() or 1) > 1 else "python")
    assert BatchLoader(sampler, (32, 32, 3),
                       backend="native").backend == "native"
    assert BatchLoader(sampler, (32, 32, 3),
                       backend="python").backend == "python"
    with pytest.raises(ValueError):
        BatchLoader(sampler, (32, 32, 3), backend="pillow")
    one = 32 * 32 * 3
    cache = DecodeCache(0)
    cache.budget = 2 * one
    batches = list(BatchLoader(sampler, (32, 32, 3), n_batches=2,
                               backend="python", cache=cache))
    assert len(batches) == 2 and batches[0][0].shape == (9, 32, 32, 3)
    assert cache._bytes == 2 * one and len(cache._data) == 2


def test_batch_loader_hands_on_a_decode_failure(tiny_dataset):
    class Broken:
        def __iter__(self):
            yield ["missing.png"], np.zeros(1, np.int32)
            raise OSError("disk gone")
    out = BatchLoader(Broken(), (32, 32, 3))
    it = iter(out)
    images, _ = next(it)
    assert images.shape == (1, 32, 32, 3) and not images.any()
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_apply_update_scales_the_learning_rate():
    from embeddingnet_tpu_torch.train.optim import get_optimizer
    from embeddingnet_tpu_torch.train.state import TrainState
    module = torch.nn.Linear(3, 1, bias=False)
    spec = get_optimizer("sgd", lambda count: 0.5 / (count + 1))
    state = TrainState.create(module, spec)
    state.plateau_scale = 0.1
    w0 = module.weight.detach().clone()
    module.weight.grad = torch.ones_like(module.weight)
    apply_update(state, spec)
    torch.testing.assert_close(module.weight.detach(), w0 - 0.05)
    assert state.step == 1
