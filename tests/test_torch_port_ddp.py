"""The port's data-parallel training on the CPU: 2 gloo ranks (spawned with
``torch.multiprocessing``, one torch thread each, joined through a
``file://`` store under the test's temp dir) against the port's
one-process step and Trainer on the same global batch.

Steps (ResNet-18 at 32x32, 16-d embeddings, SGD; the global batch drawn
from numpy seeds, the draws from generators seeded alike): the first
step's loss, gradients, global BatchNorm statistics and parameters within
1e-5 of the largest entry for ``batch_all`` (with the ``default``
augmentation), ``batch_hard``, ``semihard`` (global draws), the siamese
and the arcface step and ``simple2`` with its L2 rules (the penalty enters
once); ``batch_all`` and ``batch_hard`` over 4 steps within 1e-3; the
ranks bit-identical after every step. The modules are float64 (the miners
and the losses compute in f32, as the steps cast the embeddings): in f32
the one-process step is itself as far as 1e-2 (arcface, a conv gradient)
and 3e-2 (the loss after 4 steps, where a triplet crosses its margin) from
its own run with the parameters scaled by 1 + 3e-7, so an f32 comparison
could not tell a fault from rounding; here the measured gaps are under
2e-7 on the first step and 5e-6 after 4. The Trainer: a 2-rank fit(1), a
resume, fit(2) against the one-process fit of the same config, rank 0
alone writing, the recall through the sharded kNN; and
``configs/batch4096_sharded.yml`` cut to a tiny width and batch builds and
trains one step on 2 ranks.

The workers live here, in a module that imports no JAX, so that a spawned
rank starts quickly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.models.registry import (  # noqa: E402
    ArcFaceModule, EmbeddingModule, SiameseModule)
from embeddingnet_tpu_torch.ops.augment import get_aug  # noqa: E402
from embeddingnet_tpu_torch.parallel.collectives import (  # noqa: E402
    DataParallel, state_digest)
from embeddingnet_tpu_torch.train import steps  # noqa: E402
from embeddingnet_tpu_torch.train.optim import (get_optimizer,  # noqa: E402
                                                reg_rules_for)
from embeddingnet_tpu_torch.train.state import TrainState  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SHAPE = (32, 32, 3)
FIRST_STEP_TOL = 1e-5     # of the largest entry of each tensor
MULTI_STEP_TOL = 1e-3
# the fit's metrics: relative MULTI_STEP_TOL, and this much absolute for a
# value near 0 (a val loss of 0.058 lands 6.5e-5 off after 6 steps)
FIT_ATOL = 1e-4
# the fit's final state, each tensor in norm: at B = 8 (4 rows a rank) the
# one-process run doubles a perturbation every step or so, and the f32
# miner's sums in another order seed one of 1e-7; after 6 steps the stem's
# BatchNorm bias (entries up to 0.015) is 1.4e-3 off in norm
FIT_STATE_TOL = 1e-2
STEPS = 4


# -- spawning ranks -----------------------------------------------------------


def _entry(rank, world, store, fn, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        torch.save(result, f"{out}.rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world, directory, *args):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns each
    rank's result (anything ``torch.save`` takes), in rank order."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    tag = os.path.join(directory, f"{fn.__name__}-{world}")
    mp.spawn(_entry, args=(world, tag + ".store", fn, tag, args),
             nprocs=world, join=True)
    return [torch.load(f"{tag}.rank{r}.pt", weights_only=False)
            for r in range(world)]


# -- the step cases -----------------------------------------------------------


def _images(seed, b):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b,) + SHAPE,
                                         dtype=np.uint8))


def _pk_labels(k_classes, k_samples):
    return torch.from_numpy(np.repeat(np.arange(k_classes),
                                      k_samples).astype(np.int32))


def _narrow(encoder):
    """ResNet-18 with 8 filters in its first stage (8 to 64 channels) in
    place of ``encoder``'s backbone, and a head to match."""
    from embeddingnet_tpu_torch.models.heads import EmbeddingHead
    from embeddingnet_tpu_torch.models.resnet import resnet18
    head = encoder.head
    encoder.backbone = resnet18(num_filters=8)
    encoder.head = EmbeddingHead(encoder.backbone.out_channels,
                                 head.dense_2.weight.shape[0],
                                 head.embeddings_normalization)
    return encoder


def _case(name):
    """``(module, optimizer spec, step factory(parallel), batches)``: the
    batches a list of global ``(args...)`` tuples, rows first."""
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(7)
    sgd = get_optimizer("sgd", 0.05)
    n_steps = STEPS if name.endswith("_steps") else 1
    mode = name.replace("_steps", "")
    module, spec, factory, batches = _build_case(name, gen, sgd, n_steps,
                                                 mode)
    module.double()
    return module, spec, factory, batches


def _build_case(name, gen, sgd, n_steps, mode):
    if name == "siamese":
        module = SiameseModule("resnet18", encodings_len=16,
                               distance_type="l2", input_shape=SHAPE)
        _narrow(module.encoder)
        module.reset_parameters(gen)
        targets = torch.tensor([1.0] * 4 + [0.0] * 4)
        batches = [(_images(1, 8), _images(2, 8), targets)]
        return module, sgd, lambda dp: steps.make_siamese_train_step(
            module, sgd, parallel=dp), batches
    if name == "arcface":
        module = ArcFaceModule("resnet18", encodings_len=16, n_classes=4,
                               input_shape=SHAPE)
        _narrow(module.encoder)
        module.reset_parameters(gen)
        batches = [(_images(3, 8), torch.tensor([0, 1, 2, 3, 3, 2, 1, 0]))]
        return module, sgd, lambda dp: steps.make_arcface_train_step(
            module, sgd, n_classes=4, parallel=dp), batches
    backbone = "simple2" if name == "simple2_l2" else "resnet18"
    module = EmbeddingModule(backbone, encodings_len=16, input_shape=SHAPE)
    if backbone == "resnet18":
        _narrow(module)
    module.reset_parameters(gen)
    spec = sgd
    mode = "batch_all" if name == "simple2_l2" else mode
    batches = [(_images(10 + i, 16), _pk_labels(4, 4))
               for i in range(n_steps)]
    kw = dict(mode=mode, max_positives=3,
              reg_rules=reg_rules_for(backbone),
              augment_fn=get_aug("default") if name == "batch_all" else None)
    return module, spec, lambda dp: steps.make_triplet_train_step(
        module, spec, parallel=dp, **kw), batches


CASES = ("batch_all", "batch_hard", "semihard", "siamese", "arcface",
         "simple2_l2", "batch_all_steps", "batch_hard_steps")


def _run_case(name, dp):
    """Each step's metrics, the final state, the last gradients and the
    state digest after every step."""
    module, spec, factory, batches = _case(name)
    state = TrainState.create(module, spec,
                              generator=torch.Generator().manual_seed(5))
    step = factory(dp)
    metrics, digests = [], []
    for batch in batches:
        if dp is not None:
            lo, hi = dp.rows(batch[0].shape[0])
            batch = tuple(x[lo:hi] for x in batch)
        _, m = step(state, *batch)
        metrics.append({k: v.detach().clone() for k, v in m.items()})
        digests.append(state_digest(module))
    return {"metrics": metrics, "digests": digests,
            "state": {k: v.clone() for k, v in module.state_dict().items()},
            "grads": {n: p.grad.clone() for n, p in
                      module.named_parameters()}}


def _step_worker(rank, world, names):
    dp = DataParallel.current()
    return {name: _run_case(name, dp) for name in names}


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = spawn(_step_worker, WORLD, tmp_path_factory.mktemp("ddp"),
                      CASES)
        alone = {name: _run_case(name, None) for name in CASES}
    finally:
        torch.set_num_threads(n)
    return ranks, alone


def _close(got, want, tol, what):
    scale = max(float(want.detach().abs().max()), 1e-30) if want.numel() \
        else 1.0
    err = float((got.double() - want.double()).abs().max()) if \
        want.numel() else 0.0
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("name", CASES[:6])
def test_first_step_matches_the_one_process_step(step_runs, name):
    ranks, alone = step_runs
    want = alone[name]
    for r, run in enumerate(ranks):
        got = run[name]
        for k, v in want["metrics"][0].items():
            if v.is_floating_point():
                _close(got["metrics"][0][k], v, FIRST_STEP_TOL, f"{k}")
            else:
                assert int(got["metrics"][0][k]) == int(v), k
        for k, v in want["grads"].items():
            _close(got["grads"][k], v, FIRST_STEP_TOL, f"grad {k}")
        # parameters and the global BatchNorm statistics
        for k, v in want["state"].items():
            if v.is_floating_point():
                _close(got["state"][k], v, FIRST_STEP_TOL, f"state {k}")
            else:
                assert torch.equal(got["state"][k], v), k
    a, b = (ranks[r][name]["digests"] for r in range(WORLD))
    assert [d.tolist() for d in a] == [d.tolist() for d in b]


@pytest.mark.parametrize("name", CASES[6:])
def test_four_steps_stay_with_the_one_process_run(step_runs, name):
    ranks, alone = step_runs
    want = alone[name]
    for run in ranks:
        got = run[name]
        for s in range(STEPS):
            _close(got["metrics"][s]["loss"], want["metrics"][s]["loss"],
                   MULTI_STEP_TOL, f"loss of step {s}")
        for k, v in want["state"].items():
            if v.is_floating_point():
                _close(got["state"][k], v, MULTI_STEP_TOL, f"state {k}")
    # bit-identical ranks after every step
    a, b = (ranks[r][name]["digests"] for r in range(WORLD))
    assert [d.tolist() for d in a] == [d.tolist() for d in b]


def test_l2_penalty_enters_once(step_runs):
    """simple2 carries kernel regularisers: with the penalty on every rank
    the summed gradient would hold it twice; the one-process step's
    gradient is matched (above), and the penalty's part is not small."""
    from embeddingnet_tpu_torch.train.optim import l2_penalty
    module, *_ = _case("simple2_l2")
    pen = l2_penalty(module.named_parameters(), reg_rules_for("simple2"))
    pen.backward()
    ranks, alone = step_runs
    got = ranks[0]["simple2_l2"]["grads"]
    want = alone["simple2_l2"]["grads"]
    name = "backbone.embedding_dense.weight"
    g_pen = dict(module.named_parameters())[name].grad
    # a second penalty would move the gradient 10 tolerances at least
    bar = FIRST_STEP_TOL * float(want[name].abs().max())
    assert float(g_pen.abs().max()) > 10 * bar
    _close(got[name], want[name], FIRST_STEP_TOL, name)
    assert float((got[name] - want[name] - g_pen).abs().max()) > bar


# -- the Trainer --------------------------------------------------------------


def _cfg(dataset, work_dir, **sections):
    cfg = {
        "MODEL": {"backbone_name": "resnet18", "input_shape": [32, 32, 3],
                  "encodings_len": 16, "backbone_weights": None,
                  "mode": "triplet", "embeddings_normalization": True},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.2},
        "GENERATOR": {"negatives_selection_mode": "batch_hard",
                      "k_classes": 4, "k_samples": 2, "batch_size": 6,
                      "n_batches": 3, "n_batches_val": 2},
        "TRAIN": {"n_epochs": 2, "eval_recall_every": 1, "optimizer": "sgd",
                  "learning_rate": 0.01, "plot_history": False,
                  "early_stopping_patience": 1, "plateau_patience": 1},
        "GENERAL": {"work_dir": str(work_dir), "project_name": "run",
                    "seed": 3},
        "MESH": {"data": -1},
        "PERFORMANCE": {"compute_dtype": "float32", "bn_momentum": 0.9,
                        "async_checkpoint": True},
    }
    for section, values in sections.items():
        cfg[section] = {**cfg.get(section, {}), **values}
    return cfg


def _trainer(cfg):
    from embeddingnet_tpu_torch.train.loop import Trainer
    params = params_from_dict(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    return Trainer(params, loader, device="cpu", log_fn=lambda *a: None)


def _trainer64(cfg):
    """A Trainer whose module is float64 and computes in float64 (as the
    steps above)."""
    trainer = _trainer(cfg)
    trainer.module.double()
    for m in trainer.module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = None
    return trainer


def _fit_resume_fit(cfg):
    """fit(1), a second Trainer resumed from epoch 0, its fit(2): the
    histories and the final module state."""
    first = _trainer64(cfg)
    h1 = first.fit(1).history
    second = _trainer64(cfg)
    second.resume(0)
    h2 = second.fit(2).history
    state = {k: v.clone() for k, v in second.module.state_dict().items()}
    return {"h1": dict(h1), "h2": dict(h2), "state": state,
            "plateau": second.plateau.state_dict(),
            "early_stop": second.early_stop.state_dict(),
            "epochs": second.ckpt_mgr.epochs()}


def _trainer_worker(rank, world, dataset, work_dir, sharded_dir):
    out = _fit_resume_fit(_cfg(dataset, work_dir))
    out["digest"] = state_digest(_trainer(_cfg(dataset, work_dir)).module)
    out["sharded"] = _sharded_config_run(dataset, sharded_dir)
    return out


def _sharded_config(dataset, work_dir, **sections):
    """``configs/batch4096_sharded.yml`` cut to a tiny batch and image
    (ResNet-50, bf16, remat, batch_all, ``MESH.data: -1`` as it stands):
    P-K 4 x 4 at 32x32, one step and one val batch of 8 triplets."""
    import yaml
    with open(os.path.join(ROOT, "configs", "batch4096_sharded.yml")) as f:
        cfg = yaml.safe_load(f)
    cuts = {"MODEL": {"input_shape": [32, 32, 3]},
            "DATALOADER": {"dataset_path": dataset},
            "GENERATOR": {"k_classes": 4, "k_samples": 4, "batch_size": 8,
                          "n_batches": 1, "n_batches_val": 1},
            "TRAIN": {"n_epochs": 1, "plot_history": False},
            "GENERAL": {"work_dir": str(work_dir), "seed": 3}}
    for section, values in {**cuts, **sections}.items():
        cfg[section] = {**cfg.get(section, {}), **values}
    return cfg


def _sharded_config_run(dataset, work_dir):
    import warnings
    out = {}
    for label, sections, error in (
            ("mesh_data_1", {"MESH": {"data": 1}}, ValueError),
            ("mesh_2x2", {"MESH": {"data": 2, "model": 2}}, ValueError)):
        try:
            _trainer(_sharded_config(dataset, work_dir, **sections))
        except error as e:
            out[label] = str(e)
    # MESH.model: 2 over the 2 ranks: one data row, ResNet-50 whole on
    # both (no rule matches a CNN)
    grid = _trainer(_sharded_config(dataset, work_dir,
                                    MESH={"data": -1, "model": 2}))
    out["mesh_model_2"] = (tuple(grid.grid[:2]), grid.parallel.size,
                           getattr(grid.module, "tp_shards", None))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = _trainer(_sharded_config(dataset, work_dir))
    # the triplet step rematerialises: no warning that remat is ignored
    out["remat"] = trainer.params.performance.remat and not any(
        "remat" in str(w.message) for w in caught)
    history = trainer.fit(1).history
    out["loss"] = history["loss"][0]
    out["dtype"] = str(trainer.compute_dtype)
    return out


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp("ddp_trainer")
    dataset = root / "dataset"
    rng = np.random.default_rng(0)
    for cls in range(6):
        d = dataset / f"class_{cls}"
        d.mkdir(parents=True)
        base = rng.integers(0, 256, (1, 1, 3))
        for i in range(10):
            img = np.clip(base + rng.normal(0, 20, (32, 32, 3)), 0,
                          255).astype(np.uint8)
            cv2.imwrite(str(d / f"{i}.png"), img)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = spawn(_trainer_worker, WORLD, root / "spawn", str(dataset),
                      str(root / "ranks"), str(root / "sharded_run"))
        alone = _fit_resume_fit(_cfg(str(dataset), root / "alone"))
    finally:
        torch.set_num_threads(n)
    return ranks, alone, root


def test_trainer_fit_resume_fit_matches_one_process(trainer_runs):
    ranks, alone, _ = trainer_runs
    for run in ranks:
        for h in ("h1", "h2"):
            assert run[h].keys() == alone[h].keys()
            for key, values in alone[h].items():
                if key.endswith("_s") or key == "images_per_sec":
                    continue
                np.testing.assert_allclose(run[h][key], values,
                                           rtol=MULTI_STEP_TOL,
                                           atol=FIT_ATOL, err_msg=key)
        for k, v in alone["state"].items():
            # each tensor to FIT_STATE_TOL in norm
            if v.is_floating_point() and v.norm() > 0:
                gap = float((run["state"][k] - v).norm() / v.norm())
                assert gap <= FIT_STATE_TOL, (k, gap)
        assert run["epochs"] == alone["epochs"]
    # one model: identical state, histories and callback state on every rank
    a, b = ranks
    assert a["h2"] == b["h2"] and a["plateau"] == b["plateau"]
    assert a["early_stop"] == b["early_stop"]
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    assert torch.equal(a["digest"], b["digest"])


def test_trainer_recall_goes_through_the_sharded_knn(trainer_runs):
    ranks, alone, _ = trainer_runs
    for run in ranks:
        for key in ("val_recall1", "val_recall5"):
            assert run["h1"][key] == alone["h1"][key], key


def test_only_rank_zero_writes(trainer_runs):
    _, _, root = trainer_runs
    run = root / "ranks" / "run"
    weights = run / "weights"
    for entry in os.listdir(weights):
        assert not entry.startswith(".tmp"), entry
        assert sorted(os.listdir(weights / entry)) == ["host.json",
                                                       "state.pt"]
    lines = (run / "tf_log" / "train_metrics.jsonl").read_text().splitlines()
    # rank 0's lines alone: fit(1)'s epoch and the resumed fit's second
    assert len(lines) == 2


def test_sharded_config_trains_on_two_ranks(trainer_runs):
    """``configs/batch4096_sharded.yml`` (``MESH.data: -1``, remat, bf16)
    builds a Trainer and trains on 2 gloo ranks; ``MESH.data: 1`` and a
    2x2 mesh under a launch of 2 ranks raise, as in JAX; ``MESH.model: 2``
    makes one data row of a model group of 2, which splits nothing of a
    ResNet."""
    ranks = [run["sharded"] for run in trainer_runs[0]]
    for out in ranks:
        assert "MESH.data: -1" in out["mesh_data_1"]
        assert "a world of 2 ranks" in out["mesh_2x2"]
        assert out["mesh_model_2"] == ((1, 2), 1, None)
        assert out["remat"] and out["dtype"] == "torch.bfloat16"
        assert np.isfinite(out["loss"])
    assert ranks[0]["loss"] == ranks[1]["loss"]
