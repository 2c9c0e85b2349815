"""Siamese training, the optimizers and the mining warm-up of the port
against the JAX package: ``SiameseModule`` (l1 and l2 heads) forward and
input gradient on converted weights, one siamese train step against the
JAX step run in float64 (the contrastive loss, the pair accuracy, the L2
penalty, and the encoder's two streams each updating the BatchNorm running
averages), ``radam`` and ``rms_prop`` against optax over 12 steps with the
plateau scale and the parameter EMA of the Trainer's chain, ``PairSampler``
drawing the JAX sampler's pairs, ``TripletNet``/``SiameseNet``, and the
warm-up's mode per epoch. The port alone: a tiny siamese ``Trainer`` whose
run resumed from its epoch-0 checkpoint ends bit for bit where an
uninterrupted run does, its CLI export, and a warm-up fit switching modes.

Small sizes: ResNet-18 at 32 px, 16-d embeddings, four pairs; one torch
thread (a module fixture), as the Trainer's files run."""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from embeddingnet_tpu.data import samplers as jsamplers  # noqa: E402
from embeddingnet_tpu.models import api as japi  # noqa: E402
from embeddingnet_tpu.models.registry import \
    SiameseModule as JSiameseModule  # noqa: E402
from embeddingnet_tpu.train import optim as joptim  # noqa: E402
from embeddingnet_tpu.train.loop import Trainer as JTrainer  # noqa: E402
from embeddingnet_tpu.train.state import TrainState as JTrainState  # noqa
from embeddingnet_tpu.train.steps import \
    make_siamese_train_step as j_make_step  # noqa: E402
from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.data import samplers  # noqa: E402
from embeddingnet_tpu_torch.models import api  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.models.registry import SiameseModule  # noqa
from embeddingnet_tpu_torch.train import optim  # noqa: E402
from embeddingnet_tpu_torch.train.loop import Trainer  # noqa: E402
from embeddingnet_tpu_torch.train.state import TrainState  # noqa: E402
from embeddingnet_tpu_torch.train.steps import (  # noqa: E402
    apply_update, make_siamese_train_step)

from _torch_port import jax_init, numpy_tree, randomize_bn  # noqa: E402

SIZE, D, PAIRS = 32, 16, 4
# the encoder in float32 against JAX's float32, another library's sums
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
# the port's float32 step against the float64 reference (as
# tests/test_torch_port_train.py): metrics and running statistics to 1e-5
# relative, each gradient to 1e-2 relative L2 (the float32 BatchNorm sums)
STEP_RTOL, GRAD_REL_L2 = 1e-5, 1e-2
# an optimizer's parameters and EMA after each of 12 float32 updates
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
REG_RULES = ((r".*dense_1.*kernel", 1e-3),)
CLI = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools", "train_torch.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the steps here are many small ops, which
    several threads per process only slow down when the suite runs its
    files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_siamese(distance_type):
    module = JSiameseModule(backbone_name="resnet18", encodings_len=D,
                            distance_type=distance_type)
    x0 = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    return module, randomize_bn(jax_init(module, (x0, x0)))


def _port_siamese(variables, distance_type):
    module = SiameseModule("resnet18", encodings_len=D,
                           distance_type=distance_type)
    module.load_state_dict(flax_to_torch(variables, module))
    return module


def _pairs(seed=0):
    rng = np.random.default_rng(seed)
    shape = (PAIRS, SIZE, SIZE, 3)
    return (rng.integers(0, 256, shape, np.uint8),
            rng.integers(0, 256, shape, np.uint8),
            np.array([1, 1, 0, 0], np.float32))


@pytest.mark.parametrize("distance_type", ["l1", "l2"])
def test_siamese_module_matches_jax(distance_type):
    """Eval-mode forward (distance and both embeddings) and the gradient
    of the summed distance with respect to both images."""
    jmodule, variables = _jax_siamese(distance_type)
    im1, im2, _ = _pairs()
    x1, x2 = (im.astype(np.float32) / 255.0 for im in (im1, im2))

    def f(a, b):
        return jmodule.apply(variables, (a, b), train=False)

    (jd, je1, je2) = f(jnp.asarray(x1), jnp.asarray(x2))
    jg1, jg2 = jax.grad(lambda a, b: jnp.sum(f(a, b)[0]), argnums=(0, 1))(
        jnp.asarray(x1), jnp.asarray(x2))

    module = _port_siamese(variables, distance_type).eval()
    t1 = torch.from_numpy(x1).requires_grad_()
    t2 = torch.from_numpy(x2).requires_grad_()
    d, e1, e2 = module((t1, t2))
    d.sum().backward()
    for got, want in ((d, jd), (e1, je1), (e2, je2)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    for got, want in ((t1.grad, jg1), (t2.grad, jg2)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL,
                                   atol=FWD_ATOL * np.abs(want).max())
    assert not any("classifier" in k for k in module.state_dict())


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_siamese_train_step_matches_jax_float64():
    """One l1 siamese step with SGD at learning rate 1 from converted
    weights: the JAX state moves by minus the gradient, which the port's
    gradient is held to; the loss and the accuracy; the BatchNorm running
    statistics after the encoder's two train-mode calls (two updates at
    momentum 0.99, the second on top of the first)."""
    jmodule, variables = _jax_siamese("l1")
    im1, im2, targets = _pairs(1)
    tx = optax.sgd(1.0)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        jstate = JTrainState.create(v64, tx)
        jstep = jax.jit(j_make_step(jmodule, tx, reg_rules=REG_RULES,
                                    compute_dtype=jnp.float64))
        jnew, jmetrics = jstep(jstate, jnp.asarray(im1), jnp.asarray(im2),
                               jnp.asarray(targets))
        jnew = jax.tree.map(np.asarray, jnew)
        jmetrics = {k: float(v) for k, v in jmetrics.items()}

    module = _port_siamese(variables, "l1")
    spec = optim.get_optimizer("sgd", 1.0)
    state = TrainState.create(module, spec)
    step = make_siamese_train_step(module, spec, reg_rules=REG_RULES)
    state, metrics = step(state, torch.from_numpy(im1),
                          torch.from_numpy(im2), torch.from_numpy(targets))
    assert state.step == 1
    for name in ("loss", "accuracy"):
        np.testing.assert_allclose(float(metrics[name]), jmetrics[name],
                                   rtol=STEP_RTOL, err_msg=name)

    stats = jnew.batch_stats
    start = flax_to_torch({"params": numpy_tree(v64["params"]),
                           "batch_stats": stats}, module)
    after = flax_to_torch({"params": jnew.params, "batch_stats": stats},
                          module)
    for name, p in module.named_parameters():
        want = (start[name] - after[name]).double().numpy()
        assert _rel_l2(p.grad.double().numpy(), want) < GRAD_REL_L2, name
    sd = module.state_dict()
    single = _port_siamese(variables, "l1").train()
    with torch.no_grad():         # one stream only: one update
        single.encoder(torch.from_numpy(im1).float() / 255.0)
    moved_twice = 0
    for key, value in after.items():
        if "running_" not in key:
            continue
        ref = value.double().numpy()
        np.testing.assert_allclose(
            sd[key].double().numpy(), ref, rtol=0,
            atol=STEP_RTOL * max(np.abs(ref).max(), 1e-30), err_msg=key)
        once = single.state_dict()[key].double().numpy()
        moved_twice += not np.allclose(once, ref, rtol=0,
                                       atol=1e-3 * np.abs(ref).max())
    assert moved_twice > 0      # one update is not what JAX did


def _tiny_params():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(5, 7, generator=g),
            "b": torch.randn(7, generator=g)}


@pytest.mark.parametrize("name", ["radam", "rms_prop"])
def test_optimizer_matches_optax_with_plateau_and_ema(name):
    """12 updates (radam: rho_t crosses optax's threshold of 4 at the 5th)
    from the same gradients at the schedule's rates: optax's chain
    (``scaled_by_plateau`` set to 0.5, ``track_param_ema(0.9)``) against
    the port's optimizer, plateau scale and EMA."""
    start = _tiny_params()
    rng = np.random.default_rng(4)
    grads = [{k: (rng.normal(size=v.shape) * 10 ** rng.uniform(-3, 0))
              .astype(np.float32) for k, v in start.items()}
             for _ in range(12)]
    schedule = joptim.step_decay_schedule(1e-2, 0.5, 1, 4)
    tx = optax.chain(joptim.scaled_by_plateau(
        joptim.get_optimizer(name, schedule)), joptim.track_param_ema(0.9))
    params = {k: jnp.asarray(v.numpy()) for k, v in start.items()}
    opt_state = joptim.set_plateau_scale(tx.init(params), 0.5)

    module = torch.nn.Module()
    for k, v in start.items():
        module.register_parameter(k, torch.nn.Parameter(v.clone()))
    spec = optim.get_optimizer(name, optim.step_decay_schedule(
        1e-2, 0.5, 1, 4))
    state = TrainState.create(module, spec, ema_decay=0.9)
    state.plateau_scale = 0.5
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in
                                        g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k])
        apply_update(state, spec)
        ema = joptim.get_ema_params(opt_state)
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), rtol=OPT_RTOL,
                                       atol=OPT_ATOL, err_msg=k)
            np.testing.assert_allclose(state.ema[k].numpy(),
                                       np.asarray(ema[k]), rtol=OPT_RTOL,
                                       atol=OPT_ATOL, err_msg=k)
    moved = max((p.detach() - start[k]).abs().max().item()
                for k, p in module.named_parameters())
    assert moved > 1e-3
    if name == "radam":
        rho = [optim.RAdam._scalars(t, 0.9, 0.999)[2] for t in (4, 5)]
        assert rho[0] < 4.0 <= rho[1] < 5.0
        inner = opt_state[0][0][0]
        for k, p in module.named_parameters():
            s = state.optimizer.state[p]
            assert s["step"] == 12 == int(inner.count)
            for got, want in ((s["exp_avg"], inner.mu[k]),
                              (s["exp_avg_sq"], inner.nu[k])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=OPT_RTOL,
                    atol=OPT_RTOL * np.abs(want).max(), err_msg=k)


def test_pair_sampler_matches_jax():
    files = {f"c{i}": [f"c{i}/{j}.png" for j in range(n)]
             for i, n in enumerate([5, 1, 7, 3, 0, 4])}
    names = sorted(files)
    for seed, batch in ((0, 8), (17, 5)):
        ours = samplers.PairSampler(files, names, batch_size=batch,
                                    seed=seed)
        ref = jsamplers.PairSampler(files, names, batch_size=batch,
                                    seed=seed)
        for _ in range(4):
            (l1, r1), t1 = ours.sample()
            (l2, r2), t2 = ref.sample()
            assert (l1, r1) == (l2, r2)
            np.testing.assert_array_equal(t1, t2)
            assert t1.dtype == np.float32


def _net_params(distance_type):
    return params_from_dict({
        "MODEL": {"input_shape": [SIZE, SIZE, 3], "encodings_len": D,
                  "mode": "siamese", "backbone_name": "resnet18",
                  "distance_type": distance_type, "backbone_weights": None},
        "GENERAL": {"seed": 5}})


@pytest.mark.parametrize("distance_type", ["l1", "l2"])
def test_triplet_and_siamese_nets_match_jax(distance_type):
    """``TripletNet.merged_forward`` and ``SiameseNet.pair_forward`` on the
    JAX nets' converted weights (the l1 head's too)."""
    params = _net_params(distance_type)
    jnet = japi.SiameseNet(params)
    jnet.variables = randomize_bn(jnet.variables)
    net = api.SiameseNet(params, device="cpu")
    net.module.load_state_dict(flax_to_torch(jnet.variables, net.module))
    if distance_type == "l1":
        head = numpy_tree(jnet.l1_head_variables)["params"]["output_siamese"]
        with torch.no_grad():
            net.l1_head.output_siamese.weight.copy_(
                torch.from_numpy(head["kernel"].T.copy()))
            net.l1_head.output_siamese.bias.copy_(
                torch.from_numpy(head["bias"].copy()))
    im1, im2, _ = _pairs(2)
    np.testing.assert_allclose(net.pair_forward(im1, im2),
                               jnet.pair_forward(im1, im2), rtol=FWD_RTOL,
                               atol=FWD_ATOL)

    jtrip = japi.TripletNet(params)
    jtrip.variables = jnet.variables
    trip = api.TripletNet(params, device="cpu")
    trip.module.load_state_dict(net.module.state_dict())
    got = trip.merged_forward(im1, im2, im1[::-1].copy())
    want = jtrip.merged_forward(im1, im2, im1[::-1].copy())
    assert got.shape == (PAIRS, 3 * D)
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)


@pytest.mark.parametrize("mode", ["triplet", "siamese"])
def test_mining_mode_for_epoch_matches_jax(mode):
    """The stage of each epoch across a 2-epoch warm-up, as the JAX
    Trainer's ``_mining_mode_for_epoch`` decides it (siamese mode mines
    nothing and ignores the warm-up)."""
    params = params_from_dict({
        "MODEL": {"mode": mode, "backbone_name": "resnet18"},
        "GENERATOR": {"negatives_selection_mode": "batch_hard"},
        "TRAIN": {"mining_warmup_epochs": 2,
                  "mining_warmup_mode": "semihard"}})
    fake = types.SimpleNamespace(mode=mode, params=params)
    got = [Trainer._mining_mode_for_epoch(fake, e) for e in range(5)]
    want = [JTrainer._mining_mode_for_epoch(fake, e) for e in range(5)]
    assert got == want
    if mode == "triplet":
        assert got == ["semihard"] * 2 + ["batch_hard"] * 3


# -- the port alone: Trainer and CLI ------------------------------------------


def _cfg(dataset, work_dir, **sections):
    cfg = {
        "MODEL": {"backbone_name": "resnet18", "input_shape": [SIZE, SIZE, 3],
                  "encodings_len": D, "backbone_weights": None,
                  "mode": "siamese", "distance_type": "l2",
                  "embeddings_normalization": True},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.2},
        "GENERATOR": {"batch_size": PAIRS, "n_batches": 2,
                      "n_batches_val": 1, "margin": 1.0,
                      "augmentations": "default"},
        "TRAIN": {"n_epochs": 2, "optimizer": "radam",
                  "learning_rate": 5e-4, "plot_history": False},
        "GENERAL": {"work_dir": str(work_dir), "project_name": "run",
                    "seed": 3},
        "PERFORMANCE": {"compute_dtype": "float32"},
    }
    for section, values in sections.items():
        cfg[section] = {**cfg.get(section, {}), **values}
    return cfg


def _trainer(cfg, log=None):
    params = params_from_dict(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    return Trainer(params, loader, device="cpu",
                   log_fn=log if log is not None else (lambda *a: None))


def _state(trainer):
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


def test_siamese_fit_resume_is_bit_exact(tiny_dataset, tmp_path):
    """A siamese fit (PairSampler train and val loaders, radam, the
    ``default`` augmentation) resumed from its epoch-0 checkpoint ends bit
    for bit where the uninterrupted fit does."""
    whole = _trainer(_cfg(tiny_dataset, tmp_path / "a"))
    history = whole.fit(2)
    assert set(history.history) >= {"loss", "accuracy", "val_loss",
                                    "val_accuracy", "images_per_sec"}
    assert all(np.isfinite(history.history["loss"]))
    assert all(0.0 <= a <= 1.0 for a in history.history["val_accuracy"])

    first = _trainer(_cfg(tiny_dataset, tmp_path / "b"))
    first.fit(1)
    resumed = _trainer(_cfg(tiny_dataset, tmp_path / "b")).resume()
    assert resumed.start_epoch == 1
    again = resumed.fit(2)
    _assert_equal(_state(resumed), _state(whole))
    assert again.history["loss"] == history.history["loss"][1:]
    assert isinstance(resumed.state.optimizer, optim.RAdam)


def test_siamese_cli_exports_the_encoder(tiny_dataset, tmp_path):
    """The CLI fits a siamese config and exports its encoder (without the
    distance head), which encodes as the Trainer's encoder does."""
    import runpy
    yaml = pytest.importorskip("yaml")
    cfg = _cfg(tiny_dataset, tmp_path, TRAIN={"n_epochs": 1},
               ENCODINGS={"save_encodings": True,
                          "max_num_samples_of_each_class": 2})
    path = tmp_path / "siamese.yml"
    path.write_text(yaml.safe_dump(cfg))
    main = runpy.run_path(CLI)["main"]
    trainer, net = main([str(path), "--device", "cpu"])
    images = np.random.default_rng(0).integers(0, 256, (3, SIZE, SIZE, 3),
                                               np.uint8)
    reloaded = api.EmbeddingNet(params_from_dict(cfg), device="cpu")
    reloaded.load_model(str(tmp_path / "run" / "base_model.pt"))
    with torch.no_grad():
        want = trainer.encoder.eval()(
            torch.from_numpy(images).float() / 255.0).numpy()
    np.testing.assert_allclose(reloaded.encode(images), want, rtol=1e-5,
                               atol=1e-6)
    assert (tmp_path / "run" / "encodings" / "encodings.pkl").exists()


def test_warmup_fit_switches_mode_and_resumes_in_stage(tiny_dataset,
                                                       tmp_path):
    """A triplet fit with one semihard warm-up epoch before batch_hard logs
    the switch at epoch 1 and mines in each stage; a run resumed from epoch
    0 starts in the warm-up mode and switches at the same epoch."""
    cfg = _cfg(tiny_dataset, tmp_path,
               MODEL={"mode": "triplet"},
               GENERATOR={"negatives_selection_mode": "batch_hard",
                          "k_classes": 3, "k_samples": 3,
                          "augmentations": None},
               TRAIN={"mining_warmup_epochs": 1,
                      "mining_warmup_mode": "semihard", "optimizer": "adam"})
    lines = []
    trainer = _trainer(cfg, log=lines.append)
    assert trainer._mining_mode == "semihard"
    history = trainer.fit(2)
    assert trainer._mining_mode == "batch_hard"
    switch = [l for l in lines if "mining mode" in l]
    assert switch == ["epoch 1: mining mode semihard -> batch_hard "
                      "(TRAIN.mining_warmup_epochs=1)"]
    assert all(np.isfinite(history.history["loss"]))
    assert all(n >= 0 for n in history.history["n_triplets"])

    lines.clear()
    resumed = _trainer(cfg, log=lines.append).resume(0)
    assert resumed._mining_mode == "semihard"
    resumed.fit(2)
    assert resumed._mining_mode == "batch_hard"
    assert any("semihard -> batch_hard" in l for l in lines)
    _assert_equal(_state(resumed), _state(trainer))
