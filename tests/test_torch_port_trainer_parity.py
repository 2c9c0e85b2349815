"""The Trainer's host code and its optimizer chain against the JAX package:
``TripletSampler`` and the per-epoch ``PKSampler`` seeds, ``BatchLoader``
(cv2 on both sides, with and without ``DecodeCache``), the callbacks,
``triplet_hinge``, ``create_save_folders``, the freeze mask, one
plateau-scaled Adam update with EMA and a frozen backbone against optax's
chain, and the val loss of the eval step on converted weights against
``make_triplet_eval_step``.

Both ``BatchLoader``s are built with ``backend="python"``: on a host with
more than one core they would pick their native decoders, which differ
from cv2 by up to one gray level (``ROADMAP.md`` fault F1)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from embeddingnet_tpu.data import ENDataLoader as JENDataLoader  # noqa
from embeddingnet_tpu.data import samplers as jsamplers  # noqa: E402
from embeddingnet_tpu.data.pipeline import BatchLoader as JBatchLoader  # noqa
from embeddingnet_tpu.data.pipeline import DecodeCache as JDecodeCache  # noqa
from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu.models.registry import \
    backbone_param_mask as j_mask  # noqa: E402
from embeddingnet_tpu.ops.losses import triplet_hinge as j_hinge  # noqa
from embeddingnet_tpu.train import callbacks as jcb  # noqa: E402
from embeddingnet_tpu.train import checkpoint as jckpt  # noqa: E402
from embeddingnet_tpu.train import optim as joptim  # noqa: E402
from embeddingnet_tpu.train.state import TrainState as JTrainState  # noqa
from embeddingnet_tpu.train.steps import \
    make_triplet_eval_step as j_eval_step  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.data import samplers  # noqa: E402
from embeddingnet_tpu_torch.data.pipeline import (BatchLoader,  # noqa: E402
                                                  DecodeCache)
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.models.registry import (  # noqa: E402
    EmbeddingModule, backbone_param_mask)
from embeddingnet_tpu_torch.ops.losses import triplet_hinge  # noqa: E402
from embeddingnet_tpu_torch.train import callbacks  # noqa: E402
from embeddingnet_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from embeddingnet_tpu_torch.train import optim  # noqa: E402
from embeddingnet_tpu_torch.train.state import TrainState  # noqa: E402
from embeddingnet_tpu_torch.train.steps import (  # noqa: E402
    apply_update, make_triplet_eval_step)

from _torch_port import jax_init, numpy_tree, randomize_bn  # noqa: E402

SEED = 3
SIZE, D = 32, 32
# one Adam update scaled by the plateau (0.1) with EMA (0.9), float32 on
# both sides: the parameters and the EMA to 1e-6
UPDATE_ATOL = 1e-6
# the val loss: the same float32 forward in another library, 1e-5 relative
VAL_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the steps here are many small ops, which
    several threads per process only slow down when the suite runs its
    files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def loaders(tiny_dataset):
    return (ENDataLoader(tiny_dataset, val_ratio=0.2),
            JENDataLoader(tiny_dataset, val_ratio=0.2))


def _draws(sampler, n=3):
    out = []
    for _ in range(n):
        paths, labels = sampler.sample()
        out.append((paths, labels.tolist()))
    return out


@pytest.mark.parametrize("epoch", [0, 1, 5])
def test_pk_sampler_epoch_seeds(loaders, epoch):
    """The Trainer's per-epoch seed ``GENERAL.seed + 9973 * epoch`` gives the
    JAX sampler's batches."""
    tl, jl = loaders
    seed = SEED + 9973 * epoch
    got = samplers.PKSampler(tl.train_data, tl.class_names, 3, 3, seed)
    want = jsamplers.PKSampler(jl.train_data, jl.class_names, 3, 3, seed)
    assert _draws(got) == _draws(want)


@pytest.mark.parametrize("data", ["val", "train"])
def test_triplet_sampler(loaders, data):
    """The val epoch's sampler, seed ``GENERAL.seed + 1000``."""
    tl, jl = loaders
    got = samplers.TripletSampler(getattr(tl, f"{data}_data"),
                                  tl.class_names, 6, SEED + 1000)
    want = jsamplers.TripletSampler(getattr(jl, f"{data}_data"),
                                    jl.class_names, 6, SEED + 1000)
    assert _draws(got) == _draws(want)


def test_trainer_loaders_draw_the_jax_seeds(loaders, tmp_path):
    """The port's Trainer builds its epoch loaders with the JAX Trainer's
    seeds and batch counts."""
    from embeddingnet_tpu_torch.config import params_from_dict
    from embeddingnet_tpu_torch.train.loop import Trainer
    tl, jl = loaders
    params = params_from_dict({
        "MODEL": {"backbone_name": "resnet18", "input_shape": [SIZE, SIZE, 3],
                  "encodings_len": D, "backbone_weights": None},
        "GENERATOR": {"negatives_selection_mode": "batch_all",
                      "k_classes": 3, "k_samples": 3, "batch_size": 6,
                      "n_batches": 4, "n_batches_val": 2},
        "GENERAL": {"work_dir": str(tmp_path), "seed": SEED},
        "PERFORMANCE": {"compute_dtype": "float32"}})
    trainer = Trainer(params, tl, device="cpu")
    trainer._current_epoch = 2
    train, val = trainer._train_loader(), trainer._val_loader()
    assert (train.n_batches, val.n_batches) == (4, 2)
    assert _draws(train.sampler) == _draws(jsamplers.PKSampler(
        jl.train_data, jl.class_names, 3, 3, SEED + 9973 * 2))
    assert _draws(val.sampler) == _draws(jsamplers.TripletSampler(
        jl.val_data, jl.class_names, 6, SEED + 1000))


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("kind", ["pk", "triplet"])
def test_batch_loader_matches(loaders, kind, cached):
    """Two epochs through one cache: the second reads every hit from it."""
    tl, jl = loaders
    t_cache = DecodeCache(16) if cached else None
    j_cache = JDecodeCache(16) if cached else None
    for _ in range(2):
        if kind == "pk":
            ts = samplers.PKSampler(tl.train_data, tl.class_names, 3, 3, 7)
            js = jsamplers.PKSampler(jl.train_data, jl.class_names, 3, 3, 7)
        else:
            ts = samplers.TripletSampler(tl.val_data, tl.class_names, 6, 7)
            js = jsamplers.TripletSampler(jl.val_data, jl.class_names, 6, 7)
        got = list(BatchLoader(ts, (SIZE, SIZE, 3), n_batches=3,
                               backend="python", cache=t_cache))
        want = list(JBatchLoader(js, (SIZE, SIZE, 3), n_batches=3,
                                 backend="python", cache=j_cache))
        assert len(got) == len(want) == 3
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gl, wl)
            for g, w in zip(gi if kind == "triplet" else [gi],
                            wi if kind == "triplet" else [wi]):
                assert g.dtype == w.dtype == np.uint8
                np.testing.assert_array_equal(g, w)
    if cached:
        assert t_cache._bytes == j_cache._bytes > 0
        assert t_cache._data.keys() == j_cache._data.keys()


def _metric_sequence(seed, n=30):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = {"loss": float(1.0 / (i + 1) + rng.normal(0, 0.05)),
             "val_loss": float(0.8 / (i + 1) + rng.normal(0, 0.08)),
             "val_recall1": float(min(1.0, i / n + rng.normal(0, 0.1)))}
        if rng.random() < 0.15:
            del m["val_recall1"]
        out.append(m)
    return out


@pytest.mark.parametrize("monitor", ["val_loss", "val_recall1", "loss"])
@pytest.mark.parametrize("patience", [1, 3])
def test_callbacks_decide_alike(monitor, patience):
    assert callbacks.monitor_mode(monitor) == jcb.monitor_mode(monitor)
    pair = [(callbacks.ReduceLROnPlateau(monitor, patience=patience,
                                         verbose=False),
             jcb.ReduceLROnPlateau(monitor, patience=patience,
                                   verbose=False)),
            (callbacks.EarlyStopping(monitor, patience=patience + 1,
                                     verbose=False),
             jcb.EarlyStopping(monitor, patience=patience + 1,
                               verbose=False))]
    th, jh = callbacks.History(), jcb.History()
    for metrics in _metric_sequence(patience):
        for mine, ref in pair:
            assert mine.update(metrics) == ref.update(metrics)
            assert mine.state_dict() == ref.state_dict()
        th.append(metrics)
        jh.append(metrics)
    assert th.history == jh.history
    assert th.last("val_loss") == jh.last("val_loss")
    # a state dict carried to a fresh callback decides alike from there
    mine = callbacks.ReduceLROnPlateau(monitor, patience=patience,
                                       verbose=False)
    mine.load_state_dict(pair[0][1].state_dict())
    assert mine.update({monitor: -1.0}) == pair[0][1].update(
        {monitor: -1.0})


def test_triplet_hinge_matches():
    rng = np.random.default_rng(0)
    a, p, n = (rng.normal(size=(64, 16)).astype(np.float32)
               for _ in range(3))
    for margin in (0.2, 0.5, 5.0):
        got = triplet_hinge(*map(torch.from_numpy, (a, p, n)), margin)
        want = np.asarray(j_hinge(jnp.asarray(a), jnp.asarray(p),
                                  jnp.asarray(n), margin))
        # float32 sums of 16 squares in another order, hinges up to about
        # 30 (one ulp 2e-6): to a few ulps
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_create_save_folders_and_encodings_pickle_match(tmp_path):
    general = {"work_dir": str(tmp_path / "w"), "project_name": "proj"}
    got = ckpt.create_save_folders(general)
    assert got == jckpt.create_save_folders(general)
    assert all((tmp_path / "w" / "proj").joinpath(
        p.split("proj/")[1]).is_dir() for p in got.values() if "proj/" in p)
    db = {"paths": ["a.png"], "labels": ["c"],
          "encodings": np.ones((1, 4), np.float32)}
    mine = ckpt.save_encodings_pickle(db, str(tmp_path / "t"))
    ref = jckpt.save_encodings_pickle(db, str(tmp_path / "j"))
    assert mine.endswith("encodings.pkl")
    with open(mine, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


@pytest.fixture(scope="module")
def jax_resnet():
    """The JAX ResNet-18 module and its variables, BatchNorm randomised,
    built once for the file."""
    module = JEmbeddingModule(backbone_name="resnet18", encodings_len=D)
    return module, randomize_bn(jax_init(
        module, jnp.zeros((1, SIZE, SIZE, 3)), method="init_all"))


def _port_module(variables, dtype=None):
    module = EmbeddingModule("resnet18", encodings_len=D, dtype=dtype)
    module.load_state_dict(flax_to_torch(variables, module))
    return module


@pytest.mark.parametrize("freeze", [False, "all", "except_last_2"])
def test_backbone_param_mask_matches(jax_resnet, freeze):
    _, variables = jax_resnet
    module = _port_module(variables)
    want = flax_to_torch({"params": jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        j_mask(variables["params"], freeze), variables["params"]),
        "batch_stats": variables["batch_stats"]}, module)
    got = backbone_param_mask(module, freeze)
    assert got == {n: bool(want[n].all()) for n in got}
    if freeze:
        assert not all(got.values()) and any(got.values())


def test_plateau_scaled_adam_with_ema_and_frozen_backbone_matches_optax(
        jax_resnet):
    """Two updates from the same gradients: optax's chain (masked Adam on a
    step-decay schedule, the plateau scale set to 0.1, the parameter EMA at
    0.9) against the port's optimizer, freeze mask and EMA."""
    _, variables = jax_resnet
    module = _port_module(variables)
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), numpy_tree(variables["params"])) for _ in range(2)]
    schedule = joptim.step_decay_schedule(1e-3, 0.5, 1, 1)
    mask = j_mask(variables["params"], "all")
    tx = optax.chain(joptim.scaled_by_plateau(joptim.masked(
        joptim.get_optimizer("adam", schedule), mask)),
        joptim.track_param_ema(0.9))
    params = jax.tree.map(jnp.asarray, numpy_tree(variables["params"]))
    opt_state = joptim.set_plateau_scale(tx.init(params), 0.1)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)

    spec = optim.get_optimizer("adam", optim.step_decay_schedule(
        1e-3, 0.5, 1, 1))
    state = TrainState.create(module, spec,
                              trainable=backbone_param_mask(module, "all"),
                              ema_decay=0.9)
    state.plateau_scale = 0.1
    named = dict(module.named_parameters())
    for g in grads:
        tg = flax_to_torch({"params": g,
                            "batch_stats": variables["batch_stats"]}, module)
        for name, p in named.items():
            p.grad = tg[name].clone()
        apply_update(state, spec)
    assert state.step == 2

    stats = variables["batch_stats"]
    want = flax_to_torch({"params": numpy_tree(params),
                          "batch_stats": stats}, module)
    want_ema = flax_to_torch({"params": numpy_tree(
        joptim.get_ema_params(opt_state)), "batch_stats": stats}, module)
    start = flax_to_torch(variables, module)
    for name, p in named.items():
        torch.testing.assert_close(p.detach(), want[name], rtol=0,
                                   atol=UPDATE_ATOL, msg=name)
        torch.testing.assert_close(state.ema[name], want_ema[name], rtol=0,
                                   atol=UPDATE_ATOL, msg=name)
        frozen = name.startswith("backbone.")
        assert torch.equal(p.detach(), start[name]) == frozen, name
        if not frozen:    # the update is lr * 0.1 a coordinate, or less
            moved = (p.detach() - start[name]).abs().max().item()
            assert 0 < moved <= 1.5e-4 * (1 + 0.5), name


def test_val_loss_matches_make_triplet_eval_step(jax_resnet):
    """The eval step on the JAX weights converted by ``flax_to_torch``
    (eval-mode BatchNorm with random statistics, float32, plain convs)
    against the JAX ``make_triplet_eval_step``."""
    jmodule, variables = jax_resnet
    module = _port_module(variables, dtype=torch.float32)
    rng = np.random.default_rng(2)
    a, p, n = (rng.integers(0, 256, (6, SIZE, SIZE, 3), np.uint8)
               for _ in range(3))
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, variables),
                                optax.adam(1e-3))
    want = float(jax.jit(j_eval_step(jmodule, margin=0.5))(
        jstate, jnp.asarray(a), jnp.asarray(p), jnp.asarray(n))["loss"])
    state = TrainState.create(module, optim.get_optimizer("adam", 1e-3))
    got = make_triplet_eval_step(module, margin=0.5)(
        state, *map(torch.from_numpy, (a, p, n)))["loss"]
    assert got.shape == () and got.dtype == torch.float32
    assert math.isfinite(want) and want > 0
    np.testing.assert_allclose(got.item(), want, rtol=VAL_RTOL)
