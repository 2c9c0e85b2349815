"""The ArcFace path and the softmax pretraining of the port against the JAX
package, on the CPU with one torch thread, a tiny ViT-B/16 (patch 8, dim
32, depth 2, 4 heads; its ``_VARIANTS`` entry replaced on both sides) at
32 px:

* ``softmax_cross_entropy`` and ``arcface_loss`` with their gradients, in
  float32 on both sides (measured 1.5e-7 relative, gradients 3.7e-7 of
  their largest entry): 1e-6;
* the ArcFace step (with the ``deepfake`` flip from the JAX step's own
  draws) and the softmax train and eval steps, the port in float32 against
  the JAX step in float64, two steps: the loss to 1e-6 relative, each
  updated parameter to 1e-5 of its tensor's largest entry. The steps run
  SGD here: Adam turns a gradient at rounding level into a step of
  ``lr`` of either sign, and the key projection's bias has such a
  gradient (zero in exact arithmetic: the softmax ignores a shift of all
  of a query's scores). Adam's and AdamW's updates are held to optax's
  apart, below;
* ``SimpleSampler`` seed by seed; AdamW over 12 steps against
  ``optax.adamw`` with the plateau scale, the freeze mask and the EMA
  (1e-6);
* the arcface ``Trainer``: a 2-epoch fit on ``tiny_dataset`` and a
  bit-exact resume; ``pretrain_softmax`` and its handoff against the JAX
  Trainer's, with the tiny ViT and with a ResNet-18 resumed from a
  checkpoint (SGD, float32 on both sides: 1e-5 of each tensor's largest
  entry; the key biases, zero at the start, hold rounding only, under
  1e-8); the CLI with a ``SOFTMAX_PRETRAINING`` section.
"""

import functools
import os
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from embeddingnet_tpu import config as jconfig  # noqa: E402
from embeddingnet_tpu.data import ENDataLoader as JENDataLoader  # noqa
from embeddingnet_tpu.data import samplers as jsamplers  # noqa: E402
from embeddingnet_tpu.data.pipeline import BatchLoader as JBatchLoader  # noqa
from embeddingnet_tpu.models import vit as jvit  # noqa: E402
from embeddingnet_tpu.models.registry import \
    ArcFaceModule as JArcFaceModule  # noqa: E402
from embeddingnet_tpu.models.registry import \
    SoftmaxModule as JSoftmaxModule  # noqa: E402
from embeddingnet_tpu.models.registry import \
    backbone_param_mask as j_mask  # noqa: E402
from embeddingnet_tpu.ops import losses as jlosses  # noqa: E402
from embeddingnet_tpu.ops.augment import get_aug as j_get_aug  # noqa: E402
from embeddingnet_tpu.train import loop as jloop  # noqa: E402
from embeddingnet_tpu.train import optim as joptim  # noqa: E402
from embeddingnet_tpu.train import steps as jsteps  # noqa: E402
from embeddingnet_tpu.train.state import TrainState as JTrainState  # noqa
from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.data import samplers  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models import vit  # noqa: E402
from embeddingnet_tpu_torch.models.api import EmbeddingNet  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.ops import losses  # noqa: E402
from embeddingnet_tpu_torch.ops.augment import get_aug  # noqa: E402
from embeddingnet_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from embeddingnet_tpu_torch.train import optim, steps  # noqa: E402
from embeddingnet_tpu_torch.data.pipeline import BatchLoader  # noqa: E402
from embeddingnet_tpu_torch.train import loop as loop_module  # noqa: E402
from embeddingnet_tpu_torch.train.loop import Trainer  # noqa: E402
from embeddingnet_tpu_torch.train.state import TrainState  # noqa: E402

from _torch_port import jax_preset_draws, numpy_tree  # noqa: E402

TINY = dict(patch=8, dim=32, depth=2, heads=4)
SIZE, D, C, B = 32, 16, 5, 8
LOSS_RTOL = 1e-6         # the losses alone, and the steps' losses
GRAD_TOL = 1e-6          # the losses' gradients, of their largest entry
PARAM_TOL = 1e-5         # updated parameters, of their tensor's largest
ADAMW_ATOL = 1e-6        # AdamW against optax.adamw, 12 updates
HANDOFF_TOL = 1e-5       # the pretrained backbone against the JAX one
# the attention's key bias has no gradient in exact arithmetic (the softmax
# ignores a shift of all of a query's scores): it moves by rounding only
KEY_BIAS = ".attn.key.bias"
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


@pytest.fixture(autouse=True)
def tiny_vit(monkeypatch):
    monkeypatch.setitem(jvit._VARIANTS, "vit-b16", TINY)
    monkeypatch.setitem(vit._VARIANTS, "vit-b16", TINY)


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (name, err)


# -- the losses --------------------------------------------------------------

@pytest.mark.parametrize("margin,scale", [(0.5, 64.0), (0.3, 30.0),
                                          (0.0, 16.0)])
def test_arcface_loss_and_gradient_match_jax(margin, scale):
    rng = np.random.default_rng(int(margin * 10))
    emb = rng.normal(size=(12, D)).astype(np.float32)
    weights = (rng.normal(size=(9, D)) * 0.01).astype(np.float32)
    labels = rng.integers(0, 9, 12).astype(np.int32)
    want, (g_emb, g_w) = jax.value_and_grad(
        lambda e, w: jlosses.arcface_loss(e, jnp.asarray(labels), w,
                                          margin=margin, scale=scale),
        argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(weights))
    e = torch.tensor(emb, requires_grad=True)
    w = torch.tensor(weights, requires_grad=True)
    got = losses.arcface_loss(e, torch.from_numpy(labels).long(), w,
                              margin=margin, scale=scale)
    got.backward()
    # the cosines stay off the clip, where JAX and torch split a gradient
    # differently
    cos = jnp.asarray(emb / np.linalg.norm(emb, axis=1, keepdims=True)) @ (
        weights / np.linalg.norm(weights, axis=1, keepdims=True)).T
    assert float(jnp.abs(cos).max()) < 1 - 1e-3
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _close(e.grad, g_emb, GRAD_TOL, "embeddings")
    _close(w.grad, g_w, GRAD_TOL, "class weights")


def test_softmax_cross_entropy_and_one_hot_match_jax():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(12, C)) * 3).astype(np.float32)
    labels = rng.integers(0, C, 12).astype(np.int32)
    onehot = losses.one_hot(torch.from_numpy(labels), C)
    np.testing.assert_array_equal(
        onehot.numpy(), np.asarray(jlosses.jax_one_hot(jnp.asarray(labels),
                                                       C)))
    want, grad = jax.value_and_grad(jlosses.softmax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(onehot.numpy()))
    x = torch.tensor(logits, requires_grad=True)
    got = losses.softmax_cross_entropy(x, onehot)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _close(x.grad, grad, GRAD_TOL)


# -- the steps against JAX in float64 ----------------------------------------

LR = 0.05


def _batches(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (B, SIZE, SIZE, 3), np.uint8),
             rng.integers(0, C, B).astype(np.int32)) for _ in range(n)]


def _jax_modules(kind):
    if kind == "arcface":
        return JArcFaceModule(backbone_name="vit-b16", encodings_len=D,
                              n_classes=C)
    return JSoftmaxModule(backbone_name="vit-b16", n_classes=C)


def _port_module(kind):
    if kind == "arcface":
        return registry.ArcFaceModule("vit-b16", encodings_len=D,
                                      n_classes=C,
                                      input_shape=(SIZE, SIZE, 3))
    return registry.SoftmaxModule("vit-b16", n_classes=C,
                                  input_shape=(SIZE, SIZE, 3))


def _start(kind):
    """JAX variables with every bias and scale moved off its initial value
    (a zero key bias would make the comparison relative to nothing)."""
    jmodule = _jax_modules(kind)
    variables = numpy_tree(jax.jit(lambda k: jmodule.init(
        {"params": k}, jnp.zeros((2, SIZE, SIZE, 3))))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)

    def visit(node):
        for key, value in node.items():
            if isinstance(value, dict):
                visit(value)
            elif key in ("bias", "scale"):
                node[key] = (value + rng.normal(0, 0.1, value.shape)
                             ).astype(np.float32)
    visit(variables["params"])
    return jmodule, variables


def _jax_steps(kind, jmodule, variables, batches, augment_fn=None):
    tx = optax.sgd(LR)
    with jax.enable_x64(True):
        state = JTrainState.create(jax.tree.map(
            lambda a: np.asarray(a, np.float64), variables), tx)
        if kind == "arcface":
            step = jsteps.make_arcface_train_step(
                jmodule, tx, n_classes=C, margin=0.5,
                augment_fn=augment_fn, compute_dtype=jnp.float64)
        else:
            step = jsteps.make_softmax_train_step(
                jmodule, tx, n_classes=C, augment_fn=augment_fn,
                compute_dtype=jnp.float64)
        step = jax.jit(step)
        out = []
        for images, labels in batches:
            state, metrics = step(state, jnp.asarray(images),
                                  jnp.asarray(labels))
            out.append((numpy_tree(state.params),
                        {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.mark.parametrize("kind,augment", [("arcface", False),
                                          ("arcface", True),
                                          ("softmax", False)])
def test_train_step_matches_jax_float64(kind, augment):
    batches = _batches()
    jmodule, variables = _start(kind)
    if augment:
        # the flip's gates from the JAX step's key, split(state.rng, 3)[1]
        batches = batches[:1]
        with jax.enable_x64(True):
            key = jax.random.split(jax.random.PRNGKey(0), 3)[1]
            draws = jax_preset_draws(get_aug("deepfake"), key,
                                     batches[0][0].shape)
        assert 0 < int(draws[0]["gate"].sum()) < B
    want = _jax_steps(kind, jmodule, variables, batches,
                      j_get_aug("deepfake") if augment else None)

    module = _port_module(kind)
    module.load_state_dict(flax_to_torch(variables, module))
    spec = optim.get_optimizer("sgd", LR)
    state = TrainState.create(module, spec)
    make = (steps.make_arcface_train_step if kind == "arcface"
            else steps.make_softmax_train_step)
    kw = {"margin": 0.5} if kind == "arcface" else {}
    step = make(module, spec, n_classes=C,
                augment_fn=get_aug("deepfake") if augment else None, **kw)
    for (images, labels), (jparams, jmetrics) in zip(batches, want):
        state, metrics = step(state, torch.from_numpy(images),
                              torch.from_numpy(labels),
                              aug_draws=draws if augment else None)
        assert metrics.keys() == jmetrics.keys()
        for key, value in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key]), value,
                                       rtol=LOSS_RTOL, err_msg=key)
        target = flax_to_torch({"params": jparams}, module)
        start = flax_to_torch(variables, module)
        for name, p in module.named_parameters():
            _close(p.detach(), target[name], PARAM_TOL, name)
            if not name.endswith(KEY_BIAS):
                assert not torch.equal(p.detach(), start[name]), name
    assert state.step == len(batches)


def test_softmax_eval_step_matches_jax():
    jmodule, variables = _start("softmax")
    images, labels = _batches(1, seed=3)[0]
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, variables),
                                optax.sgd(LR))
    want = jax.jit(jsteps.make_softmax_eval_step(jmodule, n_classes=C))(
        jstate, jnp.asarray(images), jnp.asarray(labels))
    module = _port_module("softmax")
    module.load_state_dict(flax_to_torch(variables, module))
    state = TrainState.create(module, optim.get_optimizer("sgd", LR))
    got = steps.make_softmax_eval_step(module, n_classes=C)(
        state, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-5)
    assert got["accuracy"].item() == float(want["accuracy"])
    assert not module.training


# -- the sampler and the optimizer -------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 11, 12])
def test_simple_sampler_matches_jax(tiny_dataset, seed):
    dl, jdl = ENDataLoader(tiny_dataset, val_ratio=0.2), \
        JENDataLoader(tiny_dataset, val_ratio=0.2)
    ours = samplers.SimpleSampler(dl.train_data, dl.class_names,
                                  batch_size=7, seed=seed)
    theirs = jsamplers.SimpleSampler(jdl.train_data, jdl.class_names,
                                     batch_size=7, seed=seed)
    for _ in range(3):
        paths, labels = ours.sample()
        jpaths, jlabels = theirs.sample()
        assert paths == jpaths
        np.testing.assert_array_equal(labels, jlabels)
        assert labels.dtype == jlabels.dtype


@pytest.mark.parametrize("freeze", [False, "all", "except_last_2"])
def test_adamw_matches_optax_over_12_steps(freeze):
    """12 AdamW updates from the same gradients on the tiny ArcFace ViT:
    optax's chain (``get_optimizer("adamw")``, weight decay 0.05, on a
    warm-up step-decay schedule, masked by ``freeze``, scaled by the
    plateau, the parameters' EMA at 0.9) against the port's AdamW, freeze
    mask, plateau scale and EMA. The plateau scale drops to 0.1 after
    step 4 and to 0.01 after step 8."""
    _, variables = _start("arcface")
    module = _port_module("arcface")
    module.load_state_dict(flax_to_torch(variables, module))
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), variables["params"]) for _ in range(12)]
    scales = [1.0] * 4 + [0.1] * 4 + [0.01] * 4

    schedule = joptim.step_decay_schedule(1e-3, 0.5, 1, 3, warmup_epochs=1)
    base = joptim.get_optimizer("adamw", schedule, weight_decay=0.05)
    if freeze:
        base = joptim.masked(base, j_mask(variables["params"], freeze))
    tx = optax.chain(joptim.scaled_by_plateau(base),
                     joptim.track_param_ema(0.9))
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    for g, s in zip(grads, scales):
        opt_state = joptim.set_plateau_scale(opt_state, s)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)

    spec = optim.get_optimizer("adamw", optim.step_decay_schedule(
        1e-3, 0.5, 1, 3, warmup_epochs=1), weight_decay=0.05)
    trainable = registry.backbone_param_mask(module, freeze) if freeze \
        else None
    state = TrainState.create(module, spec, trainable=trainable,
                              ema_decay=0.9)
    named = dict(module.named_parameters())
    for g, s in zip(grads, scales):
        state.plateau_scale = s
        tg = flax_to_torch({"params": g}, module)
        for name, p in named.items():
            p.grad = tg[name].clone()
        steps.apply_update(state, spec)
    want = flax_to_torch({"params": numpy_tree(params)}, module)
    want_ema = flax_to_torch({"params": numpy_tree(
        joptim.get_ema_params(opt_state))}, module)
    start = flax_to_torch(variables, module)
    mask = trainable or {n: True for n in named}
    for name, p in named.items():
        torch.testing.assert_close(p.detach(), want[name], rtol=0,
                                   atol=ADAMW_ATOL, msg=name)
        torch.testing.assert_close(state.ema[name], want_ema[name], rtol=0,
                                   atol=ADAMW_ATOL, msg=name)
        assert torch.equal(p.detach(), start[name]) != mask[name], name
    if freeze:
        assert not all(mask.values()) and any(mask.values())


# -- the Trainer ------------------------------------------------------------

def _cfg(dataset, work_dir, project="run", **sections):
    cfg = {
        "MODEL": {"backbone_name": "vit-b16",
                  "input_shape": [SIZE, SIZE, 3], "encodings_len": D,
                  "backbone_weights": None, "mode": "arcface",
                  "embeddings_normalization": False},
        "DATALOADER": {"dataset_path": dataset, "val_ratio": 0.2},
        "GENERATOR": {"batch_size": 6, "n_batches": 3, "margin": 0.3,
                      "augmentations": "deepfake"},
        "TRAIN": {"n_epochs": 2, "eval_recall_every": 1,
                  "plot_history": False, "warmup_epochs": 1},
        "GENERAL": {"work_dir": str(work_dir), "project_name": project,
                    "seed": 3},
        "PERFORMANCE": {"compute_dtype": "float32", "ema_decay": 0.9},
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
            "plateau_scale": s["plateau_scale"], "ema": s["ema"]}


def _assert_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_arcface_trainer_fits_and_resumes_bit_for_bit(tiny_dataset,
                                                      tmp_path):
    """Two epochs: the train loss monitored (no val epoch), recall every
    epoch on L2-normalised embeddings, the checkpoint carrying the class
    weights; a run resumed from epoch 0 ends where the uninterrupted one
    does, bit for bit."""
    whole = _trainer(_cfg(tiny_dataset, tmp_path, "whole"))
    assert whole.ckpt_mgr.monitor == "loss"
    assert whole._val_loader() is None and whole.eval_step is None
    history = whole.fit().history
    assert set(history) >= {"loss", "val_recall1", "val_recall5"}
    assert "val_loss" not in history
    assert np.all(np.isfinite(history["loss"]))
    assert whole.state.step == 6
    saved = torch.load(os.path.join(whole.paths["weights"], "0",
                                    ckpt.STATE_FILE), weights_only=True)
    assert saved["module"]["class_weights"].shape == (6, D)
    exported = whole.encoder_variables()
    assert not any(k.startswith(("encoder.", "class_weights"))
                   for k in exported)
    images = torch.rand(4, SIZE, SIZE, 3)
    with torch.no_grad():
        emb = whole._recall_encoder()(images)
    torch.testing.assert_close(emb.norm(dim=1), torch.ones(4))

    first = _trainer(_cfg(tiny_dataset, tmp_path, "split"))
    first.fit(1)
    second = _trainer(_cfg(tiny_dataset, tmp_path, "split"))
    second.resume(0)
    assert second.start_epoch == 1
    _assert_equal(_state(second), _state(first))
    second.fit(2)
    _assert_equal(_state(second), _state(whole))
    assert second.history.history["loss"] == history["loss"][1:]


PRETRAIN = {"optimizer": "sgd", "learning_rate": 0.05, "n_epochs": 2,
            "steps_per_epoch": 2, "val_steps": 2, "batch_size": 6}


def _moved_statistics(tree, rng):
    """A ``batch_stats`` tree with every mean and variance drawn away from
    0/1, as a resumed run's are."""
    if set(tree) == {"mean", "var"}:
        return {"mean": rng.normal(0, 0.2, np.shape(tree["mean"])).astype(
                    np.float32),
                "var": rng.uniform(0.5, 1.5, np.shape(tree["var"])).astype(
                    np.float32)}
    return {k: _moved_statistics(v, rng) for k, v in tree.items()}


# The ResNet case takes SGD steps of 0: on these near-constant images its
# BatchNorm (batches of 6, 1x1 at the last stage) amplifies the rounding of
# Flax's one-pass variance, so that a trained ResNet's f32 trajectories part
# by 1e-3 relative after one step. It holds what the seeding and the handoff
# move in a ResNet, the BatchNorm statistics, within 1e-5; the ViT case
# holds the trained parameters.
@pytest.mark.parametrize("backbone, resumed, lr", [("vit-b16", False, 0.05),
                                                   ("resnet18", True, 0.0)])
def test_pretrain_softmax_hands_over_what_jax_hands_over(tiny_dataset,
                                                         tmp_path,
                                                         monkeypatch,
                                                         backbone, resumed,
                                                         lr):
    """Both Trainers from the same weights (the JAX Trainer's, converted)
    and the same softmax head (the JAX pretraining's ``PRNGKey(seed + 7)``
    init, converted): two pretraining epochs of SGD on the same
    ``SimpleSampler`` batches (both ``BatchLoader``s on cv2,
    ``ROADMAP.md`` F1), the same epoch metrics, and the encoder's backbone
    after the handoff equal to the JAX Trainer's; the class weights and the
    optimizer untouched, the backbone saved, the handoff logged.

    ``resumed``: the port's Trainer resumes a checkpoint whose encoder has
    BatchNorm statistics away from 0/1, and the JAX Trainer is given the
    same. The pretraining's backbone takes the encoder's parameters only,
    its statistics starting at 0/1 as the JAX one's do (seeded with the
    encoder's, the val loss parts by 0.7 relative), and hands back
    both."""
    cfg = _cfg(tiny_dataset, tmp_path, GENERATOR={"augmentations": None},
               SOFTMAX_PRETRAINING={**PRETRAIN, "learning_rate": lr},
               MODEL={"backbone_name": backbone})
    monkeypatch.setattr(jloop, "BatchLoader",
                        functools.partial(JBatchLoader, backend="python"))
    # the port's Trainer on cv2 too: both would pick their native decoders
    monkeypatch.setattr(loop_module, "BatchLoader",
                        functools.partial(BatchLoader, backend="python"))
    jparams = jconfig.params_from_dict(dict(
        cfg, GENERAL={**cfg["GENERAL"], "project_name": "jax"}))
    jtrainer = jloop.Trainer(jparams, JENDataLoader(
        tiny_dataset, val_ratio=0.2), log_fn=lambda *a: None)
    if resumed:
        jtrainer.state = jtrainer.state.replace(batch_stats=_moved_statistics(
            numpy_tree(jtrainer.state.batch_stats),
            np.random.default_rng(5)))

    def jax_variables():
        out = {"params": numpy_tree(jtrainer.state.params)}
        if jtrainer.state.batch_stats:
            out["batch_stats"] = numpy_tree(jtrainer.state.batch_stats)
        return out
    logs = []
    trainer = _trainer(cfg, log=logs.append)
    trainer.module.load_state_dict(flax_to_torch(jax_variables(),
                                                 trainer.module))
    if resumed:
        assert trainer.ckpt_mgr.save(0, trainer.state, {"loss": 1.0})
        trainer = _trainer(cfg, log=logs.append).resume(0)
        stats = [v for k, v in trainer.module.state_dict().items()
                 if k.endswith("running_var")]
        assert stats and not any(torch.equal(v, torch.ones_like(v))
                                 for v in stats)

    jhead = JSoftmaxModule(backbone_name=backbone, n_classes=6,
                           encodings_len=D, dtype=jnp.float32)
    head_init = numpy_tree(jhead.init(
        {"params": jax.random.PRNGKey(3 + 7),
         "dropout": jax.random.PRNGKey(3 + 7)},
        jnp.zeros((2, SIZE, SIZE, 3)), train=False))

    def reset_from_jax(self, generator):
        self.load_state_dict(flax_to_torch(head_init, self))
    monkeypatch.setattr(registry.SoftmaxModule, "reset_parameters",
                        reset_from_jax)

    def recorder(trainer, out):
        run = trainer._pretrain_epoch

        def wrapped(*args):
            state, metrics = run(*args)
            out.append(metrics)
            return state, metrics
        return wrapped
    jmetrics, metrics = [], []
    jtrainer._pretrain_epoch = recorder(jtrainer, jmetrics)
    trainer._pretrain_epoch = recorder(trainer, metrics)
    before = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    opt_before = trainer.state.optimizer.state_dict()

    jtrainer.pretrain_softmax()
    trainer.pretrain_softmax()
    assert len(metrics) == len(jmetrics) == 2
    for ours, theirs in zip(metrics, jmetrics):
        assert ours.keys() == theirs.keys() == {
            "loss", "accuracy", "val_loss", "val_accuracy"}
        for key in ours:
            np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-5,
                                       err_msg=key)
    want = flax_to_torch(jax_variables(), trainer.module)
    for name, value in trainer.module.state_dict().items():
        if name.endswith("num_batches_tracked"):    # no JAX counterpart
            continue
        if name.endswith(KEY_BIAS):     # zero at the start; rounding only
            assert value.abs().max() < 1e-8 > want[name].abs().max(), name
        else:
            _close(value, want[name], HANDOFF_TOL, name)
        moved = not torch.equal(value, before[name])
        assert moved == (name.startswith("encoder.backbone.")
                         and (lr > 0 or ".running_" in name)), name
    assert trainer.state.optimizer.state_dict() == opt_before
    saved = torch.load(os.path.join(trainer.paths["pretraining_weights"],
                                    "backbone.pt"), weights_only=True)
    assert set(saved) == {k[len("encoder."):] for k in want
                          if k.startswith("encoder.backbone.")} | {
        "softmax_head.logits.weight", "softmax_head.logits.bias"}
    assert any("handed to the model's encoder.backbone" in l for l in logs)
    assert sum("softmax-pretrain epoch" in l for l in logs) == 2


def test_cli_pretrains_fits_and_exports(tiny_dataset, tmp_path, capsys):
    """``tools/train_torch.py`` on an arcface config with a
    ``SOFTMAX_PRETRAINING`` section: the pretraining runs before the fit,
    and the exported base model, reloaded, encodes as the Trainer's
    normalising encoder view."""
    yaml = pytest.importorskip("yaml")
    cfg = _cfg(tiny_dataset, tmp_path, SOFTMAX_PRETRAINING=PRETRAIN,
               ENCODINGS={"save_encodings": True,
                          "max_num_samples_of_each_class": 4})
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    trainer, net = runpy.run_path(CLI)["main"]([str(path), "--device",
                                                "cpu"])
    out = capsys.readouterr().out
    assert out.index("SOFTMAX PRETRAINING") < out.index("epoch 0:")
    assert "recall@1=" in out and "base model saved" in out
    assert os.path.exists(os.path.join(trainer.paths["pretraining_weights"],
                                       "backbone.pt"))
    reloaded = EmbeddingNet(params_from_dict(cfg), device="cpu").load_model(
        os.path.join(trainer.paths["work_dir"], "base_model.pt"))
    images = np.random.default_rng(0).integers(0, 256, (5, SIZE, SIZE, 3),
                                               np.uint8)
    with torch.no_grad():
        want = trainer._recall_encoder()(
            torch.from_numpy(images).float() / 255.0).numpy()
    np.testing.assert_allclose(reloaded.encode(images), want, rtol=1e-5,
                               atol=1e-6)
