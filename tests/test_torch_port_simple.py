"""The reference's hand-built CNNs in the port
(``embeddingnet_tpu_torch/models/simple.py``) against the JAX package:
``simple`` and ``simple2`` as embedding modules in eval and train mode
(outputs, features and running statistics), ``simple2``'s Dropout fed the
same masks on both sides (the JAX ``nn.Dropout`` intercepted with
``flax.linen.intercept_methods``, in the test only); the glorot
initialiser; the regularisation rules and their penalty; the triplet step
on ``simple2`` with its rules and Dropout against the JAX step in float64;
the integrated-head ``SoftmaxModule``; the backbone handoff between a
softmax module and an encoder; a config without ``backbone_name``.

Small sizes: ``simple`` at 65 px (its minimum), ``simple2`` at 32 px,
B=8, 16-d embeddings; one torch thread (a module fixture)."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu.models.registry import \
    SoftmaxModule as JSoftmaxModule  # noqa: E402
from embeddingnet_tpu.train import optim as joptim  # noqa: E402
from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models import simple  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.models.stochastic import MaskSource  # noqa
from embeddingnet_tpu_torch.train import optim  # noqa: E402
from embeddingnet_tpu_torch.train.loop import Trainer  # noqa: E402

from _torch_port import (jax_init, numpy_tree, randomize_bn,  # noqa: E402
                         triplet_steps_against_jax)

B, D = 8, 16
SIZES = {"simple": 65, "simple2": 32}
FWD_TOL = 1e-5               # f32 forward and statistics, of the largest
# the train-mode forward in f32 against JAX in float64, as
# tests/test_torch_port_efficientnet.py holds it (train-mode BatchNorm
# amplifies f32 rounding; JAX's own f32 run is further off)
TRAIN_FWD_TOL = 5e-5
# as tests/test_torch_port_efficientnet.py: the port's f32 step against the
# JAX step in float64 from the same state
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5
LR = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (name, err)


@contextlib.contextmanager
def _jax_dropout_masks(holder):
    """Every JAX ``nn.Dropout`` that is not deterministic takes the next
    mask of ``holder["masks"]`` (``where(mask, x / keep, 0)``, as Flax
    applies its own)."""
    def intercept(next_fun, args, kwargs, context):
        m = context.module
        if (isinstance(m, fnn.Dropout) and context.method_name == "__call__"
                and not m.deterministic):
            mask = holder["masks"][holder["i"]]
            holder["i"] += 1
            x = args[0]
            return jnp.where(mask, x / (1.0 - m.rate), 0.0)
        return next_fun(*args, **kwargs)
    with fnn.intercept_methods(intercept):
        yield


def _dropout_masks(size, seed=1, batch=B):
    """simple2's three masks, in Flax's shapes (NHWC for the conv maps)."""
    rng = np.random.default_rng(seed)
    s3 = -(-(size - 4) // 2)
    s6 = -(-(s3 - 4) // 2)
    shapes = [(batch, s3, s3, 32), (batch, s6, s6, 64), (batch, 512)]
    return [rng.uniform(size=s) < 0.55 for s in shapes]


def _with_random_bn(variables):
    variables = numpy_tree(variables)
    return randomize_bn(variables) if "batch_stats" in variables \
        else variables


def _jax_embedding(name):
    module = JEmbeddingModule(backbone_name=name, encodings_len=D)
    size = SIZES[name]
    return module, _with_random_bn(jax_init(
        module, jnp.zeros((2, size, size, 3)), method="init_all"))


def _port_embedding(name, variables=None):
    size = SIZES[name]
    module = registry.EmbeddingModule(name, encodings_len=D,
                                      input_shape=(size, size, 3))
    if variables is not None:
        module.load_state_dict(flax_to_torch(variables, module))
    return module


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["simple", "simple2"])
def test_embedding_module_matches_jax(name, train):
    """The embedding and the features (the Flatten of ``simple``, the last
    conv + BN map of ``simple2``), and in train mode the running
    statistics after the forward, ``simple2``'s Dropout on the given
    masks."""
    jmodule, variables = _jax_embedding(name)
    size = SIZES[name]
    x = np.random.default_rng(2).uniform(0, 1, (B, size, size, 3)).astype(
        np.float32)
    masks = _dropout_masks(size) if train and name == "simple2" else []
    holder = {}
    dtype = np.float64 if train else np.float32
    with _jax_dropout_masks(holder), jax.enable_x64(train):
        def run(v, x, masks):
            holder["masks"], holder["i"] = masks, 0
            feats = jmodule.apply(v, x, train=False, method="features")
            if not train:
                return (jmodule.apply(v, x, train=False), feats,
                        v.get("batch_stats", {}))
            out, mut = jmodule.apply(v, x, train=True,
                                     mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(0)})
            return out, feats, mut.get("batch_stats", {})
        ref = jax.tree.map(lambda a: np.asarray(a, dtype), variables)
        want, want_feats, stats = jax.jit(run)(
            ref, jnp.asarray(x, dtype), [jnp.asarray(m) for m in masks])
        want, want_feats = np.asarray(want), np.asarray(want_feats)
        stats = numpy_tree(stats)
    assert holder["i"] == len(masks)
    module = _port_embedding(name, variables)
    assert module.head is None
    module.eval()
    got_feats = module.features(torch.from_numpy(x))
    module.train(train)
    source = MaskSource([torch.from_numpy(m) for m in masks])
    got = module(torch.from_numpy(x), source)
    source.check_used()
    _close(got.detach().numpy(), want, TRAIN_FWD_TOL if train else FWD_TOL)
    _close(got_feats.detach().numpy(), want_feats, FWD_TOL, "features")
    after = flax_to_torch({"params": ref["params"], "batch_stats": stats}
                          if stats else {"params": ref["params"]}, module)
    for key, value in module.state_dict().items():
        if "running_" in key:
            _close(value.numpy(), after[key].numpy(), FWD_TOL, key)


def test_minimum_input_sizes_raise_as_in_jax():
    for name, low in (("simple", 64), ("simple2", 23)):
        module = registry.EmbeddingModule(name, encodings_len=D,
                                          input_shape=(low, low, 3))
        with pytest.raises(ValueError, match=f"'{name}' backbone needs "
                                             f"input >= {low + 1}px"):
            module(torch.zeros(1, low, low, 3))
    with pytest.raises(ValueError, match="needs input_shape"):
        registry.EmbeddingModule("simple")


def test_glorot_initialiser_matches_jax():
    """Every conv and Dense kernel glorot-uniform (fans from the kernel's
    shape, as Flax's), every bias zero: each tensor's std within 15% of
    JAX's, within the uniform's limit."""
    _, variables = _jax_embedding("simple2")
    jax_state = flax_to_torch(variables, _port_embedding("simple2"))
    module = _port_embedding("simple2")
    module.reset_parameters(torch.Generator().manual_seed(0))
    checked = 0
    for name, p in module.named_parameters():
        w = p.detach().numpy()
        if name.endswith(".bias") and "_bn" not in name:
            assert not w.any(), name
        if p.dim() < 2 or p.numel() < 512:
            continue
        fan_in = p[0].numel()
        fan_out = p.shape[0] * (p[0, 0].numel() if p.dim() == 4 else 1)
        limit = np.sqrt(6.0 / (fan_in + fan_out))
        assert np.abs(w).max() <= limit, name
        assert abs(w.std() / jax_state[name].numpy().std() - 1) < 0.15, name
        checked += 1
    assert checked >= 8


def test_reg_rules_and_penalty_match_jax():
    assert optim.reg_rules_for("simple") == joptim.reg_rules_for("simple")
    assert optim.reg_rules_for("simple2") == joptim.reg_rules_for("simple2")
    assert optim.reg_rules_for("efficientnet-b3") == ()
    _, variables = _jax_embedding("simple2")
    module = _port_embedding("simple2", variables)
    rules = optim.reg_rules_for("simple2")
    want = float(joptim.l2_penalty(variables["params"], rules))
    got = optim.l2_penalty(module.named_parameters(), rules).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got > 0


def test_simple2_triplet_step_matches_jax_float64():
    """Two batch-hard SGD steps on ``simple2`` with its regularisation
    rules and Dropout on the same masks, each from the JAX float64
    trajectory's state: the loss, every parameter, the running
    statistics."""
    jmodule, variables = _jax_embedding("simple2")
    rng = np.random.default_rng(3)
    size = SIZES["simple2"]
    batches = [(rng.integers(0, 256, (B, size, size, 3), np.uint8),
                np.repeat(np.arange(B // 2), 2).astype(np.int32))
               for _ in range(2)]
    module = _port_embedding("simple2")
    holder = {}
    results = triplet_steps_against_jax(
        jmodule, variables, module, batches,
        [_dropout_masks(size, seed=10 + i) for i in range(2)], holder,
        context=_jax_dropout_masks(holder),
        reg_rules=optim.reg_rules_for("simple2"), lr=LR)
    start = flax_to_torch(variables, module)
    for loss, jloss, got, want in results:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        for name, p in module.named_parameters():
            _close(got[name].numpy(), want[name].numpy(), PARAM_TOL, name)
        for key in got:
            if "running_" in key:
                _close(got[key].numpy(), want[key].numpy(), FWD_TOL, key)
    moved = [n for n, _ in module.named_parameters()
             if not torch.equal(results[0][2][n], start[n])]
    # the classifier head is off the loss's path
    assert len(moved) == len(list(module.parameters())) - 2


@pytest.mark.parametrize("name", ["simple", "simple2"])
def test_integrated_softmax_module_matches_jax(name):
    """The pretraining module on a backbone with its own head: the conv
    stack's features (pooled when a map), ``flat_logits``; no head
    parameters on either side; eval mode against JAX in float32, train
    mode, ``simple2``'s two conv Dropouts fed the same masks, against JAX
    in float64."""
    size = SIZES[name]
    jmodule = JSoftmaxModule(backbone_name=name, n_classes=5)
    variables = _with_random_bn(jax_init(jmodule, jnp.zeros((2, size,
                                                             size, 3))))
    module = registry.SoftmaxModule(name, n_classes=5,
                                    input_shape=(size, size, 3))
    module.load_state_dict(flax_to_torch(variables, module))
    assert not any("dense" in k for k in module.state_dict())
    x = np.random.default_rng(4).uniform(0, 1, (B, size, size, 3)).astype(
        np.float32)
    masks = _dropout_masks(size)[:2] if name == "simple2" else []
    holder = {}
    want = {}
    for train, dtype in ((False, np.float32), (True, np.float64)):
        with _jax_dropout_masks(holder), jax.enable_x64(train):
            def run(v, x, masks):
                holder["masks"], holder["i"] = masks, 0
                if not train:
                    return jmodule.apply(v, x, train=False)
                return jmodule.apply(
                    v, x, train=True, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.PRNGKey(0)})[0]
            want[train] = np.asarray(jax.jit(run)(
                jax.tree.map(lambda a: np.asarray(a, dtype), variables),
                jnp.asarray(x, dtype), [jnp.asarray(m) for m in masks]))
    module.eval()
    _close(module(torch.from_numpy(x)).detach().numpy(), want[False],
           FWD_TOL)
    module.train()
    source = MaskSource([torch.from_numpy(m) for m in masks])
    got = module(torch.from_numpy(x), source)
    source.check_used()
    _close(got.detach().numpy(), want[True], TRAIN_FWD_TOL)
    # the pretraining's initialiser draws flat_logits as Flax's Dense
    fresh = registry.SoftmaxModule(name, n_classes=5,
                                   input_shape=(size, size, 3))
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    w = fresh.flat_logits.weight.detach().numpy()
    std = np.sqrt(1.0 / w.shape[1])     # variance 1 / fan_in, truncated
    assert np.abs(w).max() <= 2 * std / .87962566103423978
    assert abs(w.std() / std - 1) < 0.2


def test_backbone_handoff_with_an_integrated_head():
    """The pretraining's seeding and handoff between an encoder (conv
    stack and head) and a softmax module (conv stack alone): what both
    hold is copied, the encoder's head stays."""
    size = SIZES["simple2"]
    encoder = _port_embedding("simple2")
    encoder.reset_parameters(torch.Generator().manual_seed(0))
    softmax = registry.SoftmaxModule("simple2", n_classes=5,
                                     input_shape=(size, size, 3))
    softmax.reset_parameters(torch.Generator().manual_seed(1))
    registry.transfer_backbone_params(encoder, softmax)
    for name, p in softmax.backbone.named_parameters():
        assert torch.equal(p, dict(encoder.backbone.named_parameters())[name])
    head = encoder.backbone.dense_512.weight.detach().clone()
    with torch.no_grad():
        softmax.backbone.conv_1.weight.add_(1.0)
        softmax.backbone.conv_1_bn.running_mean.add_(2.0)
    registry.transfer_backbone_params(softmax, encoder, statistics=True)
    assert torch.equal(encoder.backbone.conv_1.weight,
                       softmax.backbone.conv_1.weight)
    assert torch.equal(encoder.backbone.conv_1_bn.running_mean,
                       softmax.backbone.conv_1_bn.running_mean)
    assert torch.equal(encoder.backbone.dense_512.weight, head)
    with pytest.raises(KeyError, match="backbones differ"):
        registry.transfer_backbone_params(
            registry.EmbeddingModule("resnet18"), softmax)


def test_config_without_backbone_name_builds(tiny_dataset, tmp_path):
    """The port's default ``MODEL.backbone_name`` is ``simple``: a config
    that names none builds its Trainer, the embedding module on
    ``simple`` and the step with ``simple``'s rules."""
    params = params_from_dict({
        "MODEL": {"input_shape": [72, 72, 3], "encodings_len": D,
                  # the default "imagenet" raises in both packages: no
                  # downloads
                  "backbone_weights": None},
        "DATALOADER": {"dataset_path": tiny_dataset, "val_ratio": 0.2},
        "GENERATOR": {"k_classes": 3, "k_samples": 2},
        "GENERAL": {"work_dir": str(tmp_path / "work")}})
    assert params.model.backbone_name == "simple"
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device="cpu", log_fn=lambda *a: None)
    assert isinstance(trainer.module.backbone, simple.SimpleCNN)
    assert trainer.module.head is None
    assert optim.reg_rules_for(params.model.backbone_name) == \
        simple.SIMPLE_REG_RULES
    with torch.no_grad():
        assert trainer.module.eval()(torch.zeros(2, 72, 72, 3)).shape == (
            2, D)
