"""The port's SE-ResNets, ResNeXts and SENet-154 (``embeddingnet_tpu_torch/
models/resnet.py``) against the JAX package's.

Reduced constructions of both registries' ``seresnet18``, ``seresnet50``,
``resnext50`` and ``seresnext50`` (one block a stage, narrow widths,
swapped in with ``monkeypatch``): the embedding module in eval mode in
float32, and two batch-hard SGD triplet steps in train mode against the
JAX step in float64. ``fast_conv``: an SE bottleneck ResNet takes the
fused BN-ReLU conv (K3) as often as a plain one, and a ResNeXt's grouped
convs take no conv kernel (the ``groups == 1`` gate). ``SENet154Block``
alone, with and without its 3x3 downsample, eval in float32 and train
mode (output, running statistics and every gradient) in float64; the full
SENet-154 tree against JAX's shapes, and its train-mode forward in float64
(slow: at random weights SENet-154's 50 blocks amplify float32 rounding
past 1e-5 of the output). The initialisers: He-normal convs,
``lecun_normal`` squeeze-excitation Dense layers.

The variables come from the port (``_torch_port.port_variables``), so no
JAX ``init`` runs. B=8 at 32 px, 16-d; one torch thread."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models import registry as jregistry  # noqa: E402
from embeddingnet_tpu.models import resnet as jresnet  # noqa: E402
from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models import resnet as tresnet  # noqa: E402
from embeddingnet_tpu_torch.models.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)
from embeddingnet_tpu_torch.ops import fused_conv as tfc  # noqa: E402

from _torch_port import (biases_moved, port_variables, rel_err,  # noqa
                         tree_shapes, triplet_steps_against_jax)

SIZE, B, D = 32, 8, 16
FWD_TOL = 1e-5               # f32 eval forward, of the largest entry
# the port's f32 step against JAX's float64 step, from the same state (as
# tests/test_torch_port_efficientnet.py): the loss to 1e-5 relative, each
# parameter to 2e-5 and each running statistic to 1e-5 of its tensor's
# largest entry
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5
# float64 on both sides: sums in another order
F64_TOL = 1e-10

# (block, keyword arguments) of each reduced variant, the same on both sides
REDUCED = {
    "seresnet18": ("BasicBlock", dict(use_se=True)),
    "seresnet50": ("BottleneckBlock", dict(use_se=True)),
    "resnext50": ("BottleneckBlock", dict(groups=4, width_per_group=4)),
    "seresnext50": ("BottleneckBlock", dict(groups=4, width_per_group=4,
                                            use_se=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced(module, name, stage_sizes=(1, 1, 1, 1), num_filters=16):
    block, kw = REDUCED[name]
    return lambda **k: module.ResNet(  # noqa: E731
        stage_sizes=stage_sizes, block_cls=getattr(module, block),
        num_filters=num_filters, **kw, **k)


@pytest.fixture
def reduced(monkeypatch):
    """Each REDUCED name in both registries built small."""
    for name in REDUCED:
        monkeypatch.setitem(jregistry._RESNETS, name,
                            _reduced(jresnet, name))
        monkeypatch.setitem(registry._RESNETS, name,
                            _reduced(tresnet, name))


def _images(seed, b=B, size=SIZE):
    return np.random.default_rng(seed).uniform(
        size=(b, size, size, 3)).astype(np.float32)


def _counting(fn):
    """Calls of the conv kernels' entry points made while ``fn`` runs."""
    names = ("conv3x3_small", "conv3x3_small_bn_relu", "conv3x3_small_mixed")
    calls = dict.fromkeys(names, 0)
    originals = {n: getattr(tfc, n) for n in names}

    def wrap(name):
        def inner(*a):
            calls[name] += 1
            return originals[name](*a)
        return inner

    try:
        for n in names:
            setattr(tfc, n, wrap(n))
        return fn(), calls
    finally:
        for n, f in originals.items():
            setattr(tfc, n, f)


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_reduced_embedding_eval_matches_jax(reduced, name):
    module = registry.EmbeddingModule(name, encodings_len=D).eval()
    variables = port_variables(module)
    assert "se" in variables["params"]["backbone"]["stage2_block1"] or (
        "se" not in name)
    x = _images(0)
    jmodule = JEmbeddingModule(backbone_name=name, encodings_len=D)
    want = jax.jit(lambda v, x: jmodule.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = module(torch.from_numpy(x))
    assert rel_err(got.numpy(), want) <= FWD_TOL


@pytest.mark.parametrize("name", ["seresnet18", "seresnext50"])
def test_reduced_triplet_step_matches_jax_float64(reduced, name):
    """Two batch-hard SGD steps, each from the JAX float64 trajectory's
    state: the loss, every parameter and the running statistics. The SE
    basic block and the SE grouped bottleneck cover each layer of the
    four variants."""
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 256, (B, SIZE, SIZE, 3), np.uint8),
                np.repeat(np.arange(B // 2), 2).astype(np.int32))
               for _ in range(2)]
    module = registry.EmbeddingModule(name, encodings_len=D)
    variables = biases_moved(port_variables(module, seed=1))
    jmodule = JEmbeddingModule(backbone_name=name, encodings_len=D)
    results = triplet_steps_against_jax(jmodule, variables, module, batches,
                                        [[], []], {}, lr=0.05)
    for loss, jloss, got, want in results:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        for key in got:
            if "num_batches" not in key:
                tol = 1e-5 if "running_" in key else PARAM_TOL
                assert rel_err(got[key], want[key]) <= tol, key
    # every parameter but the classifier's, which the step does not use,
    # and the bias of stage 1's one-unit SE reduction, a dead ReLU here
    start = flax_to_torch(variables, module)
    still = [n for n, _ in module.named_parameters()
             if torch.equal(results[0][2][n], start[n])]
    assert all(n.startswith("classifier.") or n.endswith("se.fc1.bias")
               for n in still), still


# SE bottlenecks at 64 px, as tests/test_torch_port_resnet.py's SMALL: stage
# 3 block 2 at [B,4,4,128] and stage 4 block 2 at [B,2,2,256] fuse
SMALL = dict(stage_sizes=(1, 1, 2, 2), num_filters=32)


@pytest.fixture(scope="module")
def se_bottleneck():
    x = _images(4, size=64)
    model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock, use_se=True,
                           **SMALL)
    variables = port_variables(model)
    jmodel = jresnet.ResNet(block_cls=jresnet.BottleneckBlock, use_se=True,
                            **SMALL)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    return x, variables, want


@pytest.mark.parametrize("fast_conv", [False, True])
def test_se_resnet_fast_conv_matches_jax(se_bottleneck, fast_conv):
    """The SE gate sits after ``bn3``, so ``bn1 -> relu -> conv2`` stays
    fused: K3 runs as often as on the plain ResNet of the same shape."""
    x, variables, want = se_bottleneck
    model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock, use_se=True,
                           fast_conv=fast_conv, **SMALL).eval()
    model.load_state_dict(flax_to_torch(variables, model))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        got, calls = _counting(lambda: model(xt))
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= FWD_TOL
    assert calls == {"conv3x3_small": 0, "conv3x3_small_mixed": 0,
                     "conv3x3_small_bn_relu": 2 if fast_conv else 0}


def test_resnext_fast_conv_takes_no_kernel():
    """A grouped 3x3 conv is never fused (the repaired gate) and
    :class:`FastConv3x3` sends it to ``F.conv2d``: with ``fast_conv`` on, a
    ResNeXt whose ungrouped twin fuses at stages 3-4 launches no kernel,
    and equals JAX's."""
    kw = dict(stage_sizes=(1, 1, 2, 2), num_filters=32, groups=4,
              width_per_group=8)
    x = _images(5, size=64)
    model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock,
                           fast_conv=True, **kw).eval()
    variables = port_variables(model)
    block = model.stage3_block2
    assert isinstance(block.conv2, tfc.FastConv3x3) and block.conv2.groups == 4
    assert isinstance(block.bn1, tresnet.BatchNorm)
    assert block.conv2.in_channels == 128                   # eligible width
    jmodel = jresnet.ResNet(block_cls=jresnet.BottleneckBlock, **kw)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got, calls = _counting(lambda: model(xt))
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= FWD_TOL
    assert calls == dict.fromkeys(calls, 0)
    ungrouped = tresnet.ResNet(block_cls=tresnet.BottleneckBlock,
                               fast_conv=True, **SMALL)
    assert isinstance(ungrouped.stage3_block2.conv2, tfc.FusedBNReluConv3x3)


def _jax_block(planes, strides, train, groups=4):
    norm = partial(fnn.BatchNorm, use_running_average=not train,
                   momentum=0.99, epsilon=1e-5)
    return jresnet.SENet154Block(planes=planes, strides=strides, norm=norm,
                                 groups=groups)


def _port_block(in_channels, planes, strides, groups=4):
    norm = partial(tresnet.BatchNorm, eps=1e-5, momentum=0.99)
    return tresnet.SENet154Block(in_channels, planes, norm, strides, groups)


@pytest.mark.parametrize("in_channels,strides", [(32, (2, 2)), (64, (1, 1))],
                         ids=["downsample", "identity"])
def test_senet154_block_matches_jax(in_channels, strides):
    planes = 16
    block = _port_block(in_channels, planes, strides)
    variables = port_variables(block)
    params = variables["params"]
    assert ("downsample_conv" in params) == (strides == (2, 2))
    if strides == (2, 2):
        assert params["downsample_conv"]["kernel"].shape == (3, 3, 32, 64)
    assert params["conv2"]["kernel"].shape == (3, 3, 8, 64)   # 64 groups/16
    x = np.random.default_rng(6).normal(size=(4, 8, 8, in_channels))

    # eval, float32
    want = jax.jit(lambda v, x: _jax_block(planes, strides, False).apply(
        v, x))(variables, jnp.asarray(x, jnp.float32))
    with torch.inference_mode():
        got = block.eval()(torch.from_numpy(x).float().permute(0, 3, 1, 2))
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= FWD_TOL

    # train mode, float64: output, running statistics, every gradient
    r = np.random.default_rng(7).normal(size=want.shape)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jblock = _jax_block(planes, strides, True)

        def loss(params, x):
            out, mut = jblock.apply(
                {"params": params, "batch_stats": v64["batch_stats"]}, x,
                mutable=["batch_stats"])
            return (out * r).sum(), (out, mut["batch_stats"])

        (_, (jout, jstats)), (jgrads, jgx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(v64["params"],
                                                 jnp.asarray(x))
    block = block.double().train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = block(xt)
    (out * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    assert rel_err(out.detach().permute(0, 2, 3, 1).numpy(), jout) <= F64_TOL
    assert rel_err(xt.grad.permute(0, 2, 3, 1).numpy(), jgx) <= F64_TOL
    want_grads = flax_to_torch({"params": jax.tree.map(np.asarray, jgrads),
                                "batch_stats": jax.tree.map(np.asarray,
                                                            jstats)}, block)
    for name, p in block.named_parameters():
        assert rel_err(p.grad.numpy(), want_grads[name]) <= F64_TOL, name
    for key, value in block.state_dict().items():
        if "running_" in key:
            assert rel_err(value.numpy(), want_grads[key]) <= F64_TOL, key


def test_senet154_tree_matches_jax():
    """The full SENet-154 (three-conv stem, (3, 8, 36, 3) blocks of 64
    groups) has JAX's variables, name for name and shape for shape."""
    jmodule = jresnet.senet154()
    shapes = jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    model = registry._build_backbone("senet154", None, fast_conv=True)[0]
    assert isinstance(model, tresnet.SENet154)
    assert not any(isinstance(m, tfc.FastConv3x3) for m in model.modules())
    assert tree_shapes(torch_to_flax(model)) == tree_shapes(shapes)
    assert model.out_channels == 2048


@pytest.mark.slow
def test_senet154_train_forward_matches_jax_float64():
    """The whole SENet-154 in train mode (batch statistics keep its 50
    blocks' activations in range, where eval mode at random weights drives
    the SE gates to 1e-57 and amplifies float64 rounding to 1e-5), float64:
    the output and every running statistic."""
    model = tresnet.senet154().double().train()
    variables = port_variables(model)
    x = np.random.default_rng(8).uniform(size=(4, SIZE, SIZE, 3))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, stats = jax.jit(lambda v, x: jresnet.senet154().apply(
            v, x, train=True, mutable=["batch_stats"]))(v64, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= 1e-9
    after = flax_to_torch({"params": variables["params"],
                           "batch_stats": jax.tree.map(np.asarray, stats[
                               "batch_stats"])}, model)
    for key, value in model.state_dict().items():
        if "running_" in key:
            assert rel_err(value.numpy(), after[key]) <= 1e-9, key


def test_initialisers_match_jax():
    """He-normal convs (truncated, variance 2 / fan_in, a grouped conv's
    fan_in its group's) and ``lecun_normal`` SE Dense layers (variance
    1 / fan_in), the port's draws and JAX's alike."""
    kw = dict(stage_sizes=(1, 1, 1, 1), num_filters=64, use_se=True,
              groups=8, width_per_group=8)
    jmodel = jresnet.ResNet(block_cls=jresnet.BottleneckBlock, **kw)
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, SIZE, SIZE, 3)))
    model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock, **kw)
    jstate = flax_to_torch(jax.tree.map(np.asarray, jvars), model)
    registry._reset_backbone(model, torch.Generator().manual_seed(0))
    checked = {"conv": 0, "dense": 0}
    for name, p in model.named_parameters():
        if p.dim() < 2 or p.numel() < 2048:
            continue
        kind = "conv" if p.dim() == 4 else "dense"
        std = np.sqrt((2.0 if kind == "conv" else 1.0) / p[0].numel())
        for label, a in (("port", p.detach().numpy()),
                         ("jax", jstate[name].numpy())):
            assert abs(a.std() / std - 1) < 0.1, (label, name)
            assert np.abs(a).max() <= 2 * std / .87962566103423978 + 1e-6
        checked[kind] += 1
    assert checked["conv"] >= 8 and checked["dense"] >= 4
