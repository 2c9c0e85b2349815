"""The port's VGG and DenseNet (``embeddingnet_tpu_torch/models/vgg.py``,
``densenet.py``) against the JAX package's, and the initialiser of the
zoo families that take Flax's default.

VGG-16 whole at 32 px in eval mode (float32); VGG-19's and DenseNet-121's
trees against JAX's shapes; reduced VGG and DenseNet (``block_sizes=(1,
2, 1, 1)``, growth 8) swapped into both registries with ``monkeypatch``:
the embedding module in eval mode (float32) and two batch-hard SGD
triplet steps against the JAX step in float64 (loss, every parameter, the
running statistics); DenseNet-121 whole in eval mode (slow). Every conv
of VGG, DenseNet, Xception, the Inceptions and NASNet draws Flax's
``lecun_normal`` (truncated, variance 1 / fan_in), zero biases, the port's
draws and JAX's alike.

Variables come from the port (``_torch_port.port_variables``). B=8 at 32
px, 16-d; one torch thread."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models import densenet as jdensenet  # noqa: E402
from embeddingnet_tpu.models import vgg as jvgg  # noqa: E402
from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu_torch.models import densenet  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models import vgg  # noqa: E402
from embeddingnet_tpu_torch.models.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)

from _torch_port import (biases_moved, port_variables, rel_err,  # noqa
                         tree_shapes, triplet_steps_against_jax)

SIZE, B, D = 32, 8, 16
FWD_TOL = 1e-5
# the port's f32 step against JAX's float64 step (as
# tests/test_torch_port_efficientnet.py)
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5
VGG_BLOCKS = ((16, 1), (32, 2))
DENSE_BLOCKS, GROWTH = (1, 2, 1, 1), 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reduced(monkeypatch):
    """``vgg16`` and ``densenet121`` built small in both registries."""
    monkeypatch.setattr(jvgg, "vgg16", lambda **kw: jvgg.VGG(
        blocks=VGG_BLOCKS, **kw))
    monkeypatch.setattr(jdensenet, "densenet121", lambda **kw:
                        jdensenet.DenseNet(block_sizes=DENSE_BLOCKS,
                                           growth=GROWTH, **kw))
    monkeypatch.setitem(registry._ZOO, "vgg16", lambda bn_momentum, **kw:
                        vgg.VGG(VGG_BLOCKS, **kw))
    monkeypatch.setitem(registry._ZOO, "densenet121", lambda **kw:
                        densenet.DenseNet(DENSE_BLOCKS, growth=GROWTH, **kw))


def _images(seed, b=B, size=SIZE):
    return np.random.default_rng(seed).uniform(
        size=(b, size, size, 3)).astype(np.float32)


def _eval_against_jax(name, x):
    module = registry.EmbeddingModule(name, encodings_len=D).eval()
    variables = port_variables(module)
    jmodule = JEmbeddingModule(backbone_name=name, encodings_len=D)
    want = jax.jit(lambda v, x: jmodule.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = module(torch.from_numpy(x))
    return rel_err(got.numpy(), want)


def test_vgg16_embedding_eval_matches_jax():
    module = registry.EmbeddingModule("vgg16", encodings_len=D)
    assert module.backbone.out_channels == 512
    assert _eval_against_jax("vgg16", _images(0)) <= FWD_TOL


@pytest.mark.parametrize("name", ["vgg19", "densenet121"])
def test_full_tree_matches_jax(name):
    jmodule = JEmbeddingModule(backbone_name=name, encodings_len=D)
    shapes = jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        method="init_all"))
    module = registry.EmbeddingModule(name, encodings_len=D)
    assert tree_shapes(torch_to_flax(module)) == tree_shapes(shapes)


@pytest.mark.parametrize("name", ["vgg16", "densenet121"])
def test_reduced_embedding_eval_matches_jax(reduced, name):
    assert _eval_against_jax(name, _images(1)) <= FWD_TOL


@pytest.mark.parametrize("name", ["vgg16", "densenet121"])
def test_reduced_triplet_step_matches_jax_float64(reduced, name):
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 256, (B, SIZE, SIZE, 3), np.uint8),
                np.repeat(np.arange(B // 2), 2).astype(np.int32))
               for _ in range(2)]
    module = registry.EmbeddingModule(name, encodings_len=D)
    # VGG's biased convs moved up: moved both ways, the reduced VGG's small
    # activations all fall below its ReLUs' zero
    variables = biases_moved(port_variables(module, seed=1), positive=True)
    jmodule = JEmbeddingModule(backbone_name=name, encodings_len=D)
    results = triplet_steps_against_jax(jmodule, variables, module, batches,
                                        [[], []], {}, lr=0.05)
    for loss, jloss, got, want in results:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        for key in got:
            if "num_batches" not in key:
                tol = 1e-5 if "running_" in key else PARAM_TOL
                assert rel_err(got[key], want[key]) <= tol, key
    # every parameter but the classifier's, which the step does not use
    start = flax_to_torch(variables, module)
    still = [n for n, _ in module.named_parameters()
             if torch.equal(results[0][2][n], start[n])]
    assert all(n.startswith("classifier.") for n in still), still


def test_densenet_concatenation_and_transition():
    """The input channels first, then each layer's ``growth``; each
    transition halves the channels and pools 2x2."""
    model = densenet.DenseNet(DENSE_BLOCKS, growth=GROWTH)
    assert model.stage2_block1.bn0.num_features == (64 + GROWTH) // 2
    assert model.transition2_conv.out_channels == (
        (64 + GROWTH) // 2 + 2 * GROWTH) // 2
    x = torch.randn(2, 3, SIZE, SIZE)
    feats = {}
    model.stage1_block1.register_forward_hook(
        lambda m, i, o: feats.update(inp=i[0], out=o))
    with torch.no_grad():
        model.eval()(x)
    assert torch.equal(feats["out"][:, :64], feats["inp"])
    assert feats["out"].shape[1] == 64 + GROWTH


@pytest.mark.slow
def test_densenet121_embedding_eval_matches_jax():
    assert _eval_against_jax("densenet121", _images(2)) <= FWD_TOL


@pytest.mark.parametrize("name", ["vgg16", "densenet121", "xception",
                                  "inceptionv3", "nasnetmobile"])
def test_lecun_normal_initialiser(name):
    """Each conv kernel: a normal truncated at two standard deviations of
    variance 1 / fan_in (a depthwise kernel's fan_in k^2), zero biases;
    BatchNorm 1 and 0 (the port's draws from ``_reset_backbone``). JAX
    draws the same (``test_lecun_normal_matches_jax_draws``)."""
    backbone, _ = registry._build_backbone(name, None)
    registry._reset_backbone(backbone, torch.Generator().manual_seed(0))
    checked = 0
    for key, p in backbone.named_parameters():
        w = p.detach().numpy()
        if key.endswith("bias") and p.dim() == 1 and not any(
                s in key for s in ("bn", "_bn")):
            assert not w.any(), key
        if p.dim() != 4 or p.numel() < 4096:
            continue
        std = np.sqrt(1.0 / p[0].numel())
        assert abs(w.std() / std - 1) < 0.1, key
        assert np.abs(w).max() <= 2 * std / .87962566103423978 + 1e-6, key
        checked += 1
    assert checked >= 5


def test_lecun_normal_matches_jax_draws():
    """JAX's reduced DenseNet and VGG kernels have the statistics the port
    draws (``test_lecun_normal_initialiser``)."""
    for jmodel in (jdensenet.DenseNet(block_sizes=DENSE_BLOCKS, growth=32),
                   jvgg.VGG(blocks=((64, 2), (128, 1)))):
        variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, SIZE, SIZE, 3)))
        checked = 0
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables["params"]):
            a = np.asarray(leaf)
            if a.ndim != 4 or a.size < 4096:
                if a.ndim == 1 and "conv" in str(path[-2]):
                    assert not a.any()                 # the VGG biases
                continue
            std = np.sqrt(1.0 / np.prod(a.shape[:3]))
            assert abs(a.std() / std - 1) < 0.1, path
            assert np.abs(a).max() <= 2 * std / .87962566103423978 + 1e-6
            checked += 1
        assert checked >= 2
