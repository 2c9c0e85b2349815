"""The port's NASNet (``embeddingnet_tpu_torch/models/nasnet.py``) against
the JAX package's.

``correct_pad`` against JAX's on odd and even maps; reduced NASNets
(``penultimate_filters=192``: cells 8 wide, so the stem cells' ``// 4``
and ``adjust``'s ``// 2`` stay above 0; one normal cell a stage) in eval
mode (float32), ``skip_reduction`` off on an odd input and on on an even
one; the reduced model swapped into both registries' ``nasnetmobile``
for a batch-hard SGD triplet step against the JAX step in float64
(loss, every parameter, the running statistics) and for
``backbone_param_mask`` against JAX's; the 32 px minimum; the registry's
momentum over the module's 0.9997; NASNet-Mobile's tree against JAX's
shapes; the whole NASNet-Mobile at 32 and 33 px (slow).

Variables come from the port (``_torch_port.port_variables``). B=4, 16-d;
one torch thread."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models import nasnet as jnasnet  # noqa: E402
from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu.models.registry import \
    backbone_param_mask as j_mask  # noqa: E402
from embeddingnet_tpu_torch.models import nasnet  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)

from _torch_port import (biases_moved, port_variables, rel_err,  # noqa
                         tree_shapes, triplet_steps_against_jax)

B, D = 4, 16
REDUCED = dict(penultimate_filters=192, num_blocks=1, stem_block_filters=8)
FWD_TOL = 1e-5
# the step against JAX's float64 step, as tests/test_torch_port_efficientnet
# .py holds it, the port in float64 too: the reduced NASNet's 60 train-mode
# BatchNorms move the float32 loss 1.2e-5 (as tests/test_torch_port_zoo_
# xception.py)
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reduced(monkeypatch):
    """``nasnetmobile`` built small in both registries."""
    monkeypatch.setattr(jnasnet, "nasnetmobile", lambda **kw: jnasnet.NASNet(
        **REDUCED, **kw))
    monkeypatch.setitem(registry._ZOO, "nasnetmobile", lambda **kw:
                        nasnet.NASNet(**REDUCED, **kw))


def _images(seed, size, b=B):
    return np.random.default_rng(seed).uniform(
        size=(b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("n", [7, 8, 15, 16])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_correct_pad_matches_jax(n, k):
    x = torch.zeros(1, 2, n, n + 1)
    (top, bottom), (left, right) = jnasnet._correct_pad(
        np.zeros((1, n, n + 1, 2)), k)
    assert nasnet.correct_pad(x, k) == (left, right, top, bottom)


@pytest.mark.parametrize("skip_reduction,size", [(False, 33), (True, 32)])
def test_reduced_nasnet_eval_matches_jax(skip_reduction, size):
    model = nasnet.NASNet(skip_reduction=skip_reduction, **REDUCED).eval()
    variables = port_variables(model)
    x = _images(size, size)
    jmodel = jnasnet.NASNet(skip_reduction=skip_reduction, **REDUCED)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (B, 192, 1, 1)
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= FWD_TOL


def test_reduced_triplet_step_matches_jax_float64(reduced):
    """A step at 33 px (odd: ``correct_pad`` pads both sides there)."""
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 256, (B, 33, 33, 3), np.uint8),
                np.repeat(np.arange(B // 2), 2).astype(np.int32))]
    module = registry.EmbeddingModule("nasnetmobile", encodings_len=D)
    variables = biases_moved(port_variables(module, seed=1))
    jmodule = JEmbeddingModule(backbone_name="nasnetmobile", encodings_len=D)
    results = triplet_steps_against_jax(jmodule, variables, module, batches,
                                        [[]], {}, lr=0.05,
                                        port_float64=True)
    for loss, jloss, got, want in results:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        for key in got:
            if "num_batches" not in key:
                tol = 1e-5 if "running_" in key else PARAM_TOL
                assert rel_err(got[key], want[key]) <= tol, key


@pytest.mark.parametrize("freeze", ["all", "except_last_2"])
def test_backbone_param_mask_matches_jax(reduced, freeze):
    module = registry.EmbeddingModule("nasnetmobile", encodings_len=D)
    variables = port_variables(module)
    params = jax.tree.map(np.asarray, variables["params"])
    want = flax_to_torch({"params": jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        j_mask(params, freeze), params),
        "batch_stats": variables["batch_stats"]}, module)
    got = registry.backbone_param_mask(module, freeze)
    assert got == {n: bool(want[n].all()) for n in got}
    assert not all(got.values()) and any(got.values())


def test_minimum_size_and_momentum():
    model = nasnet.NASNet(**REDUCED)
    with pytest.raises(ValueError, match=">= 32px"):
        model(torch.zeros(1, 3, 31, 40))
    assert model.stem_bn1.momentum == pytest.approx(1 - 0.9997)
    # the registry passes PERFORMANCE.bn_momentum, as JAX's does
    built, _ = registry._build_backbone("nasnetmobile", None, bn_momentum=0.9)
    assert built.stem_bn1.momentum == pytest.approx(0.1)


def test_nasnetmobile_tree_matches_jax():
    shapes = jax.eval_shape(lambda: jnasnet.nasnetmobile().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    model = nasnet.nasnetmobile()
    assert tree_shapes(torch_to_flax(model)) == tree_shapes(shapes)
    assert model.out_channels == 1056


@pytest.mark.slow
@pytest.mark.parametrize("size", [32, 33])
def test_nasnetmobile_eval_matches_jax(size):
    module = registry.EmbeddingModule("nasnetmobile", encodings_len=D).eval()
    variables = port_variables(module)
    x = _images(size + 1, size)
    jmodule = JEmbeddingModule(backbone_name="nasnetmobile", encodings_len=D)
    want = jax.jit(lambda v, x: jmodule.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = module(torch.from_numpy(x))
    assert rel_err(got.numpy(), want) <= FWD_TOL
