"""The port's InceptionV3 (``embeddingnet_tpu_torch/models/inception.py``)
against the JAX package's; Inception-ResNet-v2 is in
``test_torch_port_zoo_inception_resnet.py``, so the two whole models run
on different workers.

The JAX module takes no size parameters, so the non-slow tests share one
module fixture: the whole model's embedding module at 75 px (the
smallest input) from the port's variables, its tree against JAX's
shapes (``jax.eval_shape``), and its eval forward in float32. On it:
the BatchNorms without scale (a unit weight outside the ``state_dict``,
the parameters exactly Flax's leaves) and ``backbone_param_mask(...,
"except_last_2")`` against JAX's on the counter-numbered names. The
train-mode triplet step against the JAX step in float64 is slow.

B=4, 16-d; one torch thread."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu.models.registry import \
    backbone_param_mask as j_mask  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)
from embeddingnet_tpu_torch.models.resnet import BatchNorm  # noqa: E402

from _torch_port import (biases_moved, port_variables, rel_err,  # noqa
                         tree_shapes, triplet_steps_against_jax,
                         zoo_eval_reference)

SIZE, B, D = 75, 4, 16
NAME = "inceptionv3"
FWD_TOL = 1e-5
# the step against JAX's float64 step, as tests/test_torch_port_efficientnet
# .py holds it, the port in float64 too (deep train-mode BatchNorm, as
# tests/test_torch_port_zoo_xception.py)
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inception():
    """(port module, its variables, JAX's variable shapes, input, JAX's
    eval embeddings)."""
    return zoo_eval_reference(NAME, 0, SIZE, B, D)


def test_tree_matches_jax(inception):
    module, _, shapes, _, _ = inception
    assert tree_shapes(torch_to_flax(module)) == tree_shapes(shapes)
    n_params = sum(np.prod(s) for k, s in tree_shapes(
        shapes["params"]).items())
    assert n_params == sum(p.numel() for p in module.parameters())


def test_embedding_eval_matches_jax(inception):
    module, _, _, x, want = inception
    with torch.inference_mode():
        got = module(torch.from_numpy(x))
    assert rel_err(got.numpy(), want) <= FWD_TOL


def test_batchnorm_without_scale(inception):
    """Every InceptionV3 BatchNorm has no scale: its weight is a unit
    buffer, in neither the state_dict nor the parameters, and follows the
    module to another dtype."""
    module = inception[0]
    bns = [m for m in module.backbone.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 94
    state = module.state_dict()
    names = {n for n, _ in module.named_parameters()}
    for bn in bns[:3]:
        assert not isinstance(bn.weight, torch.nn.Parameter)
        assert torch.equal(bn.weight, torch.ones(bn.num_features))
    assert not any(k.endswith("bn1.weight") for k in state)
    assert "backbone.bn1.bias" in names and "backbone.bn1.weight" not in names
    assert bns[0].weight.dtype == torch.float32


@pytest.mark.parametrize("freeze", ["all", "except_last_2"])
def test_backbone_param_mask_matches_jax(inception, freeze):
    """The JAX mask on the tree as a tree map leaves it (sorted keys, as
    after the Trainer's weights load): the last two of ``bn1 .. bn94,
    conv1 .. conv94`` as strings are ``conv93`` and ``conv94``."""
    module, variables, _, _, _ = inception
    params = jax.tree.map(np.asarray, variables["params"])
    want = flax_to_torch({"params": jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        j_mask(params, freeze), params),
        "batch_stats": variables["batch_stats"]}, module)
    got = registry.backbone_param_mask(module, freeze)
    assert got == {n: bool(want[n].all()) for n in got}
    if freeze == "except_last_2":
        tails = {n.split(".")[1] for n, t in got.items()
                 if t and n.startswith("backbone.")}
        assert tails == {"conv93", "conv94"}


@pytest.mark.slow
def test_triplet_step_matches_jax_float64():
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 256, (B, SIZE, SIZE, 3), np.uint8),
                np.repeat(np.arange(B // 2), 2).astype(np.int32))]
    module = registry.EmbeddingModule(NAME, encodings_len=D)
    variables = biases_moved(port_variables(module, seed=1))
    jmodule = JEmbeddingModule(backbone_name=NAME, encodings_len=D)
    results = triplet_steps_against_jax(jmodule, variables, module, batches,
                                        [[]], {}, lr=0.05, port_float64=True)
    for loss, jloss, got, want in results:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        for key in got:
            if "num_batches" not in key:
                tol = 1e-5 if "running_" in key else PARAM_TOL
                assert rel_err(got[key], want[key]) <= tol, key
