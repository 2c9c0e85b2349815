"""The port's Xception (``embeddingnet_tpu_torch/models/xception.py``) and
the layers of the compact zoo (``models/compact.py``) against the JAX
package's.

TF's ``"SAME"`` max pool (3x3, stride 2; the odd pixel high, -inf) and the
count-excluding ``"SAME"`` average pool against Flax's on odd and even
sizes, exact; the whole Xception's tree against JAX's shapes; the
embedding module in eval mode at 71 and 72 px (float32); a batch-hard SGD
triplet step against the JAX step in float64 (loss, every parameter, the
running statistics) at 32 px, and two at 71 px (slow).

Variables come from the port (``_torch_port.port_variables``). B=4, 16-d;
one torch thread."""

import flax.linen as fnn
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu_torch.models import compact  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models.convert import torch_to_flax  # noqa
from embeddingnet_tpu_torch.models.xception import Xception  # noqa: E402

from _torch_port import (biases_moved, port_variables, rel_err,  # noqa
                         tree_shapes, triplet_steps_against_jax)

B, D = 4, 16
FWD_TOL = 1e-5
# the step against JAX's float64 step, as tests/test_torch_port_efficientnet.py
# holds it; the port runs in float64 too: Xception's 40 train-mode
# BatchNorms amplify float32 rounding to 1e-5 of the loss and 5e-4 of the
# first conv's update (the miner still runs in float32)
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [5, 6, 33, 34])
def test_same_pools_match_flax(n):
    """Integer inputs: the max is exact, the means of 4-9 integers over
    their count are the same float either way."""
    x = np.random.default_rng(n).integers(-9, 10, (2, n, n, 3)).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2), padding="SAME")
    got = compact.max_pool_same(xt, 3, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n % 2 == 0:
        # -inf on the high side only: F.max_pool2d's symmetric padding
        # would add a window
        assert got.shape[1] == n // 2
    want = fnn.avg_pool(jnp.asarray(x), (3, 3), (1, 1), padding="SAME",
                        count_include_pad=False)
    got = compact.avg_pool_same(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_xception_tree_matches_jax():
    jmodule = JEmbeddingModule(backbone_name="xception", encodings_len=D)
    shapes = jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 71, 71, 3)), method="init_all"))
    module = registry.EmbeddingModule("xception", encodings_len=D)
    assert tree_shapes(torch_to_flax(module)) == tree_shapes(shapes)
    backbone = module.backbone
    assert isinstance(backbone, Xception) and backbone.out_channels == 2048
    dw = backbone.block5_sepconv1_dw
    assert dw.groups == dw.in_channels == 728


@pytest.mark.parametrize("size", [71, 72])
def test_xception_embedding_eval_matches_jax(size):
    module = registry.EmbeddingModule("xception", encodings_len=D).eval()
    variables = port_variables(module)
    x = np.random.default_rng(size).uniform(size=(B, size, size, 3)).astype(
        np.float32)
    jmodule = JEmbeddingModule(backbone_name="xception", encodings_len=D)
    want = jax.jit(lambda v, x: jmodule.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.inference_mode():
        got = module(torch.from_numpy(x))
    assert rel_err(got.numpy(), want) <= FWD_TOL


def _steps_against_jax(size, n_steps):
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 256, (B, size, size, 3), np.uint8),
                np.repeat(np.arange(B // 2), 2).astype(np.int32))
               for _ in range(n_steps)]
    module = registry.EmbeddingModule("xception", encodings_len=D)
    variables = biases_moved(port_variables(module, seed=1))
    jmodule = JEmbeddingModule(backbone_name="xception", encodings_len=D)
    results = triplet_steps_against_jax(jmodule, variables, module, batches,
                                        [[]] * n_steps, {}, lr=0.05,
                                        port_float64=True)
    for loss, jloss, got, want in results:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        for key in got:
            if "num_batches" not in key:
                tol = 1e-5 if "running_" in key else PARAM_TOL
                assert rel_err(got[key], want[key]) <= tol, key


def test_xception_triplet_step_matches_jax_float64():
    """One batch-hard SGD step at 32 px (the whole Xception runs there:
    its exit flow reaches 1x1), against the JAX step in float64: the
    loss, every parameter and the running statistics. XLA's float64
    depthwise backward on the CPU takes about 55 s a step at 71 px."""
    _steps_against_jax(32, 1)


@pytest.mark.slow
def test_xception_triplet_steps_at_71px_match_jax_float64():
    _steps_against_jax(71, 2)
