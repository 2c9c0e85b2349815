"""The port's Inception-ResNet-v2 (``embeddingnet_tpu_torch/models/
inception.py``) against the JAX package's.

The JAX module takes no size parameters, so the non-slow tests share one
module fixture: the whole model's embedding module at 75 px (the
smallest input) from the port's variables, its tree against JAX's
shapes (``jax.eval_shape``), and its eval forward in float32. On it: the
residual blocks' biased projections with no BatchNorm. The train-mode
triplet step against the JAX step in float64 is slow.

B=4, 16-d; one torch thread."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models.convert import torch_to_flax  # noqa: E402

from _torch_port import (biases_moved, port_variables, rel_err,  # noqa
                         tree_shapes, triplet_steps_against_jax,
                         zoo_eval_reference)

SIZE, B, D = 75, 4, 16
NAME = "inceptionresnetv2"
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
def inception_resnet():
    """(port module, its variables, JAX's variable shapes, input, JAX's
    eval embeddings)."""
    return zoo_eval_reference(NAME, 1, SIZE, B, D)


def test_tree_matches_jax(inception_resnet):
    module, _, shapes, _, _ = inception_resnet
    assert tree_shapes(torch_to_flax(module)) == tree_shapes(shapes)
    n_params = sum(np.prod(s) for k, s in tree_shapes(
        shapes["params"]).items())
    assert n_params == sum(p.numel() for p in module.parameters())


def test_embedding_eval_matches_jax(inception_resnet):
    module, _, _, x, want = inception_resnet
    with torch.inference_mode():
        got = module(torch.from_numpy(x))
    assert rel_err(got.numpy(), want) <= FWD_TOL


def test_block_projections_have_bias_and_no_batchnorm(inception_resnet):
    """The residual blocks close with a biased 1x1 conv and no BatchNorm;
    the last conv (``conv_7b``) has its BatchNorm."""
    params = inception_resnet[1]["params"]["backbone"]
    biased = sorted(int(k[4:]) for k, v in params.items()
                    if k.startswith("conv") and "bias" in v)
    assert len(biased) == 10 + 20 + 10
    assert not any(f"bn{i}" in params for i in biased)
    last = max(int(k[4:]) for k in params if k.startswith("conv"))
    assert f"bn{last}" in params and last not in biased


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
