"""The port's GPipe building block (``parallel/pp.py``) against the
sequential blocks and the JAX package's ``pipeline_blocks_forward``.

The tiny ViT's two encoder blocks (dim 32, 4 heads; ``tests/test_tp.py``'s
model) in float64 on 8 rows of 5 tokens: through 2 stages on 2 gloo ranks
with 2 and 4 microbatches, and through 1 stage in one process; the output
and the gradient of ``sum(y ** 2)`` for each stage's parameters against
the port's blocks applied in order to EXACT_TOL of each tensor's largest
entry, and against JAX's sequential blocks and its pipeline on a 2-device
virtual mesh: the output to JAX_TOL, the gradient (of JAX's sequential
blocks) to JAX_GRAD_TOL. The ranks live in ``tests/_torch_port_spawn.py``, which imports
no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models.vit import EncoderBlock as JEncoderBlock  # noqa
from embeddingnet_tpu.parallel import build_mesh  # noqa: E402
from embeddingnet_tpu.parallel.pp import (  # noqa: E402
    pipeline_blocks_forward as jpipeline, stack_stage_params as jstack)

from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.models.vit import EncoderBlock  # noqa: E402
from embeddingnet_tpu_torch.parallel import pp  # noqa: E402

import _torch_port_spawn as ranks  # noqa: E402
from _torch_port import numpy_tree  # noqa: E402

DIM, HEADS, DEPTH = 32, 4, 2
EXACT_TOL = 1e-12
JAX_TOL = 1e-10        # outputs against JAX
# gradients against JAX's (measured 5e-8 for every tensor: JAX's float64
# backward rounds so; the port's pipeline meets its own blocks to 1e-12)
JAX_GRAD_TOL = 1e-7


@pytest.fixture(scope="module")
def blocks():
    block = JEncoderBlock(DIM, HEADS)
    keys = jax.random.split(jax.random.PRNGKey(0), DEPTH)
    params = [numpy_tree(block.init(k, jnp.zeros((2, 5, DIM)))["params"])
              for k in keys]
    x = np.random.default_rng(0).normal(size=(8, 5, DIM))
    sds = [{k: v.double() for k, v in flax_to_torch(
        {"params": p}, EncoderBlock(DIM, HEADS)).items()} for p in params]
    return block, params, x, sds


def _sequential(sds, x):
    block = EncoderBlock(DIM, HEADS).double()
    params = [{k: v.clone().requires_grad_(True) for k, v in sd.items()}
              for sd in sds]
    y = torch.as_tensor(x)
    for p in params:
        y = torch.func.functional_call(block, p, (y,))
    grads = torch.autograd.grad((y ** 2).sum(),
                                [t for p in params for t in p.values()])
    it = iter(grads)
    return y.detach(), [{k: next(it) for k in p} for p in params]


def _close(got, want, tol, what, scale=None):
    """``got`` within ``tol`` of ``want``'s largest entry (or of
    ``scale``)."""
    scale = float(want.abs().max()) if scale is None else scale
    gap = float((got - want).abs().max()) / scale
    assert gap <= tol, (what, gap)


def _grads_close(got, want, tol):
    """A stage's gradients, by name: the key bias's is zero in exact
    arithmetic (the softmax ignores a shift of a query's scores), so it is
    held to the block's largest gradient entry."""
    largest = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        _close(got[name], g, tol, name,
               largest if name == "attn.key.bias" else None)


@pytest.fixture(scope="module")
def two_stages(blocks, tmp_path_factory):
    _, _, x, sds = blocks
    return ranks.spawn(ranks.pipeline_worker, 2,
                       tmp_path_factory.mktemp("pp"), sds, x, (2, 4))


@pytest.mark.parametrize("n_micro", [2, 4])
def test_two_stages_match_the_sequential_blocks(blocks, two_stages,
                                                n_micro):
    _, _, x, sds = blocks
    want_y, want_g = _sequential(sds, x)
    for stage, run in enumerate(two_stages):
        got = run[n_micro]
        # every rank of the group holds the output
        _close(got["out"], want_y, EXACT_TOL, "out")
        # stage s holds block s (one block a stage): [1, ...]
        _grads_close({k: g[0] for k, g in got["grads"].items()},
                     want_g[stage], EXACT_TOL)


@pytest.mark.parametrize("n_micro", [1, 4])
def test_one_stage_is_the_blocks_in_order(blocks, n_micro):
    _, _, x, sds = blocks
    got = ranks.pipeline_run(sds, x, 1, n_micro)
    want_y, want_g = _sequential(sds, x)
    _close(got["out"], want_y, EXACT_TOL, "out")
    for i in range(DEPTH):
        _grads_close({k: g[i] for k, g in got["grads"].items()}, want_g[i],
                     EXACT_TOL)


def test_against_the_jax_pipeline(blocks, two_stages):
    """The output against JAX's sequential blocks and its pipeline over a
    2-device mesh (``model=2``), and each stage's gradient against JAX's
    sequential blocks' (a gradient through JAX's pipeline compiles for
    about a minute on the CPU, ``tests/test_pp.py`` marks it slow)."""
    block, params, x, sds = blocks
    mesh = build_mesh(data=1, model=2, devices=jax.devices()[:2])
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        xj = jnp.asarray(x)

        def apply(p, h):
            return block.apply({"params": p}, h)

        def seq(plist):
            h = xj
            for p in plist:
                h = apply(p, h)
            return h

        y_seq = np.asarray(seq(p64))
        y_pipe = np.asarray(jpipeline(apply, jstack(p64, n_stages=2), xj,
                                      mesh, n_micro=2))
        g_seq = numpy_tree(jax.grad(lambda ps: jnp.sum(seq(ps) ** 2))(p64))
    got = two_stages[0][2]
    for want in (y_seq, y_pipe):
        _close(got["out"], torch.as_tensor(want), JAX_TOL, "out")
    for stage, run in enumerate(two_stages):
        want = flax_to_torch({"params": g_seq[stage]},
                             EncoderBlock(DIM, HEADS))
        _grads_close({k: g[0] for k, g in run[2]["grads"].items()},
                     {k: v.double() for k, v in want.items()},
                     JAX_GRAD_TOL)


def test_stack_stage_params_shape(blocks):
    _, _, _, sds = blocks
    stacked = pp.stack_stage_params(sds, n_stages=2)
    assert stacked["mlp.fc1.weight"].shape == (2, 1, 4 * DIM, DIM)
    assert pp.stack_stage_params(sds, 1)["mlp.fc1.weight"].shape == (
        1, 2, 4 * DIM, DIM)
    with pytest.raises(ValueError, match="not divisible"):
        pp.stack_stage_params(sds, 3)
