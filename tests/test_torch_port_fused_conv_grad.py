"""Gradients of the port's three conv ops against ``jax.grad`` of the JAX
package's (``embeddingnet_tpu/ops/fused_conv.py``, Pallas in interpret mode
on the CPU), and the mixed-path gate. On the CPU the ops' backward runs the
plain twins of the backward kernels (K1 as the dgrad, K2, K4), the same
custom backward that launches the kernels on the card. Inputs come from
numpy with a seed; f32 on both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.ops import fused_conv as jfc  # noqa: E402
from embeddingnet_tpu_torch.ops import fused_conv as tfc  # noqa: E402

# f32, sums over up to B*S*S = 1024 rows in another order: 1e-4
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, s, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, s, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=(cin,)).astype(np.float32)
    # bias well away from 0, so relu(bias) != 0 tests the zero ring
    bias = (rng.normal(size=(cin,)) + 1.0).astype(np.float32)
    cot = rng.normal(size=(b, s, s, cout)).astype(np.float32)
    return x, w, scale, bias, cot


def _torch_grads(op, args, cot):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = op(*leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_grads(op, args, cot):
    def loss(*a):
        return jnp.sum(op(*a) * cot)
    value = op(*map(jnp.asarray, args))
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    return np.asarray(value), [np.asarray(g) for g in grads]


@pytest.fixture(autouse=True)
def _no_launches():
    tfc.reset_launch_counts()
    yield
    # the CPU route runs the plain versions and launches nothing
    assert not any(tfc.LAUNCHES.values()), tfc.LAUNCHES


OPS = [
    ("conv3x3_small", 2, (16, 2, 128, 256)),
    ("conv3x3_small", 2, (8, 4, 256, 128)),
    ("conv3x3_small_mixed", 2, (8, 8, 128, 128)),
    ("conv3x3_small_bn_relu", 4, (16, 2, 256, 128)),
    ("conv3x3_small_bn_relu", 4, (8, 4, 128, 128)),
]


@pytest.mark.parametrize("name,n_args,shape", OPS)
def test_op_value_and_grads_match_jax(name, n_args, shape):
    x, w, scale, bias, cot = _inputs(hash(shape) % 1000, *shape)
    args = (x, w, scale, bias)[:n_args]
    want, want_grads = _jax_grads(getattr(jfc, name), args, cot)
    got, got_grads = _torch_grads(getattr(tfc, name), args, cot)
    np.testing.assert_allclose(got, want, **TOL)
    for i, (g, w_) in enumerate(zip(got_grads, want_grads)):
        np.testing.assert_allclose(g, w_, **TOL, err_msg=f"argument {i}")


@pytest.mark.parametrize("fused", [False, True])
def test_modules_route_8x8_to_the_mixed_op(fused):
    """At 8x8 the modules take the mixed op (plain forward, kernel
    backward) where the JAX modules do, and their gradients equal the
    JAX modules' on the same weight."""
    b, s, c = 8, 8, 128
    x, w, scale, bias, cot = _inputs(7, b, s, c, c)
    calls = []
    original = tfc.conv3x3_small_mixed

    def counting(*a):
        calls.append(a[0].shape)
        return original(*a)

    if fused:
        mod = tfc.FusedBNReluConv3x3(c, c)
        jmod = jfc.FusedBNReluConv3x3(c)
        extra = (scale, bias)
    else:
        mod = tfc.FastConv3x3(c, c)
        jmod = jfc.FastConv3x3(c)
        extra = ()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))

    def jloss(kernel, x_, *e):
        y = jmod.apply({"params": {"kernel": kernel}}, x_, *e)
        return jnp.sum(y * cot)

    want_dw, want_dx = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(w), jnp.asarray(x), *map(jnp.asarray, extra))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    tfc.conv3x3_small_mixed = counting
    try:
        y = mod(xt, *map(torch.from_numpy, extra))
    finally:
        tfc.conv3x3_small_mixed = original
    (y.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    assert len(calls) == 1
    np.testing.assert_allclose(
        mod.weight.grad.permute(2, 3, 1, 0).numpy(), np.asarray(want_dw),
        **TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_dx), **TOL)


MIXED_GATE_CASES = [
    (16, 8, 128, 128), (8, 8, 128, 256), (1024, 8, 128, 128),
    # the batch-tile condition: a multiple of 8
    (12, 8, 128, 128), (7, 8, 128, 128), (4, 8, 128, 128),
    (24, 8, 256, 256), (40, 8, 128, 128),
    # C=512 at 8x8: the JAX wgrad row budget leaves no tile
    (1024, 8, 512, 512), (8, 8, 256, 512), (16, 8, 384, 768),
    # not 8x8
    (16, 4, 128, 128), (16, 16, 128, 128),
]


@pytest.mark.parametrize("b,s,cin,cout", MIXED_GATE_CASES)
def test_mixed_gate_matches_jax(b, s, cin, cout):
    x_shape, w_shape = (b, s, s, cin), (3, 3, cin, cout)
    assert (tfc.eligible_mixed(x_shape, w_shape)
            == jfc.eligible_mixed(x_shape, w_shape))
    # on the card only bf16 takes the kernel backward
    assert (tfc.eligible_mixed(x_shape, w_shape, dtype=torch.bfloat16)
            == jfc.eligible_mixed(x_shape, w_shape))
    assert not tfc.eligible_mixed(x_shape, w_shape, dtype=torch.float32)


def test_plain_wgrad_is_the_conv_weight_gradient():
    """The plain K2 twin equals torch's own conv weight gradient."""
    x, w, _, _, cot = _inputs(9, 4, 4, 128, 128)
    xt = torch.from_numpy(x)
    got = tfc._plain_wgrad(xt, torch.from_numpy(cot))
    want = torch.nn.grad.conv2d_weight(
        xt.permute(0, 3, 1, 2), (128, 128, 3, 3),
        torch.from_numpy(cot).permute(0, 3, 1, 2), padding=1)
    np.testing.assert_allclose(got.numpy(), want.permute(2, 3, 1, 0).numpy(),
                               **TOL)
    assert got.dtype == torch.float32


def test_wgrad_splits_fill_the_card():
    """The reduction split gives every training shape at B=1024 enough
    blocks, each part at least 16 chunks of 64 rows, and none at a tiny
    batch."""
    for s, c in ((8, 128), (4, 256), (2, 512)):
        splits = tfc.wgrad_splits(1024, s, c, c)
        tiles = (9 * c // 64) * (c // 64)
        chunks = 1024 * s * s // 64
        assert tiles * splits >= 4 * 132 or chunks // splits < 32
        assert chunks // splits >= 16
    assert tfc.wgrad_splits(8, 8, 128, 128) == 1
