"""The port's small-spatial 3x3 conv ops and modules against the JAX
package's (``embeddingnet_tpu/ops/fused_conv.py``, Pallas in interpret mode
on the CPU). Inputs are made with numpy from a seed; comparisons are f32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.ops import fused_conv as jfc  # noqa: E402
from embeddingnet_tpu_torch.ops import _cuda  # noqa: E402
from embeddingnet_tpu_torch.ops import fused_conv as tfc  # noqa: E402

# f32 on both sides; the sums run in another order (1e-4, as the JAX
# package's own oracle tests of these kernels)
TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(8, 4, 128, 128), (8, 2, 128, 256)]


def _inputs(seed, b, s, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, s, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    # bias well away from 0, so relu(bias) != 0 tests the zero ring
    scale = rng.uniform(0.5, 2.0, size=(cin,)).astype(np.float32)
    bias = (rng.normal(size=(cin,)) + 1.0).astype(np.float32)
    return x, w, scale, bias


@pytest.fixture(autouse=True)
def _fresh_counts():
    tfc.reset_launch_counts()
    yield
    # the CPU route runs the plain versions and launches nothing
    assert not any(tfc.LAUNCHES.values()), tfc.LAUNCHES


@pytest.mark.parametrize("b,s,cin,cout", SHAPES)
def test_conv3x3_small_matches_jax(b, s, cin, cout):
    x, w, _, _ = _inputs(0, b, s, cin, cout)
    want = np.asarray(jfc.conv3x3_small(jnp.asarray(x), jnp.asarray(w)))
    got = tfc.conv3x3_small(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == (b, s, s, cout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("b,s,cin,cout", SHAPES)
def test_conv3x3_small_bn_relu_matches_jax(b, s, cin, cout):
    x, w, scale, bias = _inputs(1, b, s, cin, cout)
    want = np.asarray(jfc.conv3x3_small_bn_relu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias)))
    got = tfc.conv3x3_small_bn_relu(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


GATE_CASES = [
    ((16, 4, 4, 128), (3, 3, 128, 128), (1, 1), 1),
    ((16, 4, 4, 128), (3, 3, 128, 128), (2, 2), 1),
    ((16, 4, 4, 128), (3, 3, 128, 128), (1, 1), 32),
    ((16, 6, 6, 128), (3, 3, 128, 128), (1, 1), 1),
    ((16, 8, 8, 128), (3, 3, 128, 128), (1, 1), 1),
    ((16, 16, 16, 128), (3, 3, 128, 128), (1, 1), 1),
    ((16, 4, 4, 64), (3, 3, 64, 64), (1, 1), 1),
    ((16, 4, 4, 128), (1, 1, 128, 128), (1, 1), 1),
    ((16, 2, 2, 512), (3, 3, 512, 512), (1, 1), 1),
]


@pytest.mark.parametrize("x_shape,w_shape,strides,groups", GATE_CASES)
def test_gate_matches_jax(x_shape, w_shape, strides, groups):
    assert (tfc.eligible(x_shape, w_shape, strides, groups)
            == jfc.eligible(x_shape, w_shape, strides, groups))
    assert (tfc.eligible_mixed(x_shape, w_shape, strides, groups)
            == jfc.eligible_mixed(x_shape, w_shape, strides, groups))


def test_gate_documented_differences():
    w = (3, 3, 128, 128)
    # the kernel masks a ragged batch: no batch-tile condition
    assert not jfc.eligible((7, 4, 4, 128), w)
    assert tfc.eligible((7, 4, 4, 128), w)
    # on the card only bf16 is eligible; on the CPU (dtype None) any type
    assert tfc.eligible((7, 4, 4, 128), w, dtype=torch.bfloat16)
    assert not tfc.eligible((7, 4, 4, 128), w, dtype=torch.float32)
    assert not tfc.eligible((7, 4, 4, 128), w, dtype=torch.float16)
    # no VMEM weight-block cap (the JAX gate refuses C=1024 on the TPU)
    assert tfc.eligible((8, 2, 2, 1024), (3, 3, 1024, 1024),
                        dtype=torch.bfloat16)


def test_fast_conv_state_dict_is_conv2d():
    fast = tfc.FastConv3x3(128, 256)
    fused = tfc.FusedBNReluConv3x3(128, 256)
    ref = torch.nn.Conv2d(128, 256, 3, padding=1, bias=False)
    for mod in (fast, fused):
        sd = mod.state_dict()
        assert sd.keys() == ref.state_dict().keys()
        assert sd["weight"].shape == ref.weight.shape
        mod.load_state_dict(ref.state_dict())
    bn = tfc.BNScaleBias(128)
    assert bn.state_dict().keys() == torch.nn.BatchNorm2d(128).state_dict(
    ).keys()


@pytest.mark.parametrize("shape", [(4, 128, 2, 2), (2, 32, 7, 7)])
def test_fast_conv_module_matches_conv2d(shape):
    """Eligible and fallback shapes: the module equals nn.Conv2d under the
    same weight."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .contiguous(memory_format=torch.channels_last)
    fast = tfc.FastConv3x3(shape[1], 128)
    ref = torch.nn.Conv2d(shape[1], 128, 3, padding=1, bias=False)
    fast.load_state_dict(ref.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(fast(x).numpy(), ref(x).numpy(), **TOL)


def test_bn_scale_bias_matches_jax():
    """Same (scale, bias) as the JAX BNScaleBias, in eval mode and in train
    mode, and the same running-statistics update."""
    rng = np.random.default_rng(13)
    x = rng.normal(2.0, 3.0, size=(16, 4, 4, 32)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=(32,)).astype(np.float32)
    beta = rng.normal(size=(32,)).astype(np.float32)
    mean = rng.normal(size=(32,)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=(32,)).astype(np.float32)
    variables = {"params": {"scale": gamma, "bias": beta},
                 "batch_stats": {"mean": mean, "var": var}}

    jmod = jfc.BNScaleBias(momentum=0.9, epsilon=1e-3)
    tmod = tfc.BNScaleBias(32, eps=1e-3, momentum=0.9)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(gamma))
        tmod.bias.copy_(torch.from_numpy(beta))
        tmod.running_mean.copy_(torch.from_numpy(mean))
        tmod.running_var.copy_(torch.from_numpy(var))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    want = jmod.apply(variables, jnp.asarray(x), use_running_average=True)
    with torch.no_grad():
        got = tmod.eval()(xt)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6,
                                   atol=1e-6)

    want, upd = jmod.apply(variables, jnp.asarray(x),
                           use_running_average=False,
                           mutable=["batch_stats"])
    with torch.no_grad():
        got = tmod.train()(xt)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(tmod.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tmod.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


def test_fused_module_matches_jax_module():
    """FusedBNReluConv3x3 on converted weights equals the JAX module."""
    b, s, cin, cout = 4, 2, 128, 128
    x, w, scale, bias = _inputs(4, b, s, cin, cout)
    want = np.asarray(jfc.FusedBNReluConv3x3(cout).apply(
        {"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x),
        jnp.asarray(scale), jnp.asarray(bias)))
    mod = tfc.FusedBNReluConv3x3(cin, cout)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_cuda_module_imports_without_nvcc(monkeypatch, tmp_path):
    """ops/_cuda.py imports anywhere; only a build asks for nvcc, and
    without one it raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()
    assert not (tmp_path / "build").exists()


def test_library_path_keyed_by_source():
    """One library per source, each keyed by a hash of all the sources."""
    paths = [_cuda.library_path(src) for src in _cuda.SOURCES]
    assert {p.parent for p in paths} == {_cuda.BUILD_DIR}
    assert all(p.suffix == ".so" for p in paths)
    assert all(src.exists() for src in _cuda.SOURCES)
    assert {p.stem.rsplit("_", 1)[1] for p in paths} == {_cuda._digest()}
    assert sorted(_cuda.SOURCES) == sorted(_cuda.CSRC.glob("*.cu"))


def test_cuda_wrapper_raises_on_grad_and_bad_input():
    """The CUDA route never falls back: a tensor the kernel cannot take
    raises before any launch, whether or not it requires grad (the autograd
    op goes to the same checks), forward and backward wrappers alike
    (checked on a meta device tensor, so no card is needed)."""
    x = torch.empty((4, 2, 2, 128), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, 3, 128, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="kernel takes bf16"):
        tfc.conv3x3_small(x.float().requires_grad_(), w.requires_grad_())
    w = w.detach()
    with pytest.raises(ValueError, match="kernel takes bf16"):
        tfc.conv3x3_wgrad(x[..., :64], x)
    with pytest.raises(ValueError, match="g must be"):
        tfc.conv3x3_wgrad(x, x[:2])
    with pytest.raises(ValueError, match="kernel takes bf16"):
        tfc.conv3x3_dgrad(x.half(), w)
    with pytest.raises(ValueError, match="kernel takes bf16"):
        tfc.conv3x3_small(x.float(), w)
    with pytest.raises(ValueError, match="kernel takes bf16"):
        tfc.conv3x3_small(x[:, :1], w)
    s = torch.empty((128,), device="meta")
    with pytest.raises(ValueError, match="scale and bias"):
        tfc.conv3x3_small_bn_relu(x, w, s.half(), s)
