"""T1: the port's ``conv3x3_small_affine_relu`` (``relu(conv3x3(x, W)*scale
+ bias)``) against the two JAX functions of the A/B tool it ports,
``tools/pallas_fused_conv.py``: ``fused_conv_bn_relu`` (the Pallas kernel,
in interpret mode on the CPU) and ``xla_conv_bn_relu``; and the port's own
A/B tool, ``tools/fused_conv_epilogue_torch.py``, end to end on the CPU.

The JAX tool reads ``FC_BATCH`` when it is imported and ``FC_INTERPRET``
when its kernel is traced, so the fixture sets both around the import and
every call. Inputs are bf16 values made once from a seeded numpy generator
and handed to both packages; outputs are bf16, compared to one bf16 ulp."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu_torch.ops import fused_conv as tfc  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BATCH = 128       # the JAX kernel's batch tile: B is a multiple of it


def _load(name, relpath):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jtool():
    """``tools/pallas_fused_conv.py`` imported with FC_INTERPRET=1 and
    FC_BATCH=128, which stay set while the module's tests run."""
    saved = {k: os.environ.get(k) for k in ("FC_INTERPRET", "FC_BATCH")}
    os.environ.update(FC_INTERPRET="1", FC_BATCH=str(JAX_BATCH))
    try:
        yield _load("pallas_fused_conv", "tools/pallas_fused_conv.py")
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


@pytest.fixture(autouse=True)
def _fresh_counts():
    tfc.reset_launch_counts()
    yield
    # the CPU route runs the plain version and launches nothing
    assert not any(tfc.LAUNCHES.values()), tfc.LAUNCHES


def _inputs(b, s, c, seed=0):
    """The JAX tool's inputs (``main``): x [B, S, S, C] and w [3, 3, C, C]
    as bf16 values, scale and bias [C] f32; numpy float32 arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, s, c))
    w = rng.normal(size=(3, 3, c, c)) * 0.02
    scale = rng.uniform(0.5, 1.5, (c,))
    bias = rng.normal(size=(c,)) * 0.1

    def bf16_values(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float() \
            .numpy()

    return (bf16_values(x), bf16_values(w), scale.astype(np.float32),
            bias.astype(np.float32))


def _port(x, w, scale, bias):
    out = tfc.conv3x3_small_affine_relu(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _jax_args(x, w, scale, bias):
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
            jnp.asarray(scale[None]), jnp.asarray(bias[None]))


# Next to the ReLU's 0 a bf16 ulp is tiny: there the f32 sums' own error
# (4,608 products at C=512, summed in two orders; measured 2.4e-7) decides
ZERO_ATOL = 1e-5


def _assert_within_one_ulp(got, want):
    """Each bf16 value equal to, or one bf16 ulp from, the other's (or
    within ZERO_ATOL of it next to 0); returns how many differ. Both sides
    accumulate in f32 in different orders, so a value next to a rounding
    boundary of bf16 may round the other way."""
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(big > 0, 2.0 ** (np.floor(np.log2(np.where(
        big > 0, big, 1.0))) - 7), 0.0)
    diff = np.abs(got - want)
    assert (diff <= np.maximum(ulp, ZERO_ATOL)).all(), (diff - ulp).max()
    return int((diff > 0).sum())


def test_t1_plain_matches_both_jax_functions(jtool):
    """At the JAX tool's shape (B=128, S=2, C=512): the port against the
    Pallas kernel in interpret mode and against XLA's conv -> BN -> ReLU."""
    x, w, scale, bias = _inputs(JAX_BATCH, 2, 512)
    got = _port(x, w, scale, bias)
    args = _jax_args(x, w, scale, bias)
    pallas = np.asarray(jtool.fused_conv_bn_relu(*args), np.float32)
    xla = np.asarray(jtool.xla_conv_bn_relu(*args), np.float32)
    assert got.shape == pallas.shape == xla.shape == (JAX_BATCH, 2, 2, 512)
    n_pallas = _assert_within_one_ulp(got, pallas)
    n_xla = _assert_within_one_ulp(got, xla)
    print(f"values one ulp apart: {n_pallas} (Pallas), {n_xla} (XLA), "
          f"{_assert_within_one_ulp(pallas, xla)} between the two JAX "
          f"functions, of {got.size}")
    # one ulp on a few dozen of the 262,144 values, as between the two JAX
    # functions themselves
    assert n_pallas < 200 and n_xla < 200, (n_pallas, n_xla)
    assert (got > 0).mean() > 0.3        # the ReLU leaves work to compare


@pytest.mark.parametrize("b,s,c", [(3, 2, 512), (5, 4, 256), (2, 2, 128)])
def test_t1_plain_matches_xla_at_other_shapes(jtool, b, s, c):
    """A ragged batch (no multiple of the JAX tile) and the S=4 stage: the
    XLA function is generic in its shapes (the Pallas one is not)."""
    x, w, scale, bias = _inputs(b, s, c, seed=b)
    want = np.asarray(jtool.xla_conv_bn_relu(*_jax_args(x, w, scale, bias)),
                      np.float32)
    _assert_within_one_ulp(_port(x, w, scale, bias), want)


def test_t1_refuses_grad_off_the_cpu():
    """T1 has no backward: off the CPU (a meta tensor here; no card needed)
    an input that requires grad raises before any launch, and so does a
    shape or dtype the kernel does not take."""
    x = torch.empty((4, 2, 2, 128), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, 3, 128, 128), dtype=torch.bfloat16, device="meta")
    scale = torch.empty((128,), device="meta")
    bias = torch.empty((128,), device="meta")
    with pytest.raises(RuntimeError, match="forward only"):
        tfc.conv3x3_small_affine_relu(x.requires_grad_(), w, scale, bias)
    with pytest.raises(RuntimeError, match="forward only"):
        tfc.conv3x3_small_affine_relu(x.detach(), w, scale.requires_grad_(),
                                      bias)
    with pytest.raises(ValueError, match="f32 \\[128\\]"):
        tfc.conv3x3_small_affine_relu(x.detach(), w, scale.detach()[:64],
                                      bias)
    with pytest.raises(ValueError, match="bf16"):
        tfc.conv3x3_small_affine_relu(x.detach().float(), w.float(),
                                      scale.detach(), bias)
    with torch.no_grad():               # no grad mode: only the shapes
        with pytest.raises(ValueError, match="S in"):
            tfc.conv3x3_small_affine_relu(x[:, :1].detach(), w,
                                          scale.detach(), bias)


def test_port_tool_runs_on_the_cpu(monkeypatch, capsys):
    """``tools/fused_conv_epilogue_torch.py --device cpu`` at a small batch:
    the numerics check and the three interleaved timings."""
    monkeypatch.setenv("FC_BATCH", "4")
    tool = _load("fused_conv_epilogue_torch",
                 "tools/fused_conv_epilogue_torch.py")
    result = tool.main(["--device", "cpu"])
    assert result["batch"] == 4 and result["device"] == "cpu"
    assert result["max_abs_err"] == 0.0     # T1 on the CPU is the plain one
    assert result["library_s"] > 0 and result["t1_s"] > 0
    out = capsys.readouterr().out
    assert "numerics: max |T1 - plain|" in out and "best-of-3" in out
    assert out.count("T1 [") == 3 and out.count("library [") == 3
    # the tool's inputs are the JAX tool's: the same seeded draws
    x, w, scale, bias = tool.inputs(4, "cpu")
    want = _inputs(4, 2, 512)
    for got, ref in zip((x, w, scale, bias), want):
        np.testing.assert_array_equal(got.float().numpy(), ref)
