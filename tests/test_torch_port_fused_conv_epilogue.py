"""T1: the port's ``conv3x3_small_affine_relu`` (``relu(conv3x3(x, W)*scale
+ bias)``) against the two JAX functions of the A/B tool it ports,
``tools/pallas_fused_conv.py``: ``fused_conv_bn_relu`` (the Pallas kernel,
in interpret mode on the CPU) and ``xla_conv_bn_relu``; and the port's own
A/B tool, ``tools/fused_conv_epilogue_torch.py``, end to end on the CPU.

The JAX tool reads ``FC_BATCH`` when it is imported and ``FC_INTERPRET``
when its kernel is traced, so the fixture sets both around the import and
every call. Inputs are bf16 values made once from a seeded numpy generator
and handed to both packages; outputs are bf16, compared to one bf16 ulp."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu_torch.ops import fused_conv as tfc  # noqa: E402

from _torch_port import JAX_T1_BATCH as JAX_BATCH  # noqa: E402
from _torch_port import (assert_within_one_bf16_ulp,  # noqa: E402
                         jax_t1_tool, load_file, t1_inputs)


@pytest.fixture(scope="module")
def jtool():
    """``tools/pallas_fused_conv.py`` imported with FC_INTERPRET=1 and
    FC_BATCH=128, which stay set while the module's tests run."""
    with jax_t1_tool() as tool:
        yield tool


@pytest.fixture(autouse=True)
def _fresh_counts():
    tfc.reset_launch_counts()
    yield
    # the CPU route runs the plain version and launches nothing
    assert not any(tfc.LAUNCHES.values()), tfc.LAUNCHES


def _port(x, w, scale, bias):
    out = tfc.conv3x3_small_affine_relu(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
        torch.from_numpy(scale), torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _jax_args(x, w, scale, bias):
    return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
            jnp.asarray(scale[None]), jnp.asarray(bias[None]))


def test_t1_plain_matches_both_jax_functions(jtool):
    """At the JAX tool's shape (B=128, S=2, C=512): the port against the
    Pallas kernel in interpret mode and against XLA's conv -> BN -> ReLU."""
    x, w, scale, bias = t1_inputs(JAX_BATCH, 2, 512)
    got = _port(x, w, scale, bias)
    args = _jax_args(x, w, scale, bias)
    pallas = np.asarray(jtool.fused_conv_bn_relu(*args), np.float32)
    xla = np.asarray(jtool.xla_conv_bn_relu(*args), np.float32)
    assert got.shape == pallas.shape == xla.shape == (JAX_BATCH, 2, 2, 512)
    n_pallas = assert_within_one_bf16_ulp(got, pallas)
    n_xla = assert_within_one_bf16_ulp(got, xla)
    print(f"values one ulp apart: {n_pallas} (Pallas), {n_xla} (XLA), "
          f"{assert_within_one_bf16_ulp(pallas, xla)} between the two JAX "
          f"functions, of {got.size}")
    # one ulp on a few dozen of the 262,144 values, as between the two JAX
    # functions themselves
    assert n_pallas < 200 and n_xla < 200, (n_pallas, n_xla)
    assert (got > 0).mean() > 0.3        # the ReLU leaves work to compare


@pytest.mark.parametrize("b,s,c", [(3, 2, 512), (5, 4, 256), (2, 2, 128)])
def test_t1_plain_matches_xla_at_other_shapes(jtool, b, s, c):
    """A ragged batch (no multiple of the JAX tile) and the S=4 stage: the
    XLA function is generic in its shapes (the Pallas one is not)."""
    x, w, scale, bias = t1_inputs(b, s, c, seed=b)
    want = np.asarray(jtool.xla_conv_bn_relu(*_jax_args(x, w, scale, bias)),
                      np.float32)
    assert_within_one_bf16_ulp(_port(x, w, scale, bias), want)


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
    tool = load_file("fused_conv_epilogue_torch",
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
    want = t1_inputs(4, 2, 512)
    for got, ref in zip((x, w, scale, bias), want):
        np.testing.assert_array_equal(got.float().numpy(), ref)
