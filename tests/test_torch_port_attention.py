"""The attention core's CPU side (``embeddingnet_tpu_torch/ops/attention.py``):
the backward kernel's algebra in plain PyTorch (P rebuilt from the
logsumexp, ``dS = P * (dP - rowsum(dO * O))``) against autograd of the
plain path in float64; a CPU or ``meta`` tensor takes the plain path, the
old eager code bit for bit, and counts ``plain``; a ViT counts one core in
``vit.LAUNCHES["attention"]`` and one ``attn`` span per call, and again in
a remat recompute; the checks that refuse what the kernels cannot take;
no module of the port calls a library's attention. The kernels themselves
are checked on the card in ``tests/test_torch_port_cuda.py``."""

import math

import numpy as np
import pytest
import torch

from embeddingnet_tpu_torch.models import remat, vit
from embeddingnet_tpu_torch.ops import attention as att
from embeddingnet_tpu_torch.utils import trace

# float64 sums in another order than autograd's
ALGEBRA_TOL = 1e-10


@pytest.fixture(autouse=True)
def _counts():
    att.reset_launch_counts()
    yield
    att.reset_launch_counts()


def _inputs(b, n, h, d, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, n, h * d)) * s).to(dtype)
            for s in (1.5, 1.0, 1.0, 1.0)]


def _old_core(q, k, v, heads):
    """The eager core as the ViT block wrote it before the kernels."""
    b, n, d = q.shape
    head_dim = d // heads

    def split(t):
        return t.view(b, n, heads, head_dim).transpose(1, 2)

    q, k, v = split(q) / math.sqrt(head_dim), split(k), split(v)
    weights = torch.softmax(q @ k.transpose(-2, -1), dim=-1)
    return (weights @ v).transpose(1, 2).reshape(b, n, heads * head_dim)


@pytest.mark.parametrize("b,n,h,d", [(2, 50, 3, 16), (1, 1, 2, 64),
                                     (3, 70, 2, 32), (2, 129, 1, 64),
                                     (1, 197, 2, 16)])
def test_backward_algebra_matches_autograd(b, n, h, d):
    q, k, v, do = _inputs(b, n, h, d)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = att.plain_attention(*leaves, h)
    grads = torch.autograd.grad(want, leaves, do)
    out, lse = att.plain_forward_lse(q, k, v, h)
    assert lse.shape == (b, h, n)
    torch.testing.assert_close(out, want.detach(), rtol=0,
                               atol=ALGEBRA_TOL)
    got = att.plain_backward(q, k, v, out, do, lse, h)
    for name, g, w in zip(("dq", "dk", "dv"), got, grads):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=0, atol=ALGEBRA_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_a_cpu_tensor_takes_the_plain_path(dtype):
    q, k, v, _ = _inputs(2, 17, 4, 16, dtype)
    got = att.attention(q, k, v, 4)
    assert torch.equal(got, _old_core(q, k, v, 4))
    assert att.LAUNCHES == {"fwd": 0, "bwd": 0, "plain": 1}


def test_a_meta_tensor_takes_the_plain_path():
    q = torch.empty((2, 197, 768), device="meta", dtype=torch.bfloat16)
    got = att.attention(q, q, q, 12)
    assert got.shape == (2, 197, 768) and got.device.type == "meta"
    assert att.LAUNCHES == {"fwd": 0, "bwd": 0, "plain": 1}


@pytest.mark.parametrize("on", [False, True], ids=["plain", "remat"])
def test_a_vit_counts_one_core_and_one_span_per_call(on):
    """Forward and backward of a two-block ViT: each block's core counts
    once in ``vit.LAUNCHES`` and in ``plain`` and opens one ``attn`` span,
    and again in a remat recompute; the gradients equal."""
    torch.manual_seed(0)
    module = vit.ViT((32, 32), dim=32, depth=2, heads=2)
    module.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(2, 3, 32, 32)).astype(np.float32))
    grads = {}
    for remat_on in (False, on):
        trace.reset()
        trace.enable()
        before = vit.LAUNCHES["attention"]
        att.reset_launch_counts()
        module.zero_grad()
        try:
            with remat.rematerialize(remat_on):
                module(x).square().sum().backward()
        finally:
            trace.disable()
        calls = 4 if remat_on else 2
        assert vit.LAUNCHES["attention"] - before == calls
        assert att.LAUNCHES == {"fwd": 0, "bwd": 0, "plain": calls}
        assert trace.totals()["attn"][0] == calls
        grads[remat_on] = [p.grad.clone() for p in module.parameters()]
        trace.reset()
    for a, b in zip(grads[False], grads[on]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _refused(q, k, v, heads):
    with pytest.raises(ValueError) as err:
        att._check(q, k, v, heads)
    return str(err.value)


@pytest.mark.parametrize("case,match", [
    ("float32 d=256", "head dimension 256"),
    ("int8", "bfloat16 or float16"),
    ("d=40", "head dimension 40"), ("d=8", "head dimension 8"),
    ("d=256", "head dimension 256"), ("column stride", "strides"),
    ("row stride", "strides"), ("shape", "does not match"),
    ("dtype", "does not match"), ("rank", "is not")])
def test_the_checks_refuse_what_the_kernels_cannot_take(case, match):
    q, k, v, _ = _inputs(2, 50, 4, 64, torch.bfloat16)
    heads = 4
    if case == "float32 d=256":
        q, k, v, heads = q.float(), k.float(), v.float(), 1
    elif case == "int8":
        q, k, v = (t.to(torch.int8) for t in (q, k, v))
    elif case == "d=40":
        q, k, v = q[..., :160], k[..., :160], v[..., :160]
    elif case == "d=8":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif case == "d=256":
        heads = 1
    elif case == "column stride":
        q = torch.cat([q, q], dim=-1)[..., ::2]
    elif case == "row stride":
        q = torch.cat([q, q[..., :4]], dim=-1)[..., :256]
    elif case == "shape":
        k = k[:, :49]
    elif case == "dtype":
        k = k.half()
    elif case == "rank":
        q, k, v = q[0], k[0], v[0]
    assert match in _refused(q, k, v, heads)


@pytest.mark.parametrize("b,n,h,d", [(256, 197, 12, 64), (1, 1, 1, 16),
                                     (3, 257, 6, 128)])
def test_the_checks_pass_what_the_kernels_take(b, n, h, d):
    q = torch.empty((b, n, h * d), dtype=torch.bfloat16)
    assert att._check(q, q, q, h) == d
    assert att._strides(q) == (h * d, n * h * d)
    assert att._strides(q[:1, :1]) == (h * d, h * d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [8, 40, 128])
def test_the_checks_pass_float32_and_float64(dtype, d):
    """The kernels' float32 and float64 instances read no tensor map: any
    head dimension up to 128, and rows at any stride."""
    q = torch.empty((3, 50, 4 * d + 4), dtype=dtype)[..., :4 * d]
    assert att._fits(q) and q.stride(1) % att.ALIGN
    assert att._check(q, q, q, 4) == d


@pytest.mark.parametrize("call", ["scaled_dot_product_attention",
                                  "flash_attn", "torch.compile("])
def test_the_port_calls_no_library_attention(call):
    """The port's attention is its own kernel: no module of the package
    calls PyTorch's fused attention, a package of finished attention
    kernels or ``torch.compile``."""
    import pathlib
    root = pathlib.Path(att.__file__).resolve().parent.parent
    hits = [str(p.relative_to(root)) for p in sorted(root.rglob("*.py"))
            if call in p.read_text()]
    assert hits == []
