"""Tests of the port that need a CUDA card: the hand-written kernels
(the 3x3 conv forward K1/K3, its backward K1-as-dgrad/K2/K4, the u8
normalisation T2) against their plain PyTorch versions, and the modules
that launch them, forward and backward.
They skip on a machine without a card. On the card, run them with

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not need). Inputs come from numpy with a seed; errors are
taken against the plain version in f32 with TF32 off, to bf16 output
rounding (2e-2, the JAX package's bound for these kernels in bf16); the
f32 weight gradients to 1e-3 of their largest entry (the same bf16
products summed in f32 in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu_torch.ops import fused_conv as fc  # noqa: E402
from embeddingnet_tpu_torch.ops import preprocess as pre  # noqa: E402

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
WGRAD_REL = 1e-3


def _launched(**counts):
    """The launch counts, every kernel not named at zero."""
    return {name: counts.get(name, 0) for name in fc.LAUNCHES}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    yield torch.device("cuda")
    fc.reset_launch_counts()
    pre.reset_launch_counts()


def _inputs(seed, b, s, cin, cout, device):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, s, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=(cin,)).astype(np.float32)
    bias = (rng.normal(size=(cin,)) + 1.0).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(x).bfloat16(), to(w).bfloat16(), to(scale), to(bias)


@pytest.mark.parametrize("b,s,cin,cout", [
    (32, 4, 256, 256), (256, 2, 512, 512), (3, 4, 128, 256),
    (1, 2, 384, 128)])
def test_kernels_match_plain(card, b, s, cin, cout):
    x, w, scale, bias = _inputs(0, b, s, cin, cout, card)
    got = fc.conv3x3_small(x, w).float()
    want = fc._plain_conv3x3(x.float(), w.float())
    torch.testing.assert_close(got, want, **BF16_TOL)
    got = fc.conv3x3_small_bn_relu(x, w, scale, bias).float()
    want = fc._plain_conv3x3(fc._affine_relu(x, scale, bias).float(),
                             w.float())
    torch.testing.assert_close(got, want, **BF16_TOL)
    assert fc.LAUNCHES == _launched(conv3x3_small=1, conv3x3_small_bn_relu=1)


def _assert_wgrad_close(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=WGRAD_REL * want.abs().max().item())


@pytest.mark.parametrize("b,s,c", [
    (1024, 8, 128), (1024, 4, 256), (1024, 2, 512), (8, 8, 128),
    (3, 4, 128), (16, 2, 512)])
def test_backward_kernels_match_plain(card, b, s, c):
    """K1 as the dgrad, K2 and K4 at the training shapes."""
    x, w, scale, bias = _inputs(5, b, s, c, c, card)
    g = _inputs(6, b, s, c, c, card)[0]
    got = fc.conv3x3_dgrad(g, w).float()
    want = fc._plain_conv3x3(g.float(), fc._flip(w).float())
    torch.testing.assert_close(got, want, **BF16_TOL)
    _assert_wgrad_close(fc.conv3x3_wgrad(x, g),
                        fc._plain_wgrad(x.float(), g.float()))
    z = fc._affine_relu(x, scale, bias)
    _assert_wgrad_close(fc.conv3x3_wgrad_bn_relu(x, g, scale, bias),
                        fc._plain_wgrad(z.float(), g.float()))
    assert fc.LAUNCHES == _launched(conv3x3_dgrad=1, conv3x3_wgrad=1,
                                    conv3x3_wgrad_bn_relu=1)


def test_wgrad_is_deterministic(card):
    """The split reduction adds its parts in a fixed order: two launches
    give the same dW bit for bit."""
    x, _, scale, bias = _inputs(7, 1024, 8, 128, 128, card)
    g = _inputs(8, 1024, 8, 128, 128, card)[0]
    assert fc.wgrad_splits(1024, 8, 128, 128) > 1
    assert torch.equal(fc.conv3x3_wgrad(x, g), fc.conv3x3_wgrad(x, g))
    assert torch.equal(fc.conv3x3_wgrad_bn_relu(x, g, scale, bias),
                       fc.conv3x3_wgrad_bn_relu(x, g, scale, bias))


def test_normalize_u8_matches_plain(card):
    """T2 equals its plain version, which is the exact divide, on every u8
    value and at the training batch's shape."""
    every = torch.arange(256, dtype=torch.uint8, device=card)
    assert torch.equal(pre.normalize_u8(every),
                       (every.float() / 255.0).bfloat16())
    x = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (1024, 64, 64, 3), np.uint8)).to(card)
    assert torch.equal(pre.normalize_u8(x), pre._plain_normalize_u8(x))
    assert pre.LAUNCHES == {"normalize_u8": 2}


def test_kernel_is_deterministic(card):
    x, w, scale, bias = _inputs(1, 64, 2, 512, 512, card)
    a = fc.conv3x3_small_bn_relu(x, w, scale, bias)
    b = fc.conv3x3_small_bn_relu(x, w, scale, bias)
    assert torch.equal(a, b)


def test_kernels_take_grad_and_refuse_what_they_cannot_take(card):
    """A tensor that requires grad goes through the kernels, forward and
    backward; a dtype, layout or shape the kernels do not take raises
    before any launch, with no fallback."""
    x, w, scale, bias = _inputs(2, 8, 4, 128, 128, card)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    fc.conv3x3_small(xg, wg).float().sum().backward()
    assert xg.grad.dtype == torch.bfloat16 and wg.grad.dtype == torch.bfloat16
    assert fc.LAUNCHES == _launched(conv3x3_small=1, conv3x3_dgrad=1,
                                    conv3x3_wgrad=1)
    fc.reset_launch_counts()
    with pytest.raises(ValueError):
        fc.conv3x3_small(x.half(), w.half())
    with pytest.raises(ValueError):
        fc.conv3x3_small(x.transpose(1, 2), w)      # not contiguous
    with pytest.raises(ValueError):
        fc.conv3x3_wgrad(x, x[:4])
    with pytest.raises(ValueError):
        fc.conv3x3_dgrad(x[:, :2, :2], w)           # S=2 with a 4x4 batch
    with pytest.raises(ValueError):
        pre.normalize_u8(x)                         # not uint8
    assert fc.LAUNCHES == _launched()
    assert pre.LAUNCHES == {"normalize_u8": 0}


@pytest.mark.parametrize("s,c", [(8, 128), (4, 256), (2, 512)])
def test_module_gradients_match_cpu(card, s, c):
    """FusedBNReluConv3x3 and FastConv3x3 in bf16 on the card (the mixed op
    at 8x8, the kernels at 4x4 and 2x2) against the same modules in f32 on
    the CPU: output, input and weight gradients to 2e-2 relative L2. The
    inputs and weights are bf16 values on both sides, so only the card's
    bf16 intermediates differ."""
    rng = np.random.default_rng(10)
    bf16_values = lambda a: torch.from_numpy(  # noqa: E731
        a.astype(np.float32)).bfloat16().float()
    x = bf16_values(rng.normal(size=(16, c, s, s)))
    cot = bf16_values(rng.normal(size=(16, c, s, s)))
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=c) + 1.0).astype(np.float32))
    for fused in (False, True):
        results = []
        for device, dtype in (("cpu", None), (card, torch.bfloat16)):
            mod = (fc.FusedBNReluConv3x3(c, c, compute_dtype=dtype) if fused
                   else fc.FastConv3x3(c, c, compute_dtype=dtype))
            torch.manual_seed(0)
            mod.reset_parameters()
            with torch.no_grad():
                mod.weight.copy_(mod.weight.bfloat16())
            mod.to(device)
            xd = x.to(device).contiguous(
                memory_format=torch.channels_last).requires_grad_()
            extra = ((scale.to(device, copy=True).requires_grad_(),
                      bias.to(device, copy=True).requires_grad_())
                     if fused else ())
            y = mod(xd, *extra)
            (y.float() * cot.to(device)).sum().backward()
            results.append([t.detach().float().cpu() for t in
                            (y, xd.grad, mod.weight.grad)
                            + tuple(e.grad for e in extra)])
        for got, want in zip(results[1], results[0]):
            rel = (got - want).norm() / want.norm()
            assert rel < 2e-2, (fused, s, c, rel.item())
    assert fc.LAUNCHES["conv3x3_dgrad"] == 2
    assert fc.LAUNCHES["conv3x3_wgrad"] == (2 if s == 8 else 1)
    assert fc.LAUNCHES["conv3x3_wgrad_bn_relu"] == (0 if s == 8 else 1)


def test_modules_launch_and_match_plain_modules(card):
    """FusedBNReluConv3x3 and FastConv3x3 in bf16 launch the kernels on a
    channels_last batch and agree with the same modules on the CPU."""
    x, _, scale, bias = _inputs(3, 16, 4, 256, 256, card)
    fused = fc.FusedBNReluConv3x3(256, 256, compute_dtype=torch.bfloat16)
    fast = fc.FastConv3x3(256, 256, compute_dtype=torch.bfloat16)
    xc = x.permute(0, 3, 1, 2)                       # channels_last NCHW
    with torch.inference_mode():
        want_fused = fused(xc.cpu().float(), scale.cpu(), bias.cpu()).float()
        want_fast = fast(xc.cpu().float()).float()
        fused.to(card)
        fast.to(card)
        got_fused = fused(xc, scale, bias).float().cpu()
        got_fast = fast(xc).float().cpu()
    assert fc.LAUNCHES == _launched(conv3x3_small=1, conv3x3_small_bn_relu=1)
    torch.testing.assert_close(got_fused, want_fused, **BF16_TOL)
    torch.testing.assert_close(got_fast, want_fast, **BF16_TOL)


def test_resnet50_kernel_path_matches_cudnn(card):
    from embeddingnet_tpu_torch.models.registry import EmbeddingModule
    gen = torch.Generator().manual_seed(0)
    fast = EmbeddingModule("resnet50", fast_conv=True, dtype=torch.bfloat16)
    fast.reset_parameters(gen)
    plain = EmbeddingModule("resnet50", dtype=torch.bfloat16)
    plain.load_state_dict(fast.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(32, 64, 64, 3)).astype(np.float32)).to(card)
    with torch.inference_mode():
        got = fast.to(card).eval()(x)
        want = plain.to(card).eval()(x)
    assert fc.LAUNCHES["conv3x3_small_bn_relu"] == 7
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)
