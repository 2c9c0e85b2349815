"""Tests of the port that need a CUDA card: the hand-written kernels
against their plain PyTorch versions, and the modules that launch them.
They skip on a machine without a card. On the card, run them with

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not need). Inputs come from numpy with a seed; errors are
taken against the plain version in f32 with TF32 off, to bf16 output
rounding (2e-2, the JAX package's bound for these kernels in bf16)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu_torch.ops import fused_conv as fc  # noqa: E402

pytestmark = pytest.mark.cuda

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fc.reset_launch_counts()
    yield torch.device("cuda")
    fc.reset_launch_counts()


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
    assert fc.LAUNCHES == {"conv3x3_small": 1, "conv3x3_small_bn_relu": 1}


def test_kernel_is_deterministic(card):
    x, w, scale, bias = _inputs(1, 64, 2, 512, 512, card)
    a = fc.conv3x3_small_bn_relu(x, w, scale, bias)
    b = fc.conv3x3_small_bn_relu(x, w, scale, bias)
    assert torch.equal(a, b)


def test_kernel_refuses_what_it_cannot_take(card):
    x, w, scale, bias = _inputs(2, 8, 4, 128, 128, card)
    with pytest.raises(NotImplementedError):
        fc.conv3x3_small(x.requires_grad_(), w)
    x = x.detach()
    with pytest.raises(ValueError):
        fc.conv3x3_small(x.half(), w.half())
    with pytest.raises(ValueError):
        fc.conv3x3_small(x.transpose(1, 2), w)      # not contiguous
    assert fc.LAUNCHES == {"conv3x3_small": 0, "conv3x3_small_bn_relu": 0}


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
    assert fc.LAUNCHES == {"conv3x3_small": 1, "conv3x3_small_bn_relu": 1}
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
