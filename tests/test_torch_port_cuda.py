"""Tests of the port that need a CUDA card: the hand-written kernels
(the 3x3 conv forward K1/K3, its backward K1-as-dgrad/K2/K4 and the conv
with the affine-ReLU epilogue T1 — all in csrc/conv3x3_sm90.cu, the
TMA/wgmma design, K3 and K4 with the BN-ReLU prologue on the landed input
tile, T1 with the epilogue on the accumulators — and the u8 normalisation
T2 of csrc/normalize_u8_sm90.cu, at its edges too: a tail, misaligned
views, no elements, and BatchNorm's statistics, affine and backward of
csrc/batchnorm_sm90.cu, the attention core's forward and backward of
csrc/attention_sm90.cu, and LayerNorm's of csrc/layernorm_sm90.cu, whose
tolerances are stated beside their tests)
against their plain PyTorch versions, the modules that
launch them, forward and backward, the augmentation presets (op by op and
chained), the miner, the ViT forward, the ArcFace loss and a small ViT's
ArcFace gradients, the EfficientNet/MobileNet/simple CNNs and one model of
each zoo family forward and backward on the card against the CPU.
They skip on a machine without a card. On the card, run them with

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not need). Inputs come from numpy with a seed; errors are
taken against the plain version in f32 with TF32 off, to bf16 output
rounding (2e-2, the JAX package's bound for these kernels in bf16); the
f32 weight gradients to 1e-3 of their largest entry (the same bf16
products summed in f32 in another order). Also: the kernels' A/B tool's
``device_ms`` raises on a read that saw no kernel, and the data-parallel
step in an NCCL group of one rank matches the CPU's one-process step; a
squeeze-excitation bottleneck with ``fast_conv`` (K3, K1-as-dgrad, K4),
TF's ``"SAME"`` max pool and a reduced NASNet (its ``adjust`` and
``correct_pad``) on the card against the CPU."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu_torch.ops import _cuda  # noqa: E402
from embeddingnet_tpu_torch.ops import augment as aug  # noqa: E402
from embeddingnet_tpu_torch.ops import batchnorm as bnk  # noqa: E402
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
    bnk.reset_launch_counts()
    yield torch.device("cuda")
    fc.reset_launch_counts()
    pre.reset_launch_counts()
    bnk.reset_launch_counts()


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
    assert fc.plan_sm90("wgrad", 1024, 8, 128, 128).parts > 1
    assert torch.equal(fc.conv3x3_wgrad(x, g), fc.conv3x3_wgrad(x, g))
    assert torch.equal(fc.conv3x3_wgrad_bn_relu(x, g, scale, bias),
                       fc.conv3x3_wgrad_bn_relu(x, g, scale, bias))


@pytest.mark.parametrize("b", [1, 3, 8, 32, 37, 256, 1001, 1024])
@pytest.mark.parametrize("s,cin,cout", [
    (8, 128, 128), (4, 256, 256), (2, 512, 512), (4, 128, 256),
    (2, 384, 128)])
def test_sm90_kernels_match_plain(card, b, s, cin, cout):
    """csrc/conv3x3_sm90.cu: K1's forward and dgrad and K2 against their
    plain versions at the training shapes, at Cin != Cout, at the serving
    batches (3, 32, 256), a siamese stream's 8, and at batches that fill no
    tile (the TMA boxes' zero fill); B=1001 and 1024 take 256-row tiles at
    S=4 and 8, the others 128. K2's dW is the same bit for bit from launch
    to launch."""
    x, w, _, _ = _inputs(20, b, s, cin, cout, card)
    g = _inputs(21, b, s, cout, cout, card)[0]
    torch.testing.assert_close(fc.conv3x3_small(x, w).float(),
                               fc._plain_conv3x3(x.float(), w.float()),
                               **BF16_TOL)
    torch.testing.assert_close(
        fc.conv3x3_dgrad(g, w).float(),
        fc._plain_conv3x3(g.float(), fc._flip(w).float()), **BF16_TOL)
    dw = fc.conv3x3_wgrad(x, g)
    _assert_wgrad_close(dw, fc._plain_wgrad(x.float(), g.float()))
    assert torch.equal(dw, fc.conv3x3_wgrad(x, g))
    assert fc.LAUNCHES == _launched(conv3x3_small=1, conv3x3_dgrad=1,
                                    conv3x3_wgrad=2)


@pytest.mark.parametrize("b", [1, 3, 8, 37, 1001, 1024])
@pytest.mark.parametrize("s,cin,cout", [
    (4, 256, 256), (2, 512, 512), (4, 128, 256)])
def test_prologue_kernels_match_plain(card, b, s, cin, cout):
    """K3 and K4 (csrc/conv3x3_sm90.cu with the BN-ReLU prologue) against
    their plain versions at the fused training shapes and at Cin != Cout,
    at a siamese stream's batch of 8 and at batches that fill no tile; the
    biases are mostly positive, so a padding ring or a ragged row
    rewritten by the affine would show. K4's dW is the same bit for bit
    from launch to launch."""
    x, w, scale, bias = _inputs(25, b, s, cin, cout, card)
    assert (bias > 0).float().mean() > 0.5
    g = _inputs(26, b, s, cout, cout, card)[0]
    z = fc._affine_relu(x, scale, bias).float()
    torch.testing.assert_close(
        fc.conv3x3_small_bn_relu(x, w, scale, bias).float(),
        fc._plain_conv3x3(z, w.float()), **BF16_TOL)
    got = fc.conv3x3_wgrad_bn_relu(x, g, scale, bias)
    _assert_wgrad_close(got, fc._plain_wgrad(z, g.float()))
    assert torch.equal(got, fc.conv3x3_wgrad_bn_relu(x, g, scale, bias))
    assert fc.LAUNCHES == _launched(conv3x3_small_bn_relu=1,
                                    conv3x3_wgrad_bn_relu=2)


@pytest.mark.parametrize("b", [3, 32, 256])
def test_prologue_forward_at_the_serving_batches(card, b):
    """K3 at the serving batches, stage 3's and stage 4's shapes."""
    for s, c in ((4, 256), (2, 512)):
        x, w, scale, bias = _inputs(27, b, s, c, c, card)
        torch.testing.assert_close(
            fc.conv3x3_small_bn_relu(x, w, scale, bias).float(),
            fc._plain_conv3x3(fc._affine_relu(x, scale, bias).float(),
                              w.float()), **BF16_TOL)
    assert fc.LAUNCHES == _launched(conv3x3_small_bn_relu=2)


def _device_kernels(fn):
    """Names of the device kernels one call of ``fn`` runs (after a first,
    untraced call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def test_prologue_never_writes_z(card):
    """One K3 call is one kernel; one K4 call is its kernel and at most the
    part sum: no elementwise kernel, so z = relu(x*scale + bias) is never
    written to device memory."""
    x, w, scale, bias = _inputs(28, 1024, 4, 256, 256, card)
    g = _inputs(29, 1024, 4, 256, 256, card)[0]
    names = _device_kernels(lambda: fc.conv3x3_small_bn_relu(x, w, scale,
                                                             bias))
    assert len(names) == 1 and "conv3x3_sm90_kernel" in names[0], names
    names = _device_kernels(lambda: fc.conv3x3_wgrad_bn_relu(x, g, scale,
                                                             bias))
    assert len(names) <= 2 and "conv3x3_wgrad_sm90_kernel" in names[0] \
        and all("conv3x3_sum_parts_kernel" in n for n in names[1:]), names


def test_prologue_wrappers_refuse_what_the_kernels_cannot_take(card):
    """A misaligned, non-contiguous or wrongly typed input, or a scale or
    bias of the wrong shape or type, raises before any launch."""
    x, w, scale, bias = _inputs(30, 8, 4, 128, 128, card)
    n = x.numel()
    shifted = torch.empty(n + 8, dtype=x.dtype, device=card)[1:n + 1]
    shifted = shifted.view(x.shape).copy_(x)        # 2 bytes off 16
    k3 = lambda *a: fc.conv3x3_small_bn_relu(*a)  # noqa: E731
    k4 = lambda x_, s_, b_: fc.conv3x3_wgrad_bn_relu(  # noqa: E731
        x_, x, s_, b_)
    for bad in (shifted, x.transpose(1, 2)):
        with pytest.raises(ValueError, match="contiguous and 16-byte"):
            k3(bad, w, scale, bias)
        with pytest.raises(ValueError, match="contiguous and 16-byte"):
            k4(bad, scale, bias)
    misaligned = torch.empty(129, device=card)[1:].copy_(scale)
    with pytest.raises(ValueError, match="contiguous and 16-byte"):
        k3(x, w, misaligned, bias)
    with pytest.raises(ValueError, match="contiguous and 16-byte"):
        k4(x, scale, misaligned)
    for bad_x in (x.float(), x.half()):
        with pytest.raises(ValueError, match="kernel takes bf16"):
            k3(bad_x, w, scale, bias)
        with pytest.raises(ValueError, match="kernel takes bf16"):
            fc.conv3x3_wgrad_bn_relu(bad_x, bad_x, scale, bias)
    with pytest.raises(ValueError, match="w must be bf16"):
        k3(x, w.float(), scale, bias)
    for s_, b_ in ((scale[:64], bias), (scale, bias[:64]),
                   (scale.half(), bias), (scale, bias.double()),
                   (scale[None], bias)):
        with pytest.raises(ValueError, match="scale and bias"):
            k3(x, w, s_, b_)
        with pytest.raises(ValueError, match="scale and bias"):
            k4(x, s_, b_)
    assert fc.LAUNCHES == _launched()


def test_dgrad_launches_one_kernel_and_copies_no_weight(card):
    """The dgrad reads the weight as it stands: one call is one kernel,
    with no flip, transpose or copy of the weight beside it. The profiler
    loses kernel records now and then, so the read is one that
    ``benchmark/trace.py``'s ``settled`` takes."""
    from torch.profiler import ProfilerActivity, profile
    from benchmark.trace import READS, settled
    _, w, _, _ = _inputs(22, 1024, 4, 256, 256, card)
    g = _inputs(23, 1024, 4, 256, 256, card)[0]
    fc.conv3x3_dgrad(g, w)                  # build and first launch
    torch.cuda.synchronize()
    counts = []
    while len(counts) < READS and not (counts and settled(counts)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fc.conv3x3_dgrad(g, w)
            torch.cuda.synchronize()
        device = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        counts.append(len(device))
    assert len(device) == 1 and "conv3x3_sm90_kernel" in device[0], device


def test_sm90_wrappers_refuse_what_the_kernels_cannot_take(card):
    """A misaligned or non-contiguous input raises before any launch, and
    the C entry point refuses (-1, nothing launched) a mode it does not
    know, a tile height other than 128 or 256, and a scale or bias given
    where the mode takes none or missing where it takes them."""
    x, w, scale, bias = _inputs(24, 8, 4, 128, 128, card)
    n = x.numel()
    shifted = torch.empty(n + 8, dtype=x.dtype, device=card)[1:n + 1]
    shifted = shifted.view(x.shape).copy_(x)        # 2 bytes off 16
    for bad in (shifted, x.transpose(1, 2)):
        with pytest.raises(ValueError, match="contiguous and 16-byte"):
            fc.conv3x3_small_affine_relu(bad, w, scale, bias)
        with pytest.raises(ValueError, match="contiguous and 16-byte"):
            fc.conv3x3_small(bad, w)
        with pytest.raises(ValueError, match="contiguous and 16-byte"):
            fc.conv3x3_dgrad(bad, w)
        with pytest.raises(ValueError, match="contiguous and 16-byte"):
            fc.conv3x3_wgrad(bad, x)
        with pytest.raises(ValueError, match="contiguous and 16-byte"):
            fc.conv3x3_wgrad(x, bad)
    with pytest.raises(ValueError, match="contiguous and 16-byte"):
        fc.conv3x3_dgrad(x, w.transpose(2, 3))
    assert fc.LAUNCHES == _launched()

    entry = _cuda.library("conv3x3_sm90").embn_conv3x3_sm90
    out = torch.full_like(x, 7.0)
    sc, bi = scale.data_ptr(), bias.data_ptr()
    stream = torch.cuda.current_stream(card).cuda_stream
    for mode, s_, b_, rows in ((4, None, None, 128), (-1, None, None, 128),
                               (0, sc, bi, 128), (1, sc, bi, 128),
                               (2, None, None, 128), (3, None, None, 128),
                               (2, sc, None, 128), (3, None, bi, 128),
                               (0, None, None, 64), (3, sc, bi, 192)):
        assert entry(x.data_ptr(), w.data_ptr(), s_, b_, out.data_ptr(),
                     8, 4, 128, 128, mode, rows, 1, stream) == -1, mode
    torch.cuda.synchronize()
    assert (out == 7.0).all()                       # nothing ran


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


@pytest.mark.parametrize("case", ["tail", "offset_1", "offset_8", "empty",
                                  "vit_val", "road_val"])
def test_normalize_u8_edges_match_plain(card, case):
    """T2's edges, exact against its plain version: a tail of n % 16
    elements; a flat view at an odd offset (the scalar path) and at 8 bytes
    (an 8-element head, then aligned vectors); a zero-size tensor (no
    launch); the ViT pretraining's val batch [128, 96, 96, 3]; the
    road-signs config's val batch [24, 48, 48, 3]."""
    rng = np.random.default_rng(10)
    flat = torch.from_numpy(rng.integers(0, 256, 1_000_003 + 8,
                                         np.uint8)).to(card)
    x = {"tail": flat[:1_000_003], "offset_1": flat[1:],
         "offset_8": flat[8:], "empty": flat[:0],
         "vit_val": torch.from_numpy(rng.integers(
             0, 256, (128, 96, 96, 3), np.uint8)).to(card),
         "road_val": torch.from_numpy(rng.integers(
             0, 256, (24, 48, 48, 3), np.uint8)).to(card)}[case]
    got = pre.normalize_u8(x)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, pre._plain_normalize_u8(x))
    assert pre.LAUNCHES == {"normalize_u8": 0 if case == "empty" else 1}


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


@pytest.mark.parametrize("b,s,c", [
    (3, 2, 512), (128, 2, 512), (1024, 2, 512), (3, 4, 256), (128, 4, 256),
    (1024, 4, 256)])
def test_epilogue_kernel_matches_plain(card, b, s, c):
    """T1, relu(conv3x3(x, w)*scale + bias), against its plain version in
    f32 and in bf16, at the shapes chip_smoke.py checks."""
    x, w, _, _ = _inputs(11, b, s, c, c, card)
    rng = np.random.default_rng(12)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)
                             ).to(card)
    bias = torch.from_numpy((rng.normal(size=c) * 0.1).astype(np.float32)
                            ).to(card)
    got = fc.conv3x3_small_affine_relu(x, w, scale, bias)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, s, c)
    torch.testing.assert_close(
        got.float(), fc._plain_conv3x3_affine_relu(x.float(), w.float(),
                                                   scale, bias), **BF16_TOL)
    torch.testing.assert_close(
        got.float(), fc._plain_conv3x3_affine_relu(x, w, scale, bias).float(),
        **BF16_TOL)
    assert (got > 0).float().mean() > 0.3
    assert fc.LAUNCHES == _launched(conv3x3_small_affine_relu=1)
    with pytest.raises(RuntimeError, match="forward only"):
        fc.conv3x3_small_affine_relu(x.clone().requires_grad_(), w, scale,
                                     bias)
    assert fc.LAUNCHES == _launched(conv3x3_small_affine_relu=1)


@pytest.mark.parametrize("name", ["default", "plates", "plates2",
                                  "deepfake"])
def test_augmentation_on_the_card_matches_the_cpu(card, name):
    """Each op of the preset on the card against the CPU, from the same
    draws (sampled on the card's generator) and the same input, to 1e-3
    gray levels: the same f32 ops, rounded differently by the two
    devices' pow, division and sums."""
    x = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 255, (64, 64, 64, 3)).astype(np.float32))
    augment = aug.get_aug(name)
    gen = torch.Generator(device=card).manual_seed(0)
    draws = augment.sample(x.shape, gen)
    assert all(t.device.type == "cuda" for d in draws for t in d.values())
    for op, d in zip(augment.ops, draws):
        want = op.apply(x, {k: v.cpu() for k, v in d.items()})
        got = op.apply(x.to(card), d).cpu()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3,
                                   msg=op.name)
        x = want


def test_augmentation_preset_chained_on_the_card_matches_the_cpu(card):
    """The ``default`` preset chained on the card and on the CPU from the
    same draws and input: a pixel whose luminance lands on the other side
    of a CLAHE bin edge maps elsewhere, so at most 0.1% of the pixels are
    past 1e-3 gray levels."""
    x = torch.from_numpy(np.random.default_rng(16).integers(
        0, 256, (128, 64, 64, 3)).astype(np.float32))
    augment = aug.get_aug("default")
    draws = augment.sample(x.shape, torch.Generator(device=card)
                           .manual_seed(0))
    want = augment.apply(x, [{k: v.cpu() for k, v in d.items()}
                             for d in draws])
    got = augment.apply(x.to(card), draws).cpu()
    off = (got - want).abs().amax(-1) > 1e-3
    assert torch.isfinite(got).all()
    assert off.float().mean().item() <= 1e-3, int(off.sum())


def test_augmentation_does_not_synchronise(card):
    """The preset samples on the card's generator and applies with no
    host synchronisation (CUDA's sync debug mode raises on one)."""
    x = torch.rand((32, 64, 64, 3), device=card) * 255
    gen = torch.Generator(device=card).manual_seed(0)
    augment = aug.get_aug("default")
    augment(x, gen)                     # first call: allocations, set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = augment(x, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out).all()


def _exact_epilogue_inputs(seed, b, s, c, device):
    """T1's inputs on which every rounding is known: x and w small integers
    in bf16, so the conv's f32 sums are exact in any order; scales with
    full f32 mantissas; and for each output channel n the bias
    -fl(y_n*scale_n), y_n the channel's most frequent conv value, so that
    there mul-then-add gives exactly 0 where an FMA would give the
    product's rounding error. Returns (x, w, scale, bias, y) with y the
    exact conv in f32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-2, 3, (b, s, s, c)).astype(
        np.float32)).to(device)
    w = torch.from_numpy(rng.integers(-1, 2, (3, 3, c, c)).astype(
        np.float32)).to(device)
    y = fc._plain_conv3x3(x.double(), w.double())
    assert torch.equal(fc._plain_conv3x3(x, w).double(), y)   # exact in f32
    y = y.float()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)
                             ).to(device)
    bias = -(y.reshape(-1, c).mode(0).values * scale)
    return x.bfloat16(), w.bfloat16(), scale, bias, y


@pytest.mark.parametrize("b,s,c", [(1024, 2, 512), (1024, 4, 256),
                                   (37, 4, 256)])
def test_epilogue_kernel_is_bit_exact(card, b, s, c):
    """On the exact-integer inputs T1 equals its plain version bit for bit
    (128-row tiles at S=2, 256-row at S=4, a ragged batch); an FMA, whose
    bf16 results differ on some of these entries (counted here from the
    exact product in f64), would not."""
    x, w, scale, bias, y = _exact_epilogue_inputs(14, b, s, c, card)
    got = fc.conv3x3_small_affine_relu(x, w, scale, bias)
    want = fc._plain_conv3x3_affine_relu(x, w, scale, bias)
    fma = (y.double() * scale.double() + bias.double()).float().clamp_min(
        0.0).bfloat16()
    assert (fma != want).sum() > 0.1 * c
    assert torch.equal(got, want)
    assert fc.LAUNCHES == _launched(conv3x3_small_affine_relu=1)


def test_epilogue_is_one_sm90_kernel(card):
    """One T1 call is one launch of csrc/conv3x3_sm90.cu's kernel with the
    epilogue flag (no other kernel beside it), counted under
    conv3x3_small_affine_relu and not under K3."""
    x, w, _, _ = _inputs(15, 1024, 2, 512, 512, card)
    scale = torch.rand(512, device=card) + 0.5
    bias = torch.randn(512, device=card) * 0.1
    names = _device_kernels(lambda: fc.conv3x3_small_affine_relu(
        x, w, scale, bias))
    assert len(names) == 1, names
    assert "conv3x3_sm90_kernel<false," in names[0], names
    assert ", false, true>" in names[0], names
    assert fc.LAUNCHES == _launched(conv3x3_small_affine_relu=2)


# -- the mining modes on the card ---------------------------------------------

# card against CPU on exact distances (below): the selections equal, the
# loss and the stats (sums in another order) to 1e-5 relative, the
# gradient (products with 1/n_selected) to 1e-5 of its largest entry
MINING_RTOL = 1e-5


def _exact_embeddings(b, d=256, seed=0):
    """[b, d] f32 embeddings on a grid of 1/256 within +-0.5: every product
    and partial sum of the squared distances is exact in float32, so the
    card and the CPU compute the same distances in any order."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(size=(b, d)) * 0.12, -0.5, 0.5)
    return (np.round(x * 256) / 256).astype(np.float32)


def _mine_on(device, mode, emb, labels, draws, max_positives):
    """(loss, stats, embedding gradient, selections) of ``mode`` on
    ``device``, all on the host."""
    from embeddingnet_tpu_torch.ops import mining
    e = torch.from_numpy(emb).to(device).requires_grad_()
    lab = torch.from_numpy(labels).to(device)
    d = None if draws is None else draws.to(device)
    loss, stats = mining.mined_triplet_loss(
        e, lab, margin=0.5, mode=mode, draws=d, max_positives=max_positives)
    loss.backward()
    sel = {}
    b = len(labels)
    if mode in mining.PARITY_MODES and b > 256:
        k = None if max_positives is None else max_positives + 1
        aux = mining._parity_forward_large(e.detach(), lab, 0.5, mode, d,
                                           k)[3]
        sel = {n: v.cpu() for n, v in aux.items() if v is not None}
    elif mode in mining.PARITY_MODES:
        dist = mining.pairwise_sq_l2(e.detach()).sqrt()
        _, _, _, s, n_star = mining._parity_select(dist, lab, 0.5, mode, d)
        sel = {"selected": s.cpu(), "n_star": torch.where(s, n_star, -1)
               .cpu()}
    return (loss.item(), [float(v) for v in stats], e.grad.cpu(), sel)


@pytest.mark.parametrize("mode,path", [
    (mode, path) for mode in ("semihard", "hardest", "random_hard",
                              "batch_hard", "batch_all")
    for path in ("enumeration", "pk", "dense")
    # batch_all's generic-label path is not ported (ROADMAP.md, item 3)
    if (mode, path) != ("batch_all", "dense")])
def test_mining_on_the_card_matches_the_cpu(card, mode, path):
    """Each mode on each of its paths (B=256 enumeration, B=1024 grouped
    P-K and, with the rows shuffled, B=1024 dense) on exact-distance
    embeddings with the same draws: identical selections, equal loss,
    stats and embedding gradient."""
    from embeddingnet_tpu_torch.ops import mining
    b = 256 if path == "enumeration" else 1024
    emb = _exact_embeddings(b)
    labels = np.repeat(np.arange(b // 4), 4).astype(np.int64)
    max_positives = 3
    if path == "dense":
        order = np.random.default_rng(1).permutation(b)
        emb, labels, max_positives = emb[order], labels[order], None
    draws = mining.sample_draws(mode, b, max_positives,
                                torch.Generator().manual_seed(2))
    got = _mine_on(card, mode, emb, labels, draws, max_positives)
    want = _mine_on("cpu", mode, emb, labels, draws, max_positives)
    np.testing.assert_allclose(got[0], want[0], rtol=MINING_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=MINING_RTOL)
    scale = want[2].abs().max().item()
    torch.testing.assert_close(got[2], want[2], rtol=0,
                               atol=MINING_RTOL * scale)
    assert got[3].keys() == want[3].keys()
    for name in want[3]:
        assert torch.equal(got[3][name], want[3][name]), name
    assert got[1][0] > 0              # triplets were mined


# the ViT/ArcFace path (on the card the attention kernels' float32
# instances, else PyTorch's ops), f32 with TF32 off, card against CPU from
# the same weights and inputs: sums in another order, to 1e-5 of each
# tensor's largest entry
VIT_SMALL = {"vit-b16": dict(patch=16, dim=128, depth=2, heads=4),
             "vit-l14": dict(patch=16, dim=128, depth=2, heads=4,
                             ln_pre=True, use_quick_gelu=True,
                             patch_bias=False, proj_dim=96, ln_eps=1e-5)}
VIT_CARD_TOL = 1e-5


def _rel(got, want):
    return ((got.cpu().double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("name", sorted(VIT_SMALL))
def test_vit_forward_on_the_card_matches_the_cpu(card, name, monkeypatch):
    import copy
    from embeddingnet_tpu_torch.models import vit
    from embeddingnet_tpu_torch.models.registry import EmbeddingModule
    from embeddingnet_tpu_torch.ops import attention
    monkeypatch.setitem(vit._VARIANTS, name, VIT_SMALL[name])
    cpu = EmbeddingModule(name, encodings_len=64, input_shape=(64, 64, 3))
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(card)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (16, 64, 64, 3)).astype(np.float32))
    attention.reset_launch_counts()
    with torch.no_grad():
        assert _rel(gpu.features(x.to(card)), cpu.features(x)) \
            < VIT_CARD_TOL
        assert _rel(gpu(x.to(card)), cpu(x)) < VIT_CARD_TOL
    assert fc.LAUNCHES == _launched()
    # two calls of two blocks each side: the card's launch the kernels
    depth = VIT_SMALL[name]["depth"]
    assert attention.LAUNCHES == {"fwd": 2 * depth, "bwd": 0,
                                  "plain": 2 * depth}


def test_arcface_loss_on_the_card_matches_the_cpu(card):
    from embeddingnet_tpu_torch.ops.losses import arcface_loss
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.normal(size=(256, 512)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(1000, 512)) * 0.01).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, 256))
    out = []
    for device in ("cpu", card):
        e = emb.to(device).detach().requires_grad_()
        cw = w.to(device).detach().requires_grad_()
        loss = arcface_loss(e, labels.to(device), cw, margin=0.5,
                            scale=64.0)
        loss.backward()
        out.append((loss.detach().cpu(), e.grad.cpu(), cw.grad.cpu()))
    (l_cpu, ge_cpu, gw_cpu), (l_gpu, ge_gpu, gw_gpu) = out
    assert _rel(l_gpu, l_cpu) < VIT_CARD_TOL
    assert _rel(ge_gpu, ge_cpu) < VIT_CARD_TOL
    assert _rel(gw_gpu, gw_cpu) < VIT_CARD_TOL


# the depthwise family and the simple CNNs (no kernel of the port: cuDNN
# and PyTorch's ops), card against CPU from one state_dict and the same
# drop masks. Train mode in float64 on both: f32 train-mode BatchNorm on
# batch statistics amplifies two devices' rounding past 1e-5, and a ReLU's
# kink takes a pre-activation either way (on the CPU, two conv layouts put
# simple2's f32 conv_7 gradient 1.8% apart); eval mode in f32 with TF32
# off. Each tensor to 1e-5 of its largest entry; a gradient that is zero in
# exact arithmetic (a BatchNorm bias before a train-mode BatchNorm) to 1e-5
# of the model's largest gradient entry
DEPTHWISE_FAMILIES = [("efficientnet-b0", 64), ("mobilenet", 64),
                      ("mobilenetv2", 64), ("simple", 72), ("simple2", 64)]
DEPTHWISE_CARD_TOL = 1e-5


@pytest.mark.parametrize("name,size", DEPTHWISE_FAMILIES)
def test_depthwise_family_on_the_card_matches_the_cpu(card, name, size,
                                                      monkeypatch):
    import copy
    from embeddingnet_tpu_torch.models import efficientnet as efn
    from embeddingnet_tpu_torch.models.registry import EmbeddingModule
    from embeddingnet_tpu_torch.models.stochastic import MaskSource
    from embeddingnet_tpu_torch.ops.mining import mined_triplet_loss
    monkeypatch.setitem(efn.SCALINGS, "efficientnet-b0", (0.25, 0.5, 224))
    cpu = EmbeddingModule(name, encodings_len=64, classifier=False,
                          input_shape=(size, size, 3))
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (16, size, size, 3)))
    labels = torch.arange(4).repeat_interleave(4)
    out, masks = [], None
    for device in ("cpu", card):
        module = copy.deepcopy(cpu).double().train().to(device)
        source = (MaskSource(generator=torch.Generator().manual_seed(0))
                  if masks is None else MaskSource(masks))
        emb = module(x.to(device), source)
        masks = source.drawn
        loss, _ = mined_triplet_loss(emb, labels.to(device), margin=0.5,
                                     mode="batch_hard")
        loss.backward()
        out.append((emb.detach().cpu(), loss.detach().cpu(), {
            n: p.grad.cpu() for n, p in module.named_parameters()}))
    (e_cpu, l_cpu, g_cpu), (e_gpu, l_gpu, g_gpu) = out
    assert _rel(e_gpu, e_cpu) < DEPTHWISE_CARD_TOL
    assert _rel(l_gpu, l_cpu) < DEPTHWISE_CARD_TOL
    _assert_grads_close(g_gpu, g_cpu)
    with torch.no_grad():
        want = copy.deepcopy(cpu).eval()(x.float())
        got = copy.deepcopy(cpu).to(card).eval()(x.float().to(card))
    assert _rel(got, want) < DEPTHWISE_CARD_TOL
    assert fc.LAUNCHES == _launched()


def _assert_grads_close(got, want):
    """Each gradient to DEPTHWISE_CARD_TOL of its largest entry; one that
    is zero in exact arithmetic (under 1e-8 of the model's largest entry)
    to that share of the model's largest entry."""
    top = max(g.abs().max().item() for g in want.values())
    for n, g in want.items():
        scale = top if g.abs().max().item() < 1e-8 * top \
            else g.abs().max().item()
        err = (got[n] - g).abs().max().item() / scale
        assert err < DEPTHWISE_CARD_TOL, (n, err)


# one name a zoo family at its smallest input, card against CPU from one
# state_dict in float64 train mode: the embeddings, the batch-hard loss and
# every gradient (_assert_grads_close). No float32 check: at random weights
# SENet-154's 50 blocks amplify float32 rounding past 1e-5
# (tests/test_torch_port_zoo_resnet.py)
ZOO_FAMILIES = [("seresnet18", 32), ("seresnext50", 32), ("senet154", 32),
                ("densenet121", 32), ("vgg16", 32), ("inceptionv3", 75),
                ("inceptionresnetv2", 75), ("xception", 71),
                ("nasnetmobile", 32), ("nasnetmobile", 33)]


@pytest.mark.parametrize("name,size", ZOO_FAMILIES)
def test_zoo_family_on_the_card_matches_the_cpu(card, name, size):
    import copy
    from embeddingnet_tpu_torch.models.registry import EmbeddingModule
    from embeddingnet_tpu_torch.ops.mining import mined_triplet_loss
    cpu = EmbeddingModule(name, encodings_len=64, classifier=False)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(size).uniform(
        0, 1, (8, size, size, 3)))
    labels = torch.arange(2).repeat_interleave(4)
    out = []
    for device in ("cpu", card):
        module = copy.deepcopy(cpu).double().train().to(device)
        emb = module(x.to(device))
        loss, _ = mined_triplet_loss(emb, labels.to(device), margin=0.5,
                                     mode="batch_hard")
        loss.backward()
        out.append((emb.detach().cpu(), loss.detach().cpu(), {
            n: p.grad.cpu() for n, p in module.named_parameters()}))
    (e_cpu, l_cpu, g_cpu), (e_gpu, l_gpu, g_gpu) = out
    assert _rel(e_gpu, e_cpu) < DEPTHWISE_CARD_TOL
    assert _rel(l_gpu, l_cpu) < DEPTHWISE_CARD_TOL
    _assert_grads_close(g_gpu, g_cpu)


@pytest.mark.parametrize("name", sorted(VIT_SMALL))
def test_vit_arcface_on_the_card_matches_the_cpu(card, name, monkeypatch):
    """A small ViT of each family under an ArcFace module, f32 with TF32
    off: on the card (the attention kernels' float32 instances, forward
    and backward) against the CPU (the plain version) from the same
    weights and images, the embeddings, the ArcFace loss and every
    gradient to VIT_CARD_TOL of the tensor's largest entry; the key
    biases, whose gradient is zero in exact arithmetic, to VIT_CARD_TOL of
    the model's largest gradient entry."""
    import copy
    from embeddingnet_tpu_torch.models import vit
    from embeddingnet_tpu_torch.models.registry import ArcFaceModule
    from embeddingnet_tpu_torch.ops import attention
    from embeddingnet_tpu_torch.ops.losses import arcface_loss
    monkeypatch.setitem(vit._VARIANTS, name, VIT_SMALL[name])
    cpu = ArcFaceModule(name, encodings_len=64, n_classes=37,
                        input_shape=(64, 64, 3))
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(0, 1, (16, 64, 64, 3)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 37, 16))
    attention.reset_launch_counts()
    out = []
    for module, device in ((cpu, "cpu"), (copy.deepcopy(cpu).to(card), card)):
        emb, w = module(x.to(device))
        loss = arcface_loss(emb, labels.to(device), w, margin=0.5,
                            scale=64.0)
        loss.backward()
        out.append((emb.detach().cpu(), loss.detach().cpu(), {
            n: p.grad.cpu() for n, p in module.named_parameters()}))
    (e_cpu, l_cpu, g_cpu), (e_gpu, l_gpu, g_gpu) = out
    assert _rel(e_gpu, e_cpu) < VIT_CARD_TOL
    assert _rel(l_gpu, l_cpu) < VIT_CARD_TOL
    top = max(g.abs().max().item() for g in g_cpu.values())
    for n, g in g_cpu.items():
        scale = top if n.endswith(".attn.key.bias") else \
            g.abs().max().item()
        assert (g_gpu[n] - g).abs().max().item() / scale < VIT_CARD_TOL, n
    # the CPU's blocks take the plain version, the card's the kernels
    depth = VIT_SMALL[name]["depth"]
    assert attention.LAUNCHES == {"fwd": depth, "bwd": depth,
                                  "plain": depth}


def test_device_ms_raises_on_an_empty_read(card):
    """A profiler read that saw no CUDA kernel is an error naming the
    function, not a device time of 0."""
    import runpy
    tool = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "conv3x3_kernels_ab_torch.py"))

    def launches_nothing():
        return None
    with pytest.raises(RuntimeError, match="launches_nothing"):
        tool["device_ms"](launches_nothing, iters=3)
    x = torch.ones(1 << 20, device=card)
    assert tool["device_ms"](lambda: x.mul(2.0), iters=3) > 0.0


def test_nccl_world1_step_matches_the_cpu_step(card):
    """The data-parallel step in an NCCL group of one rank (the
    collectives run) against the one-process step on the CPU, float64
    modules (the miner in f32, as the step casts), batch_all and
    batch_hard: the loss, every gradient and the running statistics to
    DEPTHWISE_CARD_TOL of the largest entry."""
    import copy
    import socket
    import torch.distributed as dist
    from embeddingnet_tpu_torch.models.heads import EmbeddingHead
    from embeddingnet_tpu_torch.models.registry import EmbeddingModule
    from embeddingnet_tpu_torch.models.resnet import resnet18
    from embeddingnet_tpu_torch.parallel.collectives import DataParallel
    from embeddingnet_tpu_torch.train.optim import get_optimizer
    from embeddingnet_tpu_torch.train.state import TrainState
    from embeddingnet_tpu_torch.train.steps import make_triplet_train_step
    base = EmbeddingModule("resnet18", encodings_len=16)
    base.backbone = resnet18(num_filters=16)
    base.head = EmbeddingHead(base.backbone.out_channels, 16)
    base.reset_parameters(torch.Generator().manual_seed(0))
    base.double()
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (32, 32, 32, 3),
                                           dtype=np.uint8))
    labels = torch.arange(8).repeat_interleave(4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        for mode in ("batch_all", "batch_hard"):
            out = []
            for device, dp in ((card, DataParallel.current()),
                               ("cpu", None)):
                module = copy.deepcopy(base).to(device)
                spec = get_optimizer("sgd", 0.05)
                state = TrainState.create(module, spec)
                step = make_triplet_train_step(module, spec, mode=mode,
                                               max_positives=3, parallel=dp)
                _, m = step(state, images, labels)
                out.append((m["loss"].cpu(), {
                    n: p.grad.cpu() for n, p in module.named_parameters()},
                    {k: v.cpu() for k, v in module.state_dict().items()}))
            (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = out
            assert _rel(l_gpu, l_cpu) < DEPTHWISE_CARD_TOL, mode
            for n, g in g_cpu.items():
                err = (g_gpu[n] - g).abs().max().item() / max(
                    g.abs().max().item(), 1e-30)
                assert err < DEPTHWISE_CARD_TOL, (mode, n, err)
            for k, v in s_cpu.items():
                if "running_" in k:
                    assert _rel(s_gpu[k], v) < DEPTHWISE_CARD_TOL, (mode, k)
    finally:
        dist.destroy_process_group()


# The SE block's kernel path against its cuDNN path on the card: relative
# L2 of their difference, per tensor, over the cuDNN path's norm. The
# readings ``test_se_bottleneck_on_the_card_matches_the_cpu`` prints on an
# H100 run 2.9e-4 (the output) to 4.3e-3 (conv1's weight gradient), while
# each path is 4-8% off the f32 CPU: the limit is 2.3 times the largest.
SE_PATH_GAP = 1e-2


def test_se_bottleneck_on_the_card_matches_the_cpu(card):
    """A squeeze-excitation bottleneck block with ``fast_conv`` at a fused
    shape (4x4, 128 wide) in train mode, from one state_dict whose weights
    and inputs are bf16 values: bf16 on the card through K3 forward and
    K1-as-dgrad and K4 backward, and through cuDNN alone, and f32 on the
    CPU. The kernel path's output and every gradient within SE_PATH_GAP
    of the cuDNN path's. Against the CPU, a looser check: the output
    within 2e-2 relative L2, every gradient no further from the CPU's
    than 1.5 times the cuDNN path's plus 2e-2 (chip_smoke.py's
    GRAD_FACTOR), since each flows back through a train-mode BatchNorm,
    whose backward subtracts the gradient's batch mean, and bf16 rounding
    lands 4-8% off in norm on either path. Prints its readings as one
    JSON line."""
    import json
    from functools import partial
    from embeddingnet_tpu_torch.models import resnet
    rng = np.random.default_rng(30)
    bf16_values = lambda a: torch.from_numpy(  # noqa: E731
        a.astype(np.float32)).bfloat16().float()
    x = bf16_values(rng.normal(size=(32, 512, 4, 4)))
    cot = bf16_values(rng.normal(size=(32, 512, 4, 4)))
    state = None
    results = {}
    for label, device, dtype, fast in (
            ("cpu", "cpu", None, True), ("cudnn", card, torch.bfloat16, False),
            ("kernels", card, torch.bfloat16, True)):
        norm = partial(resnet.BatchNorm, eps=1.001e-5, momentum=0.9,
                       compute_dtype=dtype)
        block = resnet.BottleneckBlock(512, 128, norm, use_se=True,
                                       fast_conv=fast, dtype=dtype)
        assert isinstance(block.conv2, fc.FusedBNReluConv3x3) == fast
        if state is None:
            resnet.init_he_(block, torch.Generator().manual_seed(0))
            with torch.no_grad():
                for p in block.parameters():
                    p.copy_(p.bfloat16())
            state = block.state_dict()
        block.load_state_dict(state)
        block.to(device).train()
        xd = x.to(device).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        fc.reset_launch_counts()
        y = block(xd)
        (y.float() * cot.to(device)).sum().backward()
        launches = dict(fc.LAUNCHES)
        results[label] = {"output": y.detach().float().cpu(),
                          "input grad": xd.grad.float().cpu(),
                          **{n: p.grad.float().cpu()
                             for n, p in block.named_parameters()}}
    assert launches == _launched(conv3x3_small_bn_relu=1, conv3x3_dgrad=1,
                                 conv3x3_wgrad_bn_relu=1)

    def rel(got, want):
        return ((got - want).norm() / want.norm()).item()

    readings = {name: {"cudnn_vs_cpu": rel(results["cudnn"][name], want),
                       "kernels_vs_cpu": rel(results["kernels"][name], want),
                       "kernels_vs_cudnn": rel(results["kernels"][name],
                                               results["cudnn"][name])}
                for name, want in results["cpu"].items()}
    print(json.dumps({"se_bottleneck_readings": readings}))
    for name, r in readings.items():
        assert r["kernels_vs_cudnn"] < SE_PATH_GAP, (name, r)
        assert r["kernels_vs_cpu"] <= 1.5 * r["cudnn_vs_cpu"] + 2e-2, (
            name, r)
    assert readings["output"]["kernels_vs_cpu"] < 2e-2, readings["output"]


@pytest.mark.parametrize("n", [33, 34])
def test_same_max_pool_and_nasnet_adjust_on_the_card(card, n):
    """TF's ``"SAME"`` max pool (-inf on the high side) equal on the card
    and the CPU; a reduced NASNet (every cell's ``adjust``, the strided
    separable convs behind ``correct_pad``) in f32 eval mode, TF32 off, on
    the card against the CPU to 1e-5 of the largest entry, on an odd and
    an even input."""
    import copy
    from embeddingnet_tpu_torch.models import compact, nasnet
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(4, 16, n, n)).astype(np.float32))
    want = compact.max_pool_same(x, 3, 2)
    got = compact.max_pool_same(x.to(card), 3, 2).cpu()
    assert torch.equal(got, want) and got.shape[-1] == (n + 1) // 2
    model = nasnet.NASNet(penultimate_filters=192, num_blocks=1,
                          stem_block_filters=8)
    from embeddingnet_tpu_torch.models.registry import _reset_backbone
    _reset_backbone(model, torch.Generator().manual_seed(0))
    images = torch.from_numpy(rng.uniform(size=(8, 3, n, n)).astype(
        np.float32))
    with torch.no_grad():
        want = model.eval()(images)
        got = copy.deepcopy(model).to(card).eval()(images.to(card)).cpu()
    assert _rel(got, want) < 1e-5
    assert fc.LAUNCHES == _launched()


# -- BatchNorm: csrc/batchnorm_sm90.cu through ops/batchnorm.py -------------
#
# The kernels against the plain eager version on the CPU (the same module
# state, the same inputs), f32 with TF32 off. Tolerances, each as a share of
# the reference tensor's largest entry: f32 outputs, running averages and
# parameter gradients to BN_F32 (sums of up to a million f32 terms added in
# another order, and rsqrtf's 2 ulp against the CPU's); dx to BN_F32 of the
# largest |scale * dy|, its direct term: the train-mode backward subtracts
# the gradient's batch mean and its projection on x, which leaves a residue
# that the two orders of summation round differently; bf16 outputs and dx to
# BN_BF16 (one bf16 rounding of values the two sides compute a few f32 ulp
# apart lands a bf16 ulp, 2^-8, either way).
BN_F32 = 1e-4
BN_BF16 = 1e-2
# float64 (a module converted with .double(), as the card-vs-CPU checks
# convert theirs; the kernels' float64 instances): every output and
# gradient to BN_F64, sums of up to 262,144 float64 terms in another order
# (some 1e-12 of the terms at most); a wrong term would be of their size
BN_F64 = 1e-10
# the tolerance of an output or input gradient in its dtype
BN_TOL = {torch.float32: BN_F32, torch.bfloat16: BN_BF16,
          torch.float64: BN_F64}

# (N, C, H, W): ResNet-50's first and last BatchNorm at 64 px and
# EfficientNet-B3's at 96 px with the batch cut, B3's 1,392-wide layer, and
# an odd C over a single row
BN_SHAPES = [(8, 64, 32, 32), (64, 2048, 2, 2), (8, 40, 48, 48),
             (16, 1536, 3, 3), (8, 1392, 3, 3), (1, 7, 1, 1)]


def _bn_launched(**counts):
    return {name: counts.get(name, 0) for name in bnk.LAUNCHES}


def _bn_modules(kind, c, dtype, device, seed=0):
    """A BatchNorm (or BNScaleBias) with drawn parameters and running
    averages, on ``device``."""
    from functools import partial
    from embeddingnet_tpu_torch.models import resnet
    make = (partial(resnet.BatchNorm, compute_dtype=dtype)
            if kind == "BatchNorm" else fc.BNScaleBias)
    bn = make(c, eps=1e-3, momentum=0.9)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=c) * 0.1))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(size=c) * 0.1))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
    return bn.to(device)


def _bn_input(shape, dtype, seed, device):
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    x = rng.normal(size=(n, h, w, c)) * 2.0 + rng.normal(size=c)
    return torch.from_numpy(x.astype(np.float32)).to(dtype).to(
        device).permute(0, 3, 1, 2)                 # channels_last NCHW


def _bn_run(bn, x, cot):
    """Forward and backward of ``bn`` on ``x`` with cotangents ``cot``:
    (outputs, dx, dgamma, dbeta)."""
    x = x.detach().clone(memory_format=torch.preserve_format)
    x.requires_grad_()
    for p in bn.parameters():
        p.grad = None
    out = bn(x)
    outs = out if isinstance(out, tuple) else (out,)
    sum((o.float() * c).sum() for o, c in zip(outs, cot)).backward()
    return ([o.detach() for o in outs], x.grad, bn.weight.grad,
            bn.bias.grad)


def _bn_scales(bn, x, cot, kind, training):
    """The largest terms that the backward adds and cancels, as float64
    computes them: for dx = a * dy + b * x + c, |a dy| or |b x|; for
    dgamma = rstd * (dscale - mean * dbias), rstd * |dscale| or rstd *
    |mean * dbias|. Either side's rounding is a share of them (at R = 1 the
    exact values are 0). ``bn`` holds the parameters and, in eval mode, the
    running averages used."""
    x = x.double()
    n = x.numel() // x.shape[1]
    gamma = bn.weight.detach().double()
    if training:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
    else:
        mean, var = bn.running_mean.double(), bn.running_var.double()
    rstd = torch.rsqrt(var + bn.eps)
    if kind == "BatchNorm":
        dy = cot[0].to(bn.compute_dtype or torch.float32).double()
        dscale, dbias = (dy * x).sum((0, 2, 3)), dy.sum((0, 2, 3))
        direct = ((gamma * rstd)[:, None, None] * dy).abs().max()
    else:
        dscale, dbias = cot[0].double(), cot[1].double()
        direct = torch.zeros((), dtype=torch.float64)
    b = (-gamma * (dscale - mean * dbias) * rstd ** 3 / n if training
         else torch.zeros_like(mean))
    dx = max(direct.item(), (b[:, None, None] * x).abs().max().item())
    dgamma = (rstd * torch.maximum(dscale.abs(), (mean * dbias).abs())
              ).max().item()
    return dx, dgamma


def _bn_close(got, want, tol, ref=None):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    ref = want.abs().max().item() if ref is None else ref
    err = (got - want).abs().max().item()
    assert err <= tol * max(ref, 1e-30), (err, ref, tol)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("kind", ["BatchNorm", "BNScaleBias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_batchnorm_kernels_match_plain(card, shape, dtype, kind, training):
    """Forward (y or (scale, bias)), the running averages and
    num_batches_tracked, dx, dgamma and dbeta of the kernels against the
    plain version on the CPU from one state, in train and eval mode; and
    the launches: two a layer each way in train mode (one forward for
    BNScaleBias), bn_apply alone for an eval BatchNorm forward. A float64
    module runs the kernels' float64 instances, never the plain version."""
    c = shape[1]
    x = _bn_input(shape, dtype, 1, "cpu")
    rng = np.random.default_rng(2)
    if kind == "BatchNorm":
        cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))]
    else:
        cot = [torch.from_numpy(rng.normal(size=c).astype(np.float32))
               for _ in range(2)]
    cpu = _bn_modules(kind, c, dtype, "cpu").train(training)
    gpu = _bn_modules(kind, c, dtype, card).train(training)
    if dtype == torch.float64:
        cpu.double(), gpu.double()
    bnk.reset_launch_counts()
    want = _bn_run(cpu, x, cot)
    got = _bn_run(gpu, x.to(card), [t.to(card) for t in cot])
    torch.cuda.synchronize()
    tol = BN_TOL[dtype]
    # parameters and running averages: f32 (or float64)
    param_tol = BN_F64 if dtype == torch.float64 else BN_F32
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype
        _bn_close(g, w, BN_TOL[g.dtype])
    dx_scale, dgamma_scale = _bn_scales(cpu, x, cot, kind, training)
    if kind == "BatchNorm" or training:
        _bn_close(got[1], want[1], tol, dx_scale)
    else:
        assert got[1] is None and want[1] is None
    _bn_close(got[2], want[2], param_tol, dgamma_scale)
    _bn_close(got[3], want[3], param_tol)
    for name in ("running_mean", "running_var"):
        _bn_close(getattr(gpu, name), getattr(cpu, name), param_tol)
    assert gpu.num_batches_tracked.item() == cpu.num_batches_tracked.item()
    if training:
        want_launches = dict(bn_stats=1, bn_bwd_dx=1)
        want_launches["bn_apply" if kind == "BatchNorm" else
                      "bn_finalize"] = 1
        if kind == "BatchNorm":
            want_launches["bn_bwd_reduce"] = 1
    elif kind == "BatchNorm":   # the backward finishes the running averages
        want_launches = dict(bn_apply=1, bn_finalize=1, bn_bwd_reduce=1,
                             bn_bwd_dx=1)
    else:
        want_launches = dict(bn_finalize=2)
    assert bnk.LAUNCHES == _bn_launched(**want_launches)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
@pytest.mark.parametrize("case", ["nchw", "unaligned", "odd_c"])
def test_batchnorm_edges_match_plain(card, case, dtype):
    """A contiguous NCHW input (taken through its strides; NASNet's stem
    adjusts feed one), a channels_last view whose base is not 16-byte
    aligned and C = 42 run the one-channel instances and match the plain
    version, in bf16 and in float64."""
    shape = (4, 42 if case == "odd_c" else 64, 6, 6)
    x = _bn_input(shape, dtype, 3, "cpu")
    if case == "nchw":
        x = x.contiguous()
    xg = x.to(card)
    if case == "nchw":
        xg = xg.contiguous()
        assert bnk.geometry(xg).nchw == 1
    elif case == "unaligned":
        n, c, h, w = shape
        flat = torch.empty(n * h * w * c + 1, dtype=dtype, device=card)
        xg = flat[1:].view(n, h, w, c).permute(0, 3, 1, 2)
        xg.copy_(x.to(card))
        assert xg.data_ptr() % 16 and bnk.geometry(xg).nchw == 0
    assert bnk.vector_width(bnk.geometry(xg), xg) == 1
    cot = [torch.from_numpy(np.random.default_rng(4).normal(
        size=shape).astype(np.float32))]
    cpu = _bn_modules("BatchNorm", shape[1], dtype, "cpu")
    gpu = _bn_modules("BatchNorm", shape[1], dtype, card)
    if dtype == torch.float64:
        cpu.double(), gpu.double()
    want = _bn_run(cpu, x, cot)
    got = _bn_run(gpu, xg, [cot[0].to(card)])
    param_tol = BN_F64 if dtype == torch.float64 else BN_F32
    _bn_close(got[0][0], want[0][0], BN_TOL[dtype])
    _bn_close(got[1], want[1], BN_TOL[dtype])
    _bn_close(got[2], want[2], param_tol)
    _bn_close(got[3], want[3], param_tol)
    _bn_close(gpu.running_var, cpu.running_var, param_tol)


def test_batchnorm_recomputing_leaves_running_averages(card):
    """A rematerialised forward (``recomputing``) gives the first forward's
    output and leaves the running averages and the batch count alone."""
    from embeddingnet_tpu_torch.ops import batchnorm_context as ctxm
    x = _bn_input((8, 256, 8, 8), torch.bfloat16, 5, card)
    bn = _bn_modules("BatchNorm", 256, torch.bfloat16, card)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    again = ctxm.current()._replace(recomputing=True)
    with ctxm.use(again):
        y_re = bn(x)
    after = bn.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    y = bn(x)
    assert torch.equal(y, y_re)
    assert bn.num_batches_tracked.item() == before[
        "num_batches_tracked"].item() + 1
    assert not torch.equal(bn.running_var, before["running_var"])


def test_batchnorm_is_bitwise_repeatable(card):
    """The sums add their partials in a fixed order: two runs from one
    state give the same outputs, gradients and running averages bit for
    bit, at the stem's shape (521 row groups) and the last layer's."""
    for shape in ((64, 64, 32, 32), (256, 2048, 2, 2)):
        x = _bn_input(shape, torch.bfloat16, 6, card)
        cot = [torch.from_numpy(np.random.default_rng(7).normal(
            size=shape).astype(np.float32)).to(card)]
        runs = []
        for _ in range(2):
            bn = _bn_modules("BatchNorm", shape[1], torch.bfloat16, card)
            runs.append(_bn_run(bn, x, cot) + (bn.running_var.clone(),))
        a, b = runs
        assert torch.equal(a[0][0], b[0][0])
        for i in (1, 2, 3, 4):
            assert torch.equal(a[i], b[i]), i


def test_batchnorm_wrapper_refuses_what_the_kernels_cannot_take(card):
    """A float64 CUDA input to a module that is not float64 (the kernels'
    float64 instances take float64 modules alone), a float16 input, a
    layout that is neither channels_last nor contiguous NCHW, a 2-D input,
    parameters of two dtypes and a float64 module asked for a bf16 output
    raise before any launch."""
    bnk.reset_launch_counts()
    bn = _bn_modules("BatchNorm", 64, torch.bfloat16, card)
    x = _bn_input((4, 64, 8, 8), torch.float32, 8, card)
    for bad in (x.double(), x.half(), x[:, :, ::2], x.contiguous()[..., 1:],
                x[:, :, 0, 0]):
        with pytest.raises(ValueError):
            bnk.batch_norm(bn, bad, torch.bfloat16)
        with pytest.raises(ValueError):
            bnk.scale_bias(bn, bad)
    bn.running_var.data = bn.running_var.data.bfloat16()
    with pytest.raises(ValueError):
        bnk.batch_norm(bn, x, torch.bfloat16)
    bn64 = _bn_modules("BatchNorm", 64, None, card).double()
    with pytest.raises(ValueError):
        bnk.batch_norm(bn64, x.double(), torch.bfloat16)
    with pytest.raises(ValueError):
        bnk.batch_norm(bn64, x, None)
    assert bnk.LAUNCHES == _bn_launched()


def test_batchnorm_global_statistics_in_an_nccl_group_of_one(card):
    """With a world (an NCCL group of one rank), the statistics kernel writes
    the sums, the collective runs and bn_finalize finishes them, forward
    and backward: the same numbers bit for bit as without a world; and the
    data-parallel f32 train step through the kernels matches the
    one-process step on the card to BN_F32 (loss, gradients, running
    averages)."""
    import copy
    import socket
    import torch.distributed as dist
    from embeddingnet_tpu_torch.models.heads import EmbeddingHead
    from embeddingnet_tpu_torch.models.registry import EmbeddingModule
    from embeddingnet_tpu_torch.models.resnet import resnet18
    from embeddingnet_tpu_torch.ops import batchnorm_context as ctxm
    from embeddingnet_tpu_torch.parallel.collectives import DataParallel
    from embeddingnet_tpu_torch.train.optim import get_optimizer
    from embeddingnet_tpu_torch.train.state import TrainState
    from embeddingnet_tpu_torch.train.steps import make_triplet_train_step
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        world = DataParallel.current()
        shape = (16, 256, 8, 8)
        x = _bn_input(shape, torch.bfloat16, 9, card)
        cot = [torch.from_numpy(np.random.default_rng(10).normal(
            size=shape).astype(np.float32)).to(card)]
        for kind in ("BatchNorm", "BNScaleBias"):
            if kind == "BNScaleBias":
                cot = [t.to(card) for t in (torch.randn(256), torch.randn(
                    256))]
            runs = []
            for w in (None, world):
                bn = _bn_modules(kind, 256, torch.bfloat16, card)
                bnk.reset_launch_counts()
                with ctxm.global_statistics(w):
                    out = _bn_run(bn, x, cot)
                runs.append((out, bn.running_mean.clone(),
                             bn.running_var.clone(), dict(bnk.LAUNCHES)))
            (a, am, av, al), (b, bm, bv, bl) = runs
            for ga, gb in zip(a[0], b[0]):
                assert torch.equal(ga, gb), kind
            for i in (1, 2, 3):
                assert torch.equal(a[i], b[i]), (kind, i)
            assert torch.equal(am, bm) and torch.equal(av, bv)
            assert bl["bn_finalize"] >= 2 and al["bn_finalize"] <= 1, (
                al, bl)
        base = EmbeddingModule("resnet18", encodings_len=16)
        base.backbone = resnet18(num_filters=16)
        base.head = EmbeddingHead(base.backbone.out_channels, 16)
        base.reset_parameters(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(1)
        images = torch.from_numpy(rng.integers(0, 256, (32, 32, 32, 3),
                                               dtype=np.uint8))
        labels = torch.arange(8).repeat_interleave(4)
        out = []
        for dp in (world, None):
            module = copy.deepcopy(base).to(card)
            spec = get_optimizer("sgd", 0.05)
            state = TrainState.create(module, spec)
            step = make_triplet_train_step(module, spec, mode="batch_all",
                                           max_positives=3, parallel=dp)
            bnk.reset_launch_counts()
            _, m = step(state, images, labels)
            torch.cuda.synchronize()
            assert bnk.LAUNCHES["bn_stats"] > 0
            out.append((m["loss"].cpu(), {
                n: p.grad.cpu() for n, p in module.named_parameters()},
                {k: v.cpu() for k, v in module.state_dict().items()
                 if "running_" in k}))
        (l_dp, g_dp, s_dp), (l_one, g_one, s_one) = out
        _bn_close(l_dp, l_one, BN_F32)
        for n, g in g_one.items():
            _bn_close(g_dp[n], g, BN_F32)
        for k, v in s_one.items():
            _bn_close(s_dp[k], v, BN_F32)
    finally:
        dist.destroy_process_group()


def test_batchnorm_under_remat_matches_without(card):
    """A bf16 ResNet-18 step with its blocks rematerialised (the recompute
    runs the statistics kernel again, ``recomputing``) against the same
    step without: the loss and the BatchNorm state equal, bit for bit (the
    kernels' sums are repeatable and the recompute leaves the running
    averages alone), the gradients to BN_BF16 of their largest entry (the
    convs' backward may add in another order)."""
    import copy
    from embeddingnet_tpu_torch.models import remat
    from embeddingnet_tpu_torch.models.heads import EmbeddingHead
    from embeddingnet_tpu_torch.models.registry import EmbeddingModule
    from embeddingnet_tpu_torch.models.resnet import resnet18
    base = EmbeddingModule("resnet18", encodings_len=16, dtype=torch.bfloat16)
    base.backbone = resnet18(num_filters=16, dtype=torch.bfloat16)
    base.head = EmbeddingHead(base.backbone.out_channels, 16)
    base.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(11).uniform(
        size=(32, 32, 32, 3)).astype(np.float32)).to(card)
    out = {}
    for on in (False, True):
        module = copy.deepcopy(base).to(card).train()
        bnk.reset_launch_counts()
        with remat.rematerialize(on):
            loss = module(x).float().square().sum()
            loss.backward()
        torch.cuda.synchronize()
        out[on] = (loss.detach(), {n: p.grad for n, p in
                                   module.named_parameters()},
                   {k: v for k, v in module.state_dict().items()
                    if "running_" in k or "num_batches" in k},
                   dict(bnk.LAUNCHES))
    (l0, g0, s0, n0), (l1, g1, s1, n1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for n, g in g0.items():
        assert (g is None) == (g1[n] is None), n
        if g is not None:
            _bn_close(g1[n], g, BN_BF16)
    assert n1["bn_stats"] > n0["bn_stats"] > 0     # the recompute's
    assert n1["bn_bwd_dx"] == n0["bn_bwd_dx"]


# the attention kernels (csrc/attention_sm90.cu) against the float32 plain
# path as the truth, relative to each result's largest entry: the kernels
# read q, k, v in bf16 and round P and dS to bf16 for their products, as
# the eager bf16 path rounds its scores, weights and products; the
# tolerance is the bf16 output rounding the conv kernels are held to
ATT_TOL = 2e-2
ATT_SHAPES = [(256, 197, 12, 64), (8, 50, 12, 64), (4, 257, 12, 64),
              (4, 1, 12, 64), (3, 197, 12, 64), (4, 197, 6, 64),
              (4, 197, 4, 32), (4, 257, 16, 64), (2, 130, 2, 128)]


def _att_inputs(seed, b, n, h, d, device, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, n, h * d)).astype(
        np.float32)).to(device).to(dtype) for _ in range(4)]


def _att_rel(got, want):
    """The largest error over the largest entry of ``want`` (over 1 where
    ``want`` is 0: one token's dq and dk)."""
    scale = want.abs().max().item() or 1.0
    return (got.float() - want).abs().max().item() / scale


@pytest.fixture
def att(card):
    from embeddingnet_tpu_torch.ops import attention
    attention.reset_launch_counts()
    yield attention
    attention.reset_launch_counts()


@pytest.mark.parametrize("b,n,h,d", ATT_SHAPES)
def test_attention_kernels_match_plain(att, card, b, n, h, d):
    """The forward and dq, dk, dv of the kernels against autograd of the
    float32 plain path, to ATT_TOL of each result's largest entry, and
    never more than twice the bf16 plain path's own error there plus 1e-3
    (the kernels round the same operands in other places)."""
    q, k, v, do = _att_inputs(b * n + d, b, n, h, d, card)
    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    want = att.plain_attention(qf, kf, vf, h)
    wants = [want, *torch.autograd.grad(want, (qf, kf, vf), do.float())]
    qb, kb, vb = (x.clone().requires_grad_() for x in (q, k, v))
    plain = att.plain_attention(qb, kb, vb, h)
    plains = [plain, *torch.autograd.grad(plain, (qb, kb, vb), do)]
    qk, kk, vk = (x.clone().requires_grad_() for x in (q, k, v))
    out = att.attention(qk, kk, vk, h)
    gots = [out, *torch.autograd.grad(out, (qk, kk, vk), do)]
    for name, got, p, w in zip(("out", "dq", "dk", "dv"), gots, plains,
                               wants):
        assert torch.isfinite(got).all(), name
        err = _att_rel(got, w)
        assert err < ATT_TOL, (name, err)
        assert err <= 2 * _att_rel(p, w) + 1e-3, (name, err)
    assert att.LAUNCHES == {"fwd": 1, "bwd": 1, "plain": 0}


# _forward's logsumexp and _backward's dq, dk, dv against the kernels'
# arithmetic in plain PyTorch (plain_forward_lse, plain_backward) in float64
# from the same inputs, relative to each result's largest entry (the
# logsumexp absolute): bf16 rounds P and dS for its products (ATT_TOL); its
# logsumexp and float32's are f32 sums of exact products in another order
# (1e-4 over scores of a few units); fp16 as bf16; float32's results 1e-5,
# as the card checks of the ViT path; float64's sums in another order,
# 1e-10. One token's dq and dk are zero in exact arithmetic (the
# reference's are rounding), so they are held absolutely
ATT_REFERENCE = {torch.bfloat16: (ATT_TOL, 1e-4),
                 torch.float16: (ATT_TOL, 1e-4), torch.float32: (1e-5, 1e-4),
                 torch.float64: (1e-10, 1e-10)}


@pytest.mark.parametrize("dtype", sorted(ATT_REFERENCE, key=str))
@pytest.mark.parametrize("b,n,h,d", [(4, 197, 12, 64), (3, 1, 12, 64),
                                     (2, 257, 2, 128), (2, 50, 4, 40)])
def test_attention_kernels_match_the_reference_algebra(att, card, dtype, b,
                                                       n, h, d):
    if dtype in att.TENSOR_CORE_DTYPES and d % 16:
        with pytest.raises(ValueError, match=f"head dimension {d}"):
            att._check(*_att_inputs(0, b, n, h, d, card, dtype)[:3], h)
        return
    q, k, v, do = _att_inputs(b * n + d, b, n, h, d, card, dtype)
    tol, lse_tol = ATT_REFERENCE[dtype]
    out, lse = att._forward(q, k, v, h, d, keep_lse=True)
    grads = att._backward(q, k, v, out, do, lse, h, d)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    want, want_lse = att.plain_forward_lse(q64, k64, v64, h)
    wants = att.plain_backward(q64, k64, v64, want, do64, want_lse, h)
    assert lse.dtype == torch.promote_types(dtype, torch.float32)
    assert (lse.double() - want_lse).abs().max().item() < lse_tol
    for name, got, w in zip(("out", "dq", "dk", "dv"), (out, *grads),
                            (want, *wants)):
        assert torch.isfinite(got).all(), name
        exact_zero = n == 1 and name in ("dq", "dk")
        scale = 1.0 if exact_zero else w.abs().max().item()
        err = (got.double() - w).abs().max().item() / scale
        assert err < tol, (name, err)
    assert att.LAUNCHES == {"fwd": 1, "bwd": 1, "plain": 0}


def test_attention_launches_are_exact(att, card):
    """With gradients one forward launch keeping the logsumexp, one
    backward launch; under no_grad one forward; a float32 card tensor
    launches the float32 instance, a CPU tensor takes the plain
    version."""
    q, k, v, do = _att_inputs(1, 2, 197, 12, 64, card)
    q.requires_grad_()
    out = att.attention(q, k, v, 12)
    assert att.LAUNCHES == {"fwd": 1, "bwd": 0, "plain": 0}
    out.backward(do)
    assert att.LAUNCHES == {"fwd": 1, "bwd": 1, "plain": 0}
    with torch.no_grad():
        again = att.attention(q, k, v, 12)
    assert att.LAUNCHES == {"fwd": 2, "bwd": 1, "plain": 0}
    assert torch.equal(again, out.detach())
    att.attention(q.float(), k.float(), v.float(), 12)
    att.attention(q.detach().cpu(), k.cpu(), v.cpu(), 12)
    assert att.LAUNCHES == {"fwd": 3, "bwd": 1, "plain": 1}


def test_attention_is_bitwise_repeatable(att, card):
    """Two launches give the same bits forward and backward (no atomics)."""
    q, k, v, do = _att_inputs(2, 16, 197, 12, 64, card)
    runs = []
    for _ in range(2):
        qk, kk, vk = (x.clone().requires_grad_() for x in (q, k, v))
        out = att.attention(qk, kk, vk, 12)
        runs.append([out, *torch.autograd.grad(out, (qk, kk, vk), do)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_attention_refuses_what_the_kernels_cannot_take(att, card):
    q, k, v, _ = _att_inputs(3, 2, 50, 4, 64, card)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        att.attention(q.to(torch.int8), k.to(torch.int8), v.to(torch.int8),
                      4)
    with pytest.raises(ValueError, match="head dimension 40"):
        att.attention(q[..., :160], k[..., :160], v[..., :160], 4)
    with pytest.raises(ValueError, match="head dimension 8"):
        att.attention(q[..., :32], k[..., :32], v[..., :32], 4)
    with pytest.raises(ValueError, match="head dimension 256"):
        att.attention(q, k, v, 1)
    wide = torch.cat([q, q], dim=-1)
    with pytest.raises(ValueError, match="strides"):
        att.attention(wide[..., ::2], k, v, 4)
    odd = torch.cat([q, q[..., :4]], dim=-1)[..., :256]
    with pytest.raises(ValueError, match="strides"):
        att.attention(odd, k, v, 4)
    with pytest.raises(ValueError, match="does not match"):
        att.attention(q, k[:, :49], v, 4)
    assert att.LAUNCHES == {"fwd": 0, "bwd": 0, "plain": 0}


def test_attention_under_remat_matches_without(att, card):
    """A bf16 ViT's forward and backward with its blocks rematerialised
    (the recompute runs the forward kernel again) against the same without:
    the loss and every gradient equal bit for bit."""
    import copy
    from embeddingnet_tpu_torch.models import remat
    from embeddingnet_tpu_torch.models.vit import ViT
    base = ViT((64, 64), dim=128, depth=2, heads=2, dtype=torch.bfloat16)
    base.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(12).uniform(
        size=(8, 3, 64, 64)).astype(np.float32)).to(card)
    out = {}
    for on in (False, True):
        module = copy.deepcopy(base).to(card).train()
        att.reset_launch_counts()
        with remat.rematerialize(on):
            loss = module(x).float().square().sum()
            loss.backward()
        torch.cuda.synchronize()
        out[on] = (loss.detach(), {n: p.grad for n, p in
                                   module.named_parameters()},
                   dict(att.LAUNCHES))
    (l0, g0, n0), (l1, g1, n1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
    assert n0 == {"fwd": 2, "bwd": 2, "plain": 0}
    assert n1 == {"fwd": 4, "bwd": 2, "plain": 0}


# the LayerNorm kernels (csrc/layernorm_sm90.cu) against their arithmetic in
# float64 (plain_forward, plain_backward) from the same inputs.
# Per result, relative to each row's (or each vector's) largest reference
# entry: bf16 and fp16 outputs (y, dx) within one ulp of the reference
# rounded once to their dtype (the kernels round once, from f32), plus
# LN_F32 of the row's largest entry for values near zero, where an ulp is
# smaller than f32's rounding of the mean and of terms as large as the
# row's largest; their f32 statistics and parameter sums (rsqrtf's 2 ulps,
# f32 sums of a row and of the rows in another order) to LN_F32; float32's
# results to LN_F32 too, as the card checks of the ViT path; float64's sums
# in another order to 1e-12
LN_F32 = 1e-5
LN_BITS = {torch.bfloat16: 8, torch.float16: 11}
LN_TOL = {torch.bfloat16: LN_F32, torch.float16: LN_F32,
          torch.float32: LN_F32, torch.float64: 1e-12}
LN_DIMS = [768, 1024, 100]        # the ViTs' D, one not a multiple of 8
LN_ROWS = 2 * 197 + 3


@pytest.fixture
def ln(card):
    from embeddingnet_tpu_torch.ops import layernorm
    layernorm.reset_launch_counts()
    yield layernorm
    layernorm.reset_launch_counts()


def _ln_inputs(seed, rows, d, device, dtype):
    """x (rows of mean about 1; row 0 constant, row 1 of variance about
    1e-6, where eps counts), an output gradient (row 0's small, so that its
    dx, rstd times it, stays inside fp16's range), and the weight and bias
    in the sums' precision."""
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 1.0, (rows, d))
    x[0] = 0.75
    x[1] = 1e-3 * rng.normal(size=d)
    dy = rng.normal(size=(rows, d))
    dy[0] *= 1e-5
    acc = torch.promote_types(dtype, torch.float32)
    to = lambda a, t: torch.from_numpy(a).to(device, t)  # noqa: E731
    return (to(x, dtype), to(dy, dtype), to(rng.normal(1.0, 0.1, d), acc),
            to(rng.normal(0.0, 0.1, d), acc))


def _ln_reference(x, dy, w, b, eps):
    """y, mean, rstd, dx, dweight, dbias in float64 on the CPU."""
    x64, dy64, w64, b64 = (t.double().cpu() for t in (x, dy, w, b))
    from embeddingnet_tpu_torch.ops import layernorm
    y, mean, rstd = layernorm.plain_forward(x64, w64, b64, eps)
    return (y, mean, rstd,
            *layernorm.plain_backward(x64, dy64, mean, rstd, w64))


def _ln_close(name, got, want, dtype):
    """Raises past the tolerance of ``dtype`` stated above."""
    got = got.double().cpu()
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-300)
    err = (got - want).abs()
    if name in ("y", "dx") and dtype in LN_BITS:
        ref = want.to(dtype).double()
        ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(
            torch.maximum(ref.abs(), got.abs()))[1] - LN_BITS[dtype])
        err = (got - ref).abs()
        worst = (err / (ulp + LN_F32 * scale)).max().item()
    else:
        worst = (err / (LN_TOL[dtype] * scale)).max().item()
    assert torch.isfinite(got).all(), name
    assert worst <= 1.0, (name, worst)


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("d", LN_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.float64], ids=str)
def test_layernorm_kernels_match_the_reference(ln, card, dtype, d, eps):
    x, dy, w, b = _ln_inputs(d, LN_ROWS, d, card, dtype)
    y, stats = ln._forward(x, w, b, eps, True)
    grads = ln._backward(x, dy, stats, w)
    mean, rstd = stats
    assert y.dtype == grads[0].dtype == dtype
    assert mean.dtype == grads[1].dtype == w.dtype
    for name, got, want in zip(("y", "mean", "rstd", "dx", "dweight",
                                "dbias"), (y, mean, rstd, *grads),
                               _ln_reference(x, dy, w, b, eps)):
        _ln_close(name, got, want, dtype)
    assert ln.LAUNCHES == {"fwd": 1, "bwd": 1, "plain": 0}


@pytest.mark.parametrize("pad", [8, 3])
def test_layernorm_takes_rows_at_a_stride(ln, card, pad):
    """x a [B, N, 768] view of [B, N, 768 + pad], through autograd: 16-byte
    aligned rows (pad 8) give the contiguous copy's bits, the others (pad
    3, the scalar instance) the reference's tolerance."""
    x, dy, w, b = _ln_inputs(5, LN_ROWS, 768 + pad, card, torch.bfloat16)
    wide = x.reshape(1, LN_ROWS, 768 + pad).clone().requires_grad_()
    w, b = w[:768].clone().requires_grad_(), b[:768].clone().requires_grad_()
    dy = dy[:, :768].reshape(1, LN_ROWS, 768)
    out = {}
    for name, leaf in (("view", wide), ("copy", wide.detach()[..., :768]
                                        .contiguous().requires_grad_())):
        xs = leaf[..., :768] if name == "view" else leaf
        y = ln.layer_norm(xs, w, b, 1e-12)
        out[name] = [y, *torch.autograd.grad(y, (leaf, w, b), dy)]
        if name == "view":
            assert torch.equal(out[name][1][..., 768:],
                               torch.zeros_like(wide[..., 768:]))
            out[name][1] = out[name][1][..., :768]
    assert ln.LAUNCHES == {"fwd": 2, "bwd": 2, "plain": 0}
    if pad == 8:
        for a, c in zip(out["view"], out["copy"]):
            assert torch.equal(a, c)
        return
    ref = _ln_reference(x[:, :768], dy[0], w.detach(), b.detach(), 1e-12)
    for name, got, want in zip(("y", "dx", "dweight", "dbias"), out["view"],
                               (ref[0], *ref[3:])):
        _ln_close(name, got.reshape(want.shape), want, torch.bfloat16)


def test_layernorm_is_bitwise_repeatable(ln, card):
    """Two backward calls give the same bits (no atomics; the partial
    sums added in a fixed order), and the forward gives the same bits
    whether it keeps the statistics or not, as a remat recompute runs
    it."""
    x, dy, w, b = _ln_inputs(7, 64 * 197, 768, card, torch.bfloat16)
    y, stats = ln._forward(x, w, b, 1e-12, True)
    again, none = ln._forward(x, w, b, 1e-12, False)
    assert none is None and torch.equal(y, again)
    first = ln._backward(x, dy, stats, w)
    second = ln._backward(x, dy, stats, w)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_layernorm_under_remat_matches_without(ln, card):
    """A bf16 ViT's forward and backward with its blocks rematerialised
    (the recompute runs the forward kernel again) against the same without:
    the loss and every gradient equal bit for bit; a forward launch each
    LayerNorm call, a backward launch each LayerNorm."""
    import copy
    from embeddingnet_tpu_torch.models import remat
    from embeddingnet_tpu_torch.models.vit import ViT
    base = ViT((64, 64), dim=128, depth=2, heads=2, dtype=torch.bfloat16)
    base.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(13).uniform(
        size=(8, 3, 64, 64)).astype(np.float32)).to(card)
    out = {}
    for on in (False, True):
        module = copy.deepcopy(base).to(card).train()
        ln.reset_launch_counts()
        with remat.rematerialize(on):
            loss = module(x).float().square().sum()
            loss.backward()
        torch.cuda.synchronize()
        out[on] = (loss.detach(), {n: p.grad for n, p in
                                   module.named_parameters()},
                   dict(ln.LAUNCHES))
    (l0, g0, n0), (l1, g1, n1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
    assert n0 == {"fwd": 5, "bwd": 5, "plain": 0}
    assert n1 == {"fwd": 9, "bwd": 5, "plain": 0}


@pytest.mark.parametrize("name,d,fwd,bwd", [("vit-b16", 768, 49, 25),
                                            ("vit-l14", 1024, 98, 50)])
def test_layernorm_launches_in_a_vit_arcface_step(ln, card, name, d, fwd,
                                                  bwd):
    """One ArcFace step at full width and depth, 224 px, bf16, under remat
    (B=8: the launches do not follow the batch): ViT-B/16 launches the
    forward kernel 49 times (12 blocks x 2 LayerNorms x 2 under remat, and
    ln_final) and the backward 25; CLIP ViT-L/14 at D 1024 98 and 50
    (ln_pre too); no call takes the plain version."""
    from embeddingnet_tpu_torch.models.registry import ArcFaceModule
    from embeddingnet_tpu_torch.train import optim
    from embeddingnet_tpu_torch.train.state import TrainState
    from embeddingnet_tpu_torch.train.steps import make_arcface_train_step
    module = ArcFaceModule(name, encodings_len=512, n_classes=64,
                           dtype=torch.bfloat16,
                           input_shape=(224, 224, 3)).to(card)
    module.reset_parameters(torch.Generator(card).manual_seed(0))
    assert module.encoder.backbone.ln_final.normalized_shape == (d,)
    spec = optim.get_optimizer("adam", 1e-4)
    state = TrainState.create(module, spec,
                              generator=torch.Generator(card).manual_seed(1))
    step = make_arcface_train_step(module, spec, n_classes=64, remat=True,
                                   compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(14)
    images = torch.from_numpy(rng.integers(0, 256, (8, 224, 224, 3),
                                           dtype=np.uint8)).to(card)
    labels = torch.from_numpy(rng.integers(0, 64, 8)).to(card)
    ln.reset_launch_counts()
    _, metrics = step(state, images, labels)
    assert np.isfinite(float(metrics["loss"]))
    assert ln.LAUNCHES == {"fwd": fwd, "bwd": bwd, "plain": 0}
