"""BatchNorm's kernels (``embeddingnet_tpu_torch/ops/batchnorm.py`` over
``csrc/batchnorm_sm90.cu``), what of them runs on the CPU:

- the launch plan (``plan_batchnorm``) for every BatchNorm of the two
  benchmark cells' models (ResNet-50 at 64 px with the fused BN-ReLU conv,
  EfficientNet-B3 at 96 px, B=1,024), the shapes taken from the modules
  themselves, and at the edges (one row, one channel, C = 2,304): the grid
  covers every row and channel once, within the limits the kernels check;
- a box model of the kernels' loops over the plan: which (row, channel)
  each thread of each block reads, every element exactly once, vector
  accesses on whole 16-byte vectors;
- a CPU tensor through the wrapper (``batch_norm``, ``scale_bias``) gives
  today's eager forward, running averages and gradients bit for bit (the
  JAX parity tests hold that path);
- the layouts the wrapper takes and the vector width it picks;
- every CNN family of the port feeds its BatchNorms a layout the kernels
  take.
The card runs the kernels (``tests/test_torch_port_cuda.py``)."""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu_torch.models.registry import EmbeddingModule  # noqa
from embeddingnet_tpu_torch.models import resnet  # noqa: E402
from embeddingnet_tpu_torch.ops import batchnorm as bnk  # noqa: E402
from embeddingnet_tpu_torch.ops import fused_conv as fc  # noqa: E402

H100_SMS = 132
CELL_BATCH = 1024


def _bn_inputs(module, x, *args):
    """``[(module, input shape)]`` of every BatchNorm ``module`` calls on
    ``x``, in call order."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a: seen.append((mod, a[0]))) for m in module.modules()
        if isinstance(m, fc.BNScaleBias)]
    try:
        with torch.no_grad():
            module.train()(x, *args)
    finally:
        for h in hooks:
            h.remove()
    return seen


def _cell_shapes(name, size, fast_conv):
    module = EmbeddingModule(name, encodings_len=256, fast_conv=fast_conv,
                             input_shape=(size, size, 3))
    return collections.Counter(
        tuple(x.shape[1:]) for _, x in _bn_inputs(
            module, torch.rand(1, size, size, 3)))


def _check_plan(plan, rows, channels, sm_count=H100_SMS):
    """The plan's grid covers ``rows`` x ``channels`` once, as the entry
    points' ``bad_plan`` asks."""
    ty = plan.ty
    assert 1 <= plan.tx <= (bnk.MAX_TX if plan.vec == bnk.VECTOR
                            else bnk.MAX_TX_SCALAR)
    assert plan.rows_per_block % ty == 0
    assert plan.groups * plan.rows_per_block >= rows
    assert (plan.groups - 1) * plan.rows_per_block < rows
    width = plan.tx * plan.vec
    assert plan.slabs * width >= channels > (plan.slabs - 1) * width
    assert 1 <= plan.slabs <= 65535
    # the grid stays near the blocks the card holds, and a slab's last
    # block adds at most 8 partial rows a thread
    assert plan.groups * plan.slabs <= max(
        sm_count * bnk.BLOCKS_PER_SM + plan.slabs, plan.slabs)
    assert plan.groups <= bnk.MAX_GROUPS
    assert -(-plan.groups // ty) <= 8
    # the slabs are balanced: the last one is at least half full
    assert channels - (plan.slabs - 1) * width >= width // 2 or (
        plan.slabs == 1)
    if plan.vec == bnk.VECTOR:
        assert channels % bnk.VECTOR == 0


@pytest.mark.parametrize("name,size,fast_conv,layers", [
    ("resnet50", 64, True, 53), ("efficientnet-b3", 96, False, 78)])
def test_plan_for_every_batchnorm_of_the_cells(name, size, fast_conv,
                                               layers):
    """ResNet-50 at 64 px (the flagship, 53 BatchNorms) and B3 at 96 px
    (78): every layer's plan at B=1,024 on 132 SMs covers its rows and
    channels, takes the 16-byte vectors (every width is a multiple of 8),
    cuts the channels into slabs of at most a 128-byte line, and fills
    the card: a block an SM or more wherever the layer has rows for it."""
    shapes = _cell_shapes(name, size, fast_conv)
    assert sum(shapes.values()) == layers
    for (c, h, w), _ in shapes.items():
        rows = CELL_BATCH * h * w
        plan = bnk.plan_batchnorm(rows, c, bnk.VECTOR, H100_SMS)
        _check_plan(plan, rows, c)
        assert plan.vec == bnk.VECTOR
        assert plan.slabs == -(-c // (8 * bnk.MAX_TX))
        if rows >= H100_SMS * plan.ty * bnk.UNROLL:
            assert plan.groups * plan.slabs >= H100_SMS, (c, h, w, plan)


def test_plan_at_the_stem_and_the_last_layer():
    """The two ends of the flagship: its 1,048,576 x 64 stem and its 4,096
    x 2,048 last layer, the same algorithm with other parameters."""
    assert bnk.plan_batchnorm(1 << 20, 64, 8, H100_SMS) == bnk.BNPlan(
        vec=8, tx=8, slabs=1, groups=256, rows_per_block=4096)
    assert bnk.plan_batchnorm(4096, 2048, 8, H100_SMS) == bnk.BNPlan(
        vec=8, tx=8, slabs=32, groups=16, rows_per_block=256)
    # B3's 144-wide layers: 18 vectors in 3 slabs of 6, none idle
    assert bnk.plan_batchnorm(1024 * 48 * 48, 144, 8, H100_SMS)[:3] == (
        8, 6, 3)


@pytest.mark.parametrize("rows,channels,vec", [
    (1, 1, 1), (1, 7, 1), (1, 8, 8), (3, 1, 1), (1 << 20, 1, 1),
    (4096, 2304, 8), (4096, 2304, 1), (37, 42, 1), (2 ** 31 - 1, 8, 8)])
def test_plan_at_the_edges(rows, channels, vec):
    """One row, one channel, C = 2,304 on both widths, an odd width, the
    most rows the kernels take."""
    plan = bnk.plan_batchnorm(rows, channels, vec, H100_SMS)
    _check_plan(plan, rows, channels)
    if rows == 1:
        assert plan.groups == 1
    if channels == 1:
        assert (plan.tx, plan.slabs) == (1, 1)
    if channels == 2304:
        assert plan.tx * plan.slabs * vec == 2304


@pytest.mark.parametrize("args", [(0, 8, 8, 132), (8, 0, 8, 132),
                                  (8, 8, 4, 132), (8, 8, 8, 0)])
def test_plan_refuses_what_no_kernel_takes(args):
    with pytest.raises(ValueError):
        bnk.plan_batchnorm(*args)


def _box_model(plan, rows, channels):
    """The elements each thread of each block reads, replayed from the
    kernels' loops (``reduce_body``, ``bn_apply_sm90_kernel``,
    ``bn_bwd_dx_sm90_kernel`` share them): a count per (row, channel),
    and the address of every vector access."""
    count = np.zeros((rows, channels), np.int64)
    starts = []
    ty_n = plan.ty
    for s in range(plan.slabs):
        for g in range(plan.groups):
            begin = g * plan.rows_per_block
            end = min(rows, begin + plan.rows_per_block)
            for t in range(bnk.THREADS):
                tx, ty = t % plan.tx, t // plan.tx
                c0 = (s * plan.tx + tx) * plan.vec
                if c0 >= channels or ty >= ty_n:
                    continue
                for r in range(begin + ty, end, ty_n):
                    count[r, c0:c0 + plan.vec] += 1
                    if plan.vec > 1:
                        starts.append(r * channels + c0)
    return count, starts


@pytest.mark.parametrize("rows,channels,vec", [
    (1, 1, 1), (1, 7, 1), (5, 3, 1), (33, 42, 1), (300, 40, 8),
    (2000, 64, 8), (64, 2304, 8), (17, 520, 8)])
def test_box_model_reads_every_element_once(rows, channels, vec):
    plan = bnk.plan_batchnorm(rows, channels, vec, H100_SMS)
    count, starts = _box_model(plan, rows, channels)
    assert (count == 1).all()
    # bf16: an 8-channel vector is 16 bytes from a 16-byte aligned base
    assert all(start * 2 % 16 == 0 for start in starts)


# the eager path as it stood before the kernels, verbatim: the CPU route
# must stay this bit for bit
def _eager_scale_bias(bn, x):
    from embeddingnet_tpu_torch.ops import batchnorm_context
    acc = torch.promote_types(x.dtype, torch.float32)
    if bn.training:
        xf = x.to(acc)
        ctx = batchnorm_context.current()
        mean = xf.mean((0, 2, 3))
        ex2 = xf.square().mean((0, 2, 3))
        var = (ex2 - mean.square()).clamp_min(0)
        if not ctx.recomputing:
            with torch.no_grad():
                bn.running_mean.lerp_(mean.to(bn.running_mean.dtype),
                                      bn.momentum)
                bn.running_var.lerp_(var.to(bn.running_var.dtype),
                                     bn.momentum)
                bn.num_batches_tracked += 1
    else:
        mean, var = bn.running_mean, bn.running_var
    scale = torch.rsqrt(var.to(acc) + bn.eps) * bn.weight.to(acc)
    bias = bn.bias.to(acc) - mean.to(acc) * scale
    return scale, bias


def _eager_batch_norm(bn, x, compute_dtype):
    scale, bias = _eager_scale_bias(bn, x)
    y = (x.to(scale.dtype) * scale[:, None, None] + bias[:, None, None])
    return y.to(compute_dtype or scale.dtype)


def _module(kind, c, dtype):
    bn = (resnet.BatchNorm(c, eps=1e-3, momentum=0.9, compute_dtype=dtype)
          if kind == "BatchNorm" else fc.BNScaleBias(c, momentum=0.9))
    g = torch.Generator().manual_seed(c)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
        bn.running_mean.normal_(generator=g)
        bn.running_var.uniform_(0.5, 2.0, generator=g)
    return bn


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("kind", ["BatchNorm", "BNScaleBias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_is_the_eager_path_bit_for_bit(kind, dtype, training):
    """The module's forward (the wrapper's CPU route), the running
    averages and the input and parameter gradients equal the eager path
    as it stood, with tolerance 0."""
    import copy
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(4, 24, 5, 5, generator=g) * 2 + 1).to(dtype).contiguous(
        memory_format=torch.channels_last)
    a = _module(kind, 24, dtype if kind == "BatchNorm" else None)
    a.train(training)
    b = copy.deepcopy(a)
    results = []
    for bn, fn in ((a, None), (b, "eager")):
        xr = x.detach().clone().requires_grad_()
        if fn is None:
            out = bn(xr)
        elif kind == "BatchNorm":
            out = _eager_batch_norm(bn, xr, bn.compute_dtype)
        else:
            out = _eager_scale_bias(bn, xr)
        outs = out if isinstance(out, tuple) else (out,)
        cot = torch.Generator().manual_seed(2)
        sum((o.float() * torch.randn(o.shape, generator=cot)).sum()
            for o in outs).backward()
        results.append([o.detach() for o in outs] + [
            xr.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var, bn.num_batches_tracked])
    for got, want in zip(*results):
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_float64_takes_the_plain_version():
    """On the CPU a float64 module (the card-vs-CPU checks' precision) runs
    the plain version: BatchNorm's output stays float64, as the eager
    path's. (On the card the kernels' float64 instances run it.)"""
    bn = _module("BatchNorm", 8, None).double()
    x = torch.randn(2, 8, 3, 3, dtype=torch.float64)
    y = bn(x)
    assert y.dtype == torch.float64
    assert torch.equal(y, _eager_batch_norm(_module("BatchNorm", 8, None)
                                            .double(), x, None))


def test_geometry_and_vector_width():
    """channels_last -> a [rows, C] matrix; contiguous NCHW -> taken through
    its strides (nchw 1, one channel a thread); a tensor that is both (a
    size-1 dimension) -> channels_last; any other layout, or not 4-D,
    raises. Vectors only on channels_last bf16 or f32 with C a multiple of
    8 and every base 16-byte aligned; float64 one channel a thread."""
    x = torch.zeros(2, 16, 3, 5).contiguous(memory_format=torch.channels_last)
    assert bnk.geometry(x) == bnk.Geometry(30, 15, 16, 0)
    assert bnk.vector_width(bnk.geometry(x), x) == bnk.VECTOR
    nchw = torch.zeros(2, 16, 3, 5)
    assert bnk.geometry(nchw) == bnk.Geometry(30, 15, 16, 1)
    assert bnk.vector_width(bnk.geometry(nchw), nchw) == 1
    assert bnk.geometry(torch.zeros(2, 16, 1, 1)).nchw == 0
    odd = torch.zeros(2, 12, 3, 5).contiguous(
        memory_format=torch.channels_last)
    assert bnk.vector_width(bnk.geometry(odd), odd) == 1
    flat = torch.zeros(2 * 16 * 15 + 1)
    shifted = flat[1:].view(2, 3, 5, 16).permute(0, 3, 1, 2)
    assert bnk.geometry(shifted).nchw == 0
    assert bnk.vector_width(bnk.geometry(shifted), x, shifted) == 1
    assert bnk.vector_width(bnk.geometry(x), x.double()) == 1
    for bad in (x[:, :, ::2], x.permute(0, 1, 3, 2), torch.zeros(4, 16),
                nchw[..., 1:]):
        with pytest.raises(ValueError):
            bnk.geometry(bad)


@pytest.mark.parametrize("name,size", [
    ("resnet18", 32), ("seresnext50", 32), ("efficientnet-b0", 32),
    ("mobilenet", 32), ("mobilenetv2", 32), ("simple2", 32),
    ("densenet121", 32), ("xception", 71), ("inceptionv3", 75),
    ("nasnetmobile", 32)])
def test_every_family_feeds_a_layout_the_kernels_take(name, size):
    """Each CNN family's BatchNorms, in train mode on a channels_last batch
    as the registry makes it, get tensors the wrapper takes; every layer of
    the families whose widths are multiples of 8 gets the 16-byte vectors
    at its base."""
    module = EmbeddingModule(name, encodings_len=16, classifier=False,
                             input_shape=(size, size, 3))
    seen = _bn_inputs(module, torch.rand(2, size, size, 3))
    assert seen
    for mod, x in seen:
        geo = bnk.geometry(x)
        assert geo.nchw == 0 or x.is_contiguous(), (name, type(mod), x.shape)


def test_nasnet_feeds_contiguous_nchw():
    """The caller of the kernels' strided NCHW path: NASNet-Mobile at 32 px
    feeds its stem_2 cell's adjust BatchNorm and the six separable-conv
    BatchNorms of its reduction branches contiguous NCHW tensors (H, W > 1,
    so not channels_last too), which the kernels take through their
    strides rather than through a channels_last copy."""
    module = EmbeddingModule("nasnetmobile", encodings_len=16,
                             classifier=False, input_shape=(32, 32, 3))
    names = {mod: n for n, mod in module.named_modules()}
    nchw = [names[mod] for mod, x in _bn_inputs(
        module, torch.rand(2, 32, 32, 3)) if bnk.geometry(x).nchw]
    assert len(nchw) == 7
    assert all(n.endswith("stem_2") for n in nchw), nchw
    assert any("adjust_bn" in n for n in nchw), nchw


def test_a_traced_card_tensor_takes_the_plain_version(monkeypatch):
    """``torch.export`` traces on fake tensors, which hold no memory to
    launch on: a fake CUDA tensor (``EmbeddingNet.save_exported`` traces
    one on the card) takes the plain version, whose ops the traced program
    then holds, and never reaches the kernels."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = []
    monkeypatch.setattr(bnk, "plain_batch_norm",
                        lambda bn, x, dtype: calls.append("batch_norm"))
    monkeypatch.setattr(bnk, "plain_scale_bias",
                        lambda bn, x: calls.append("scale_bias"))
    monkeypatch.setattr(bnk, "_kernels", lambda *args: pytest.fail(
        "a traced tensor reached the kernels"))
    with FakeTensorMode():
        x = torch.empty(2, 8, 3, 3, device="cuda")
        assert x.device.type == "cuda"
        bnk.batch_norm(None, x, torch.bfloat16)
        bnk.scale_bias(None, x)
    assert calls == ["batch_norm", "scale_bias"]
