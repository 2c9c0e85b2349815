"""LayerNorm's CPU side (``embeddingnet_tpu_torch/ops/layernorm.py``):

- ``plain_layer_norm`` is the ViT's LayerNorm as it was written before the
  kernels (``F.layer_norm`` on an f32 copy, cast back), bit for bit;
- the kernels' arithmetic in plain PyTorch (``plain_forward``,
  ``plain_backward``) against ``F.layer_norm`` and its autograd in
  float64;
- a CPU, ``meta`` or traced (``FakeTensor``) input takes the plain version
  and counts ``plain``; a ViT counts one LayerNorm in
  ``vit.LAUNCHES["layernorm"]`` and one ``ln`` span a call, and again in a
  remat recompute;
- the launch plan for every D the ViTs use and at the edges, and a box
  model of the kernels' loops over it: which (row, column) each lane of
  each block holds, every value exactly once, the parameters' shared-memory
  order and the partial sums' columns;
- the checks that refuse what the kernels cannot take; no module of the
  port but this one calls ``F.layer_norm``.
The kernels themselves are checked on the card in
``tests/test_torch_port_cuda.py``."""

import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from embeddingnet_tpu_torch.models import remat, vit
from embeddingnet_tpu_torch.ops import layernorm as ln
from embeddingnet_tpu_torch.utils import trace

H100_SMS = 132
# float64 sums in another order than F.layer_norm's and autograd's
ALGEBRA_TOL = 1e-12
# every D of the ViT variants, and one that is not a multiple of 8
DIMS = [768, 1024, 100]


@pytest.fixture(autouse=True)
def _counts():
    ln.reset_launch_counts()
    yield
    ln.reset_launch_counts()


def _inputs(rows, d, dtype=torch.float64, seed=0):
    """x (rows of mean about 1), an output gradient, weight and bias."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(1.0, 1.0, size=(rows, d))).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(rows, d))).to(dtype)
    w = torch.from_numpy(rng.normal(1.0, 0.1, size=d))
    b = torch.from_numpy(rng.normal(0.0, 0.1, size=d))
    return x, dy, w, b


def _old_layer_norm(module, x):
    """The ViT's LayerNorm forward as it was written before the kernels."""
    return F.layer_norm(x.to(torch.promote_types(x.dtype, torch.float32)),
                        module.normalized_shape, module.weight, module.bias,
                        module.eps).to(x.dtype)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64], ids=str)
def test_plain_layer_norm_is_the_old_vit_layernorm(dtype, eps, d):
    x, _, w, b = _inputs(6, d, dtype)
    module = vit.LayerNorm(d, eps=eps)
    if dtype == torch.float64:
        module = module.double()
    with torch.no_grad():
        module.weight.copy_(w)
        module.bias.copy_(b)
        got = module(x.view(2, 3, d))
        want = _old_layer_norm(module, x.view(2, 3, d))
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(ln.plain_layer_norm(x, module.weight, module.bias,
                                           eps), want.view(6, d))
    assert ln.LAUNCHES == {"fwd": 0, "bwd": 0, "plain": 1}


@pytest.mark.parametrize("d", DIMS + [3, 8])
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_the_kernels_algebra_matches_autograd(eps, d):
    """``plain_forward`` gives ``F.layer_norm``, and
    ``plain_backward`` its autograd, in float64."""
    x, dy, w, b = _inputs(5, d)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], eps)
    grads = torch.autograd.grad(want, leaves, dy)
    y, mean, rstd = ln.plain_forward(x, w, b, eps)
    assert mean.shape == rstd.shape == (5,)
    torch.testing.assert_close(y, want.detach(), rtol=0, atol=ALGEBRA_TOL)
    got = ln.plain_backward(x, dy, mean, rstd, w)
    for name, g, ref in zip(("dx", "dweight", "dbias"), got, grads):
        assert g.shape == ref.shape, name
        torch.testing.assert_close(g, ref, rtol=0, atol=ALGEBRA_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
def test_a_cpu_tensor_takes_the_plain_path(dtype):
    x, _, w, b = _inputs(4, 768, dtype)
    got = ln.layer_norm(x, w.float(), b.float(), 1e-12)
    assert torch.equal(got, ln.plain_layer_norm(x, w.float(), b.float(),
                                                1e-12))
    assert ln.LAUNCHES == {"fwd": 0, "bwd": 0, "plain": 1}


def test_a_meta_tensor_takes_the_plain_path():
    x = torch.empty((2, 197, 768), device="meta", dtype=torch.bfloat16)
    w = torch.empty((768,), device="meta")
    got = ln.layer_norm(x, w, w, 1e-12)
    assert got.shape == x.shape and got.device.type == "meta"
    assert got.dtype == torch.bfloat16
    assert ln.LAUNCHES == {"fwd": 0, "bwd": 0, "plain": 1}


def test_a_traced_cuda_tensor_takes_the_plain_path():
    """A fake tensor on the card (``torch.export``'s tracing) holds no
    memory to launch on: it takes the plain version, even where the card
    is missing."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    with FakeTensorMode():
        x = torch.empty((2, 197, 768), device="cuda", dtype=torch.bfloat16)
        w = torch.empty((768,), device="cuda")
        got = ln.layer_norm(x, w, w, 1e-12)
    assert isinstance(got, FakeTensor) and got.device.type == "cuda"
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert ln.LAUNCHES == {"fwd": 0, "bwd": 0, "plain": 1}


@pytest.mark.parametrize("on", [False, True], ids=["plain", "remat"])
def test_a_vit_counts_one_layernorm_and_one_span_per_call(on):
    """Forward and backward of a two-block ViT: each LayerNorm (two a
    block, ``ln_final``) counts once in ``vit.LAUNCHES`` and in ``plain``
    and opens one ``ln`` span, and again in a remat recompute; the
    gradients equal."""
    module = vit.ViT((32, 32), dim=32, depth=2, heads=2)
    module.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(2, 3, 32, 32)).astype(np.float32))
    grads = {}
    for remat_on in (False, on):
        trace.reset()
        trace.enable()
        before = vit.LAUNCHES["layernorm"]
        ln.reset_launch_counts()
        module.zero_grad()
        try:
            with remat.rematerialize(remat_on):
                module(x).square().sum().backward()
        finally:
            trace.disable()
        calls = 9 if remat_on else 5
        assert vit.LAUNCHES["layernorm"] - before == calls
        assert ln.LAUNCHES == {"fwd": 0, "bwd": 0, "plain": calls}
        assert trace.totals()["ln"][0] == calls
        grads[remat_on] = [p.grad.clone() for p in module.parameters()]
        trace.reset()
    for a, b in zip(grads[False], grads[on]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# -- the plan and a box model of the kernels' loops --------------------------


@pytest.mark.parametrize("d,dtype,aligned,want", [
    (768, torch.bfloat16, True, (8, 32, 3)),     # ViT-B: 3 chunks a lane
    (1024, torch.bfloat16, True, (8, 32, 4)),    # ViT-L: 4
    (768, torch.float16, True, (8, 32, 3)),
    (776, torch.bfloat16, True, (8, 32, 4)),
    (768, torch.float32, True, (1, 32, 32)),     # one value an access
    (1024, torch.float64, True, (1, 32, 32)),
    (100, torch.bfloat16, True, (1, 32, 32)),    # not a multiple of 8
    (768, torch.bfloat16, False, (1, 32, 32)),   # rows off 16 bytes
    (64, torch.bfloat16, True, (8, 8, 3)),       # 8 chunks: 8 lanes
    (8, torch.bfloat16, True, (8, 1, 3)),
    (12, torch.float32, True, (1, 16, 32)),
    (1, torch.float32, True, (1, 1, 32)),
])
def test_the_plan_shape(d, dtype, aligned, want):
    assert ln.plan_shape(d, dtype, aligned) == want


@pytest.mark.parametrize("d,dtype,aligned", [
    (1025, torch.bfloat16, True), (1032, torch.bfloat16, True),
    (1032, torch.float16, False), (2048, torch.float32, True)])
def test_the_plan_refuses_rows_too_long(d, dtype, aligned):
    with pytest.raises(ValueError, match="hold up to"):
        ln.plan_shape(d, dtype, aligned)


@pytest.mark.parametrize("rows,blocks_per_sm", [
    (256 * 197, 8), (256 * 197, 2), (8 * 197, 4), (1, 8), (131, 1),
    (133, 1), (10_000_019, 3)])
def test_the_plan_covers_the_rows(rows, blocks_per_sm):
    """Blocks of contiguous rows, as many as the card holds at once where
    there are enough rows, each holding at least one row."""
    plan = ln.plan_layernorm(rows, ln.plan_shape(768, torch.bfloat16, True),
                             H100_SMS, blocks_per_sm)
    assert plan.blocks <= H100_SMS * blocks_per_sm
    assert plan.blocks * plan.rows_per_block >= rows
    assert (plan.blocks - 1) * plan.rows_per_block < rows
    if rows >= H100_SMS * blocks_per_sm:
        assert plan.blocks > (H100_SMS * blocks_per_sm) // 2


def _box_model(rows, d, plan):
    """Which (row, column) each value a lane holds comes from, following
    the kernels' loops (block, row walk, slot, chunk, value), as arrays;
    the shared-memory index of each column's parameters (``j * nc + c``)
    and the column the block's partial row writes it to."""
    nc = d // plan.vec
    slots = ln.THREADS // plan.lanes
    row_of, col_of, smem_of = [], [], []
    for block in range(plan.blocks):
        begin = block * plan.rows_per_block
        end = min(begin + plan.rows_per_block, rows)
        for base in range(begin, end, slots):
            for slot in range(slots):
                row = base + slot
                if row >= end:
                    continue
                for lane in range(plan.lanes):
                    for k in range(plan.chunks):
                        c = lane + k * plan.lanes
                        if c >= nc:
                            continue
                        for j in range(plan.vec):
                            row_of.append(row)
                            col_of.append(c * plan.vec + j)
                            smem_of.append(j * nc + c)
    smem = np.array(smem_of)
    # the partial row's column of shared-memory index r (the block's
    # in-order sum: r % nc * vec + r / nc)
    partial_col = smem % nc * plan.vec + smem // nc
    return np.array(row_of), np.array(col_of), smem, partial_col


@pytest.mark.parametrize("rows,d,dtype,aligned", [
    (37, 768, torch.bfloat16, True), (37, 1024, torch.bfloat16, True),
    (21, 100, torch.bfloat16, True), (19, 768, torch.float32, True),
    (9, 1024, torch.float64, True), (70, 64, torch.bfloat16, True),
    (11, 1000, torch.bfloat16, True), (5, 1024, torch.float32, True),
    (300, 8, torch.float16, True), (17, 768, torch.bfloat16, False),
    (600, 3, torch.float32, True)])
def test_the_box_model_holds_every_value_once(rows, d, dtype, aligned):
    """Every (row, column) is held by exactly one lane once; a lane's
    chunks are whole accesses of ``vec`` values (16 bytes, or one); the
    interleaved parameter index is a permutation of the columns, and the
    partial sums go back to the column they came from."""
    plan = ln.plan_layernorm(rows, ln.plan_shape(d, dtype, aligned), 4, 2)
    row, col, smem, partial_col = _box_model(rows, d, plan)
    flat = row * d + col
    assert len(flat) == rows * d
    assert np.array_equal(np.sort(flat), np.arange(rows * d))
    assert np.array_equal(partial_col, col)
    per_column = {}
    for c, s in zip(col, smem):
        assert per_column.setdefault(c, s) == s
    assert sorted(per_column.values()) == list(range(d))
    if plan.vec > 1:
        assert np.all(col.reshape(-1, plan.vec)[:, 0] % plan.vec == 0)
        assert np.all(np.diff(col.reshape(-1, plan.vec), axis=1) == 1)
        assert plan.vec * dtype.itemsize == ln.CHUNK_BYTES


# -- what the kernels take ---------------------------------------------------


@pytest.mark.parametrize("case,want", [
    ("contiguous", 768), ("one row", 768), ("2-D slice", 776),
    ("3-D slice", 800), ("transposed", None), ("column stride", None),
    ("leading size-1", 768), ("expanded", None)])
def test_the_row_stride(case, want):
    x = torch.empty((4, 5, 768), dtype=torch.bfloat16)
    t = {"contiguous": x, "one row": x[:1, :1],
         "2-D slice": torch.empty((6, 776))[:, :768],
         "3-D slice": torch.empty((4, 5, 800))[..., :768],
         "transposed": x.transpose(0, 1),
         "column stride": torch.empty((4, 5, 1536))[..., ::2],
         "leading size-1": torch.empty((1, 5, 768)),
         "expanded": torch.empty(768).expand(4, 5, 768)}[case]
    assert ln._row_stride(t) == want


def _refused(x, w, b):
    with pytest.raises(ValueError) as err:
        ln._check(x, w, b)
    return str(err.value)


@pytest.mark.parametrize("case,match", [
    ("int8", "bfloat16, float16"), ("column stride", "strides"),
    ("transposed", "strides"), ("no rows", "no rows"),
    ("device", "weight must be"), ("weight shape", "weight must be"),
    ("bias missing", "bias must be")])
def test_the_checks_refuse_what_the_kernels_cannot_take(case, match):
    x, _, w, b = _inputs(10, 768, torch.bfloat16)
    w, b = w.float(), b.float()
    if case == "int8":
        x = x.to(torch.int8)
    elif case == "column stride":
        x = torch.cat([x, x], dim=-1)[:, ::2]
    elif case == "transposed":
        x = x.view(2, 5, 768).transpose(0, 1)
    elif case == "no rows":
        x = x[:0]
    elif case == "device":
        w = w.to("meta")
    elif case == "weight shape":
        w = w[:100]
    elif case == "bias missing":
        b = None
    assert match in _refused(x, w, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.float64], ids=str)
def test_the_checks_pass_what_the_kernels_take(dtype):
    x = torch.empty((3, 197, 800), dtype=dtype)[..., :768]
    w = torch.empty(768)
    assert ln._check(x, w, w) == 800
    assert ln._check(x[0, 0], w, w) == 768


def test_the_port_calls_no_library_layer_norm_elsewhere():
    """The card's LayerNorm is the port's own kernel: no module of the
    package but ``ops/layernorm.py`` (its plain version) calls a library's
    layer norm, and none calls ``torch.compile``."""
    call = re.compile(r"\b(F|functional|torch)\.(native_)?layer_norm\(")
    root = pathlib.Path(ln.__file__).resolve().parent.parent
    hits = [str(p.relative_to(root)) for p in sorted(root.rglob("*.py"))
            if call.search(p.read_text())]
    assert hits == ["ops/layernorm.py"]
    assert not any("torch.compile(" in p.read_text()
                   for p in root.rglob("*.py"))
