"""The addressing of ``csrc/conv3x3_sm90.cu`` (K1 forward and dgrad, K2, and
K3 and K4, which add the BN-ReLU prologue), checked without a card through
the plan that its wrapper uses
(``embeddingnet_tpu_torch.ops.fused_conv.plan_sm90``).

* Coverage: every output row and dW entry is owned by exactly one block,
  K2's parts cover the positions exactly, and at B=1,024 the grid fills the
  H100's 132 SMs.
* A model of the kernels' TMA box loads: each box is cut from the tensor by
  the plan's coordinates, with zeros for every coordinate outside the
  tensor (negative ones included), as TMA fills them; the sum of the tile
  products equals the plain version (and the JAX package's XLA reference)
  for the forward, for the dgrad from the unflipped weight, and for K2.
  f32, small widths; the sums are taken in another order than the plain
  versions', so to 1e-4.
* The prologue of K3 and K4 in that model: each landed box laid out as
  TMA's 128-byte swizzle writes it into the ring stage, each consumer
  thread's vectors rewritten in place with the scales and biases of the
  channel group the swizzle map gives, on the rows the plan calls real
  only. In bf16 the rewritten stage equals the box of the zero-padded
  plain ``_affine_relu`` bit for bit; in f32 the products equal the plain
  versions, the JAX package's XLA references and its Pallas kernels in
  interpret mode. A negative control (the affine on every row) fails.
* T1's epilogue in that model: the accumulator fragment of
  ``Sm90Plan.accumulator_entry`` covers each entry of a tile once, and the
  affine and ReLU applied in that layout (f32, the product and the sum
  rounded apart) to the forward's tile sums equal the port's plain
  ``_plain_conv3x3_affine_relu`` (to 1e-4) and, rounded to bf16, the JAX
  tool that T1 ports (``tools/pallas_fused_conv.py``: its Pallas kernel in
  interpret mode at S=2, C=512, the one shape it takes, and its XLA
  function at S=4, C=256) to one bf16 ulp.
"""

import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.ops import fused_conv as jfc  # noqa: E402
from embeddingnet_tpu_torch.ops import fused_conv as tfc  # noqa: E402

from _torch_port import (JAX_T1_BATCH, assert_within_one_bf16_ulp,  # noqa
                         jax_t1_tool, t1_inputs)

TOL = dict(rtol=1e-4, atol=1e-4)
SMS = 132
TRAINING = [(8, 128), (4, 256), (2, 512)]
KINDS = ["fprop", "dgrad", "wgrad"]


def _box(t, origin, box):
    """The TMA box of ``t`` at ``origin``, both innermost first: ``t``'s
    last axis is the first coordinate. Elements outside ``t`` are zero."""
    rank = t.ndim
    out = np.zeros(tuple(reversed(box)), t.dtype)
    src, dst = [], []
    for axis in range(rank):
        lo, n, size = origin[axis], box[axis], t.shape[rank - 1 - axis]
        a, b = max(lo, 0), min(lo + n, size)
        if a >= b:
            return out
        src.append(slice(a, b))
        dst.append(slice(a - lo, b - lo))
    out[tuple(reversed(dst))] = t[tuple(reversed(src))]
    return out


def _tma_swizzle(stage):
    """``stage`` [rows, 64] as TMA's 128-byte swizzle writes it into a
    1024-byte aligned buffer: [rows, 8 physical 16-byte chunks, 8]; the
    16-byte chunk j of the row at byte address a lands at chunk
    j ^ ((a >> 7) & 7)."""
    rows = stage.shape[0]
    r = np.arange(rows)[:, None]
    phys = np.empty((rows, 8, 8), stage.dtype)
    phys[r, np.arange(8)[None, :] ^ ((r * 128 >> 7) & 7)] = \
        stage.reshape(rows, 8, 8)
    return phys


def _tma_unswizzle(phys):
    rows = phys.shape[0]
    r = np.arange(rows)[:, None]
    return phys[r, np.arange(8)[None, :] ^ ((r * 128 >> 7) & 7)].reshape(
        rows, 64)


@functools.lru_cache(maxsize=None)
def _prologue_index(plan):
    """(rows, physical chunks) of every consumer thread's vectors."""
    vectors = [v for thread in range(256)
               for v in plan.prologue_vectors(thread)]
    return tuple(np.array(a) for a in zip(*vectors))


def _bf16_round(z):
    """float32 -> the bits of bf16, rounded to nearest even (finite z)."""
    bits = z.view(np.uint32)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def _prologue(plan, stage, channel0, real, scale, bias):
    """The kernel's prologue on a landed ring stage [rows, 64] (float32, or
    uint16 holding bf16): swizzled as TMA lays it, every thread's vectors
    on a real row rewritten in place, z = relu(x*scale + bias) (product and
    sum rounded apart in f32, then one round to the stage's type) with the
    channels ``channel0[row] + 8 * sm90_swizzle_group(row, chunk) + 0..7``;
    read back unswizzled."""
    rows, chunks = _prologue_index(plan)
    phys = _tma_swizzle(stage)
    keep = real[rows]
    rows, chunks = rows[keep], chunks[keep]
    channels = (channel0[rows] + 8 * tfc.sm90_swizzle_group(rows, chunks)
                )[:, None] + np.arange(8)
    vec = phys[rows, chunks]
    if stage.dtype == np.uint16:
        vec = (vec.astype(np.uint32) << 16).view(np.float32)
    z = np.maximum(vec * scale[channels] + bias[channels], np.float32(0))
    phys[rows, chunks] = _bf16_round(z) if stage.dtype == np.uint16 else z
    return _tma_unswizzle(phys)


def _fragment_indices(plan):
    """thread, u, h, j and e of every accumulator of the 256 consumer
    threads, flat."""
    grid = np.meshgrid(np.arange(256), np.arange(plan.rows // 128),
                       np.arange(2), np.arange(16), np.arange(2),
                       indexing="ij")
    return [a.ravel() for a in grid]


def _epilogue(plan, acc, n0, scale, bias):
    """T1's epilogue on a tile's accumulators [rows, 128] (output channels
    n0 ..) as the kernel runs it: thread t's ``acc[u][4j + 2h + e]`` (its
    place in the tile from ``plan.accumulator_entry``) becomes
    relu(acc*scale + bias) with the scale and bias the kernel reads for it,
    channel n0 + 2*(lane%4) + 8j + e, the product and the sum rounded apart
    in f32; an entry no thread holds stays NaN."""
    thread, u, h, j, e = _fragment_indices(plan)
    rows, cols = plan.accumulator_entry(thread, u, h, j, e)
    channel = n0 + 2 * (thread % 32 % 4) + 8 * j + e
    out = np.full_like(acc, np.nan)
    out[rows, cols] = np.maximum(
        acc[rows, cols] * scale[channel] + bias[channel], np.float32(0))
    return out


def _conv_model(plan, act, w, affine=None, mask=True, epilogue=None):
    """The conv as its kernel computes it: per persistent block, per tile
    of the block, per tap and 64-wide K chunk, the A box times the two B
    boxes; rows past the batch dropped. ``act`` [B, S, S, K], ``w`` [3, 3,
    Cin, Cout]. With ``affine`` = (scale, bias), K3: the prologue on each A
    box, on the rows ``plan.real_rows`` calls real (all rows when ``mask``
    is off: the negative control). With ``epilogue`` = (scale, bias), T1:
    :func:`_epilogue` on each tile's sums."""
    m = plan.batch * plan.s * plan.s
    r = plan.rows
    w2d = w.reshape(-1, w.shape[3])
    out = np.full((plan.tiles[0] * r, plan.n_channels), np.nan, np.float32)
    for bx, by in (tile for block in range(plan.grid[0])
                   for tile in plan.block_tiles(block)):
        acc = np.zeros((r, 128), np.float32)
        for t, c0 in itertools.product(range(9),
                                       range(0, plan.k_channels, 64)):
            origin = plan.a_origin(bx, t, c0)
            a = _box(act, origin, plan.box).reshape(r, 64)
            if affine is not None:
                real = (plan.real_rows(origin).numpy() if mask
                        else np.ones(r, bool))
                a = _prologue(plan, a, np.full(r, c0), real, *affine)
            halves = [_box(w2d, plan.b_origin(by, t, c0, h), (64, 64))
                      for h in range(2)]
            if plan.kind == "dgrad":
                b = np.concatenate(halves, 0).T        # [64 k, 128 n]
            else:
                b = np.concatenate(halves, 1)          # [64 k, 128 n]
            acc += a @ b
        if epilogue is not None:
            acc = _epilogue(plan, acc, by * 128, *epilogue)
        assert np.isnan(out[bx * r:(bx + 1) * r,
                            by * 128:(by + 1) * 128]).all()
        out[bx * r:(bx + 1) * r, by * 128:(by + 1) * 128] = acc
    return out[:m].reshape(plan.batch, plan.s, plan.s, plan.n_channels)


def _wgrad_model(plan, x, g, affine=None, mask=True):
    """K2 as its kernel computes it: per part and dW tile, the A^T G
    products of the part's chunks; the parts' partials added in order. With
    ``affine``, K4: the prologue on each stage of two boxes (channels c0 and
    c0 + 64, 64 positions each)."""
    cin, cout = plan.k_channels, plan.n_channels
    g2d = g.reshape(-1, cout)
    parts = np.zeros((plan.parts, 9 * cin, cout), np.float32)
    for z, bx, by in itertools.product(range(plan.parts),
                                       range(plan.tiles[0]),
                                       range(plan.tiles[1])):
        t, c0 = plan.wgrad_tile(bx)
        assert c0 + 128 <= cin          # a tile never straddles a tap
        acc = np.zeros((128, 128), np.float32)
        for chunk in plan.part_chunks(z):
            origins = [plan.a_origin(bx, t, c0 + 64 * h, chunk)
                       for h in range(2)]
            a = np.concatenate([_box(x, o, plan.box).reshape(64, 64)
                                for o in origins], 0)       # the stage
            if affine is not None:
                real = (np.concatenate([plan.real_rows(o).numpy()
                                        for o in origins]) if mask
                        else np.ones(128, bool))
                a = _prologue(plan, a, c0 + 64 * (np.arange(128) // 64),
                              real, *affine)
            a = np.concatenate([a[:64], a[64:]], 1)         # [64 pos, 128]
            b = np.concatenate(
                [_box(g2d, plan.g_origin(by, chunk, h), (64, 64))
                 for h in range(2)], 1)
            acc += a.T @ b
        parts[z, bx * 128:(bx + 1) * 128, by * 128:(by + 1) * 128] = acc
    out = parts[0]
    for z in range(1, plan.parts):
        out = out + parts[z]
    return out.reshape(3, 3, cin, cout)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s,c", TRAINING)
@pytest.mark.parametrize("batch", [1, 3, 37, 1024])
def test_plan_covers_every_output_once(kind, s, c, batch):
    plan = tfc.plan_sm90(kind, batch, s, c, c)
    assert all(1 <= d <= 256 for d in plan.box)
    assert plan.box[0] * 2 == 128           # the 128-byte swizzle's span
    if kind == "wgrad":
        assert plan.images * s * s == 64
        assert plan.grid == plan.tiles + (plan.parts,)
        assert plan.tiles == (9 * c // 128, c // 128)
        covered = [i for z in range(plan.parts) for i in plan.part_chunks(z)]
        assert covered == list(range(plan.chunks))
        assert all(len(plan.part_chunks(z)) for z in range(plan.parts))
        assert plan.chunks * 64 >= batch * s * s > (plan.chunks - 1) * 64
        rows = np.zeros(9 * c, int)
        for bx in range(plan.tiles[0]):
            t, c0 = plan.wgrad_tile(bx)
            rows[t * c + c0:t * c + c0 + 128] += 1
        assert (rows == 1).all()
    else:
        assert plan.rows in (128, 256)
        assert plan.images * s * s == plan.rows
        assert plan.tiles[1] * 128 == c
        assert plan.grid == (min(plan.tiles[0] * plan.tiles[1], SMS), 1, 1)
        owned = np.zeros(plan.tiles, int)
        for block in range(plan.grid[0]):
            tiles = plan.block_tiles(block)
            assert tiles               # no block of the grid is idle
            for bx, by in tiles:
                owned[bx, by] += 1
                assert plan.a_origin(bx, 4, 0)[3] * s * s == bx * plan.rows
        assert (owned == 1).all()
        rows = plan.tiles[0] * plan.rows
        assert rows >= batch * s * s > rows - plan.rows


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s,c", TRAINING)
def test_grid_fills_the_card_at_the_training_batch(kind, s, c):
    """At B=1,024 K2's tiles times parts fill at least a wave of 132 SMs;
    the conv's persistent grid is one block per SM over 256 tiles of 256
    rows at S=8, 128 of 256 rows at S=4 and 128 of 128 rows at S=2, C=512:
    the last two are 97% of the SMs, and no split is used there."""
    plan = tfc.plan_sm90(kind, 1024, s, c, c)
    if kind == "wgrad":
        assert plan.blocks >= SMS
    else:
        tiles = plan.tiles[0] * plan.tiles[1]
        assert plan.rows == (128 if s == 2 else 256)
        assert tiles == 1024 * s * s * c // (plan.rows * 128)
        assert plan.blocks == min(tiles, SMS) >= 0.96 * SMS
        # the tiles are spread evenly: no block has two more than another
        counts = [len(plan.block_tiles(i)) for i in range(plan.blocks)]
        assert max(counts) - min(counts) <= 1


def test_wgrad_parts_at_the_training_shapes():
    """K2's rule at B=1,024: 29 parts at S=8, C=128 (261 blocks of 264 in
    two waves), 7 at S=4, C=256 (252 of 264), none at S=2, C=512, whose 144
    tiles already fill a wave and whose 9.4 MB of f32 partials would cost
    more than the second wave's tail; a tiny batch is not split."""
    assert [tfc.plan_sm90("wgrad", 1024, s, c, c).parts
            for s, c in TRAINING] == [29, 7, 1]
    assert tfc.wgrad_sm90_parts(1, 2, 128, 128) == (1, 1)


@pytest.mark.parametrize("kind", KINDS)
def test_dgrad_reverses_the_taps(kind):
    plan = tfc.plan_sm90(kind, 8, 4, 128, 256)
    want = tuple(range(8, -1, -1)) if kind == "dgrad" else tuple(range(9))
    assert plan.weight_taps == want
    # the dgrad's K is w's Cout, its N w's Cin
    assert (plan.k_channels, plan.n_channels) == (
        (256, 128) if kind == "dgrad" else (128, 256))


def _data(seed, b, s, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, s, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    g = rng.normal(size=(b, s, s, cout)).astype(np.float32)
    return x, w, g


GATHER_SHAPES = [(1, 8, 128, 128), (3, 8, 128, 128), (8, 4, 128, 128),
                 (3, 2, 128, 128), (3, 4, 128, 256), (2, 2, 256, 128)]


# sms=1 makes the plan take 256-row tiles at these small batches
@pytest.mark.parametrize("sms", [SMS, 1])
@pytest.mark.parametrize("b,s,cin,cout", GATHER_SHAPES)
def test_box_model_forward_matches_plain(b, s, cin, cout, sms):
    x, w, _ = _data(0, b, s, cin, cout)
    plan = tfc.plan_sm90("fprop", b, s, cin, cout, sms)
    assert plan.rows == (256 if sms == 1 else 128)
    got = _conv_model(plan, x, w)
    want = tfc._plain_conv3x3(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jfc._lax_conv3x3(jnp.asarray(x), jnp.asarray(w))),
        **TOL)


@pytest.mark.parametrize("sms", [SMS, 1])
@pytest.mark.parametrize("b,s,cin,cout", GATHER_SHAPES)
def test_box_model_dgrad_reads_the_unflipped_weight(b, s, cin, cout, sms):
    """The dgrad's boxes of the weight as it stands give the conv of g with
    the flipped, transposed weight, and JAX's input gradient."""
    x, w, g = _data(1, b, s, cin, cout)
    plan = tfc.plan_sm90("dgrad", b, s, cin, cout, sms)
    assert plan.rows == (256 if sms == 1 else 128)
    got = _conv_model(plan, g, w)
    wt = torch.from_numpy(w)
    want = tfc._plain_conv3x3(torch.from_numpy(g), tfc._flip(wt))
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    _, vjp = jax.vjp(lambda a: jfc._lax_conv3x3(a, jnp.asarray(w)),
                     jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]),
                               **TOL)


@pytest.mark.parametrize("b,s,cin,cout", GATHER_SHAPES)
def test_box_model_wgrad_matches_plain(b, s, cin, cout):
    x, _, g = _data(2, b, s, cin, cout)
    plan = tfc.plan_sm90("wgrad", b, s, cin, cout)
    got = _wgrad_model(plan, x, g)
    want = tfc._plain_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jfc._lax_wgrad(jnp.asarray(x), jnp.asarray(g))),
        **TOL)


def test_box_model_wgrad_split_matches_plain():
    """A batch that K2 splits into several parts (B=37 at S=8: 37 chunks
    in 19 parts of 2, the last of 1) still sums to the plain dW."""
    x, _, g = _data(3, 37, 8, 128, 128)
    plan = tfc.plan_sm90("wgrad", 37, 8, 128, 128)
    assert plan.parts > 1
    got = _wgrad_model(plan, x, g)
    want = tfc._plain_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got, want.numpy(), **TOL)


# ---------------------------------------------------------------------------
# K3 and K4: the BN-ReLU prologue on the landed A stage.
# ---------------------------------------------------------------------------

PROLOGUE_PLANS = [("fprop", SMS), ("fprop", 1), ("wgrad", SMS)]


def _affine(seed, c):
    """scale and bias with most biases positive, so relu(bias) != 0 and a
    rewritten padding ring shows."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, size=c).astype(np.float32),
            (rng.normal(size=c) + 1.0).astype(np.float32))


def _bf16_bits(t):
    return t.bfloat16().view(torch.int16).numpy().view(np.uint16)


def _stages(plan):
    """(origins, channel of each stage row) of every A stage the kernel
    loads: the conv's box per tile, tap and chunk; K2's two boxes per dW
    row tile and position chunk."""
    if plan.kind == "wgrad":
        for bx, chunk in itertools.product(range(plan.tiles[0]),
                                           range(plan.chunks)):
            t, c0 = plan.wgrad_tile(bx)
            yield ([plan.a_origin(bx, t, c0 + 64 * h, chunk)
                    for h in range(2)], c0 + 64 * (np.arange(128) // 64))
    else:
        for bx, t, c0 in itertools.product(range(plan.tiles[0]), range(9),
                                           range(0, plan.k_channels, 64)):
            yield [plan.a_origin(bx, t, c0)], np.full(plan.rows, c0)


@pytest.mark.parametrize("kind,sms", PROLOGUE_PLANS)
def test_prologue_vectors_cover_each_stage_once(kind, sms):
    """The 256 consumer threads rewrite every 16-byte vector of a stage
    exactly once, each warpgroup within its own half (the rows that only it
    reads), and all the vectors of one thread hold the same channel group,
    so a thread needs 8 scales and biases per chunk."""
    plan = tfc.plan_sm90(kind, 1024, 4, 128, 128, sms)
    assert plan.rows == (256 if sms == 1 else 128)
    seen = np.zeros((plan.rows, 8), int)
    for thread in range(256):
        vectors = plan.prologue_vectors(thread)
        assert len(vectors) == plan.rows // 32
        half = thread // 128 * plan.rows // 2
        groups = set()
        for row, chunk in vectors:
            assert half <= row < half + plan.rows // 2
            seen[row, chunk] += 1
            groups.add(tfc.sm90_swizzle_group(row, chunk))
        assert len(groups) == 1
    assert (seen == 1).all()


def test_swizzle_group_is_a_bijection_on_every_atom():
    """On every 1024-byte atom (8 rows of 128 bytes) the map (row, physical
    chunk) -> (row, channel group) is a bijection, and it is the one TMA's
    128-byte swizzle writes (modelled from the byte addresses)."""
    rows = 256
    stage = np.repeat(np.arange(8, dtype=np.float32), 8)[None, :].repeat(
        rows, 0)                       # each element holds its group
    phys = _tma_swizzle(stage)
    r, p = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    groups = tfc.sm90_swizzle_group(r, p)
    assert (phys[..., 0] == groups).all()
    for atom in range(rows // 8):
        pairs = {(int(a), int(g)) for a, g in
                 zip(r[8 * atom:8 * atom + 8].ravel(),
                     groups[8 * atom:8 * atom + 8].ravel())}
        assert len(pairs) == 64
        assert all(sorted(groups[i]) == list(range(8))
                   for i in range(8 * atom, 8 * atom + 8))


@pytest.mark.parametrize("kind,sms", PROLOGUE_PLANS)
@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("batch", [1, 3, 37])
def test_prologue_stage_is_the_padded_z(kind, sms, s, batch):
    """In bf16 every rewritten stage equals the box of z =
    ``_affine_relu(x)`` with zeros off the tensor, bit for bit: the mask
    keeps the padding ring and the rows past the batch at zero, the swizzle
    map picks each vector's channels, and the rounding is the plain
    version's."""
    c = 256
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(batch, s, s, c)).astype(
        np.float32)).bfloat16()
    scale, bias = _affine(5, c)
    z = tfc._affine_relu(x, torch.from_numpy(scale), torch.from_numpy(bias))
    xb, zb = _bf16_bits(x), _bf16_bits(z)
    plan = tfc.plan_sm90(kind, batch, s, c, c, sms)
    stages = 0
    for origins, channel0 in _stages(plan):
        land = np.concatenate([_box(xb, o, plan.box).reshape(-1, 64)
                               for o in origins])
        want = np.concatenate([_box(zb, o, plan.box).reshape(-1, 64)
                               for o in origins])
        real = np.concatenate([plan.real_rows(o).numpy() for o in origins])
        got = _prologue(plan, land, channel0, real, scale, bias)
        np.testing.assert_array_equal(got, want)
        stages += 1
    assert stages > 0


def _bn_data(seed, b, s, cin, cout):
    x, w, g = _data(seed, b, s, cin, cout)
    scale, bias = _affine(seed + 100, cin)
    return x, w, g, scale, bias


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


BN_SHAPES = ([(b, s, 128, 128) for b in (1, 3, 37, 1024) for s in (2, 4)]
             + [(3, 4, 128, 256), (2, 2, 256, 128)])


@pytest.mark.parametrize("sms", [SMS, 1])
@pytest.mark.parametrize("b,s,cin,cout", BN_SHAPES)
def test_box_model_bn_forward_matches_plain(b, s, cin, cout, sms):
    """K3: the boxes with the prologue times the weight boxes equal
    ``conv3x3(_affine_relu(x), w)`` of the port and of the JAX package."""
    x, w, _, scale, bias = _bn_data(6, b, s, cin, cout)
    plan = tfc.plan_sm90("fprop", b, s, cin, cout, sms)
    got = _conv_model(plan, x, w, (scale, bias))
    xt, wt, st, bt = _t(x, w, scale, bias)
    want = tfc._plain_conv3x3(tfc._affine_relu(xt, st, bt), wt)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    xj, wj, sj, bj = _j(x, w, scale, bias)
    np.testing.assert_allclose(
        got, np.asarray(jfc._lax_conv3x3(jfc._affine_relu(xj, sj, bj), wj)),
        **TOL)


def _assert_wgrad_close(got, want):
    """dW sums up to B*S*S = 16,384 f32 products in another order than the
    plain version: to 1e-4 relative plus 1e-5 of the largest entry (the
    sums' rounding grows with their length; 1e-4 alone fails entries near
    zero at B=1,024)."""
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("b,s,cin,cout", BN_SHAPES)
def test_box_model_bn_wgrad_matches_plain(b, s, cin, cout):
    """K4: the prologue on each stage of K2's boxes gives the weight
    gradient of ``conv3x3(_affine_relu(x), w)``, of the port and of the
    JAX package."""
    x, _, g, scale, bias = _bn_data(7, b, s, cin, cout)
    plan = tfc.plan_sm90("wgrad", b, s, cin, cout)
    got = _wgrad_model(plan, x, g, (scale, bias))
    xt, gt, st, bt = _t(x, g, scale, bias)
    _assert_wgrad_close(got, tfc._plain_wgrad_bn_relu(xt, gt, st, bt).numpy())
    xj, gj, sj, bj = _j(x, g, scale, bias)
    _assert_wgrad_close(
        got, np.asarray(jfc._lax_wgrad(jfc._affine_relu(xj, sj, bj), gj)))


@pytest.mark.parametrize("s", [2, 4])
def test_box_model_bn_matches_pallas_interpret(s):
    """K3 and K4 in the box model against the TPU kernels themselves,
    ``_fwd_bn_kernel`` and ``_wgrad_bn_kernel`` in Pallas interpret mode."""
    x, w, g, scale, bias = _bn_data(8, 8, s, 128, 128)
    xj, wj, gj, sj, bj = _j(x, w, g, scale, bias)
    got = _conv_model(tfc.plan_sm90("fprop", 8, s, 128, 128), x, w,
                      (scale, bias))
    np.testing.assert_allclose(
        got, np.asarray(jfc._conv_bn_fwd_impl(xj, wj, sj, bj)), **TOL)
    got = _wgrad_model(tfc.plan_sm90("wgrad", 8, s, 128, 128), x, g,
                       (scale, bias))
    np.testing.assert_allclose(
        got, np.asarray(jfc._wgrad_bn_impl(xj, gj, sj, bj)), **TOL)


@pytest.mark.parametrize("kind", ["fprop", "wgrad"])
def test_box_model_without_the_mask_differs(kind):
    """Negative control: the affine on every row of the zero-filled boxes
    (relu(bias) > 0 on the padding ring) gives another answer, so the
    tests above see the ring."""
    x, w, g, scale, bias = _bn_data(9, 3, 4, 128, 128)
    assert (bias > 0).mean() > 0.5
    plan = tfc.plan_sm90(kind, 3, 4, 128, 128)
    xt, wt, gt, st, bt = _t(x, w, g, scale, bias)
    if kind == "wgrad":
        got = _wgrad_model(plan, x, g, (scale, bias), mask=False)
        want = tfc._plain_wgrad_bn_relu(xt, gt, st, bt).numpy()
    else:
        got = _conv_model(plan, x, w, (scale, bias), mask=False)
        want = tfc._plain_conv3x3(tfc._affine_relu(xt, st, bt), wt).numpy()
    assert np.abs(got - want).max() > 0.1
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# T1: the affine-ReLU epilogue on the forward's accumulators.
# ---------------------------------------------------------------------------

T1_SHAPES = [(2, 512), (4, 256)]


@pytest.mark.parametrize("sms", [SMS, 1])
def test_accumulator_fragment_covers_each_tile_entry_once(sms):
    """The 256 consumer threads' accumulators cover a 128- and a 256-row
    tile exactly once; a thread holds 2 adjacent columns of each 8, in the
    rows of its warpgroup's half."""
    plan = tfc.plan_sm90("fprop", 1024, 2, 512, 512, sms)
    assert plan.rows == (256 if sms == 1 else 128)
    rows, cols = plan.accumulator_entry(*_fragment_indices(plan))
    seen = np.zeros((plan.rows, 128), int)
    np.add.at(seen, (rows, cols), 1)
    assert (seen == 1).all()
    per_thread = 64 * plan.rows // 128
    rows = rows.reshape(256, per_thread)
    cols = cols.reshape(256, per_thread)
    for thread in (0, 37, 128, 255):
        half = thread // 128 * plan.rows // 2
        assert ((half <= rows[thread]) & (rows[thread] < half + plan.rows
                                          // 2)).all()
        assert sorted(set(cols[thread] % 8)) == [2 * (thread % 4),
                                                 2 * (thread % 4) + 1]


@pytest.fixture(scope="module")
def jtool():
    """``tools/pallas_fused_conv.py`` with FC_INTERPRET=1, FC_BATCH=128."""
    with jax_t1_tool() as tool:
        yield tool


@functools.lru_cache(maxsize=None)
def _jax_t1(jtool, s, c):
    """(inputs, the JAX tool's bf16 output) at B=128: its Pallas kernel in
    interpret mode where it takes the shape (S=2, C=512), else its XLA
    function."""
    x, w, scale, bias = t1_inputs(JAX_T1_BATCH, s, c, seed=s)
    fn = (jtool.fused_conv_bn_relu if (s, c) == (jtool.S, jtool.C)
          else jtool.xla_conv_bn_relu)
    want = fn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
              jnp.asarray(scale[None]), jnp.asarray(bias[None]))
    return (x, w, scale, bias), np.asarray(want, np.float32)


@pytest.mark.parametrize("sms", [SMS, 1])
@pytest.mark.parametrize("s,c", T1_SHAPES)
def test_box_model_epilogue_matches_plain_and_jax(jtool, s, c, sms):
    """T1 in the box model (128-row tiles, and 256-row ones with sms=1)
    against the port's plain version in f32 and the JAX tool in bf16."""
    (x, w, scale, bias), want = _jax_t1(jtool, s, c)
    plan = tfc.plan_sm90("fprop", JAX_T1_BATCH, s, c, c, sms)
    assert plan.rows == (256 if sms == 1 else 128)
    got = _conv_model(plan, x, w, epilogue=(scale, bias))
    plain = tfc._plain_conv3x3_affine_relu(*_t(x, w, scale, bias))
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    assert (got > 0).mean() > 0.3          # the ReLU leaves work to compare
    bf16 = torch.from_numpy(got).bfloat16().float().numpy()
    assert_within_one_bf16_ulp(bf16, want)
