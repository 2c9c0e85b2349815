"""The addressing of ``csrc/conv3x3_sm90.cu`` (K1 forward and dgrad, K2),
checked without a card through the plan that its wrapper uses
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
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.ops import fused_conv as jfc  # noqa: E402
from embeddingnet_tpu_torch.ops import fused_conv as tfc  # noqa: E402

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


def _conv_model(plan, act, w):
    """The conv as its kernel computes it: per persistent block, per tile
    of the block, per tap and 64-wide K chunk, the A box times the two B
    boxes; rows past the batch dropped. ``act`` [B, S, S, K], ``w`` [3, 3,
    Cin, Cout]."""
    m = plan.batch * plan.s * plan.s
    r = plan.rows
    w2d = w.reshape(-1, w.shape[3])
    out = np.full((plan.tiles[0] * r, plan.n_channels), np.nan, np.float32)
    for bx, by in (tile for block in range(plan.grid[0])
                   for tile in plan.block_tiles(block)):
        acc = np.zeros((r, 128), np.float32)
        for t, c0 in itertools.product(range(9),
                                       range(0, plan.k_channels, 64)):
            a = _box(act, plan.a_origin(bx, t, c0), plan.box).reshape(r, 64)
            halves = [_box(w2d, plan.b_origin(by, t, c0, h), (64, 64))
                      for h in range(2)]
            if plan.kind == "dgrad":
                b = np.concatenate(halves, 0).T        # [64 k, 128 n]
            else:
                b = np.concatenate(halves, 1)          # [64 k, 128 n]
            acc += a @ b
        assert np.isnan(out[bx * r:(bx + 1) * r,
                            by * 128:(by + 1) * 128]).all()
        out[bx * r:(bx + 1) * r, by * 128:(by + 1) * 128] = acc
    return out[:m].reshape(plan.batch, plan.s, plan.s, plan.n_channels)


def _wgrad_model(plan, x, g):
    """K2 as its kernel computes it: per part and dW tile, the A^T G
    products of the part's chunks; the parts' partials added in order."""
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
            a = np.concatenate(
                [_box(x, plan.a_origin(bx, t, c0 + 64 * h, chunk),
                      plan.box).reshape(64, 64) for h in range(2)], 1)
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
