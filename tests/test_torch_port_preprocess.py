"""T2, the u8 -> bf16 normalisation (``embeddingnet_tpu_torch/ops/
preprocess.py``, kernel ``csrc/normalize_u8_sm90.cu``), on the CPU.

- Against its Pallas twin: ``kern`` of ``tools/perf_probe3.py``, which the
  tool defines inside ``main()``, so its body is copied here, run in
  interpret mode. Bit for bit (tolerance 0): T2 is exact.
- A box model of the kernel's launch plan (``plan_normalize_u8``): the
  kernel's loops replayed in numpy over the plan's head, vectors, tail and
  grid, with the lanes' shuffled stores, for sizes with and without a tail
  and input addresses at every residue class mod 16 that matters (0, 1, 8,
  15). Every element is written exactly once, with its own value, every
  vector access is 16-byte aligned, each store instruction is contiguous,
  and the scalar path is taken exactly where the input is not 8-byte
  aligned.
  The card runs the kernel itself (``tests/test_torch_port_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from embeddingnet_tpu_torch.ops import preprocess as pre  # noqa: E402

H100_SMS = 132


# tools/perf_probe3.py:63-76 (kern, norm_pallas), as written there, with
# interpret=True so that it runs on the CPU
def kern(x_ref, o_ref):
    o_ref[:] = (x_ref[:].astype(jnp.float32)
                * (1.0 / 255.0)).astype(jnp.bfloat16)


def norm_pallas(im):
    flat = im.reshape(-1, 512)
    rows = flat.shape[0]
    blk = 1024
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(flat.shape, jnp.bfloat16),
        grid=(rows // blk,),
        in_specs=[pl.BlockSpec((blk, 512), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((blk, 512), lambda i: (i, 0)),
        interpret=True,
    )(flat)
    return out.reshape(im.shape)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_t2_equals_its_pallas_twin():
    """[128, 64, 64, 3] (3 of the kernel's 1024 x 512 blocks): the port's
    plain version and its bf16 preprocessing equal Pallas ``kern`` bit for
    bit."""
    u8 = np.random.default_rng(14).integers(0, 256, (128, 64, 64, 3),
                                            np.uint8)
    want = np.asarray(norm_pallas(jnp.asarray(u8))).view(np.uint16)
    x = torch.from_numpy(u8)
    np.testing.assert_array_equal(_bits(pre._plain_normalize_u8(x)), want)
    got = pre.preprocess(x, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), want)
    assert pre.LAUNCHES == {"normalize_u8": 0}


def _replay(plan, n):
    """The kernel's accesses under ``plan``, as its loops make them
    (``normalize_u8_sm90_kernel``): per block, the tiles of TILE vectors
    grid-stride; in a tile, thread ``t`` loads vector ``t0 + k * THREADS +
    t`` for k < UNROLL; then each warp (base: its first vector) makes two
    store instructions, lane L of store h writing 16-byte output chunk ``2
    * base + 32 * h + L`` with the half ``L & 1`` of vector ``base + 16 * h
    + L // 2``, masked where that vector is past the end; then the head and
    tail one element a thread, grid-stride. Returns (the loaded vectors;
    the stores as rows of (chunk, source vector, half), one array per store
    instruction; the scalar element indices)."""
    lanes = np.arange(32)
    loads, stores = [], []
    for block in range(plan.grid):
        for t0 in range(block * pre.TILE, plan.vectors,
                        plan.grid * pre.TILE):
            for k in range(pre.UNROLL):
                for warp in range(pre.THREADS // 32):
                    base = t0 + k * pre.THREADS + 32 * warp
                    v = base + lanes
                    loads.append(v[v < plan.vectors])
                    for h in range(2):
                        src = base + 16 * h + lanes // 2
                        keep = src < plan.vectors
                        stores.append(np.stack(
                            [2 * base + 32 * h + lanes, src, lanes & 1],
                            axis=1)[keep])
    loads = np.concatenate(loads) if loads else np.zeros(0, np.int64)
    body = pre.VECTOR * plan.vectors
    edges = n - body
    threads = plan.grid * pre.THREADS
    # thread t visits e = t, t + threads, ... while e < edges
    e = (np.arange(-(-edges // threads), dtype=np.int32)[:, None] * threads
         + np.arange(threads, dtype=np.int32)[None, :]).ravel()
    e = e[e < edges]
    scalars = np.where(e < plan.head, e, e + body)
    return loads, stores, scalars


@pytest.mark.parametrize("residue", [0, 1, 8, 15])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 256, 1_000_003,
                               1024 * 64 * 64 * 3])
def test_plan_box_model(n, residue):
    in_addr = 0x7F00_0000_0000 + residue       # any address of that residue
    out_addr = 0x7F10_0000_0000                # torch.empty: 16-B aligned
    plan = pre.plan_normalize_u8(n, in_addr % 16, H100_SMS)
    assert plan.scalar == (residue % 8 != 0)
    assert plan.head + pre.VECTOR * plan.vectors + plan.tail == n
    assert 1 <= plan.grid <= H100_SMS * 2048 // pre.THREADS
    if plan.scalar:
        assert (plan.head, plan.vectors, plan.tail) == (n, 0, 0)
    else:
        assert plan.head < pre.VECTOR and plan.tail < pre.VECTOR
    loads, stores, scalars = _replay(plan, n)

    # every vector loaded once, 16-byte aligned
    assert (np.bincount(loads, minlength=plan.vectors) == 1).all()
    assert ((in_addr + plan.head + pre.VECTOR * loads) % 16 == 0).all()
    if not plan.scalar and plan.vectors:
        # the head ends at the first aligned input vector
        assert (in_addr + plan.head) % 16 == 0 and plan.head == min(
            (16 - residue) % 16, n)

    # each store writes, to its 16-byte chunk (8 elements), the half of the
    # vector whose elements those are; every instruction covers contiguous
    # chunks, 512 bytes where no lane is masked
    stored = (np.concatenate(stores) if stores
              else np.zeros((0, 3), np.int64))
    chunk, src, half = stored.T
    assert (chunk == 2 * src + half).all()
    for rows in stores:
        assert (np.diff(rows[:, 0]) == 1).all()
    assert ((out_addr + 2 * (plan.head + 8 * chunk)) % 16 == 0).all()

    # every element written exactly once, by a store or one a thread
    counts = np.bincount(scalars, minlength=n).astype(np.uint8)
    per_chunk = np.bincount(chunk, minlength=2 * plan.vectors)
    counts[plan.head:plan.head + pre.VECTOR * plan.vectors] += np.repeat(
        per_chunk.astype(np.uint8), 8)
    assert len(counts) == n and (counts == 1).all()

    # the grid covers the work in one pass where the card holds it
    tiles = -(-plan.vectors // pre.TILE)
    if not plan.scalar and tiles <= H100_SMS * 8:
        assert plan.grid == max(1, tiles)
