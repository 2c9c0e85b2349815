"""Small-spatial 3x3 conv, plain and with a fused BN-apply + ReLU prologue,
forward and backward (port of ``embeddingnet_tpu/ops/fused_conv.py``).

On a CUDA tensor the ops launch the hand-written Hopper kernels; on a CPU
tensor they run their plain PyTorch versions, which the CPU tests hold
against the JAX package. There is no other route: a CUDA tensor the kernel
cannot take raises. Each op is a ``torch.autograd.Function`` whose backward
is the same on both routes: on the card it launches the backward kernels,
on the CPU their plain twins.

* :func:`conv3x3_small` — stride-1 SAME 3x3 conv: forward K1 (the TPU's
  ``_fwd_kernel``); backward K1 as the dgrad (the conv of the output
  gradient with the spatially flipped, in/out-swapped weight, read from the
  weight as it stands) and K2 (the TPU's ``_wgrad_kernel``) for the weight
  gradient.
* :func:`conv3x3_small_mixed` — the same op with the plain conv (cuDNN)
  as forward and the kernel backward, for the 8x8 maps where JAX keeps
  XLA's forward (:func:`eligible_mixed`).
* :func:`conv3x3_small_bn_relu` — ``conv3x3(relu(x*scale + bias), w)``:
  forward K3 (``_fwd_bn_kernel``); backward K1 as the dgrad, the affine and
  ReLU chain rule as plain tensor code (as JAX leaves it to XLA), and K4
  (``_wgrad_bn_kernel``), which recomputes the normalised input from the
  raw ``x`` so that it is never stored.
* :func:`conv3x3_small_affine_relu` — ``relu(conv3x3(x, w)*scale + bias)``,
  forward only: T1 (the TPU's ``fused_kernel`` of
  ``tools/pallas_fused_conv.py``, which has no VJP either), K1's forward
  with the affine and ReLU applied to its f32 accumulators before the bf16
  store; the BN-ReLU epilogue experiment that
  ``tools/fused_conv_epilogue_torch.py`` times.
* :class:`FastConv3x3`, :class:`BNScaleBias`, :class:`FusedBNReluConv3x3` —
  the modules the ResNet blocks use. Their ``state_dict``s equal those of
  ``nn.Conv2d(bias=False)`` and ``nn.BatchNorm2d``, so the fast path never
  changes a checkpoint.

The public functions keep the JAX layout: NHWC activations, ``[3, 3, Cin,
Cout]`` weights. The modules take the ResNet's NCHW tensors in
``torch.channels_last`` memory, whose NHWC view is contiguous and goes to the
kernels without a copy. The kernels are in ``csrc/conv3x3_sm90.cu``:
TMA-fed wgmma implicit GEMMs, laid out by :func:`plan_sm90` — K1, forward
and dgrad, K2, K3 and K4, which apply the affine and ReLU to each landed
input tile in shared memory, and T1, which applies it to the output tile in
registers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from embeddingnet_tpu_torch.ops import _cuda, batchnorm
from embeddingnet_tpu_torch.utils import trace

# Launches of each kernel since the last reset_launch_counts(), counted
# where the wrapper launches; a run reads them to show that its path went
# through the kernels. conv3x3_dgrad is K1 launched as the input gradient.
LAUNCHES = {"conv3x3_small": 0, "conv3x3_small_bn_relu": 0,
            "conv3x3_dgrad": 0, "conv3x3_wgrad": 0,
            "conv3x3_wgrad_bn_relu": 0, "conv3x3_small_affine_relu": 0}

# ``mode`` of csrc/conv3x3_sm90.cu's conv entry point: K1's forward, K1 as
# the dgrad, K3 (the affine + ReLU on the input) and T1 (on the output).
_FPROP, _DGRAD, _PROLOGUE, _EPILOGUE = range(4)

# Map sizes the kernels take: the forward kernel is generic in S, and the
# backward runs at 8x8 too (the mixed path).
KERNEL_SPATIAL = (2, 4, 8)

# csrc/conv3x3_sm90.cu: the H100 SXM's SMs, the kernels' 128x128 tile and
# their 64-wide K chunk (the conv's channels, K2's positions).
_SMS = 132
_SM90_TILE = 128
_SM90_CHUNK = 64
# K2's part rule counts time in chunks, one block's 128x128x64 product at
# the card's peak rate (about 0.28 us): a block's start and end cost about
# four, and one MiB of f32 partials written and read back (at 3.35 TB/s)
# about one.
_PART_OVERHEAD_CHUNKS = 4
# K1 takes 256-row tiles where they number at least this share of the SMs
_WIDE_TILE_SHARE = 0.9
_PARTIAL_BYTES_PER_CHUNK = 1 << 20
_MAX_PARTS = 64


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _gate(x_shape: Sequence[int], w_shape: Sequence[int],
          strides: Sequence[int], groups: int, spatial: Tuple[int, ...],
          dtype: Optional[torch.dtype]) -> bool:
    if tuple(strides) != (1, 1) or groups != 1:
        return False
    if len(x_shape) != 4 or tuple(w_shape[:2]) != (3, 3):
        return False
    _, h, w, cin = x_shape
    if h != w or h not in spatial or cin != w_shape[2]:
        return False
    if cin % 128 != 0 or w_shape[3] % 128 != 0:
        return False
    return dtype is None or dtype == torch.bfloat16


def eligible(x_shape: Sequence[int], w_shape: Sequence[int],
             strides: Sequence[int] = (1, 1), groups: int = 1,
             dtype: Optional[torch.dtype] = None) -> bool:
    """Shape gate of the kernel path, in the JAX layout (x NHWC, w HWIO).

    Eligible: stride-1 SAME 3x3, ungrouped, square spatial S in {2, 4},
    Cin and Cout multiples of 128 — the JAX gate's shape conditions. On the
    card the compute ``dtype`` must also be bf16, the one type the kernels
    are built for (the JAX gate asks a 2-byte dtype on the TPU); pass
    ``None`` for a CPU tensor, where the plain versions take any float type,
    as the JAX gate does in interpret mode.

    Dropped from the JAX gate, because they are facts of the TPU's VMEM: the
    row budgets (``_MAX_ROWS``, ``_wgrad_rows``) and the weight-block cap
    (``_MAX_WEIGHT_BYTES``) — the CUDA kernels stream their operands through
    shared memory in chunks — and the batch-tile condition (``_batch_tile``):
    the kernels mask a ragged last tile, so any batch is eligible.
    """
    return _gate(x_shape, w_shape, strides, groups, (2, 4), dtype)


def _jax_batch_tile_fits(batch: int, s: int, cin: int, cout: int) -> bool:
    """The JAX gate's batch-tile condition (``_batch_tile`` under the plain
    wgrad's row budget ``_wgrad_rows``): some power-of-two tile of at least
    8 divides the batch."""
    rows = 128 if cin * cout >= 512 * 512 else 1024
    tile = min(128, rows // (s * s))
    while tile >= 8:
        if batch % tile == 0:
            return True
        tile //= 2
    return False


def eligible_mixed(x_shape: Sequence[int], w_shape: Sequence[int],
                   strides: Sequence[int] = (1, 1), groups: int = 1,
                   dtype: Optional[torch.dtype] = None) -> bool:
    """Gate of the mixed path at 8x8: the plain conv (cuDNN) forward, as JAX
    keeps XLA's, and the kernel backward. Same conditions as
    :func:`eligible`, plus the JAX gate's batch-tile condition, kept here so
    that the mixed path runs exactly where the JAX package runs it (a batch
    that is a multiple of 8; C=512 is refused at 8x8)."""
    if not _gate(x_shape, w_shape, strides, groups, (8,), dtype):
        return False
    return _jax_batch_tile_fits(x_shape[0], x_shape[1], x_shape[3],
                                w_shape[3])


@dataclasses.dataclass(frozen=True)
class Sm90Plan:
    """How ``csrc/conv3x3_sm90.cu`` lays one call out; the C entry points
    compute the same grid and box coordinates.

    ``kind`` is ``"fprop"`` (K1's forward, K3's and T1's), ``"dgrad"`` (K1
    as the input gradient) or ``"wgrad"`` (K2, and K4). The A operand is a
    box of the 4-D tensor map over the activation ``[batch, s, s,
    k_channels]`` (innermost first: channels, W, H, batch): ``box`` = (64,
    s, s, ``images``). The conv's output is ``[batch*s*s, n_channels]`` in
    ``tiles`` of ``rows`` x 128 (rows 128 or 256), reduced over 9 taps x
    ``k_channels``; its ``grid`` is persistent, one block per SM, block
    ``i`` taking the tiles of
    :meth:`block_tiles`. K2's output is dW ``[9*k_channels, n_channels]`` in
    128x128 ``tiles``, one block each (grid x, y), its ``batch*s*s``
    positions reduced in ``parts`` parts (grid z) of ``per_part`` chunks of
    64 positions. A ring stage holds ``rows`` rows of 128 bytes of A: the
    conv's box, or K2's two boxes (channels c0 and c0 + 64) one after the
    other; K3's and K4's prologue rewrites it in place
    (:meth:`prologue_vectors`, :meth:`real_rows`,
    :func:`sm90_swizzle_group`). T1's epilogue maps the accumulators in
    registers (:meth:`accumulator_entry`)."""

    kind: str
    batch: int
    s: int
    k_channels: int
    n_channels: int
    rows: int
    images: int
    tiles: Tuple[int, int]
    grid: Tuple[int, int, int]
    parts: int = 1
    per_part: int = 0

    @property
    def box(self) -> Tuple[int, int, int, int]:
        return (_SM90_CHUNK, self.s, self.s, self.images)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def block_tiles(self, block: int) -> Tuple[Tuple[int, int], ...]:
        """The conv's (row tile, column tile) pairs that persistent block
        ``block`` computes, in order: every ``grid[0]``-th tile from
        ``block``, the row tile the fast index."""
        rows, cols = self.tiles
        return tuple((t % rows, t // rows)
                     for t in range(block, rows * cols, self.grid[0]))

    @property
    def weight_taps(self) -> Tuple[int, ...]:
        """The weight tap that A's tap ``t`` meets: ``8 - t`` for the dgrad,
        which reads the spatially flipped weight from ``w`` as it stands."""
        return tuple(8 - t if self.kind == "dgrad" else t for t in range(9))

    @property
    def chunks(self) -> int:
        """K2's 64-position chunks over ``batch*s*s``."""
        return -(-self.batch * self.s * self.s // _SM90_CHUNK)

    def a_origin(self, bx: int, t: int, c0: int, chunk: int = 0
                 ) -> Tuple[int, int, int, int]:
        """Origin (channel, W, H, batch) of the A box for tap ``t`` at
        channel ``c0``: of row tile ``bx`` for the conv, of position chunk
        ``chunk`` for K2. Coordinates off the tensor read as zeros."""
        b0 = (chunk * _SM90_CHUNK // (self.s * self.s) if self.kind == "wgrad"
              else bx * self.images)
        return (c0, t % 3 - 1, t // 3 - 1, b0)

    def b_origin(self, by: int, t: int, c0: int, half: int
                 ) -> Tuple[int, int]:
        """Origin (column, row) of the conv's 64x64 B box ``half`` for tap
        ``t`` and K offset ``c0``, in ``w`` seen as ``[9*Cin, Cout]``: the
        forward's box is 64 K rows by 64 output channels; the dgrad's is 64
        output-gradient channels (K, the columns) by 64 rows of input
        channels (N)."""
        n = by * _SM90_TILE + 64 * half
        if self.kind == "dgrad":
            return (c0, self.weight_taps[t] * self.n_channels + n)
        return (n, t * self.k_channels + c0)

    def wgrad_tile(self, bx: int) -> Tuple[int, int]:
        """(tap, first input channel) of K2's dW row tile ``bx``."""
        k0 = bx * _SM90_TILE
        return k0 // self.k_channels, k0 % self.k_channels

    def g_origin(self, by: int, chunk: int, half: int) -> Tuple[int, int]:
        """Origin (column, row) of K2's 64x64 box ``half`` of g, seen as
        ``[batch*s*s, Cout]``, for position chunk ``chunk``."""
        return (by * _SM90_TILE + 64 * half, chunk * _SM90_CHUNK)

    def part_chunks(self, z: int) -> range:
        """The chunks part ``z`` of K2 reduces."""
        return range(z * self.per_part,
                     min(self.chunks, (z + 1) * self.per_part))

    def real_rows(self, origin: Sequence[int]) -> torch.Tensor:
        """Which rows of the A box at ``origin`` (channel, W, H, batch) are
        positions of the tensor: ``(b, h, w)`` with ``0 <= h + origin[2] <
        s``, ``0 <= w + origin[1] < s`` and ``origin[3] + b < batch``. The
        prologue rewrites these rows only; the others, TMA's zero fill (the
        padding ring and the rows past a ragged batch), stay zero, since
        ``relu(0*scale + bias)`` need not be. Bool, one per box row."""
        _, x0, y0, b0 = origin
        ss = self.s * self.s
        r = torch.arange(self.images * ss)
        y = (r % ss) // self.s + y0
        x = r % self.s + x0
        return ((y >= 0) & (y < self.s) & (x >= 0) & (x < self.s)
                & (b0 + r // ss < self.batch))

    def prologue_vectors(self, thread: int) -> Tuple[Tuple[int, int], ...]:
        """(row, physical 16-byte chunk) of the vectors of a ring stage
        that consumer thread ``thread`` (0-255; warpgroup ``thread //
        128``) rewrites in the prologue: the warpgroup's half of the
        ``rows`` rows (the tile rows it multiplies, or K2's box of its 64
        channels), vector ``thread % 128 + 128*i`` of it."""
        wg, tid = divmod(thread, 128)
        half = self.rows // 2
        return tuple((wg * half + tid // 8 + 16 * i, tid % 8)
                     for i in range(half // 16))


    def accumulator_entry(self, thread, u, h, j, e):
        """(row, column) within the conv's ``rows`` x 128 output tile of
        consumer thread ``thread``'s (0-255) accumulator ``acc[u][4j + 2h +
        e]``: wgmma's m64n128 f32 fragment, warpgroup ``thread // 128``
        holding the tile's 64-row blocks ``wg * rows/128 + u``. The
        epilogue (T1's affine and ReLU, then the bf16 store) runs in this
        layout. Takes ints or integer arrays."""
        wg, tid = thread // 128, thread % 128
        warp, lane = tid // 32, tid % 32
        row = (64 * (wg * (self.rows // 128) + u) + 16 * warp + lane // 4
               + 8 * h)
        return row, 8 * j + 2 * (lane % 4) + e


def wgrad_sm90_parts(batch: int, s: int, cin: int, cout: int,
                     sms: int = _SMS) -> Tuple[int, int]:
    """(parts, chunks per part) of K2's reduction over ``batch*s*s``
    positions. Among the splits whose blocks fill at least one wave of
    ``sms`` SMs (where the chunks allow), the one with the least estimated
    time: whole waves times the chunks of a part plus its start and end,
    plus the f32 partials written and added back. Every part has a chunk."""
    tiles = (9 * cin // _SM90_TILE) * (cout // _SM90_TILE)
    chunks = -(-batch * s * s // _SM90_CHUNK)
    partial_chunks = 2 * 9 * cin * cout * 4 / _PARTIAL_BYTES_PER_CHUNK
    best = None
    for p in range(1, min(chunks, _MAX_PARTS) + 1):
        per = -(-chunks // p)
        parts = -(-chunks // per)
        if parts != p:
            continue
        waves = -(-tiles * parts // sms)
        cost = (waves * (per + _PART_OVERHEAD_CHUNKS)
                + (parts * partial_chunks if parts > 1 else 0.0))
        fills = tiles * parts >= sms
        key = (not fills, cost)
        if best is None or key < best[0]:
            best = (key, parts, per)
    return best[1], best[2]


def sm90_swizzle_group(row, chunk):
    """The logical 16-byte chunk (8 bf16 channels) that physical chunk
    ``chunk`` of 128-byte row ``row`` of a ring stage holds: TMA's 128-byte
    swizzle XORs the chunk with the row's place in its 1024-byte atom, the
    stage being 1024-byte aligned. Takes ints or integer arrays."""
    return chunk ^ (row % 8)


@functools.lru_cache(maxsize=None)
def plan_sm90(kind: str, batch: int, s: int, cin: int, cout: int,
              sms: int = _SMS) -> Sm90Plan:
    """The layout of one call of ``csrc/conv3x3_sm90.cu`` for the weight
    ``[3, 3, cin, cout]`` at ``[batch, s, s, .]`` on a card of ``sms`` SMs:
    ``kind`` ``"fprop"`` (x has cin channels, the output cout), ``"dgrad"``
    (g has cout, dx cin) or ``"wgrad"``. Cached: the wrappers ask it at
    every launch."""
    if kind == "wgrad":
        parts, per = wgrad_sm90_parts(batch, s, cin, cout, sms)
        tiles = (9 * cin // _SM90_TILE, cout // _SM90_TILE)
        return Sm90Plan(kind, batch, s, cin, cout, _SM90_TILE,
                        _SM90_CHUNK // (s * s), tiles, tiles + (parts,),
                        parts, per)
    if kind not in ("fprop", "dgrad"):
        raise ValueError(f"unknown kind {kind!r}")
    k, n = (cout, cin) if kind == "dgrad" else (cin, cout)
    # 256-row tiles load a quarter fewer bytes per product (the limit of
    # the mainloop: L2-to-SM traffic) where they still number 90% of the SMs
    for rows in (2 * _SM90_TILE, _SM90_TILE):
        images = rows // (s * s)
        tiles = (-(-batch // images), n // _SM90_TILE)
        if tiles[0] * tiles[1] >= _WIDE_TILE_SHARE * sms:
            break
    return Sm90Plan(kind, batch, s, k, n, rows, images, tiles,
                    (min(tiles[0] * tiles[1], sms), 1, 1))


# ---------------------------------------------------------------------------
# Plain versions: the CPU route and the reference the kernels are held to.
# ---------------------------------------------------------------------------


def _plain_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv, NHWC x HWIO -> NHWC, in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _affine_relu(x: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """relu(x*scale + bias) over the last (channel) axis: f32 math, cast
    back to x's dtype, as the kernels round before the product."""
    return (x.float() * scale + bias).clamp_min(0.0).to(x.dtype)


def _plain_conv3x3_affine_relu(x: torch.Tensor, w: torch.Tensor,
                               scale: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """The plain version of T1: ``relu(conv3x3(x, w)*scale + bias)``, the
    conv on ``x.float()`` and ``w.float()`` (bf16 products are exact in f32),
    the affine and ReLU on the f32 result, one cast to x's dtype — what
    ``xla_conv_bn_relu`` of ``tools/pallas_fused_conv.py`` computes."""
    y = _plain_conv3x3(x.float(), w.float())
    return (y * scale + bias).clamp_min(0.0).to(x.dtype)


def _flip(w: torch.Tensor) -> torch.Tensor:
    """The dgrad's weight: spatially flipped, in/out swapped, HWIO."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _plain_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW[dy, dx] = sum over (b, y, x) of x_pad[b, y+dy, x+dx]^T g[b, y, x]:
    the weight gradient of the stride-1 SAME 3x3 conv, [3, 3, Cin, Cout]
    f32 (as JAX's ``_lax_wgrad``)."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([
        torch.stack([
            torch.einsum("bhwc,bhwo->co", xp[:, dy:dy + s, dx:dx + s, :],
                         g).float()
            for dx in range(3)])
        for dy in range(3)])


def _plain_wgrad_bn_relu(x: torch.Tensor, g: torch.Tensor,
                         scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """:func:`_plain_wgrad` of ``relu(x*scale + bias)``."""
    return _plain_wgrad(_affine_relu(x, scale, bias), g)


# ---------------------------------------------------------------------------
# Kernel wrappers. A CPU tensor takes the plain version; anything else goes
# to the kernel, which checks what it is given and raises on what it cannot
# take.
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, w_shape: Sequence[int],
           tensors: Sequence[torch.Tensor],
           scale: Optional[torch.Tensor], affine_len: int = 0) -> None:
    """Raises on what the kernel cannot take. ``scale`` and ``bias`` are the
    last two of ``tensors`` where given, f32 of ``affine_len`` channels
    (Cin unless given)."""
    if not _gate(tuple(x.shape), tuple(w_shape), (1, 1), 1, KERNEL_SPATIAL,
                 x.dtype):
        raise ValueError(
            f"{name}: the kernel takes bf16 x [B, S, S, Cin] with S in "
            f"{KERNEL_SPATIAL} and w [3, 3, Cin, Cout], channels multiples "
            f"of 128; got x {tuple(x.shape)} {x.dtype}, w {tuple(w_shape)}")
    n = affine_len or x.shape[3]
    if scale is not None:
        for t in tensors[-2:]:
            if t.dtype != torch.float32 or tuple(t.shape) != (n,):
                raise ValueError(
                    f"{name}: scale and bias must be f32 [{n}], got "
                    f"{t.dtype} {tuple(t.shape)}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: inputs must be contiguous and 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def _launch_sm90(name: str, x: torch.Tensor, w: torch.Tensor,
                 mode: int = _FPROP, scale: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``csrc/conv3x3_sm90.cu``'s conv, by ``mode``: K1's ``conv3x3(x,
    w)``; ``_DGRAD``, ``conv3x3(x, _flip(w))`` read from ``w`` as it stands
    (``x`` is then the output gradient, with w's Cout channels);
    ``_PROLOGUE``, K3's ``conv3x3(relu(x*scale + bias), w)`` (scale and
    bias [Cin]); ``_EPILOGUE``, T1's ``relu(conv3x3(x, w)*scale + bias)``
    (scale and bias [Cout]). bf16 [B, S, S, N]; counted under ``name``."""
    if w.dtype != torch.bfloat16 or w.dim() != 4:
        raise ValueError(f"{name}: w must be bf16 [3, 3, Cin, Cout], got "
                         f"{w.dtype} {tuple(w.shape)}")
    kh, kw, cin, cout = w.shape
    dgrad = mode == _DGRAD
    # the dgrad's conv reads w as the flipped [3, 3, Cout, Cin] weight
    w_shape = (kh, kw, cout, cin) if dgrad else (kh, kw, cin, cout)
    affine = [scale, bias] if scale is not None else []
    _check(name, x, w_shape, [x, w] + affine, scale,
           cout if mode == _EPILOGUE else 0)
    b, s = x.shape[0], x.shape[1]
    out = torch.empty((b, s, s, w_shape[3]), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    plan = plan_sm90("dgrad" if dgrad else "fprop", b, s, cin, cout,
                     _cuda.sm_count(x.device.index))
    fn = _cuda.library("conv3x3_sm90").embn_conv3x3_sm90
    with _cuda.on_device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(bias),
                 out.data_ptr(), b, s, cin, cout, mode, plan.rows,
                 plan.grid[0], _cuda.stream(x.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _launch_wgrad(name: str, x: torch.Tensor, g: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 (no ``scale``) or K4 of ``csrc/conv3x3_sm90.cu``: the [3, 3,
    Cin, Cout] f32 weight gradient of ``conv3x3([relu(x*scale+bias)], w)``
    for the output gradient ``g``."""
    b, s, _, cin = x.shape
    cout = g.shape[3]
    tensors = [x, g] + ([scale, bias] if scale is not None else [])
    _check(name, x, (3, 3, cin, cout), tensors, scale)
    if g.dtype != x.dtype or tuple(g.shape) != (b, s, s, cout):
        raise ValueError(f"{name}: g must be {x.dtype} {(b, s, s, cout)}, "
                         f"got {g.dtype} {tuple(g.shape)}")
    out = torch.empty((3, 3, cin, cout), dtype=torch.float32,
                      device=x.device)
    if b == 0:
        return out.zero_()
    plan = plan_sm90("wgrad", b, s, cin, cout,
                     _cuda.sm_count(x.device.index))
    ws = (torch.empty((plan.parts, 9 * cin, cout), dtype=torch.float32,
                      device=x.device) if plan.parts > 1 else out)
    with _cuda.on_device(x.device):
        err = _cuda.library("conv3x3_sm90").embn_conv3x3_wgrad_sm90(
            x.data_ptr(), g.data_ptr(), _ptr(scale), _ptr(bias),
            ws.data_ptr(), out.data_ptr(), b, s, cin, cout, plan.parts,
            plan.per_part, _cuda.stream(x.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _conv_fwd(x, w):
    return _plain_conv3x3(x, w) if _on_cpu(x) else \
        _launch_sm90("conv3x3_small", x, w)


def _conv_bn_fwd(x, w, scale, bias):
    if _on_cpu(x):
        return _plain_conv3x3(_affine_relu(x, scale, bias), w)
    return _launch_sm90("conv3x3_small_bn_relu", x, w, _PROLOGUE, scale,
                        bias)


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the stride-1 SAME 3x3 conv: the same conv of the
    output gradient ``g`` [B, S, S, Cout] with the flipped, transposed
    weight, [B, S, S, Cin] in g's dtype. A CUDA tensor launches K1 as the
    dgrad, which reads ``w`` as it stands: no flipped copy is made."""
    if _on_cpu(g):
        return _plain_conv3x3(g, _flip(w))
    return _launch_sm90("conv3x3_dgrad", g, w, _DGRAD)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME 3x3 conv, [3, 3, Cin, Cout]
    f32. A CUDA tensor launches K2."""
    if _on_cpu(x):
        return _plain_wgrad(x, g)
    return _launch_wgrad("conv3x3_wgrad", x, g)


def conv3x3_wgrad_bn_relu(x: torch.Tensor, g: torch.Tensor,
                          scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``conv3x3(relu(x*scale + bias), w)`` from the raw
    ``x``, [3, 3, Cin, Cout] f32. A CUDA tensor launches K4."""
    if _on_cpu(x):
        return _plain_wgrad_bn_relu(x, g, scale, bias)
    return _launch_wgrad("conv3x3_wgrad_bn_relu", x, g, scale, bias)


# ---------------------------------------------------------------------------
# The differentiable ops.
# ---------------------------------------------------------------------------


def _conv_backward(ctx, g):
    """``_conv_vjp_bwd``: dx by K1 on the flipped weight, dW by K2, rounded
    once to the weight's dtype. ``g`` may come as a channels_last view; the
    kernels take it contiguous."""
    x, w = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()
    dx = conv3x3_dgrad(g, w) if ctx.needs_input_grad[0] else None
    dw = (conv3x3_wgrad(x, g).to(w.dtype) if ctx.needs_input_grad[1]
          else None)
    return dx, dw


class _Conv3x3Small(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv_fwd(x, w)

    backward = staticmethod(_conv_backward)


class _Conv3x3SmallMixed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _plain_conv3x3(x, w)

    backward = staticmethod(_conv_backward)


class _Conv3x3SmallBNRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias):
        ctx.save_for_backward(x, w, scale, bias)
        return _conv_bn_fwd(x, w, scale, bias)

    @staticmethod
    def backward(ctx, g):
        """``_bn_vjp_bwd_common``: dz by K1 on the flipped weight, then the
        affine and ReLU chain rule in f32, dW by K4 from the raw x."""
        x, w, scale, bias = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dz = conv3x3_dgrad(g, w).float()
        xf = x.float()
        dpre = dz * (xf * scale + bias > 0)
        dx = (dpre * scale).to(x.dtype)
        ds = (dpre * xf).sum((0, 1, 2)).to(scale.dtype)
        db = dpre.sum((0, 1, 2)).to(bias.dtype)
        dw = None
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad_bn_relu(x, g, scale, bias).to(w.dtype)
        return dx, dw, ds, db


def conv3x3_small(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv on a small square map, differentiable.

    ``x`` [B, S, S, Cin], ``w`` [3, 3, Cin, Cout]; output [B, S, S, Cout] in
    x's dtype, f32-accumulated. A CUDA tensor launches the kernels (and must
    pass :func:`eligible` with its dtype); a CPU tensor runs the plain
    versions, forward and backward."""
    return _Conv3x3Small.apply(x, w)


def conv3x3_small_affine_relu(x: torch.Tensor, w: torch.Tensor,
                              scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """``relu(conv3x3(x, w)*scale + bias)``: a stride-1 SAME 3x3 conv with
    the following BatchNorm's affine and the ReLU on its f32 accumulator,
    rounded once to x's dtype. Forward only, as the TPU kernel it ports.

    ``x`` [B, S, S, Cin], ``w`` [3, 3, Cin, Cout], ``scale``/``bias`` f32
    [Cout] (the TPU tool's [1, C] reshaped). A CUDA tensor launches T1, K1's
    forward kernel with the epilogue (bf16, S in {2, 4, 8}, channels
    multiples of 128, any B), and raises if an input requires grad: the op
    has no backward. A CPU tensor runs the plain version."""
    if _on_cpu(x):
        return _plain_conv3x3_affine_relu(x, w, scale, bias)
    if any(t.requires_grad for t in (x, w, scale, bias)) and \
            torch.is_grad_enabled():
        raise RuntimeError(
            "conv3x3_small_affine_relu is forward only (T1 has no VJP); "
            "call it on tensors that do not require grad, or under "
            "torch.no_grad()")
    return _launch_sm90("conv3x3_small_affine_relu", x, w, _EPILOGUE, scale,
                        bias)


def conv3x3_small_mixed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`conv3x3_small` with the plain conv as its forward and the
    kernel backward (the 8x8 maps of :func:`eligible_mixed`)."""
    return _Conv3x3SmallMixed.apply(x, w)


def conv3x3_small_bn_relu(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """``conv3x3(relu(x*scale + bias), w)`` in one kernel, differentiable in
    all four arguments.

    ``x`` [B, S, S, Cin] is the raw pre-BN activation; ``scale``/``bias``
    are the f32 effective affine of the preceding BatchNorm
    (:class:`BNScaleBias`). A CUDA tensor launches the kernels; a CPU tensor
    runs the plain versions."""
    return _Conv3x3SmallBNRelu.apply(x, w, scale, bias)


# ---------------------------------------------------------------------------
# Modules (NCHW tensors, channels_last memory).
# ---------------------------------------------------------------------------


def _compute_dtype(module_dtype: Optional[torch.dtype], x: torch.Tensor,
                   weight: torch.Tensor) -> torch.dtype:
    """Flax's rule: an explicit dtype wins, else the promoted input/param
    type."""
    return module_dtype or torch.promote_types(x.dtype, weight.dtype)


def cast(dtype: torch.dtype, *tensors: Optional[torch.Tensor]) -> tuple:
    """``tensors`` in ``dtype`` (None stays None): a layer's casts of its
    input and parameters to its compute dtype, inside a ``cast`` span
    (:mod:`~embeddingnet_tpu_torch.utils.trace`) when one of them is
    converted."""
    if all(t is None or t.dtype == dtype for t in tensors):
        return tensors
    with trace.span("cast"):
        return tuple(None if t is None else t.to(dtype) for t in tensors)


def _gate_dtype(x: torch.Tensor) -> Optional[torch.dtype]:
    return x.dtype if x.device.type != "cpu" else None


def _hwio(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # The kernel's [3, 3, Cin, Cout] weight is a per-call cast and permute
    # of the module's f32 OIHW parameter: one small copy per conv call,
    # counted in the module-level times of PERF.md. Autograd carries dW
    # back through it to the f32 parameter. A conversion runs inside a
    # ``cast`` span.
    if weight.dtype == dtype:
        return weight.permute(2, 3, 1, 0).contiguous()
    with trace.span("cast"):
        return weight.to(dtype).permute(2, 3, 1, 0).contiguous()


class FastConv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, features, 3, strides, padding=1, bias=False)`` that
    takes the kernel path where the shape is :func:`eligible`, the mixed
    path where it is :func:`eligible_mixed`, and ``F.conv2d`` elsewhere.
    ``compute_dtype`` casts input and weight, as Flax's ``dtype`` field
    does; parameters stay f32."""

    def __init__(self, in_channels: int, features: int,
                 strides: Sequence[int] = (1, 1), groups: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, 3, tuple(strides), 1,
                         groups=groups, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(self.compute_dtype, x, self.weight)
        x, = cast(dtype, x)
        nhwc = x.permute(0, 2, 3, 1)
        w_shape = (3, 3, self.in_channels // self.groups, self.out_channels)
        args = (tuple(nhwc.shape), w_shape, self.stride, self.groups,
                _gate_dtype(x))
        if eligible(*args):
            op = conv3x3_small
        elif eligible_mixed(*args):
            op = conv3x3_small_mixed
        else:
            w, = cast(dtype, self.weight)
            return F.conv2d(x, w, None, self.stride, 1, 1, self.groups)
        return op(nhwc.contiguous(), _hwio(self.weight, dtype)).permute(
            0, 3, 1, 2)


class BNScaleBias(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that returns the effective per-channel affine
    ``(scale, bias)`` in f32 (f64 for a float64 input) instead of applying
    it:
    ``scale = gamma * rsqrt(var + eps)``, ``bias = beta - mean * scale``.

    Statistics follow Flax's ``nn.BatchNorm``: eval mode reads the running
    statistics; train mode uses the batch mean and the biased batch variance
    (``E[x^2] - E[x]^2``, in f32) and updates the running averages with
    ``momentum`` in Flax's sense (``ra = momentum*ra + (1-momentum)*batch``;
    torch's own ``momentum`` attribute holds ``1 - momentum``), the running
    variance biased as Flax keeps it.

    In train mode it follows :mod:`~embeddingnet_tpu_torch.ops.
    batchnorm_context`: with a ``world``, the per-channel sums of ``x`` and
    ``x^2`` are all-reduced over the ranks first, so the statistics are the
    global batch's (the ranks hold equal blocks), as JAX's over a data
    mesh; while ``recomputing`` (a rematerialised forward) the running
    averages stay as the first forward left them.

    A CPU tensor runs the eager version
    (:func:`~embeddingnet_tpu_torch.ops.batchnorm.plain_scale_bias`); a CUDA
    tensor the kernels of :mod:`~embeddingnet_tpu_torch.ops.batchnorm`.

    The forward runs inside a ``bn`` span (:mod:`~embeddingnet_tpu_torch.
    utils.trace`); a subclass that applies the affine too opens its own
    around :meth:`scale_bias` and the affine, so one layer call is one
    ``bn`` range.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        with trace.span("bn"):
            return self.scale_bias(x)

    def scale_bias(self, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        return batchnorm.scale_bias(self, x)


class FusedBNReluConv3x3(nn.Conv2d):
    """The conv half of the fused ``bn -> relu -> 3x3 conv`` pair: takes the
    raw pre-BN activation and :class:`BNScaleBias`'s ``(scale, bias)`` and
    computes ``conv3x3(relu(x*scale + bias), weight)`` — through the fused
    kernel where the shape is :func:`eligible`, else through the affine and
    ReLU followed by the mixed op (:func:`eligible_mixed`) or ``F.conv2d``.
    Stride 1, ungrouped, no bias; the parameter is ``nn.Conv2d``'s."""

    def __init__(self, in_channels: int, features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, features, 3, 1, 1, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        dtype = _compute_dtype(self.compute_dtype, x, self.weight)
        x, = cast(dtype, x)
        nhwc = x.permute(0, 2, 3, 1)
        scale, bias = scale.float(), bias.float()
        args = (tuple(nhwc.shape), (3, 3, self.in_channels,
                                    self.out_channels))
        gate_dtype = _gate_dtype(nhwc)
        if eligible(*args, dtype=gate_dtype):
            y = conv3x3_small_bn_relu(nhwc.contiguous(),
                                      _hwio(self.weight, dtype), scale, bias)
            return y.permute(0, 3, 1, 2)
        z = _affine_relu(nhwc, scale, bias)
        if eligible_mixed(*args, dtype=gate_dtype):
            y = conv3x3_small_mixed(z.contiguous(),
                                    _hwio(self.weight, dtype))
            return y.permute(0, 3, 1, 2)
        w, = cast(dtype, self.weight)
        return F.conv2d(z.permute(0, 3, 1, 2), w, None, 1, 1)
