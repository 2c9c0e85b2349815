"""A frozen copy of the ``default`` augmentation preset's arithmetic, the
albumentations ops as the embedding trainer runs them on the device: float
BGR batches [B, H, W, 3] in 0..255, a per-image Bernoulli gate and
per-image parameters. Each op has two halves: ``sample(shape, generator,
device)`` draws its parameters (and the whole noise tensor), ``apply(x,
draws)`` transforms without randomness. The benchmark draws with
:func:`sample` and hands the same draws to the program and to
:func:`apply`.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Sequence

import torch

Draws = Dict[str, torch.Tensor]


class Op(NamedTuple):
    name: str
    params: Dict[str, object]
    sample: object
    apply: object


def _rand(shape, gen: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) f32 from ``gen`` (on the generator's device), on ``device``."""
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


def _gate(b: int, p: float, gen, device) -> torch.Tensor:
    """Per-image Bernoulli application mask [B, 1, 1, 1], f32."""
    return (_rand((b, 1, 1, 1), gen, device) < p).float()


def _uniform(b: int, lo: float, hi: float, gen, device) -> torch.Tensor:
    return lo + (hi - lo) * _rand((b, 1, 1, 1), gen, device)


def _blend(x: torch.Tensor, y: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    return x * (1.0 - mask) + y * mask


def _gate_only(p: float):
    def sample(shape, gen, device):
        return {"gate": _gate(shape[0], p, gen, device)}
    return sample


def apply_brightness_contrast(x: torch.Tensor, d: Draws) -> torch.Tensor:
    out = (x * d["alpha"] + d["beta"]).clamp(0.0, 255.0)
    return _blend(x, out, d["gate"])


def brightness_contrast(p: float = 0.4, brightness_limit: float = 0.2,
                        contrast_limit: float = 0.2) -> Op:
    """albumentations RandomBrightnessContrast defaults (brightness_by_max:
    beta scales 255)."""
    def sample(shape, gen, device):
        b = shape[0]
        return {"alpha": 1.0 + _uniform(b, -contrast_limit, contrast_limit,
                                        gen, device),
                "beta": _uniform(b, -brightness_limit, brightness_limit, gen,
                                 device) * 255.0,
                "gate": _gate(b, p, gen, device)}
    return Op("brightness_contrast",
              dict(p=p, brightness_limit=brightness_limit,
                   contrast_limit=contrast_limit),
              sample, apply_brightness_contrast)


def apply_random_gamma(x: torch.Tensor, d: Draws) -> torch.Tensor:
    out = 255.0 * torch.pow((x / 255.0).clamp(1e-6, 1.0), d["gamma"])
    return _blend(x, out, d["gate"])


def random_gamma(p: float = 0.4, gamma_limit=(80.0, 120.0)) -> Op:
    def sample(shape, gen, device):
        b = shape[0]
        return {"gamma": _uniform(b, gamma_limit[0] / 100.0,
                                  gamma_limit[1] / 100.0, gen, device),
                "gate": _gate(b, p, gen, device)}
    return Op("random_gamma", dict(p=p, gamma_limit=tuple(gamma_limit)),
              sample, apply_random_gamma)


def _bgr_to_hsv(x: torch.Tensor):
    """cv2-convention HSV from BGR floats (H in [0, 360) here; V 0..255)."""
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-6), 0.0)
    safe = delta.clamp_min(1e-6)
    h = torch.where(
        maxc == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(maxc == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = h * 60.0
    h = torch.where(delta == 0, 0.0, h)
    return h, s, v


def _hsv_to_bgr(h, s, v) -> torch.Tensor:
    """Branchless HSV -> BGR (the JAX package's K-function form)."""
    h = torch.remainder(h, 360.0) / 60.0

    def channel(n):
        k = torch.remainder(n + h, 6.0)
        return v - v * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    return torch.stack([channel(1.0), channel(3.0), channel(5.0)], dim=-1)


def apply_hue_saturation_value(x: torch.Tensor, d: Draws) -> torch.Tensor:
    h, s, v = _bgr_to_hsv(x)
    out = _hsv_to_bgr(h + d["h_shift"], (s + d["s_shift"]).clamp(0, 1),
                      (v + d["v_shift"]).clamp(0, 255))
    return _blend(x, out, d["gate"])


def hue_saturation_value(p: float = 0.4, hue_shift_limit: float = 20.0,
                         sat_shift_limit: float = 30.0,
                         val_shift_limit: float = 30.0) -> Op:
    """HSV jitter in cv2 units: the hue limit in cv2's 0..180 H scale."""
    def sample(shape, gen, device):
        b = shape[0]
        u = functools.partial(_uniform, b, gen=gen, device=device)
        return {
            # cv2 H unit = 2 degrees
            "h_shift": u(-hue_shift_limit, hue_shift_limit)[..., 0] * 2.0,
            "s_shift": u(-sat_shift_limit, sat_shift_limit)[..., 0] / 255.0,
            "v_shift": u(-val_shift_limit, val_shift_limit)[..., 0],
            "gate": _gate(b, p, gen, device)}
    return Op("hue_saturation_value",
              dict(p=p, hue_shift_limit=hue_shift_limit,
                   sat_shift_limit=sat_shift_limit,
                   val_shift_limit=val_shift_limit),
              sample, apply_hue_saturation_value)


def _luminance(x: torch.Tensor) -> torch.Tensor:
    return 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]


def _bins(lum: torch.Tensor, n_bins: int) -> torch.Tensor:
    return (lum / 256.0 * n_bins).to(torch.int64).clamp(0, n_bins - 1)


def _histogram(index: torch.Tensor, size: int) -> torch.Tensor:
    """f32 counts of each value of ``index`` in [0, size). Counts are
    integers, so the atomic adds on the card sum them exactly."""
    index = index.reshape(-1)
    hist = torch.zeros(size, dtype=torch.float32, device=index.device)
    return hist.scatter_add_(0, index, torch.ones_like(index,
                                                       dtype=torch.float32))


def _clipped_cdf(hist: torch.Tensor, npix: int, clip_limit: float,
                 n_bins: int) -> torch.Tensor:
    """Contrast-limited CDF over the last axis: counts clipped at
    ``clip_limit * npix / n_bins``, the excess spread evenly."""
    clipped = hist.clamp(max=clip_limit * npix / n_bins)
    excess = hist.sum(-1, keepdim=True) - clipped.sum(-1, keepdim=True)
    return torch.cumsum(clipped + excess / n_bins, -1) / npix


def _remap(x: torch.Tensor, lum: torch.Tensor, mapped: torch.Tensor,
           gate: torch.Tensor) -> torch.Tensor:
    """Scale every channel by the new over the old luminance."""
    ratio = (mapped * 255.0 / lum.clamp_min(1e-3))[..., None]
    return _blend(x, (x * ratio).clamp(0, 255), gate)


def apply_clahe_approx(x: torch.Tensor, d: Draws, clip_limit: float = 4.0,
                       n_bins: int = 64) -> torch.Tensor:
    """Contrast-limited global histogram equalisation of the luminance."""
    b = x.shape[0]
    lum = _luminance(x)
    bins = _bins(lum.reshape(b, -1), n_bins)
    n = bins.shape[1]
    rows = torch.arange(b, device=x.device)[:, None] * n_bins
    hist = _histogram(rows + bins, b * n_bins).view(b, n_bins)
    cdf = _clipped_cdf(hist, n, clip_limit, n_bins)
    mapped = torch.gather(cdf, 1, bins).view(lum.shape)
    return _remap(x, lum, mapped, d["gate"])


def apply_clahe_tiled(x: torch.Tensor, d: Draws, clip_limit: float = 4.0,
                      grid: int = 4, n_bins: int = 64,
                      stats_stride: int = 2) -> torch.Tensor:
    """Tile-based CLAHE: ``grid`` x ``grid`` tiles, histograms of every
    ``stats_stride``-th pixel in each axis, bilinear interpolation between
    the tile centres with the edges clamped. H and W must divide into tiles
    of an even size that ``stats_stride`` divides; other shapes fall back to
    :func:`apply_clahe_approx`, as the JAX ``clahe_tiled`` does."""
    b, hh, ww, _ = x.shape
    th, tw = hh // grid, ww // grid
    s = stats_stride
    if (th * grid != hh or tw * grid != ww or th % 2 or tw % 2
            or th % s or tw % s):
        return apply_clahe_approx(x, d, clip_limit=clip_limit, n_bins=n_bins)
    dev = x.device
    lum = _luminance(x)
    bins = _bins(lum, n_bins)                                 # [B, H, W]

    # per-tile clipped CDFs of the strided pixels: [B * G * G * n_bins]
    ths, tws = th // s, tw // s
    tile_y = torch.arange(hh // s, device=dev) // ths
    tile_x = torch.arange(ww // s, device=dev) // tws
    tile = ((torch.arange(b, device=dev)[:, None, None] * grid
             + tile_y[:, None]) * grid + tile_x)              # [B, H/s, W/s]
    hist = _histogram(tile * n_bins + bins[:, ::s, ::s],
                      b * grid * grid * n_bins)
    cdf = _clipped_cdf(hist.view(-1, n_bins), ths * tws, clip_limit,
                       n_bins).view(-1)

    # Pixel row y sits in the half-tile-shifted block i = (y + th/2) // th,
    # between the centres of tile rows i-1 and i (clamped to the grid), at
    # weight (r + 0.5) / th of row i, r = (y + th/2) % th; columns alike.
    def axis(n, t):
        pos = torch.arange(n, device=dev) + t // 2
        i = pos // t
        weight = ((pos % t).to(x.dtype) + 0.5) / t
        return (i - 1).clamp(0, grid - 1), i.clamp(0, grid - 1), weight

    low_y, high_y, wy = axis(hh, th)
    low_x, high_x, wx = axis(ww, tw)
    wy, wx = wy[:, None], wx[None, :]
    base = torch.arange(b, device=dev)[:, None, None] * (grid * grid)
    mapped = None
    for ty, tx, weight in ((low_y, low_x, (1 - wy) * (1 - wx)),
                           (low_y, high_x, (1 - wy) * wx),
                           (high_y, low_x, wy * (1 - wx)),
                           (high_y, high_x, wy * wx)):
        corner = base + ty[:, None] * grid + tx[None, :]     # [B, H, W]
        term = cdf[corner * n_bins + bins] * weight
        mapped = term if mapped is None else mapped + term
    return _remap(x, lum, mapped, d["gate"])


def clahe_tiled(p: float = 0.4, clip_limit: float = 4.0, grid: int = 4,
                n_bins: int = 64, stats_stride: int = 2) -> Op:
    return Op("clahe_tiled",
              dict(p=p, clip_limit=clip_limit, grid=grid, n_bins=n_bins,
                   stats_stride=stats_stride),
              _gate_only(p), functools.partial(
                  apply_clahe_tiled, clip_limit=clip_limit, grid=grid,
                  n_bins=n_bins, stats_stride=stats_stride))


def apply_blur3(x: torch.Tensor, d: Draws) -> torch.Tensor:
    """3x3 box blur, edge-padded, as two 3-tap sums."""
    xp = torch.cat([x[:, :1], x, x[:, -1:]], 1)
    ysum = xp[:, :-2] + xp[:, 1:-1] + xp[:, 2:]
    xp = torch.cat([ysum[:, :, :1], ysum, ysum[:, :, -1:]], 2)
    blurred = (xp[:, :, :-2] + xp[:, :, 1:-1] + xp[:, :, 2:]) / 9.0
    return _blend(x, blurred, d["gate"])


def blur3(p: float = 0.3) -> Op:
    """albumentations Blur with its limit normalised to 3."""
    return Op("blur3", dict(p=p), _gate_only(p), apply_blur3)


def apply_gauss_noise(x: torch.Tensor, d: Draws) -> torch.Tensor:
    noise = d["noise"] * torch.sqrt(d["var"])
    return _blend(x, (x + noise).clamp(0, 255), d["gate"])


def gauss_noise(p: float = 0.3, var_limit=(50.0, 80.0)) -> Op:
    def sample(shape, gen, device):
        b = shape[0]
        return {"var": _uniform(b, var_limit[0], var_limit[1], gen, device),
                "noise": torch.randn(tuple(shape), generator=gen,
                                     device=gen.device).to(device),
                "gate": _gate(b, p, gen, device)}
    return Op("gauss_noise", dict(p=p, var_limit=tuple(var_limit)), sample,
              apply_gauss_noise)


def default_ops() -> List[Op]:
    """The ``default`` preset, in order."""
    return [brightness_contrast(p=0.4), random_gamma(p=0.4),
            hue_saturation_value(p=0.4), clahe_tiled(p=0.4), blur3(p=0.3),
            gauss_noise(p=0.3, var_limit=(50, 80))]


PRESETS = {"default": default_ops}


def sample(preset: str, shape: Sequence[int], generator: torch.Generator,
           device=None) -> List[Draws]:
    """Every op's draws for a batch of ``shape``, in order."""
    device = generator.device if device is None else device
    return [op.sample(tuple(shape), generator, device)
            for op in PRESETS[preset]()]


def apply(preset: str, x: torch.Tensor, draws: Sequence[Draws]
          ) -> torch.Tensor:
    ops = PRESETS[preset]()
    if len(draws) != len(ops):
        raise ValueError(f"{len(draws)} draws for {len(ops)} ops")
    for op, d in zip(ops, draws):
        x = op.apply(x, d)
    return x
