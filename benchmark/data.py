"""Inputs made from a run's seed: images of coloured cells, and a folder
dataset of them as PNG files, kept in the user's cache directory so that a
later run of the same seed and size reads it again instead of writing it."""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def cell_images(rng: np.random.Generator, classes: np.ndarray, size: int,
                cells: int = 8, noise: int = 8) -> np.ndarray:
    """uint8 BGR images [N, size, size, 3] of ``classes``: each class a
    ``cells`` x ``cells`` grid of random colours scaled up to ``size``, plus
    per-image noise of up to ``noise`` grey levels."""
    base = rng.integers(0, 256, (int(classes.max()) + 1, cells, cells, 3),
                        dtype=np.uint8)
    base = base.repeat(size // cells, 1).repeat(size // cells, 2)
    out = np.empty((len(classes), size, size, 3), np.uint8)
    for lo in range(0, len(classes), 4096):
        hi = min(lo + 4096, len(classes))
        jitter = rng.integers(-noise, noise + 1, (hi - lo, size, size, 3),
                              dtype=np.int16)
        out[lo:hi] = np.clip(base[classes[lo:hi]].astype(np.int16) + jitter,
                             0, 255)
    return out


def write_dataset(root: str, images: np.ndarray, classes: np.ndarray,
                  per_class: int) -> None:
    """A folder dataset: ``root/class_<c>/<i>.png``, written on 8
    threads."""
    import cv2

    for c in np.unique(classes):
        os.makedirs(os.path.join(root, f"class_{c:04d}"), exist_ok=True)

    def write(i):
        path = os.path.join(root, f"class_{classes[i]:04d}",
                            f"{i % per_class}.png")
        if not cv2.imwrite(path, images[i],
                           [int(cv2.IMWRITE_PNG_COMPRESSION), 1]):
            raise OSError(f"cv2 could not write {path}")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(len(classes))))


# datasets kept in the cache directory, the least recently used removed
# beyond this many
KEEP = 12


def cache_dir() -> Path:
    """``$XDG_CACHE_HOME/embeddingnet-bench``, else under ``~/.cache``."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(base) / "embeddingnet-bench"


def seeded_dataset(seed: int, classes: int, per_class: int, size: int
                   ) -> str:
    """The folder dataset of ``classes`` x ``per_class`` colour-cell images
    at ``size`` px made from ``seed``: written once into the cache directory
    (under a fixed name, renamed into place when whole) and read again by
    every later run of the same arguments. Returns its path."""
    root = cache_dir()
    path = root / f"cells-{classes}x{per_class}-{size}px-{seed}"
    if not path.is_dir():
        part = root / (path.name + ".part")
        shutil.rmtree(part, ignore_errors=True)
        labels = np.repeat(np.arange(classes), per_class)
        rng = np.random.default_rng(seed)
        write_dataset(str(part), cell_images(rng, labels, size), labels,
                      per_class)
        os.replace(part, path)
    os.utime(path)
    kept = sorted((p for p in root.iterdir()
                   if p.is_dir() and p.name.startswith("cells-")
                   and not p.name.endswith(".part")),
                  key=lambda p: p.stat().st_mtime, reverse=True)
    for old in kept[KEEP:]:
        shutil.rmtree(old, ignore_errors=True)
    return str(path)
