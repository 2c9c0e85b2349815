"""Batch samplers (the port's own copy of ``PKSampler``,
``TripletSampler``, ``PairSampler`` and ``SimpleSampler`` in
``embeddingnet_tpu/data/samplers.py``).

* :class:`PKSampler`: ``k_classes`` classes without replacement x
  ``k_samples`` images with replacement. A batch is grouped (each class's
  ``k_samples`` images are adjacent), which is the layout the batch-all P-K
  fast path asserts.
* :class:`TripletSampler`: offline random (anchor, positive, negative)
  triplets, which the triplet val epoch draws.
* :class:`PairSampler`: siamese pairs, one anchor class per batch, the
  first half same-class (target 1), the second half of another class (0).
* :class:`SimpleSampler`: uniform random (image, class) batches, for the
  arcface mode and the softmax pretraining.
* :class:`ProcessShardSampler`: one rank's rows of another sampler's
  global batches (data-parallel feeding).

Each draws from a numpy generator seeded by the caller: the same seed gives
the same batches as the JAX package's sampler.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

ClassFiles = Dict[str, List[str]]


class _SamplerBase:
    def __init__(self, class_files_paths: ClassFiles,
                 class_names: Sequence[str], seed: int = 0):
        # keep only classes that have samples
        self.class_files_paths = {c: v for c, v in class_files_paths.items()
                                  if len(v) > 0}
        self.class_names = [c for c in class_names
                            if c in self.class_files_paths]
        self.n_classes = len(self.class_names)
        self.n_samples = {c: len(self.class_files_paths[c])
                          for c in self.class_names}
        self.class_to_id = {c: i for i, c in enumerate(class_names)}
        self.rng = np.random.default_rng(seed)

    def _random_class(self) -> str:
        return self.class_names[self.rng.integers(self.n_classes)]

    def __iter__(self) -> Iterator:
        while True:
            yield self.sample()


class PKSampler(_SamplerBase):
    """P-K batches: ``k_classes`` x ``k_samples``; yields ``(paths,
    int_labels)``, the labels being each class's index in
    ``class_names``."""

    def __init__(self, class_files_paths: ClassFiles,
                 class_names: Sequence[str], k_classes: int = 5,
                 k_samples: int = 5, seed: int = 0):
        super().__init__(class_files_paths, class_names, seed)
        if self.n_classes < 2:
            raise ValueError("P-K sampling needs >= 2 non-empty classes")
        self.k_classes = min(k_classes, self.n_classes)
        self.k_samples = k_samples

    @property
    def batch_size(self) -> int:
        return self.k_classes * self.k_samples

    def sample(self) -> Tuple[List[str], np.ndarray]:
        cls_idx = self.rng.choice(self.n_classes, size=self.k_classes,
                                  replace=False)
        paths: List[str] = []
        labels: List[int] = []
        for ci in cls_idx:
            cls = self.class_names[ci]
            files = self.class_files_paths[cls]
            img_idx = self.rng.choice(len(files), size=self.k_samples,
                                      replace=True)
            paths.extend(files[i] for i in img_idx)
            labels.extend([self.class_to_id[cls]] * self.k_samples)
        return paths, np.asarray(labels, np.int32)


class TripletSampler(_SamplerBase):
    """Offline random triplets: a random class, two distinct images of it,
    and an image of a random other class; yields ``((anchors, positives,
    negatives), int_labels)`` with the anchors' labels."""

    def __init__(self, class_files_paths: ClassFiles,
                 class_names: Sequence[str], batch_size: int = 32,
                 seed: int = 0):
        super().__init__(class_files_paths, class_names, seed)
        self.batch_size = batch_size

    def sample(self):
        a_paths, p_paths, n_paths = [], [], []
        labels = []
        for _ in range(self.batch_size):
            ci = int(self.rng.integers(self.n_classes))
            cls = self.class_names[ci]
            n_el = self.n_samples[cls]
            other_ci = (ci + int(self.rng.integers(1, self.n_classes))) \
                % self.n_classes
            other = self.class_names[other_ci]
            idx1 = int(self.rng.integers(n_el))
            idx2 = (idx1 + int(self.rng.integers(1, max(n_el, 2)))) % n_el
            idx3 = int(self.rng.integers(self.n_samples[other]))
            a_paths.append(self.class_files_paths[cls][idx1])
            p_paths.append(self.class_files_paths[cls][idx2])
            n_paths.append(self.class_files_paths[other][idx3])
            labels.append(self.class_to_id[cls])
        return (a_paths, p_paths, n_paths), np.asarray(labels, np.int32)


class PairSampler(_SamplerBase):
    """Siamese pairs (the reference's ``datagenerators.py:337-375``): one
    random anchor class per batch; the first ``batch_size // 2`` pairs are
    two distinct images of it (target 1), the rest an image of it and one
    of a random other class (target 0). Yields ``((left_paths,
    right_paths), float32 targets)``."""

    def __init__(self, class_files_paths: ClassFiles,
                 class_names: Sequence[str], batch_size: int = 32,
                 seed: int = 0):
        super().__init__(class_files_paths, class_names, seed)
        self.batch_size = batch_size

    def sample(self):
        left, right = [], []
        targets = np.zeros(self.batch_size, np.float32)
        ci = int(self.rng.integers(self.n_classes))
        cls = self.class_names[ci]
        n_el = self.n_samples[cls]
        idxs = self.rng.integers(n_el, size=self.batch_size)
        n_same = self.batch_size // 2
        for i in range(n_same):
            idx1 = int(idxs[i])
            idx2 = (idx1 + int(self.rng.integers(1, max(n_el, 2)))) % n_el
            left.append(self.class_files_paths[cls][idx1])
            right.append(self.class_files_paths[cls][idx2])
            targets[i] = 1.0
        for i in range(n_same, self.batch_size):
            other_ci = (ci + int(self.rng.integers(1, self.n_classes))) \
                % self.n_classes
            other = self.class_names[other_ci]
            left.append(self.class_files_paths[cls][int(idxs[i])])
            right.append(self.class_files_paths[other][
                int(self.rng.integers(self.n_samples[other]))])
        return (left, right), targets


class SimpleSampler(_SamplerBase):
    """Uniform batches: each of ``batch_size`` rows a random class, then a
    random image of it; yields ``(paths, int_labels)``."""

    def __init__(self, class_files_paths: ClassFiles,
                 class_names: Sequence[str], batch_size: int = 32,
                 seed: int = 0):
        super().__init__(class_files_paths, class_names, seed)
        self.batch_size = batch_size

    def sample(self) -> Tuple[List[str], np.ndarray]:
        paths, labels = [], []
        for _ in range(self.batch_size):
            cls = self._random_class()
            idx = int(self.rng.integers(self.n_samples[cls]))
            paths.append(self.class_files_paths[cls][idx])
            labels.append(self.class_to_id[cls])
        return paths, np.asarray(labels, np.int32)


class ProcessShardSampler:
    """One rank's view of a global-batch sampler (data-parallel feeding).

    Every rank wraps an identically seeded sampler, so each draws the
    identical global batch; this wrapper yields rows ``[lo, hi)`` of it,
    the block :func:`~embeddingnet_tpu_torch.parallel.mesh.
    process_row_block` assigns to the rank, so a rank decodes only its
    rows. ``global_check`` (optional) runs on every global batch's labels
    before the slice: the P-K layout guard must see the global layout the
    miner asserts, not the rank's block.
    """

    def __init__(self, sampler, lo: int, hi: int, global_check=None):
        self.sampler = sampler
        self.lo, self.hi = int(lo), int(hi)
        self.global_check = global_check

    def _slice(self, paths):
        if isinstance(paths, tuple):
            return tuple(p[self.lo:self.hi] for p in paths)
        return paths[self.lo:self.hi]

    def __iter__(self):
        for paths, labels in self.sampler:
            if self.global_check is not None:
                self.global_check(labels)
            yield self._slice(paths), labels[self.lo:self.hi]
