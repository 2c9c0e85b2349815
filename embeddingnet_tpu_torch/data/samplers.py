"""P-K batch sampler (the port's own copy of ``PKSampler`` in
``embeddingnet_tpu/data/samplers.py``).

``k_classes`` classes without replacement x ``k_samples`` images with
replacement, drawn from a numpy generator seeded by the caller: the same
seed gives the same batches as the JAX package's sampler. A batch is
grouped (each class's ``k_samples`` images are adjacent), which is the
layout the batch-all P-K fast path asserts.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

ClassFiles = Dict[str, List[str]]


class PKSampler:
    """P-K batches: ``k_classes`` x ``k_samples``; yields ``(paths,
    int_labels)``, the labels being each class's index in
    ``class_names``."""

    def __init__(self, class_files_paths: ClassFiles,
                 class_names: Sequence[str], k_classes: int = 5,
                 k_samples: int = 5, seed: int = 0):
        # keep only classes that have samples
        self.class_files_paths = {c: v for c, v in class_files_paths.items()
                                  if len(v) > 0}
        self.class_names = [c for c in class_names
                            if c in self.class_files_paths]
        self.n_classes = len(self.class_names)
        self.class_to_id = {c: i for i, c in enumerate(class_names)}
        self.rng = np.random.default_rng(seed)
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

    def __iter__(self) -> Iterator[Tuple[List[str], np.ndarray]]:
        while True:
            yield self.sample()
