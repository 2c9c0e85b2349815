"""Dataset index: {class_name: [image_paths]} from disk layouts (the port's
own copy of ``embeddingnet_tpu/data/index.py``, so that the port indexes a
dataset without the JAX package or its host dependencies).

``ENDataLoader`` keeps the reference's public surface: CSV annotation files
(configurable id/label columns, optional google 3-level path layout) or
folder-per-class directories (with one level of optional subdirs), a
per-class train/val split with the reference's fixed ``random_state=42``,
``flat`` views of a split, and an on-disk parse cache keyed by everything
that shapes the parse.

Two host dependencies of the JAX copy are replaced, with equal results:

* sklearn's ``train_test_split(v, test_size=r, random_state=42)`` by its
  numpy twin (:func:`split_indices`): the first ``ceil(r * n)`` entries of
  ``RandomState(42).permutation(n)`` are the val set, the rest the train
  set, each in permutation order;
* pandas' ``read_csv`` by the stdlib ``csv`` module. Classes come in the
  order of their first row and each class's images in row order, as the
  pandas version groups them. A label is the CSV's text as written, where
  pandas would first parse a numeric column (``"007"`` would become
  ``"7"``); image ids are text either way.
"""

from __future__ import annotations

import csv
import hashlib
import math
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ClassFiles = Dict[str, List[str]]

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
_SPLIT_SEED = 42


def _is_image(name: str) -> bool:
    return name.lower().endswith(_IMG_EXTS) and not name.startswith("._")


def split_indices(n: int, val_ratio: float) -> Tuple[np.ndarray, np.ndarray]:
    """(train, val) indices of ``n`` samples: what sklearn's
    ``train_test_split(range(n), test_size=val_ratio, random_state=42)``
    returns, from the same permutation."""
    perm = np.random.RandomState(_SPLIT_SEED).permutation(n)
    n_val = math.ceil(val_ratio * n)
    return perm[n_val:], perm[:n_val]


class ENDataLoader:
    """Disk index with ``.train_data``, ``.val_data``, ``.class_names``,
    ``.n_classes``, ``.n_samples`` — the attribute surface consumed by the
    reference call sites (``tools/train.py:94,110-117``)."""

    def __init__(self, dataset_path: str,
                 train_csv_file: Optional[str] = None,
                 val_csv_file: Optional[str] = None,
                 image_id_column: str = "image_id",
                 label_column: str = "label",
                 validate: bool = True,
                 val_ratio: float = 0.1,
                 is_google: bool = False,
                 cache_index: bool = True,
                 cache_dir: str = "tmp"):
        self.dataset_path = dataset_path
        self.cache_index = cache_index
        self.cache_dir = cache_dir

        if train_csv_file is not None:
            self.class_files_paths = self._load_from_csv(
                train_csv_file, image_id_column, label_column, is_google)
        else:
            self.class_files_paths = self._load_from_directory()
        self.class_names = list(self.class_files_paths.keys())

        self.n_classes = len(self.class_names)
        self.n_samples = {k: len(v) for k, v in self.class_files_paths.items()}

        self.validate = validate
        self.val_ratio = val_ratio

        if self.validate:
            if val_csv_file is not None:
                self.train_data = self.class_files_paths
                self.val_data = self._load_from_csv(
                    val_csv_file, image_id_column, label_column, is_google)
            else:
                self.train_data, self.val_data = self.split_train_val(
                    self.val_ratio)
        else:
            self.train_data = self.class_files_paths
            self.val_data: ClassFiles = {}

    # -- splits ------------------------------------------------------------

    def split_train_val(self, val_ratio: float):
        """Per-class split (:func:`split_indices`). Classes too small to
        split keep all samples in train (the reference would raise)."""
        train_data: ClassFiles = {}
        val_data: ClassFiles = {}
        for k, v in self.class_files_paths.items():
            if len(v) < 2:
                train_data[k] = v
                val_data[k] = []
                continue
            train, val = split_indices(len(v), val_ratio)
            train_data[k] = [v[i] for i in train]
            val_data[k] = [v[i] for i in val]
        return train_data, val_data

    # -- CSV layout --------------------------------------------------------

    def _cache_path(self, csv_file: str, image_id_column: str,
                    label_column: str, is_google: bool) -> str:
        stamp = str(os.path.getmtime(csv_file)) if os.path.exists(csv_file) \
            else "missing"
        # Key over everything that shapes the parsed index, not just the
        # file: re-reading the same CSV with another column mapping, layout
        # flag or dataset root must not hit a stale entry.
        key = hashlib.sha1(
            f"{os.path.abspath(csv_file)}:{stamp}:{image_id_column}:"
            f"{label_column}:{is_google}:{os.path.abspath(self.dataset_path)}"
            .encode()).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"index_{key}.pickle")

    def _load_from_csv(self, csv_file: str, image_id_column: str,
                       label_column: str, is_google: bool) -> ClassFiles:
        """CSV -> index (``datagenerators.py:60-87``), cache keyed per file."""
        cache_file = None
        if self.cache_index:
            os.makedirs(self.cache_dir, exist_ok=True)
            cache_file = self._cache_path(csv_file, image_id_column,
                                          label_column, is_google)
            if os.path.isfile(cache_file):
                with open(cache_file, "rb") as f:
                    return pickle.load(f)

        with open(csv_file, newline="") as f:
            reader = csv.DictReader(f)
            columns: Sequence[str] = reader.fieldnames or []
            for column in (image_id_column, label_column):
                if column not in columns:
                    raise ValueError(f"column {column!r} not in {csv_file} "
                                     f"(has: {list(columns)})")
            rows = [(row[image_id_column], row[label_column])
                    for row in reader]

        class_files_paths: ClassFiles = {}
        for image_id, label in rows:
            if is_google:
                # google-landmarks layout: <root>/a/b/c/abcdef....jpg
                path = os.path.join(
                    self.dataset_path,
                    f"{image_id[0]}/{image_id[1]}/{image_id[2]}/",
                    image_id + ".jpg")
            else:
                path = os.path.join(self.dataset_path, image_id)
            class_files_paths.setdefault(label, []).append(path)

        if cache_file:
            with open(cache_file, "wb") as f:
                pickle.dump(class_files_paths, f)
        return class_files_paths

    # -- folder layout -----------------------------------------------------

    def _load_from_directory(self) -> ClassFiles:
        """Folder-per-class, optional one-level subdirs
        (``datagenerators.py:89-111``)."""
        class_files_paths: ClassFiles = {}
        entries = sorted((f for f in os.scandir(self.dataset_path)
                          if f.is_dir()), key=lambda f: f.name)
        for entry in entries:
            subdirs = [f.path for f in os.scandir(entry.path) if f.is_dir()]
            files: List[str] = []
            scan_dirs = subdirs if subdirs else [entry.path]
            for d in scan_dirs:
                files.extend(sorted(
                    f.path for f in os.scandir(d)
                    if f.is_file() and _is_image(f.name)))
            class_files_paths[entry.name] = files
        return class_files_paths

    # -- flat views --------------------------------------------------------

    def flat(self, split: str = "train"):
        """(paths, labels) lists for a split, the surface
        ``EmbeddingNet.calculate_prediction_accuracy`` reads."""
        data = self.train_data if split == "train" else self.val_data
        paths, labels = [], []
        for cls, ps in data.items():
            paths.extend(ps)
            labels.extend([cls] * len(ps))
        return paths, labels
