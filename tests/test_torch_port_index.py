"""The port's dataset index, ``embeddingnet_tpu_torch.data.ENDataLoader``,
against the JAX package's: on the folder layout of ``tiny_dataset`` (plus a
class of one image and a class kept in subfolders) and on small CSVs, plain
and in the google-landmarks layout, the two give the same classes, the
same train/val split at val ratios 0.1 and 0.2 and the same flat views.
The port splits with numpy where JAX calls sklearn, and reads CSVs with the
stdlib where JAX calls pandas. Each side keeps its own parse cache."""

import csv
import os

import pytest

pytest.importorskip("torch")

from embeddingnet_tpu.data import ENDataLoader as JENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402

# (image id, label) rows: classes out of order, numeric labels (pandas
# parses them as ints), a class of one image
CSV_ROWS = ([(f"ab{i:02d}cd", str(7 - i % 3)) for i in range(29)]
            + [(f"ef{i:02d}gh", "12") for i in range(5)]
            + [("ij00kl", "4")])


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "wb").close()


def _write_csv(path, rows, columns=("image_id", "label")):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(columns)
        writer.writerows(rows)
    return str(path)


def _folder(tiny_dataset):
    """tiny_dataset plus a one-image class and a class in two subfolders
    (with a file the index skips)."""
    _touch(os.path.join(tiny_dataset, "class_single", "img_0.png"))
    for sub, n in (("a", 3), ("b", 4)):
        for i in range(n):
            _touch(os.path.join(tiny_dataset, "class_nested", sub,
                                f"img_{i}.jpg"))
    _touch(os.path.join(tiny_dataset, "class_nested", "a", "._img_9.jpg"))
    return tiny_dataset


def _both(tmp_path, dataset, **kw):
    return [cls(dataset, cache_dir=str(tmp_path / name), **kw)
            for name, cls in (("jax", JENDataLoader), ("port", ENDataLoader))]


def _assert_equal(jax_loader, port_loader):
    assert port_loader.class_names == jax_loader.class_names
    assert port_loader.n_classes == jax_loader.n_classes
    assert port_loader.n_samples == jax_loader.n_samples
    assert port_loader.train_data == jax_loader.train_data
    assert port_loader.val_data == jax_loader.val_data
    for split in ("train", "val"):
        assert port_loader.flat(split) == jax_loader.flat(split)


@pytest.mark.parametrize("val_ratio", [0.1, 0.2])
@pytest.mark.parametrize("layout", ["folder", "csv", "google_csv"])
def test_index_and_split_equal_jax(tiny_dataset, tmp_path, layout,
                                   val_ratio):
    if layout == "folder":
        dataset, kw = _folder(tiny_dataset), {}
    else:
        dataset = str(tmp_path / "images")
        kw = {"train_csv_file": _write_csv(tmp_path / "train.csv", CSV_ROWS),
              "is_google": layout == "google_csv"}
    jax_loader, port_loader = _both(tmp_path, dataset, val_ratio=val_ratio,
                                    **kw)
    _assert_equal(jax_loader, port_loader)
    sizes = port_loader.n_samples
    single = "class_single" if layout == "folder" else "4"
    assert sizes[single] == 1 and port_loader.val_data[single] == []
    assert any(len(v) for v in port_loader.val_data.values())


def test_val_csv_and_no_validation_equal_jax(tmp_path):
    dataset = str(tmp_path / "images")
    train = _write_csv(tmp_path / "train.csv", CSV_ROWS[:20])
    val = _write_csv(tmp_path / "val.csv", CSV_ROWS[20:])
    _assert_equal(*_both(tmp_path, dataset, train_csv_file=train,
                         val_csv_file=val))
    _assert_equal(*_both(tmp_path, dataset, train_csv_file=train,
                         validate=False, cache_index=False))


def test_csv_cache_is_keyed_and_reread(tmp_path):
    """The parse is cached per CSV, column mapping and root: a second
    loader reads the cache; another label column parses anew."""
    dataset = str(tmp_path / "images")
    rows = [(i, l, "x" if int(l) % 2 else "y") for i, l in CSV_ROWS]
    path = _write_csv(tmp_path / "train.csv", rows,
                      ("image_id", "label", "other"))
    cache = tmp_path / "cache"
    first = ENDataLoader(dataset, train_csv_file=path, cache_dir=str(cache))
    assert len(os.listdir(cache)) == 1
    again = ENDataLoader(dataset, train_csv_file=path, cache_dir=str(cache))
    assert again.class_files_paths == first.class_files_paths
    other = ENDataLoader(dataset, train_csv_file=path, label_column="other",
                         cache_dir=str(cache))
    assert other.class_names == ["x", "y"] and len(os.listdir(cache)) == 2


def test_missing_csv_column_raises(tmp_path):
    path = _write_csv(tmp_path / "train.csv", CSV_ROWS)
    for cls in (JENDataLoader, ENDataLoader):
        with pytest.raises(ValueError, match="'file'"):
            cls(str(tmp_path), train_csv_file=path, image_id_column="file",
                cache_index=False)
