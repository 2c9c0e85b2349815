"""The seeded dataset: made from the seed, written once into the cache
directory and read again by a later run, the least recently used removed
beyond ``KEEP``."""

import os

import numpy as np

from benchmark import data


def _files(path):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(path)
                  for f in fs)


def test_a_second_run_reads_what_the_first_wrote():
    path = data.seeded_dataset(2 ** 31 + 3, 3, 2, 16)
    files = _files(path)
    assert len(files) == 6
    stamps = [os.stat(f).st_mtime_ns for f in files]
    assert data.seeded_dataset(2 ** 31 + 3, 3, 2, 16) == path
    assert [os.stat(f).st_mtime_ns for f in files] == stamps
    other = data.seeded_dataset(2 ** 31 + 4, 3, 2, 16)
    assert other != path
    import cv2
    a, b = (cv2.imread(_files(p)[0]) for p in (path, other))
    assert a.shape == (16, 16, 3) and not np.array_equal(a, b)


def test_the_least_recently_used_go(monkeypatch):
    monkeypatch.setattr(data, "KEEP", 2)
    paths = [data.seeded_dataset(s, 2, 1, 8) for s in (1, 2, 3)]
    assert not os.path.exists(paths[0])
    assert all(os.path.isdir(p) for p in paths[1:])
    assert not [p for p in os.listdir(data.cache_dir())
                if p.endswith(".part")]
