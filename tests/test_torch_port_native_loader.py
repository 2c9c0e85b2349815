"""The port's native decoder (``data/native_loader.py``, its own copy of
the C++ source in ``csrc/enloader.cpp``) against the JAX package's, and
``BatchLoader``'s choice of decoder against JAX's.

The JAX side loads a library that the fixture compiles from
``native/enloader.cpp`` into the test's temp dir (its module's
``_LIB_PATH`` and ``_lib`` set by ``monkeypatch``), so nothing races
``native/libenloader.so`` and nothing in the JAX package changes. The
decodes are held bit for bit, exact and fast, on PNGs and JPEGs, for a
downscale, an upscale (16 -> 32 px, where the decoder and cv2 part by a
gray level: ``ROADMAP.md`` F1) and a non-square size.
"""

import logging
import multiprocessing
import os
import subprocess

import numpy as np
import pytest

from embeddingnet_tpu.data import native_loader as jnative  # noqa: E402
from embeddingnet_tpu.data import pipeline as jpipeline  # noqa: E402

from embeddingnet_tpu_torch.data import native_loader  # noqa: E402
from embeddingnet_tpu_torch.data import pipeline  # noqa: E402
from embeddingnet_tpu_torch.data.samplers import PKSampler  # noqa: E402
from embeddingnet_tpu_torch.data.index import ENDataLoader  # noqa: E402

import _torch_port_spawn as spawned  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(32, 32), (24, 40)]        # (H, W) targets: square, non-square


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's loader bound to a library built in ``tmp_path``
    from ``native/enloader.cpp`` with ``native/Makefile``'s flags."""
    lib = tmp_path / "libenloader.so"
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-fPIC",
                    "-Wall", "-shared", "-o", str(lib),
                    os.path.join(ROOT, "native", "enloader.cpp"), "-ljpeg",
                    "-lpng", "-lz", "-lpthread"], check=True,
                   capture_output=True)
    monkeypatch.setattr(jnative, "_LIB_PATH", str(lib))
    monkeypatch.setattr(jnative, "_lib", None)
    assert jnative.available()
    return jnative


@pytest.fixture
def images(tmp_path):
    """PNGs and JPEGs (quality 90) of smooth random content at 16x16 (an
    upscale to the targets), 37x53 and 96x80 (downscales, the fast path's
    2:1 and more)."""
    import cv2
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(16, 16), (37, 53), (96, 80)]):
        base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3),
                            dtype=np.uint8)
        img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
        img = np.clip(img.astype(int) + rng.integers(-12, 12, img.shape),
                      0, 255).astype(np.uint8)
        for ext, flags in ((".png", []),
                           (".jpg", [cv2.IMWRITE_JPEG_QUALITY, 90])):
            p = str(tmp_path / f"img{i}{ext}")
            cv2.imwrite(p, img, flags)
            paths.append(p)
    return paths


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_equals_the_jax_decoder(jax_native, images, shape, fast):
    h, w = shape
    got = native_loader.decode_batch(images, h, w, n_threads=3, fast=fast)
    want = jax_native.decode_batch(images, h, w, n_threads=3, fast=fast)
    assert got.shape == (len(images), h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got.min(axis=(1, 2, 3)).max() >= 0 and got.max() > 0


def test_upscale_is_cv2_within_one_gray_level(images):
    """The F1 case: 16 -> 32 px, where the decoder's bilinear and cv2's
    round apart by at most one level."""
    import cv2
    got = native_loader.decode_batch(images[:1], 32, 32)[0]
    want = cv2.resize(cv2.imread(images[0]), (32, 32))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_missing_file_leaves_a_zero_slot_and_out_is_reused(images,
                                                            tmp_path):
    out = np.full((3, 16, 16, 3), 7, np.uint8)
    got = native_loader.decode_batch(
        [images[0], str(tmp_path / "missing.png"), images[1]], 16, 16,
        out=out)
    assert got is out
    assert not out[1].any() and out[0].any() and out[2].any()
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native_loader.decode_batch(images[:2], 16, 16, out=out)


@pytest.mark.parametrize("cores,fast", [(1, False), (1, True), (8, False),
                                        (None, False)])
def test_auto_resolves_as_jax(jax_native, tiny_dataset, monkeypatch, cores,
                              fast):
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    loader = ENDataLoader(tiny_dataset, val_ratio=0.2)
    sampler = PKSampler(loader.train_data, loader.class_names, 3, 3, seed=1)
    ours = pipeline.BatchLoader(sampler, (32, 32, 3), fast_decode=fast)
    theirs = jpipeline.BatchLoader(sampler, (32, 32, 3), fast_decode=fast)
    assert ours.backend == theirs.backend
    assert ours.backend == ("native" if fast or (cores or 1) > 1
                            else "python")
    assert ours.fast_decode == fast


def test_native_backend_feeds_the_decoders_batches(tiny_dataset):
    loader = ENDataLoader(tiny_dataset, val_ratio=0.2)
    sampler = PKSampler(loader.train_data, loader.class_names, 3, 3, seed=1)
    batches = list(pipeline.BatchLoader(sampler, (32, 32, 3), n_batches=2,
                                        backend="native"))
    sampler = PKSampler(loader.train_data, loader.class_names, 3, 3, seed=1)
    for images, labels in batches:
        paths, want_labels = sampler.sample()
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_array_equal(
            images, native_loader.decode_batch(paths, 32, 32))


@pytest.fixture
def no_compiler(tmp_path, monkeypatch, caplog):
    """A build directory without a library and a compiler that is not
    there: the toolchain is missing."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_unavailable", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    caplog.set_level(logging.WARNING)
    return caplog


def test_a_missing_toolchain_is_unavailable_not_cv2(no_compiler,
                                                    tiny_dataset):
    assert not native_loader.available()
    assert "no-such-g++" in native_loader.unavailable_reason()
    loader = ENDataLoader(tiny_dataset, val_ratio=0.2)
    sampler = PKSampler(loader.train_data, loader.class_names, 3, 3, seed=1)
    # native, asked for, raises: nothing decodes with cv2 in its place
    with pytest.raises(native_loader.Unavailable, match="no-such-g\\+\\+"):
        pipeline.BatchLoader(sampler, (32, 32, 3), backend="native")
    with pytest.raises(native_loader.Unavailable):
        native_loader.decode_batch([], 8, 8)
    # auto resolves to cv2, as JAX's does; fast_decode warns
    assert pipeline.BatchLoader(sampler, (32, 32, 3)).backend == "python"
    fast = pipeline.BatchLoader(sampler, (32, 32, 3), fast_decode=True)
    assert fast.backend == "python"
    assert "fast_decode requested" in no_compiler.text
    # the compiler's message is logged once
    assert no_compiler.text.count("native decoder unavailable") == 1


def test_other_build_failures_raise(tmp_path, monkeypatch):
    bad = tmp_path / "enloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build") as e:
        native_loader.build()
    assert not isinstance(e.value, native_loader.Unavailable)


def test_two_processes_building_at_once_load_one_library(tmp_path, images):
    ctx = multiprocessing.get_context("spawn")
    start, queue = ctx.Event(), ctx.Queue()
    build_dir = tmp_path / "build"
    procs = [ctx.Process(target=spawned.build_and_decode,
                         args=(str(build_dir), start, images[0], queue))
             for _ in range(2)]
    for p in procs:
        p.start()
    start.set()
    results = [queue.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    (path_a, sum_a), (path_b, sum_b) = results
    assert path_a == path_b and sum_a == sum_b > 0
    left = sorted(os.listdir(build_dir))
    assert [f for f in left if f.endswith(".so")] == [os.path.basename(
        path_a)]
    assert not [f for f in left if f.endswith(".tmp")]
