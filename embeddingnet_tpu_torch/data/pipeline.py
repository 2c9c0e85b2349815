"""Host decode pipeline: sampler -> native or threaded cv2 decode -> uint8
batches (the port's own copy of ``embeddingnet_tpu/data/pipeline.py``).

Decoding runs on a background producer thread that keeps ``prefetch``
batches ahead of the consumer, so the device does not wait on decode: a
whole batch at once in the native C++ decoder
(:mod:`~embeddingnet_tpu_torch.data.native_loader`, ``backend="native"``),
or image by image with cv2 in a thread pool (``backend="python"``).
``backend="auto"`` picks the native decoder where the JAX loader does: on
a host with more than one core, or with ``fast_decode``, when the decoder
builds. Batches stay uint8 (BGR, NHWC); ``/255`` and augmentation run on
the device.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from embeddingnet_tpu_torch.data import native_loader
from embeddingnet_tpu_torch.data.images import get_image
from embeddingnet_tpu_torch.utils import trace


class DecodeCache:
    """In-RAM cache of decoded and resized uint8 images, shared by the
    per-epoch :class:`BatchLoader` instances (``PERFORMANCE.
    decode_cache_mb``). Exact: augmentation draws afresh on the device, so
    a cached image equals a re-decode. It stops inserting once its byte
    budget is full (epoch access is near-uniform, so evictions would
    thrash)."""

    def __init__(self, budget_mb: int):
        self.budget = int(budget_mb) * (1 << 20)
        self._data = {}
        self._bytes = 0
        self._lock = threading.Lock()

    def get_many(self, paths):
        with self._lock:
            return [self._data.get(p) for p in paths]

    def put(self, path, img: np.ndarray):
        if img.base is not None:
            # never keep a view: a row of a batch buffer would pin the
            # whole buffer while the budget counts only the row
            img = img.copy()
        with self._lock:
            if path in self._data or self._bytes + img.nbytes > self.budget:
                return
            self._data[path] = img
            self._bytes += img.nbytes


class BatchLoader:
    """Iterate uint8 batches from a sampler.

    ``sampler`` yields ``(paths, labels)``, where ``paths`` is a list of
    file paths or a tuple of such lists (triplets). The output mirrors that
    structure with stacked uint8 arrays [B, H, W, 3] (BGR); a file that
    does not decode leaves its row zero.
    """

    def __init__(self, sampler, input_shape: Sequence[int],
                 num_workers: int = 8, prefetch: int = 4,
                 n_batches: Optional[int] = None, backend: str = "auto",
                 fast_decode: bool = False,
                 cache: Optional[DecodeCache] = None):
        self.sampler = sampler
        self.input_shape = tuple(input_shape)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.n_batches = n_batches
        self._cache = cache
        # PERFORMANCE.fast_decode: the native decoder's DCT-prescaled JPEG
        # path (approximate, native_loader.decode_batch)
        self.fast_decode = bool(fast_decode)
        if backend == "auto":
            # the native decoder wins by decoding on many cores without the
            # GIL (or by the fast path); on one core cv2's SIMD decode is
            # faster, as the JAX loader measured
            multi_core = (os.cpu_count() or 1) > 1
            backend = ("native" if (multi_core or self.fast_decode)
                       and native_loader.available() else "python")
        if backend not in ("native", "python"):
            raise ValueError(f"unknown decode backend {backend!r}")
        self.backend = backend
        if backend == "native":
            # asked for or resolved: a decoder that cannot be built raises
            # here, and nothing decodes with cv2 in its place
            native_loader.load()
        if self.fast_decode and self.backend != "native":
            logging.getLogger(__name__).warning(
                "fast_decode requested but native loader unavailable; "
                "using exact cv2 decode")

    def _decode_many(self, pool: ThreadPoolExecutor,
                     paths: Sequence[str]) -> np.ndarray:
        h, w = self.input_shape[0], self.input_shape[1]
        if self._cache is None:
            return self._decode_uncached(pool, paths)
        out = np.zeros((len(paths), h, w, 3), np.uint8)
        miss_idx = []
        for i, im in enumerate(self._cache.get_many(paths)):
            if im is not None:
                out[i] = im
            else:
                miss_idx.append(i)
        if miss_idx:
            decoded = self._decode_uncached(
                pool, [paths[i] for i in miss_idx])
            for j, i in enumerate(miss_idx):
                out[i] = decoded[j]
                self._cache.put(paths[i], decoded[j])
        return out

    def _decode_uncached(self, pool: ThreadPoolExecutor,
                         paths: Sequence[str]) -> np.ndarray:
        h, w = self.input_shape[0], self.input_shape[1]
        if self.backend == "native":
            # the whole batch in C++ threads, straight into its buffer
            return native_loader.decode_batch(paths, h, w,
                                              n_threads=self.num_workers,
                                              fast=self.fast_decode)
        imgs = list(pool.map(lambda p: get_image(p, self.input_shape), paths))
        out = np.zeros((len(paths), h, w, 3), np.uint8)
        for i, im in enumerate(imgs):
            if im is not None:
                out[i] = im
        return out

    def _decode_batch(self, pool, item):
        paths, labels = item
        if isinstance(paths, tuple):
            images = tuple(self._decode_many(pool, p) for p in paths)
        else:
            images = self._decode_many(pool, paths)
        return images, labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields batches; a background thread keeps ``prefetch`` batches
        decoded ahead of the consumer."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()
        error = []

        def producer():
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            try:
                it = iter(self.sampler)
                count = 0
                while not stop.is_set():
                    if self.n_batches is not None and count >= self.n_batches:
                        break
                    try:
                        item = next(it)
                    except StopIteration:
                        # a finite sampler is exhausted: end the epoch by
                        # the sentinel below
                        break
                    batch = self._decode_batch(pool, item)
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    count += 1
            except Exception as e:      # raised in the consumer
                error.append(e)
            finally:
                pool.shutdown(wait=False)
                # the sentinel must arrive, or the consumer blocks on
                # q.get() for ever (an epoch-end hang whenever decode
                # outpaces compute and the queue is full): retry until it
                # is taken or the consumer has stopped
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.2)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with trace.span("data.get"):
                    item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
