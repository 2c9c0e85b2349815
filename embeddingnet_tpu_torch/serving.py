"""Serving: micro-batched embedding + kNN inference (port of
``embeddingnet_tpu/serving.py``).

A collector thread drains the request queue up to ``max_batch`` images and
runs one device batch for the whole bucket, padded to ``max_batch`` so every
batch has one shape. Endpoints are those of the JAX server (``/classify``,
``/classify_batch`` with big-endian framing, ``/embed``, ``/healthz``):
:func:`make_server` reuses its framework-free HTTP handler, which talks to
the engine only through ``infer_one``/``infer_many`` and its metadata.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, List, Optional

import numpy as np
import torch

from embeddingnet_tpu_torch.ops import knn as knn_ops


class InferenceEngine:
    """Micro-batching wrapper around an
    :class:`~embeddingnet_tpu_torch.models.api.EmbeddingNet` and its DB."""

    def __init__(self, net, max_batch: int = 32,
                 max_wait_ms: float = 2.0, quantize_db: bool = False):
        self.net = net
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.quantized = quantize_db
        db_emb, label_ids, classes = net._db()
        self.classes = classes
        self.labels = net.encoded_training_data["labels"]
        self._db_labels = torch.as_tensor(label_ids, device=net.device)
        db = torch.as_tensor(db_emb, device=net.device)
        if quantize_db:
            # int8 DB: 4x less device memory for the encodings
            self._db_values, self._db_scales = knn_ops.quantize_db(db)
            self._db_emb = None
        else:
            self._db_emb = db
        self.k = min(net.k, len(label_ids))
        self.k5 = min(5, len(label_ids))
        # device batches run so far, the warm-up included
        self.device_batches = 0
        self._count_lock = threading.Lock()

        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.ready = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        # The warm-up batch (kernel build, cuDNN and cuBLAS set-up) runs on
        # the collector thread itself: PyTorch keeps a cuBLAS handle per
        # thread, so a warm-up on another thread would leave the first
        # request to create the collector's. /healthz reports ready after.
        self._warmup()
        self._loop()

    def _infer(self, images: np.ndarray):
        """One device batch: uint8 [max_batch, H, W, 3] ->
        (embeddings, predicted class ids, top-5 DB indices) on the host."""
        with torch.inference_mode():
            emb = self.net.embed(torch.from_numpy(images))
            if self.quantized:
                pred, idxs = knn_ops.knn_classify_quantized(
                    self._db_values, self._db_scales, self._db_labels, emb,
                    k=max(self.k, self.k5), n_classes=len(self.classes))
                idx5 = idxs[:, :self.k5]
            else:
                pred, _ = knn_ops.knn_classify(
                    self._db_emb, self._db_labels, emb, k=self.k,
                    n_classes=len(self.classes))
                _, idx5 = knn_ops.knn_neighbors(self._db_emb, emb,
                                                k=self.k5)
            out = emb.cpu().numpy(), pred.cpu().numpy(), idx5.cpu().numpy()
        with self._count_lock:
            self.device_batches += 1
        return out

    def _warmup(self):
        h, w, _ = self.net.input_shape
        self._infer(np.zeros((self.max_batch, h, w, 3), np.uint8))
        self.ready.set()

    def _decode(self, data: bytes) -> Optional[np.ndarray]:
        import cv2
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            return None
        # cv2 dsize is (W, H); input_shape is (H, W, C)
        return cv2.resize(img, (self.net.input_shape[1],
                                self.net.input_shape[0]))

    def _loop(self):
        """Collector: drain up to max_batch requests, one device batch."""
        h, w, _ = self.net.input_shape
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            bucket = [first]
            while len(bucket) < self.max_batch:
                try:
                    bucket.append(self._queue.get(timeout=self.max_wait_s))
                except queue.Empty:
                    break
            images = np.zeros((self.max_batch, h, w, 3), np.uint8)
            for i, (img, _event, _out) in enumerate(bucket):
                images[i] = img
            emb, pred, idx5 = self._infer(images)
            for i, (_img, event, out) in enumerate(bucket):
                out["embedding"] = emb[i]
                out["label"] = self.classes[int(pred[i])]
                out["top5"] = [self.labels[int(j)] for j in idx5[i]]
                event.set()

    def infer_arrays(self, images: Iterable[Optional[np.ndarray]],
                     timeout: float = 120.0) -> List[Optional[dict]]:
        """Decoded uint8 [H, W, 3] images (None for a failed decode) ->
        one result dict each, in order. Images are queued as the iterable
        yields them, so they share device batches with other requests."""
        if not self.ready.wait(timeout):
            raise TimeoutError("model still warming up; try again")
        shape = tuple(self.net.input_shape[:2]) + (3,)
        pending = []
        for img in images:
            if img is None:
                pending.append(None)
                continue
            if img.shape != shape or img.dtype != np.uint8:
                raise ValueError(f"images must be uint8 {shape}, got "
                                 f"{img.dtype} {img.shape}")
            event = threading.Event()
            out: dict = {}
            self._queue.put((img, event, out))
            pending.append((event, out))
        results = []
        for item in pending:
            if item is None:
                results.append(None)
                continue
            event, out = item
            if not event.wait(timeout):
                raise TimeoutError("inference timed out")
            results.append(out)
        return results

    def infer_many(self, images_bytes, timeout: float = 120.0):
        """Encoded images -> results (None where decoding failed)."""
        if not self.ready.wait(timeout):
            raise TimeoutError("model still warming up; try again")
        return self.infer_arrays((self._decode(d) for d in images_bytes),
                                 timeout)

    def infer_one(self, image_bytes: bytes, timeout: float = 120.0) -> dict:
        if not self.ready.wait(timeout):
            raise TimeoutError("model still warming up; try again")
        img = self._decode(image_bytes)
        if img is None:
            raise ValueError("could not decode image bytes")
        return self.infer_arrays([img], timeout)[0]

    def close(self):
        self._stop.set()
        self._worker.join(timeout=2)


def make_server(engine: InferenceEngine, host: str = "127.0.0.1",
                port: int = 8000):
    """The JAX package's ``ThreadingHTTPServer`` over this engine. Its
    handler is plain host code (stdlib HTTP and JSON); importing it needs
    the JAX package's host dependencies (PyYAML), not JAX."""
    from embeddingnet_tpu.serving import make_server as _make_server
    return _make_server(engine, host, port)
