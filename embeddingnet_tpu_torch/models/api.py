"""High-level model API: :class:`EmbeddingNet`, :class:`TripletNet` and
:class:`SiameseNet` (port of ``embeddingnet_tpu/models/api.py``).

Holds the :class:`~embeddingnet_tpu_torch.models.registry.EmbeddingModule`
on an explicit device and exposes the reference's methods:
``generate_encodings``, ``encode_dataset`` (the bulk encode),
``save_encodings``, ``load_encodings``, ``train_embeddings_classifier``,
``predict``, ``predict_knn``, ``calculate_prediction_accuracy``,
``save_base_model`` / ``load_model``, and ``save_exported`` (alias
``save_onnx``), a ``torch.export`` program in place of the JAX package's
StableHLO file. ``params`` is the JAX package's parsed config
(``embeddingnet_tpu_torch.config.parse_params``) or a plain dict with the
same lower-case sections; ``model``, ``general``, ``encodings`` and
``performance`` (``bn_momentum`` only) are read.

Images are uint8 (or float 0..255) BGR NHWC; ``/255`` happens on the
device. Decoding image files (``embeddingnet_tpu_torch.data.images``)
needs cv2, which is imported only where a file is read.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import random
import warnings
from typing import Any, Dict

import numpy as np
import torch

from embeddingnet_tpu_torch.models.registry import EmbeddingModule
from embeddingnet_tpu_torch.ops import knn as knn_ops


class EmbeddingNet:
    """Base model class (the reference's ``embedding_net/models.py:22``).

    ``fast_conv`` and ``dtype`` go to :class:`EmbeddingModule`; their
    defaults reproduce the JAX ``EmbeddingNet`` (plain convs, f32). The
    Trainer's encoder is ``fast_conv=PERFORMANCE.pallas_conv,
    dtype=PERFORMANCE.compute_dtype``. Weights are drawn from a
    ``torch.Generator`` seeded with ``GENERAL.seed``.
    """

    def __init__(self, params, *, device, fast_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        self.params = params
        self.params_model = params["model"]
        self.params_general = params["general"]
        self.device = torch.device(device)
        self.fast_conv = fast_conv
        self.dtype = dtype
        self.encoded_training_data: Dict[str, Any] = {}
        if self.device.type == "cuda":
            # f32 matmuls and convs stay f32 (the kNN distances cancel
            # badly in TF32; hopper-kernels guide, "Numbers that differ")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._create_base_model()

    @classmethod
    def for_inference(cls, params, weights: str, encodings: str, *, device):
        """The config's encoder on ``device`` with the base model
        ``weights`` (:meth:`save_base_model`'s file) and the encodings DB
        ``encodings`` loaded, computing as ``PERFORMANCE.compute_dtype``
        and ``PERFORMANCE.pallas_conv`` say (the inference CLIs' and the
        server's encoder)."""
        perf = params["performance"]
        net = cls(params, device=device, fast_conv=perf["pallas_conv"],
                  dtype=getattr(torch, perf["compute_dtype"]))
        net.load_model(weights)
        net.load_encodings(encodings)
        return net

    # -- construction ------------------------------------------------------

    def _create_base_model(self):
        m = self.params_model
        # ArcFace trains cosine structure only, so retrieval is on the
        # hypersphere whatever the config says (as in the JAX package)
        normalize = bool(m["embeddings_normalization"]
                         or m.get("mode") == "arcface")
        performance = self.params.get("performance") or {}
        # the architecture, for the export's copy too
        self._architecture = dict(
            backbone_name=m["backbone_name"],
            encodings_len=m["encodings_len"],
            embeddings_normalization=normalize,
            bn_momentum=performance.get("bn_momentum", 0.99),
            dtype=self.dtype, input_shape=m.get("input_shape"))
        self.module = EmbeddingModule(fast_conv=self.fast_conv,
                                      **self._architecture)
        generator = torch.Generator().manual_seed(
            int(self.params_general.get("seed", 42)))
        self.module.reset_parameters(generator)
        self.module.to(self.device).eval()

    @property
    def input_shape(self):
        return tuple(self.params_model["input_shape"])

    @property
    def k(self) -> int:
        """``ENCODINGS.knn_k`` (1 when unset)."""
        enc = self.params.get("encodings") or {}
        return int(enc.get("knn_k", 1) or 1)

    # -- encoding ----------------------------------------------------------

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 or float [B, H, W, 3] tensor (0..255) -> f32 embeddings on
        the device. The caller holds inference or no-grad mode."""
        x = images.to(self.device, non_blocking=True).float() / 255.0
        return self.module(x).float()

    def encode(self, images: np.ndarray) -> np.ndarray:
        """uint8/float [B, H, W, 3] BGR batch -> f32 embeddings [B, D]."""
        with torch.inference_mode():
            emb = self.embed(torch.as_tensor(np.asarray(images)))
            return emb.cpu().numpy()

    def generate_encodings(self, data_loader, max_n_samples: int = 10,
                           shuffle: bool = True) -> Dict[str, Any]:
        """Per-class capped encoding DB (``models.py:61-84``):
        ``{'paths', 'labels', 'encodings', 'weights_fingerprint'}``."""
        from embeddingnet_tpu_torch.data.images import get_images
        data_paths, data_labels, data_encodings = [], [], []
        rng = random.Random(self.params_general.get("seed", 42))
        for class_name in data_loader.class_names:
            data_list = list(data_loader.train_data[class_name])
            if len(data_list) > max_n_samples:
                if shuffle:
                    rng.shuffle(data_list)
                data_list = data_list[:max_n_samples]
            if not data_list:
                continue
            imgs = get_images(data_list, self.input_shape)
            if imgs.size == 0:
                continue
            for path, encod in zip(data_list, self.encode(imgs)):
                data_paths.append(path)
                data_labels.append(class_name)
                data_encodings.append(encod)
        self.encoded_training_data = {
            "paths": data_paths,
            "labels": data_labels,
            "encodings": np.squeeze(np.array(data_encodings)),
            # encodings are only valid with the weights that produced them
            "weights_fingerprint": self.weights_fingerprint(),
        }
        return self.encoded_training_data

    def weights_fingerprint(self) -> str:
        """sha1 of the encoder's ``state_dict``, order-insensitive, without
        the ``classifier`` head (it plays no part in encodings). Parameters
        are f32 whatever the compute dtype, so ``fast_conv`` and ``dtype``
        leave it unchanged."""
        h = hashlib.sha1()
        for name, t in sorted(self.module.state_dict().items()):
            if name.split(".")[0] == "classifier":
                continue
            arr = t.detach().cpu().contiguous().numpy()
            h.update(name.encode())
            h.update(f"{arr.dtype}{arr.shape}".encode())
            h.update(arr.tobytes())
        return h.hexdigest()[:16]

    def encode_dataset(self, paths, batch_size: int = 256,
                       num_workers: int = 8) -> np.ndarray:
        """Bulk encode of image files: f32 embeddings [N, D] in the order
        of ``paths`` ((0, D) for none). The port's
        :class:`~embeddingnet_tpu_torch.data.pipeline.BatchLoader` decodes
        batches of ``batch_size`` on ``num_workers`` threads (the native
        decoder where its ``auto`` picks it, as the JAX loader does, else
        cv2), a batch ahead of the device; a file that does not decode encodes a
        zero image. The tail batch is encoded as it is (no compiled shape
        to pad to); the embeddings stay on the device until the end."""
        from embeddingnet_tpu_torch.data.pipeline import BatchLoader
        paths = list(paths)

        class _ListSampler:
            def __iter__(self):
                for start in range(0, len(paths), batch_size):
                    chunk = paths[start:start + batch_size]
                    yield chunk, np.zeros(len(chunk), np.int32)

        loader = BatchLoader(_ListSampler(), self.input_shape,
                             num_workers=num_workers)
        out = []
        with torch.inference_mode():
            for images, _ in loader:
                out.append(self.embed(torch.from_numpy(images)))
            if not out:
                return np.zeros((0, self.params_model["encodings_len"]),
                                np.float32)
            return torch.cat(out).cpu().numpy()

    def save_encodings(self, encoded_training_data,
                       save_folder: str = "./",
                       save_file_name: str = "encodings.pkl"):
        """Pickle the DB — the JAX package's file contract."""
        with open(os.path.join(save_folder, save_file_name), "wb") as f:
            pickle.dump(encoded_training_data, f)

    def load_encodings(self, path_to_encodings: str):
        """Load a DB written by :meth:`save_encodings` (a pickle: load only
        files this program wrote); warn if other weights made it."""
        with open(path_to_encodings, "rb") as f:
            self.encoded_training_data = pickle.load(f)
        fp = self.encoded_training_data.get("weights_fingerprint")
        if fp is not None and fp != self.weights_fingerprint():
            warnings.warn(
                "encodings DB was produced by different weights than the "
                "loaded model (fingerprint mismatch) — predictions will be "
                "meaningless; re-run generate_encodings or load the "
                "matching base_model", stacklevel=2)
        return self.encoded_training_data

    # -- classifier over encodings ----------------------------------------

    def train_embeddings_classifier(self, data_loader, classification_model,
                                    max_n_samples: int = 10,
                                    shuffle: bool = True):
        """Fit a classifier on the DB (the reference's
        ``models.py:52-59``): :meth:`generate_encodings`, then
        ``classification_model.fit(encodings, labels)`` (any object with
        an sklearn-style ``fit``), stored under
        ``encoded_training_data["knn_classifier"]`` and returned."""
        encodings = self.generate_encodings(data_loader,
                                            max_n_samples=max_n_samples,
                                            shuffle=shuffle)
        classification_model.fit(encodings["encodings"], encodings["labels"])
        self.encoded_training_data["knn_classifier"] = classification_model
        return classification_model

    # -- inference ---------------------------------------------------------

    def _load_query(self, image) -> np.ndarray:
        import cv2
        if isinstance(image, str):
            img = cv2.imread(image)
            if img is None:
                raise FileNotFoundError(f"image does not exist: {image}")
        else:
            img = image
        img = cv2.resize(img, (self.input_shape[0], self.input_shape[1]))
        return img[None]

    def _db(self):
        db = self.encoded_training_data
        if not db:
            raise RuntimeError(
                "no encodings loaded; call generate_encodings or "
                "load_encodings first")
        labels = db["labels"]
        classes = sorted(set(labels))
        class_to_id = {c: i for i, c in enumerate(classes)}
        label_ids = np.array([class_to_id[l] for l in labels], np.int32)
        return np.asarray(db["encodings"], np.float32), label_ids, classes

    def _db_on_device(self):
        db_emb, label_ids, classes = self._db()
        return (torch.as_tensor(db_emb, device=self.device),
                torch.as_tensor(label_ids, device=self.device), classes)

    def predict(self, image) -> str:
        """Label of the nearest DB entry."""
        emb = self.encode(self._load_query(image))
        db_emb, _, _ = self._db()
        d2 = np.sum((db_emb - emb) ** 2, axis=1)
        return self.encoded_training_data["labels"][int(np.argmin(d2))]

    def predict_knn(self, image, with_top5: bool = False):
        """kNN vote on the device, ``k = ENCODINGS.knn_k``."""
        emb = torch.as_tensor(self.encode(self._load_query(image)),
                              device=self.device)
        db_emb, db_labels, classes = self._db_on_device()
        pred, _ = knn_ops.knn_classify(db_emb, db_labels, emb, k=self.k,
                                       n_classes=len(classes))
        predicted_label = classes[int(pred[0])]
        if with_top5:
            _, idx5 = knn_ops.knn_neighbors(db_emb, emb,
                                            k=min(5, len(db_labels)))
            top5 = [self.encoded_training_data["labels"][int(i)]
                    for i in idx5[0].tolist()]
            return predicted_label, top5
        return predicted_label

    def calculate_prediction_accuracy(self, data_loader,
                                      batch_size: int = 256):
        """top-1 / top-5 over the val split, one encode and one kNN per
        batch."""
        from embeddingnet_tpu_torch.data.images import get_images
        val_paths, val_labels = data_loader.flat("val")
        if not val_paths:
            return {"top1": 0.0, "top5": 0.0}
        db_emb, db_labels, classes = self._db_on_device()
        labels = self.encoded_training_data["labels"]
        correct_top1 = correct_top5 = total = 0
        for start in range(0, len(val_paths), batch_size):
            chunk_labels = val_labels[start:start + batch_size]
            imgs = get_images(val_paths[start:start + batch_size],
                              self.input_shape)
            if imgs.size == 0:
                continue
            emb = torch.as_tensor(self.encode(imgs), device=self.device)
            pred, _ = knn_ops.knn_classify(db_emb, db_labels, emb, k=1,
                                           n_classes=len(classes))
            _, idx5 = knn_ops.knn_neighbors(db_emb, emb,
                                            k=min(5, len(db_labels)))
            for i, true_label in enumerate(chunk_labels):
                total += 1
                correct_top1 += classes[int(pred[i])] == true_label
                correct_top5 += true_label in {labels[j]
                                               for j in idx5[i].tolist()}
        return {"top1": correct_top1 / max(total, 1),
                "top5": correct_top5 / max(total, 1)}

    # -- persistence -------------------------------------------------------

    def save_base_model(self, save_folder: str,
                        file_name: str = "base_model.pt"):
        """The encoder's ``state_dict`` (``torch.save``) plus the
        architecture in ``<file>.json``."""
        os.makedirs(save_folder, exist_ok=True)
        path = os.path.join(save_folder, file_name)
        torch.save({k: v.detach().cpu()
                    for k, v in self.module.state_dict().items()}, path)
        meta = {
            "backbone_name": self.params_model["backbone_name"],
            "encodings_len": self.params_model["encodings_len"],
            "embeddings_normalization":
                self.params_model["embeddings_normalization"],
            "input_shape": list(self.input_shape),
        }
        with open(path + ".json", "w") as f:
            json.dump(meta, f)
        return path

    def load_model(self, file_path: str):
        """Restore weights saved by :meth:`save_base_model` (see
        :meth:`load_encoder_state`)."""
        saved = torch.load(file_path, map_location="cpu", weights_only=True)
        return self.load_encoder_state(saved, source=file_path)

    def load_encoder_state(self, state, source: str = "the state dict"):
        """Load an encoder ``state_dict``. Only the ``classifier`` head may
        be missing (an encoder-only export, or a siamese or arcface
        encoder, keeps a fresh head); any other missing key raises, and keys the model lacks
        warn and are ignored."""
        template = self.module.state_dict()
        missing = [k for k in template if k not in state
                   and k.split(".")[0] != "classifier"]
        if missing:
            raise KeyError(
                f"checkpoint is missing required keys {missing[:8]} — wrong "
                f"architecture or truncated file ({source})")
        extra = sorted(set(state) - set(template))
        if extra:
            warnings.warn(f"checkpoint has keys not in the model: "
                          f"{extra[:8]} — ignored", stacklevel=2)
        self.module.load_state_dict(
            {k: v for k, v in state.items() if k in template}, strict=False)
        return self

    def save_exported(self, save_folder: str,
                      save_name: str = "base_model.pt2") -> str:
        """The encoder as a ``torch.export`` program file
        (``torch.export.save``; load with ``torch.export.load(path)
        .module()``): f32 NHWC images already divided by 255, [1, H, W, 3]
        as the JAX package exports, in, f32 embeddings out; eval mode.

        The program is traced on the library path: a copy of the encoder
        built with ``fast_conv`` off (cuDNN or the CPU's convs in place of
        the hand-written kernels, which are not ``torch.library`` ops and
        are built at run time), carrying the same ``state_dict``, its
        BatchNorms traced as PyTorch's ops (``ops/batchnorm.py`` takes the
        plain version on the tracer's fake tensors), so the file loads
        where the kernels' build does not exist. It is a file
        format, not the serving path: :meth:`embed`, :meth:`encode_dataset`
        and the kNN keep running the kernels."""
        copy = EmbeddingModule(fast_conv=False, **self._architecture)
        copy.load_state_dict(self.module.state_dict())
        copy.to(self.device).eval()
        x = torch.zeros((1,) + self.input_shape, dtype=torch.float32,
                        device=self.device)
        program = torch.export.export(_FloatOutput(copy), (x,))
        os.makedirs(save_folder, exist_ok=True)
        path = os.path.join(save_folder, save_name)
        torch.export.save(program, path)
        return path

    # the reference's method name
    save_onnx = save_exported


class _FloatOutput(torch.nn.Module):
    """An encoder whose embeddings come out in f32."""

    def __init__(self, encoder: torch.nn.Module):
        super().__init__()
        self.encoder = encoder

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x).float()


class TripletNet(EmbeddingNet):
    """Three shared-weight streams (the reference's ``models.py:164-189``):
    the streams are the one encoder; :meth:`merged_forward` gives the
    concatenated ``[enc_a ‖ enc_p ‖ enc_n]`` output."""

    def merged_forward(self, anchors, positives, negatives) -> np.ndarray:
        embs = [self.encode(x) for x in (anchors, positives, negatives)]
        return np.concatenate(embs, axis=-1)


class SiameseNet(EmbeddingNet):
    """Two shared streams and a distance head (the reference's
    ``models.py:192-236``): ``MODEL.distance_type`` ``l1`` scores a pair
    with Dense(1, sigmoid) on ``|e1 - e2|`` (``l1_head``, Keras-initialised
    from ``GENERAL.seed``, as the JAX ``SiameseNet`` initialises its own),
    ``l2`` with the euclidean distance."""

    def __init__(self, params, *, device, fast_conv: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(params, device=device, fast_conv=fast_conv,
                         dtype=dtype)
        from embeddingnet_tpu_torch.models.heads import (SiameseL1Head,
                                                         init_keras_)
        self.distance_type = self.params_model["distance_type"]
        self.l1_head = None
        if self.distance_type == "l1":
            self.l1_head = SiameseL1Head(self.params_model["encodings_len"])
            init_keras_(self.l1_head, torch.Generator().manual_seed(
                int(self.params_general.get("seed", 42))))
            self.l1_head.to(self.device)

    def pair_forward(self, images_1, images_2) -> np.ndarray:
        """The distance output for a batch of pairs, as numpy [B]."""
        from embeddingnet_tpu_torch.models.heads import siamese_l2_distance
        e1 = torch.as_tensor(self.encode(images_1), device=self.device)
        e2 = torch.as_tensor(self.encode(images_2), device=self.device)
        with torch.inference_mode():
            d = (self.l1_head(e1, e2) if self.distance_type == "l1"
                 else siamese_l2_distance(e1, e2))
        return d.float().cpu().numpy()
