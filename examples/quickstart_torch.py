#!/usr/bin/env python
"""End-to-end quickstart of the PyTorch port: dataset -> train -> encodings
DB -> classify.

The same five steps as ``examples/quickstart.py``, with the port's
modules: it generates the same seeded folder-per-class dataset of coloured
blobs, trains ``simple2`` with in-step semihard mining for two epochs,
exports the encoder and the encodings database, classifies a held-out
image and prints the val recall. It runs on the card by default and on the
CPU with ``--device cpu`` (about a minute there).

Run from the repo root:  python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_dataset(root: str, n_classes: int = 6, n_per_class: int = 12,
                 size: int = 32) -> str:
    """Folder-per-class PNGs: coloured blobs, distinct enough to learn
    (``examples/quickstart.py``'s, from the same seed)."""
    import cv2
    rng = np.random.default_rng(0)
    for c in range(n_classes):
        d = os.path.join(root, f"class_{c:02d}")
        os.makedirs(d, exist_ok=True)
        hue = int(180 * c / n_classes)
        for i in range(n_per_class):
            img = np.full((size, size, 3), 40, np.uint8)
            center = (int(rng.integers(8, size - 8)),
                      int(rng.integers(8, size - 8)))
            hsv = np.uint8([[[hue, 220, 220]]])
            bgr = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[0, 0]
            cv2.circle(img, center, 6 + c % 3, tuple(int(v) for v in bgr),
                       -1)
            img = (img + rng.integers(0, 25, img.shape,
                                      dtype=np.uint8)).clip(0, 255)
            cv2.imwrite(os.path.join(d, f"{i:03d}.png"), img)
    return root


def main(argv=None) -> dict:
    """Runs the five steps; returns what they produced (the history, the
    export's paths, the query's prediction, the val recall)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    parser.add_argument("--work_dir", default=None,
                        help="where the dataset and the export go "
                             "(default: a new temp dir)")
    args = parser.parse_args(argv)
    work = args.work_dir or tempfile.mkdtemp(prefix="en_quickstart_torch_")
    data = make_dataset(os.path.join(work, "data"))
    print(f"dataset: {data}")

    # 1. Config: the same YAML schema, as a dict here for brevity
    from embeddingnet_tpu_torch.config import params_from_dict
    params = params_from_dict({
        "MODEL": {"input_shape": [32, 32, 3], "encodings_len": 32,
                  "mode": "triplet", "backbone_name": "simple2",
                  "backbone_weights": None},
        "DATALOADER": {"dataset_path": data, "validate": True,
                       "val_ratio": 0.25},
        "GENERATOR": {"negatives_selection_mode": "semihard",
                      "k_classes": 4, "k_samples": 4, "margin": 0.5,
                      "n_batches": 8},
        "TRAIN": {"optimizer": "adam", "learning_rate": 3e-3,
                  "n_epochs": 2, "plot_history": False},
        "ENCODINGS": {"save_encodings": True,
                      "max_num_samples_of_each_class": 10, "knn_k": 3},
        "GENERAL": {"project_name": "quickstart", "work_dir": work},
        "PERFORMANCE": {"compute_dtype": "float32"},
    })

    # 2. Train (tools/train_torch.py's path, as a library call)
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    loader = ENDataLoader(data, validate=True, val_ratio=0.25)
    trainer = Trainer(params, loader, device=args.device)
    history = trainer.fit().history

    # 3. Export: the encoder's weights and the encodings database
    from embeddingnet_tpu_torch.models.api import EmbeddingNet
    net = EmbeddingNet(params, device=args.device)
    net.load_encoder_state(trainer.encoder_variables())
    db = net.generate_encodings(loader, max_n_samples=10)
    net.save_encodings(db, work)
    w_path = net.save_base_model(work)
    db_path = os.path.join(work, "encodings.pkl")
    print(f"exported: {w_path}, {db_path}")

    # 4. Classify a held-out image
    val_cls = loader.class_names[0]
    query = loader.val_data[val_cls][0]
    label, top5 = net.predict_knn(query, with_top5=True)
    print(f"query {query}\n  true={val_cls} predicted={label} top5={top5}")

    # 5. Retrieval accuracy over the val split
    acc = net.calculate_prediction_accuracy(loader)
    print(f"val recall: top1={acc['top1']:.3f} top5={acc['top5']:.3f}")
    return {"history": history, "weights": w_path, "encodings": db_path,
            "query": (val_cls, label, top5), "recall": acc}


if __name__ == "__main__":
    main()
