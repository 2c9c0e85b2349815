#!/usr/bin/env python
"""Evaluation CLI of the PyTorch port: ``python tools/evaluate_torch.py
<config.yml> --weights W --encodings E [--tsne DIR] [--device cuda]`` ->
recall@1 / recall@5 over the validation split.

The port of ``tools/evaluate.py``: ``EmbeddingNet.
calculate_prediction_accuracy`` over the config's dataset index (the
port's ``ENDataLoader``) against the encodings DB, printed as
``tools/evaluate.py`` prints it; ``--tsne`` also writes a t-SNE plot of the
DB (sklearn and matplotlib). Weights, dtype and device as
``tools/test_torch.py``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate retrieval recall")
    parser.add_argument("config", help="model config file path")
    parser.add_argument("--weights", required=True,
                        help="base-model state_dict file (torch.save)")
    parser.add_argument("--encodings", required=True,
                        help="encodings pickle file (the retrieval DB)")
    parser.add_argument("--tsne", default=None,
                        help="also write a t-SNE plot of the DB to this dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None):
    """Runs the CLI; returns ``{"top1", "top5"}``."""
    args = parse_args(argv)
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.models.api import EmbeddingNet

    params = parse_params(args.config)
    net = EmbeddingNet.for_inference(params, args.weights, args.encodings,
                                     device=args.device)
    data_loader = ENDataLoader(**{
        k: params.dataloader[k] for k in params.dataloader.keys()})
    acc = net.calculate_prediction_accuracy(data_loader)
    print(f"recall@1={acc['top1']:.4f} recall@5={acc['top5']:.4f} "
          f"(val images: {len(data_loader.flat('val')[0])}, "
          f"db: {len(net.encoded_training_data['labels'])})")

    if args.tsne:
        from embeddingnet_tpu_torch.utils.viz import plot_tsne
        out = plot_tsne(args.encodings, args.tsne)
        print(f"t-SNE written to {out}")
    return acc


if __name__ == "__main__":
    main()
