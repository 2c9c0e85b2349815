#!/usr/bin/env python
"""Inference CLI of the PyTorch port: ``python tools/test_torch.py
<config.yml> --weights W --encodings E --image I [--top5] [--device
cuda]``.

The port of ``tools/test.py``: config + base model + encodings DB ->
the kNN label of one image (``ENCODINGS.knn_k`` neighbours), printed as
``tools/test.py`` prints it, and with ``--top5`` the five nearest DB
labels on a ``top5:`` line. ``W`` is a ``state_dict`` written by the port's
``EmbeddingNet.save_base_model`` (``base_model.pt``). The encoder follows
the config's ``PERFORMANCE.compute_dtype`` and ``pallas_conv``, as
``tools/serve_torch.py``'s does; it runs on the card unless ``--device
cpu``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Test a trained model")
    parser.add_argument("config", help="model config file path")
    parser.add_argument("--weights", required=True,
                        help="base-model state_dict file (torch.save)")
    parser.add_argument("--encodings", required=True,
                        help="encodings pickle file")
    parser.add_argument("--image", required=True, help="image to classify")
    parser.add_argument("--top5", action="store_true",
                        help="also print the top-5 neighbor labels")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None):
    """Runs the CLI; returns the predicted label (and the top-5 labels with
    ``--top5``)."""
    args = parse_args(argv)
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.models.api import EmbeddingNet

    net = EmbeddingNet.for_inference(parse_params(args.config), args.weights,
                                     args.encodings, device=args.device)
    if args.top5:
        prediction, top5 = net.predict_knn(args.image, with_top5=True)
        print(prediction)
        print("top5:", top5)
        return prediction, top5
    prediction = net.predict_knn(args.image)
    print(prediction)
    return prediction


if __name__ == "__main__":
    main()
