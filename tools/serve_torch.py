#!/usr/bin/env python
"""Serving CLI of the PyTorch port: ``python tools/serve_torch.py
<config.yml> --weights W --encodings E [--device cuda] [--host H]
[--port P]``.

HTTP inference over the trained encoder and its encodings DB with
micro-batched device execution (:mod:`embeddingnet_tpu_torch.serving`).
``W`` is a ``state_dict`` file written by the port's
``EmbeddingNet.save_base_model``. The encoder follows the config's
``PERFORMANCE`` section: ``compute_dtype`` and ``pallas_conv`` (the fused
small-spatial conv kernels).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve a trained model with the PyTorch port")
    parser.add_argument("config", help="model config file path")
    parser.add_argument("--weights", required=True,
                        help="base-model state_dict file (torch.save)")
    parser.add_argument("--encodings", required=True,
                        help="encodings pickle file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: cuda)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_batch", type=int, default=32)
    parser.add_argument("--quantize_db", action="store_true",
                        help="int8-quantize the encodings DB")
    return parser.parse_args(argv)


def build(args):
    """(engine, server) for parsed ``args``; the server is bound, not yet
    serving."""
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.models.api import EmbeddingNet
    from embeddingnet_tpu_torch.serving import InferenceEngine, make_server

    net = EmbeddingNet.for_inference(parse_params(args.config), args.weights,
                                     args.encodings, device=args.device)
    engine = InferenceEngine(net, max_batch=args.max_batch,
                             quantize_db=args.quantize_db)
    return engine, make_server(engine, args.host, args.port)


def main():
    args = parse_args()
    engine, server = build(args)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(backbone={engine.net.params_model['backbone_name']}, "
          f"device={args.device}, db={len(engine.labels)} encodings)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
