#!/usr/bin/env python
"""Convert a local pretrained checkpoint into the backbone-weights file
that ``MODEL.backbone_weights`` loads (the PyTorch port's counterpart of
``tools/convert_weights.py``; it writes the same keys, so the file serves
both packages). Nothing is downloaded.

    python tools/convert_weights_torch.py --backbone resnet50 \\
        --source torch --input resnet50-imagenet.pth --preset imagenet \\
        --out weights/
    python tools/convert_weights_torch.py --backbone vit-b16 \\
        --source hf-vit --input vit_b16.pth --out weights/
    python tools/convert_weights_torch.py --backbone vit-l14 \\
        --source clip --input clip_vitl14_vision.pth --preset clip \\
        --out weights/

It writes ``<out>/<backbone>_<preset>.npz`` with the keys
``params/backbone/...`` (and ``batch_stats/backbone/...``). Then set
``MODEL.backbone_weights: '<preset>'`` with ``EMBEDDINGNET_WEIGHTS_DIR``
pointing at ``--out``, or give the file's path: the backbone loads, the
embedding head keeps its fresh initialisation.

Sources:
  torch   a .pth/.pt state_dict of a torchvision ResNet (18-152)
  hf-vit  a torch state_dict of transformers.ViTModel
  clip    a torch state_dict of transformers.CLIPVisionModel[WithProjection]
          or of a whole CLIPModel (its vision tower)
  keras   not here: it needs TensorFlow; use tools/convert_weights.py,
          whose .npz loads in the port
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
                 "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
                 "resnet152": (3, 8, 36, 3)}


def load_torch_state_dict(path):
    """The state_dict in a torch checkpoint, out of the usual envelopes."""
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(
                obj[key], dict):
            obj = obj[key]
    return obj


def convert(backbone, source, path):
    """``(params, batch_stats or None)`` of the backbone, in Flax's
    layout."""
    from embeddingnet_tpu_torch.models import pretrained

    if source == "keras":
        raise SystemExit(
            "--source keras needs TensorFlow, which the PyTorch port does "
            "not use: convert with tools/convert_weights.py (the JAX "
            "package's tool); the .npz it writes loads in the port")
    sd = load_torch_state_dict(path)
    if source == "torch":
        stages = RESNET_STAGES.get(backbone)
        if stages is None:
            raise SystemExit(f"--source torch supports torchvision "
                             f"ResNets, not {backbone!r}")
        return pretrained.torch_resnet_to_flax(sd, stages)
    if source == "hf-vit":
        if not any(k.startswith("vit.") for k in sd):
            sd = {f"vit.{k}": v for k, v in sd.items()}
        depth = 1 + max(int(k.split(".")[3]) for k in sd
                        if k.startswith("vit.encoder.layer."))
        return pretrained.hf_vit_to_flax(sd, depth=depth), None
    if source == "clip":
        prefix = ("vision_model." if any(
            k.startswith("vision_model.") for k in sd) else "")
        depth = 1 + max(
            int(k.split(".")[2 if prefix else 1]) for k in sd
            if k.startswith(f"{prefix}encoder.layers."))
        return pretrained.clip_vit_to_flax(sd, depth=depth), None
    raise SystemExit(f"unknown --source {source!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backbone", required=True,
                    help="registry name (models/registry.py)")
    ap.add_argument("--source", required=True,
                    choices=["keras", "torch", "hf-vit", "clip"])
    ap.add_argument("--input", required=True,
                    help="local checkpoint file (no downloads happen here)")
    ap.add_argument("--preset", default="imagenet",
                    help="preset name the config will reference "
                         "(MODEL.backbone_weights)")
    ap.add_argument("--out", required=True,
                    help="output dir (point $EMBEDDINGNET_WEIGHTS_DIR here)")
    args = ap.parse_args(argv)

    from embeddingnet_tpu_torch.models.pretrained import flatten_params

    params, stats = convert(args.backbone, args.source, args.input)
    tree = {"params": {"backbone": params}}
    if stats:
        tree["batch_stats"] = {"backbone": stats}
    flat = flatten_params(tree)

    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, f"{args.backbone}_{args.preset}.npz")
    np.savez(out_path, **flat)
    n_params = sum(int(np.prod(v.shape)) for v in flat.values())
    print(f"wrote {out_path}: {len(flat)} arrays, "
          f"{n_params / 1e6:.1f}M parameters")
    print(f"use: MODEL.backbone_weights: '{args.preset}' with "
          f"EMBEDDINGNET_WEIGHTS_DIR={args.out}")
    return out_path


if __name__ == "__main__":
    main()
