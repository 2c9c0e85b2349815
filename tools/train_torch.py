#!/usr/bin/env python
"""Train CLI of the PyTorch port: ``python tools/train_torch.py
<config.yml> [--device cuda] [--resume_from EPOCH|latest]``, or on N cards
``torchrun --nproc_per_node=N tools/train_torch.py <config.yml>``.

Fits the config's triplet, siamese or arcface model with
:class:`embeddingnet_tpu_torch.train.loop.Trainer` on one device (``cuda``
unless ``--device cpu``), after the softmax pretraining phase when the
config has a ``SOFTMAX_PRETRAINING`` section. Under torchrun each process
is one rank on the card ``LOCAL_RANK`` (NCCL; ``--device cpu`` gives gloo
ranks on the CPU), the process group joined before any other use of CUDA,
and the ranks train one model data-parallel (``MESH.data: -1``, or the
world size), or, with ``MESH.model: M > 1``, each model split over groups
of M consecutive ranks (tensor parallelism: a ViT's attention and MLP, the
ArcFace class weights); rank 0 prints and writes. ``--dist_backend gloo``
runs ranks that share one card (NCCL refuses two ranks on one device):
``torchrun --nproc_per_node=2 tools/train_torch.py <cfg> --dist_backend
gloo`` with ``MESH.model: 2`` on one card. Every config of the repo fits as
it stands, on any backbone name of the JAX registry, from
``MODEL.backbone_weights`` when it names a local file or a preset in
``$EMBEDDINGNET_WEIGHTS_DIR`` (``tools/convert_weights_torch.py`` writes
one): ``configs/resnet50_batchall_1024.yml``,
``siamese_resnet18_pairs.yml``, ``efficientnetb3_batchhard_1024.yml``,
``road_signs_tpu.yml``, ``batch4096_sharded.yml`` and the four
ArcFace-on-ViT configs. It trains in the
work-dir tree ``<work_dir>/<project_name>/{weights,encodings,plots,
tf_log,...}``; ``--resume_from`` restores the whole train state of a
checkpoint epoch. Then it loads the best epoch, plots the history
(``TRAIN.plot_history``), saves the encoder as ``base_model.pt`` (the
format ``tools/serve_torch.py`` loads), exports the encodings DB
(``ENCODINGS.save_encodings``; one mean per class with ``centers_only``)
and prints recall@1/@5 over the val split.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a metric-learning embedding model with the "
                    "PyTorch port")
    parser.add_argument("config", help="model config file path")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    parser.add_argument("--resume_from", default=None,
                        help="checkpoint epoch to resume from, or 'latest'")
    parser.add_argument("--dist_backend", default=None,
                        choices=("nccl", "gloo"),
                        help="torch.distributed backend under torchrun "
                             "(default: nccl on the card, gloo on the CPU)")
    return parser.parse_args(argv)


def main(argv=None):
    """Runs the CLI; returns ``(trainer, net)``: the Trainer after its fit
    and best-epoch restore, and the exported :class:`EmbeddingNet`."""
    args = parse_args(argv)
    import torch
    from embeddingnet_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed, reset_grid, world)
    joined = torch.distributed.is_initialized()
    # before any other use of CUDA: a torchrun rank takes its own card
    device = maybe_initialize_distributed(
        args.device, backend=args.dist_backend) or args.device
    try:
        return _run(args, device, world().rank == 0)
    finally:
        if not joined and torch.distributed.is_initialized():
            reset_grid()
            torch.distributed.destroy_process_group()


def _run(args, device, rank0):
    import torch
    from embeddingnet_tpu_torch.config import parse_params
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.models.api import EmbeddingNet
    from embeddingnet_tpu_torch.train.loop import Trainer

    say = print if rank0 else (lambda *a, **k: None)

    say("LOAD PARAMETERS")
    params = parse_params(args.config)
    if params.train.plot_history:
        # plots come after the whole fit: fail now, not after it
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "TRAIN.plot_history is set but matplotlib is not installed: "
                "install it or set TRAIN.plot_history to False") from e
    say("CREATE DATALOADER")
    data_loader = ENDataLoader(**{
        k: params.dataloader[k] for k in params.dataloader.keys()})
    say(f"DATALOADER CREATED! classes={data_loader.n_classes}")

    say("CREATE MODEL AND TRAINER")
    trainer = Trainer(params, data_loader, device=device)
    if args.resume_from is not None:
        epoch = None if args.resume_from == "latest" else int(
            args.resume_from)
        trainer.resume(epoch)
    if params.softmax is not None:
        say("SOFTMAX PRETRAINING")
        trainer.pretrain_softmax()

    history = trainer.fit()
    # export the best-monitored epoch, not wherever early stopping halted
    trainer.restore_best()
    # whole tensors, gathered from a model group's slices on every rank
    variables = trainer.encoder_variables()
    if not rank0:
        # the ranks hold one model: rank 0 exports it
        return trainer, None
    if params.train.plot_history:
        from embeddingnet_tpu_torch.utils.viz import plot_grapths
        plot_grapths(history, trainer.paths["plots"])

    net = EmbeddingNet(params, device=device,
                       fast_conv=params.performance.pallas_conv,
                       dtype=trainer.compute_dtype)
    # the encoder of any mode (the siamese and arcface ones have no
    # classifier)
    net.load_encoder_state(variables)
    weights_path = net.save_base_model(trainer.paths["work_dir"])
    print(f"base model saved to {weights_path}")

    if params.encodings.save_encodings:
        print("EXPORT ENCODINGS")
        db = net.generate_encodings(
            data_loader,
            max_n_samples=params.encodings.max_num_samples_of_each_class)
        if params.encodings.centers_only:
            from embeddingnet_tpu_torch.ops.knn import class_centers
            classes = sorted(set(db["labels"]))
            ids = torch.as_tensor([classes.index(l) for l in db["labels"]])
            centers = class_centers(torch.as_tensor(db["encodings"]), ids,
                                    len(classes))
            db = {"paths": [], "labels": classes,
                  "encodings": centers.numpy(),
                  "weights_fingerprint": db["weights_fingerprint"]}
        net.save_encodings(db, trainer.paths["encodings"])
        print(f"encodings saved to {trainer.paths['encodings']}")
        if data_loader.validate and data_loader.val_data:
            net.encoded_training_data = db
            acc = net.calculate_prediction_accuracy(data_loader)
            print(f"recall@1={acc['top1']:.4f} recall@5={acc['top5']:.4f}")
    return trainer, net


if __name__ == "__main__":
    main()
