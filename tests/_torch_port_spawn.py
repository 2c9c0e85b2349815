"""The spawned ranks of the port's tensor- and pipeline-parallel tests.

This module imports no JAX (nor the JAX package), so that a rank spawned
by ``torch.multiprocessing`` starts quickly; the tests compute the JAX
references in the parent. Every rank is a gloo rank with one torch
thread, joined through a ``file://`` store under the test's temp dir.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn as nn

from embeddingnet_tpu_torch.models.heads import Dense
from embeddingnet_tpu_torch.models.vit import ViT
from embeddingnet_tpu_torch.parallel import mesh, pp
from embeddingnet_tpu_torch.parallel import tp as tensor_parallel
from embeddingnet_tpu_torch.parallel.collectives import (DataParallel,
                                                         ModelParallel,
                                                         gather_slices)
from embeddingnet_tpu_torch.train import steps
from embeddingnet_tpu_torch.train.optim import get_optimizer
from embeddingnet_tpu_torch.train.state import TrainState

SIZE = 16
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _entry(rank, world, store, fn, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        torch.save(result, f"{out}.rank{rank}.pt")
    finally:
        mesh.reset_grid()
        dist.destroy_process_group()


def spawn(fn, world, directory, *args, tag=""):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns each
    rank's result (anything ``torch.save`` takes), in rank order."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    name = os.path.join(directory, f"{fn.__name__}{tag}-{world}")
    mp.spawn(_entry, args=(world, name + ".store", fn, name, args),
             nprocs=world, join=True)
    return [torch.load(f"{name}.rank{r}.pt", weights_only=False)
            for r in range(world)]


# -- the tiny ViT --------------------------------------------------------------


class TinyViTEncoder(nn.Module):
    """``tests/test_tp.py``'s ``TinyViTEncoder`` in the port: a ViT (patch
    8, dim 32, depth 2, 4 heads) on 16x16 images, its grid mean-pooled,
    then a Dense to 16; Flax's names (``vit``, ``head``)."""

    def __init__(self, dim=32, heads=4, out=16, depth=2):
        super().__init__()
        self.vit = ViT((SIZE, SIZE), patch=8, dim=dim, depth=depth,
                       heads=heads)
        self.head = Dense(dim, out)

    def forward(self, x, masks=None):
        grid = self.vit(x.permute(0, 3, 1, 2))
        return self.head(grid.mean((2, 3)))


def tiny_vit_steps(state_dict, batches, dtype, parallel=None, tp=None,
                   optimizer="adam"):
    """Adam (1e-2) batch-all triplet steps of the tiny ViT from
    ``state_dict`` on the global ``batches`` (this rank's rows of each
    under ``parallel``, the model split over ``tp``): the losses and the
    whole state dict after the steps."""
    module = TinyViTEncoder()
    module.load_state_dict(state_dict)
    module.to(DTYPES[dtype])
    tensor_parallel.shard_module(module, tp)
    spec = get_optimizer(optimizer, 1e-2)
    state = TrainState.create(module, spec)
    step = steps.make_triplet_train_step(
        module, spec, margin=0.5, mode="batch_all", parallel=parallel,
        compute_dtype=DTYPES[dtype])
    losses = []
    for images, labels in batches:
        lo, hi = parallel.rows(len(images)) if parallel else (0, len(images))
        state, metrics = step(state, torch.as_tensor(images[lo:hi]),
                              torch.as_tensor(labels[lo:hi]))
        losses.append(metrics["loss"].item())
    whole = tensor_parallel.gather_state(state)
    return {"losses": losses, "state": whole["module"],
            "optimizer": whole["optimizer"],
            "local": {n: tuple(p.shape) for n, p in
                      module.named_parameters()}}


def tiny_vit_gradient(state_dict, images, tp=None):
    """The tiny ViT in float64, split over ``tp``: its embeddings of
    ``images / 255`` and the whole gradient of their sum of squares (no f32
    cast anywhere)."""
    module = TinyViTEncoder()
    module.load_state_dict(state_dict)
    module.double()
    tensor_parallel.shard_module(module, tp)
    emb = module(torch.as_tensor(images).double() / 255.0)
    (emb ** 2).sum().backward()
    shards = getattr(module, "tp_shards", None) or {}
    grads = {n: gather_slices(p.grad, *shards[n], tp)
             if n in shards else p.grad for n, p in module.named_parameters()}
    return {"emb": emb.detach(), "grads": grads}


def _grid_info():
    """This rank's grid: indices, the members of its groups, its row block
    of a batch of 8, its span of 5 classes."""
    grid = mesh.current_grid()
    members = {}
    for name, group in (("data", grid.data_group),
                        ("model", grid.model_group)):
        gathered = [torch.zeros(1, dtype=torch.long)
                    for _ in range(dist.get_world_size(group))]
        dist.all_gather(gathered, torch.tensor([dist.get_rank()]),
                        group=group)
        members[name] = [int(t) for t in gathered]
    return {"d": grid.d, "m": grid.m, "members": members,
            "rows": mesh.process_row_block(8),
            "span5": ModelParallel.current().span(5)}


def tp_vit_cases_worker(rank, world, model, state_dict, batches,
                        optimizers=("sgd", "adam")):
    """The tiny ViT's steps on a ``(world / model, model)`` grid: each of
    ``optimizers`` in float64, SGD in float32 too, and the grid."""
    mesh.build_grid(-1, model)
    dp, tp = DataParallel.current(), ModelParallel.current()
    out = {"grid": _grid_info(),
           "exact": tiny_vit_gradient(state_dict, batches[0][0], tp)}
    cases = [(opt, "float64") for opt in optimizers] + [("sgd", "float32")]
    for opt, dtype in cases:
        out[f"{opt}-{dtype}"] = tiny_vit_steps(state_dict, batches, dtype,
                                               dp, tp, optimizer=opt)
    return out


# -- ArcFace and the softmax head ---------------------------------------------


def class_split_steps(kind, variables_sd, batches, n_classes, dtype, tiny,
                      parallel=None, tp=None, lr=0.05):
    """SGD steps of the port's ``ArcFaceModule`` or ``SoftmaxModule`` on
    the tiny ViT (``tiny``: the ``vit-b16`` registry entry it replaces),
    the class axis split over ``tp``: per step the loss (and accuracy),
    then the whole state dict."""
    from embeddingnet_tpu_torch.models import registry, vit
    vit._VARIANTS["vit-b16"] = tiny
    if kind == "arcface":
        module = registry.ArcFaceModule("vit-b16", encodings_len=16,
                                        n_classes=n_classes,
                                        input_shape=(SIZE, SIZE, 3))
        make = steps.make_arcface_train_step
    else:
        module = registry.SoftmaxModule("vit-b16", n_classes=n_classes,
                                        input_shape=(SIZE, SIZE, 3))
        make = steps.make_softmax_train_step
    module.load_state_dict(variables_sd)
    module.to(DTYPES[dtype])
    tensor_parallel.shard_module(module, tp)
    spec = get_optimizer("sgd", lr)
    state = TrainState.create(module, spec)
    kwargs = {"parallel": parallel} if kind == "arcface" else {}
    step = make(module, spec, n_classes=n_classes,
                compute_dtype=DTYPES[dtype], **kwargs)
    metrics_out = []
    for images, labels in batches:
        lo, hi = parallel.rows(len(images)) if parallel else (0, len(images))
        state, metrics = step(state, torch.as_tensor(images[lo:hi]),
                              torch.as_tensor(labels[lo:hi]))
        metrics_out.append({k: v.item() for k, v in metrics.items()})
    return {"metrics": metrics_out,
            "state": tensor_parallel.gather_module_state(module),
            "local": {n: tuple(p.shape) for n, p in
                      module.named_parameters()}}


def tp_class_cases_worker(rank, world, model, cases, n_classes, tiny):
    """``class_split_steps`` of each ``kind -> (state dict, batches)`` in
    ``cases``, float64, the classes split over a model group of
    ``model``."""
    mesh.build_grid(-1, model)
    dp, tp = DataParallel.current(), ModelParallel.current()
    return {kind: class_split_steps(kind, sd, batches, n_classes, "float64",
                                    tiny, dp if kind == "arcface" else None,
                                    tp)
            for kind, (sd, batches) in cases.items()}


# -- the Trainer ---------------------------------------------------------------


def _trainer(cfg):
    from embeddingnet_tpu_torch.config import params_from_dict
    from embeddingnet_tpu_torch.data import ENDataLoader
    from embeddingnet_tpu_torch.train.loop import Trainer
    params = params_from_dict(cfg)
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    return Trainer(params, loader, device="cpu", log_fn=lambda *a: None)


def trainer_cases_worker(rank, world, cnn_cfg, vit_cfg, vit_resume_cfg,
                         tiny):
    """Trainers on the ranks: ``cnn_cfg`` fitted one epoch; ``vit_cfg``
    (the tiny ViT, ``tiny`` its ``vit-b16`` entry, arcface mode) pretrained
    and fitted one epoch, then ``vit_resume_cfg`` resumed from its epoch-0
    checkpoint and fitted the second. The histories, the split parameters
    and the whole encoders."""
    from embeddingnet_tpu_torch.models import vit
    out = {}
    trainer = _trainer(cnn_cfg)
    out["cnn"] = {"grid": tuple(trainer.grid[:2]),
                  "h1": trainer.fit(1).history,
                  "split": sorted(getattr(trainer.module, "tp_shards",
                                          None) or {}),
                  "after1": trainer.encoder_variables()}
    vit._VARIANTS["vit-b16"] = tiny
    trainer = _trainer(vit_cfg)
    trainer.pretrain_softmax()
    backbone = torch.load(os.path.join(
        trainer.paths["pretraining_weights"], "backbone.pt"),
        weights_only=True)
    run = {"split": sorted(trainer.module.tp_shards),
           "pretrained_whole": tuple(backbone[
               "backbone.block1.mlp.fc1.weight"].shape) == (128, 32),
           "h1": trainer.fit(1).history}
    resumed = _trainer(vit_resume_cfg)
    resumed.resume(0)
    run["h2"] = resumed.fit(2).history
    run["after2"] = resumed.encoder_variables()
    out["vit"] = run
    return out


# -- the pipeline --------------------------------------------------------------


def pipeline_run(block_sd_list, x, n_stages, n_micro, grid=None,
                 dtype="float64"):
    """The tiny ViT's blocks through :func:`pp.pipeline_blocks_forward`:
    the output and the gradient of ``sum(y ** 2)`` for this rank's stage
    (``[L/S, ...]`` tensors by name)."""
    from embeddingnet_tpu_torch.models.vit import EncoderBlock
    block = EncoderBlock(32, 4).to(DTYPES[dtype])
    stacked = pp.stack_stage_params(
        [{k: torch.as_tensor(v).to(DTYPES[dtype]) for k, v in sd.items()}
         for sd in block_sd_list], n_stages)
    params = pp.place_stage_params(stacked, grid)
    for v in params.values():
        v.requires_grad_(True)

    def block_apply(p, h):
        return torch.func.functional_call(block, p, (h,))

    x = torch.as_tensor(x).to(DTYPES[dtype])
    y = pp.pipeline_blocks_forward(block_apply, params, x, grid,
                                   n_micro=n_micro)
    names = list(params)
    grads = torch.autograd.grad((y ** 2).sum(), [params[n] for n in names])
    return {"out": y.detach(),
            "grads": {n: g for n, g in zip(names, grads)}}


def pipeline_worker(rank, world, block_sd_list, x, n_micros):
    """:func:`pipeline_run` over ``world`` stages for each of
    ``n_micros``."""
    grid = mesh.build_grid(1, world)
    return {n: pipeline_run(block_sd_list, x, world, n, grid)
            for n in n_micros}


# -- the native decoder --------------------------------------------------------


def build_and_decode(build_dir, start, image, out_queue):
    """Build the native decoder into ``build_dir`` once ``start`` is set
    (so that the processes build at once), load it and decode ``image``;
    puts ``(library path, decoded sum)`` on ``out_queue``."""
    from pathlib import Path
    from embeddingnet_tpu_torch.data import native_loader
    native_loader.BUILD_DIR = Path(build_dir)
    start.wait()
    path = native_loader.build()
    out = native_loader.decode_batch([image], 8, 8)
    out_queue.put((str(path), int(out.sum())))
