"""The train and eval steps (port of ``make_triplet_train_step``,
``make_triplet_eval_step``, ``make_siamese_train_step``,
``make_siamese_eval_step``, ``make_arcface_train_step``,
``make_softmax_train_step``, ``make_softmax_eval_step`` and
``make_eval_step`` in ``embeddingnet_tpu/train/steps.py``).

One triplet train step: uint8 P-K batch -> [augmentation in 0..255 ->]
``/255`` in the compute dtype (:func:`_preprocess`) -> encoder in train
mode (BatchNorm on batch statistics, running averages updated) -> f32
embeddings -> mined triplet loss + L2 penalty -> backward -> optimizer
update with the learning rate of the schedule at this step times the
state's plateau scale -> the parameters' EMA, where the state keeps one.
A siamese step does the same for a batch of pairs, through the
:class:`~embeddingnet_tpu_torch.models.registry.SiameseModule` (the encoder
once per stream), with the contrastive loss on the pair distances. An ArcFace step runs an
:class:`~embeddingnet_tpu_torch.models.registry.ArcFaceModule` and the
ArcFace loss on its f32 embeddings and class weights; a softmax
pretraining step a :class:`~embeddingnet_tpu_torch.models.registry.
SoftmaxModule` and the cross-entropy of its f32 logits. Neither adds the
L2 penalty, as in JAX.

The random draws come from ``state.generator`` unless the caller passes
them, in this order: the augmentation's (per stream), then the module's
drop-connect and Dropout masks (:class:`~embeddingnet_tpu_torch.models.
stochastic.MaskSource`, in the order the layers run; none for a backbone
without such layers), then the mining's. A train step takes given masks
as ``drop_draws``; the eval steps draw none.

The eval steps run the encoder in eval mode (BatchNorm on its running
statistics) on ``/255`` of the uint8 batch, without augmentation.

Data parallelism: the triplet, siamese and arcface train steps take
``parallel`` (a :class:`~embeddingnet_tpu_torch.parallel.collectives.
DataParallel` world, one rank per process) and are then called with this
rank's block of the global batch's rows. Each rank draws the global
batch's augmentation draws, masks and mining draws from a generator seeded
alike on every rank, and keeps its rows of the per-image ones; BatchNorm
takes global statistics; the triplet miner sees the global batch
(batch-all and batch-hard row-sharded, :mod:`~embeddingnet_tpu_torch.
parallel.sharded`; the other modes on the gathered embeddings); each rank
back-propagates its share of the global loss (the gathered and sharded
losses over the world size, a per-example mean as this rank's sum over the
global batch), the L2 penalty on rank 0 alone, and the gradients are
summed over ranks (:func:`~embeddingnet_tpu_torch.parallel.collectives.
all_reduce_grads`) before the update. So one step equals the one-process
step on the global batch up to the order of the sums, and the ranks stay
bit-identical.

Tensor parallelism (a module split by :func:`~embeddingnet_tpu_torch.
parallel.tp.shard_module`): the split layers carry their model group and
run its collectives themselves; every rank of a model group takes the same
rows and back-propagates the same loss, ``parallel`` is the data group,
and the gradients of split and whole parameters alike are summed over the
data group only. The ArcFace and softmax losses run on the class-split
logits (``ops/losses.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from embeddingnet_tpu_torch.models import remat as _remat
from embeddingnet_tpu_torch.models.heads import at_least_f32
from embeddingnet_tpu_torch.models.stochastic import MaskSource
from embeddingnet_tpu_torch.ops import batchnorm_context, mining
from embeddingnet_tpu_torch.ops.augment import Augment, Draws
from embeddingnet_tpu_torch.ops.losses import (accuracy, arcface_loss,
                                               contrastive_loss, one_hot,
                                               softmax_cross_entropy,
                                               triplet_hinge)
from embeddingnet_tpu_torch.ops.preprocess import preprocess
from embeddingnet_tpu_torch.parallel import collectives, sharded
from embeddingnet_tpu_torch.parallel.collectives import DataParallel
from embeddingnet_tpu_torch.train.optim import (OptimizerSpec, l2_penalty,
                                                update_param_ema)
from embeddingnet_tpu_torch.train.state import TrainState
from embeddingnet_tpu_torch.utils import trace


def _preprocess(images: torch.Tensor, dtype: torch.dtype,
                augment_fn: Optional[Augment], generator: torch.Generator,
                draws: Optional[List[Draws]],
                rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """uint8 (or float 0..255) BGR batch -> augmented, ``/255`` batch in
    ``dtype`` (the JAX ``_preprocess``): augmentation runs on f32 images in
    0..255, the division after it, as the reference orders them. Without
    augmentation this is :func:`preprocess` (T2 for uint8 to bf16); with
    it, the f32 divide, as JAX skips its bf16 shortcut then. The draws come
    from ``generator`` unless ``draws`` are given; the augmentation runs
    inside an ``augment`` span (:mod:`~embeddingnet_tpu_torch.utils.
    trace`). With
    ``rows = (lo, hi, global_batch)`` the draws (given or drawn) are the
    global batch's and ``images`` its rows ``[lo, hi)``."""
    if augment_fn is None:
        return preprocess(images, dtype)
    with trace.span("augment"):
        x = images.float()
        if draws is None:
            shape = x.shape if rows is None else (rows[2],) + x.shape[1:]
            draws = augment_fn.sample(shape, generator, x.device)
        if rows is not None:
            draws = [{k: v[rows[0]:rows[1]] for k, v in d.items()}
                     for d in draws]
        x = augment_fn.apply(x, draws)
    return (x / 255.0).to(dtype)


def _rows(parallel: Optional[DataParallel], local_batch: int):
    """``(lo, hi, global_batch)`` of this rank, or None off a world."""
    if parallel is None:
        return None
    lo, hi = parallel.rows(local_batch * parallel.size)
    return lo, hi, local_batch * parallel.size


def _share(parallel: Optional[DataParallel], local_mean: torch.Tensor,
           rows) -> torch.Tensor:
    """This rank's share of a per-example mean over the global batch: its
    rows' sum over the global batch size."""
    if parallel is None:
        return local_mean
    return local_mean * ((rows[1] - rows[0]) / rows[2])


def apply_update(state: TrainState, optimizer: OptimizerSpec) -> None:
    """The update of a train step, from the gradients in ``.grad``: the
    learning rate ``optimizer.lr_at(state.step) * state.plateau_scale``,
    ``state.optimizer.step()``, the EMA of the parameters where the state
    keeps one, and the step count, inside an ``optimizer`` span."""
    with trace.span("optimizer"):
        lr = optimizer.lr_at(state.step) * state.plateau_scale
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        if state.ema is not None:
            update_param_ema(state.ema, state.module, state.ema_decay)
        state.step += 1


def _backward_and_update(state: TrainState, module: torch.nn.Module,
                         optimizer: OptimizerSpec, loss: torch.Tensor,
                         reg_rules: Sequence, device: torch.device,
                         parallel: Optional[DataParallel] = None) -> None:
    """Differentiate ``loss + l2_penalty`` and apply the update. Under
    ``parallel`` ``loss`` is this rank's share, the penalty enters on rank
    0 alone and the gradients are summed over ranks first."""
    total = loss
    if reg_rules and (parallel is None or parallel.rank == 0):
        total = total + l2_penalty(module.named_parameters(),
                                   reg_rules).to(device)
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    for p in module.parameters():
        # optax updates every leaf: a parameter the loss does not reach
        # (the classifier head) takes a zero gradient, not none
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if parallel is not None:
        with trace.span("all_reduce_grads"):
            collectives.all_reduce_grads(module.parameters(), parallel.group)
    apply_update(state, optimizer)


def _on_device(module: torch.nn.Module, *tensors):
    device = next(module.parameters()).device
    return device, [torch.as_tensor(t).to(device, non_blocking=True)
                    for t in tensors]


def _forward(module: torch.nn.Module, x, generator: torch.Generator,
             drop_draws: Optional[Sequence[torch.Tensor]], rows=None):
    """The train-mode forward, its masks ``drop_draws`` when given, else
    drawn from ``generator`` (the global batch's, this rank's ``rows``);
    given masks must all be used."""
    masks = MaskSource(drop_draws, generator, rows=rows)
    out = module(x, masks)
    masks.check_used()
    return out


def _triplet_loss(parallel, emb, labels, margin, mode, generator,
                  mine_draws, max_positives):
    """``(loss, stats, objective)``: the global batch's mined loss, its
    stats and what this rank back-propagates."""
    if parallel is None:
        loss, stats = mining.mined_triplet_loss(
            emb, labels, margin=margin, mode=mode, rng=generator,
            draws=mine_draws, max_positives=max_positives)
        return loss, stats, loss
    if mode == "batch_all":
        fn = sharded.sharded_batch_all_loss(parallel, margin=margin,
                                            max_positives=max_positives)
        loss, stats = fn(emb, labels)
    elif mode == "batch_hard":
        loss, stats = sharded.sharded_batch_hard_loss(
            parallel, margin=margin)(emb, labels)
    else:
        # the reference's modes mine the gathered global batch on every
        # rank, with the global draws, as GSPMD runs them in JAX
        loss, stats = mining.mined_triplet_loss(
            collectives.all_gather_rows(emb, parallel.group),
            collectives.gather_rows(labels, parallel.group), margin=margin,
            mode=mode, rng=generator, draws=mine_draws,
            max_positives=max_positives)
    return loss, stats, loss / parallel.size


def make_triplet_train_step(module: torch.nn.Module,
                            optimizer: OptimizerSpec, *,
                            margin: float = 0.5, mode: str = "semihard",
                            augment_fn: Optional[Augment] = None,
                            reg_rules: Sequence = (),
                            compute_dtype: torch.dtype = torch.float32,
                            max_positives: Optional[int] = None,
                            remat: bool = False,
                            parallel: Optional[DataParallel] = None):
    """Online-mining triplet step over P-K batches; returns
    ``step(state, images_u8, labels, aug_draws=None, mine_draws=None) ->
    (state, metrics)``.

    The step updates ``state`` in place (parameters, BatchNorm statistics,
    optimizer moments, step count) and returns it. ``metrics`` holds device
    scalars — ``loss`` (without the penalty), ``n_triplets``,
    ``frac_mined``, ``mean_pos_dist``, ``mean_neg_dist`` — read them with
    ``.item()`` where the host needs them. ``optimizer`` is the spec the
    state was created from; its schedule times ``state.plateau_scale``
    sets the learning rate. Images and
    labels are moved to the module's device; the step differentiates
    ``loss + l2_penalty``, as the JAX step's ``loss_fn`` does.

    ``augment_fn`` is a preset of :func:`~embeddingnet_tpu_torch.ops.
    augment.get_aug` (None: no augmentation). The step samples its draws
    from ``state.generator``, on the generator's device, so a generator on
    the card keeps the step free of host synchronisation: the
    augmentation's, then the module's masks, then the mining's (semihard
    and random_hard, :func:`~embeddingnet_tpu_torch.ops.mining.
    draws_shape`). ``aug_draws`` (the preset's draws for this batch),
    ``drop_draws`` (the masks, in layer order) and ``mine_draws`` override
    them.
    The mining runs inside a ``mining`` span (:mod:`~embeddingnet_tpu_torch.
    utils.trace`).

    ``remat`` (``PERFORMANCE.remat``) runs the backbone's blocks under
    checkpoints (:mod:`~embeddingnet_tpu_torch.models.remat`): the same
    numbers, less memory, one more forward of time. ``parallel``: the
    data-parallel step (the module docstring); ``images`` and ``labels``
    are this rank's rows, the given draws the global batch's, and the
    metrics the global batch's on every rank."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             aug_draws: Optional[List[Draws]] = None,
             mine_draws: Optional[torch.Tensor] = None,
             drop_draws: Optional[List[torch.Tensor]] = None
             ) -> Tuple[TrainState, dict]:
        if state.module is not module:
            raise ValueError("the state was created for another module")
        module.train()
        device, (images, labels) = _on_device(module, images, labels)
        rows = _rows(parallel, images.shape[0])
        with batchnorm_context.global_statistics(parallel), \
                _remat.rematerialize(remat):
            x = _preprocess(images, compute_dtype, augment_fn,
                            state.generator, aug_draws, rows)
            emb = _forward(module, x, state.generator, drop_draws,
                           rows).float()
            with trace.span("mining"):
                loss, stats, objective = _triplet_loss(
                    parallel, emb, labels, margin, mode, state.generator,
                    mine_draws, max_positives)
            _backward_and_update(state, module, optimizer, objective,
                                 reg_rules, device, parallel)
        metrics = {
            "loss": loss.detach(),
            "n_triplets": stats.n_triplets,
            "frac_mined": stats.frac_mined,
            "mean_pos_dist": stats.mean_pos_dist,
            "mean_neg_dist": stats.mean_neg_dist,
        }
        return state, metrics

    return step


def make_siamese_train_step(module: torch.nn.Module,
                            optimizer: OptimizerSpec, *,
                            contrastive_margin: float = 1.0,
                            augment_fn: Optional[Augment] = None,
                            reg_rules: Sequence = (),
                            compute_dtype: torch.dtype = torch.float32,
                            parallel: Optional[DataParallel] = None):
    """Siamese pair step; returns ``step(state, images_1, images_2,
    targets, aug_draws=None) -> (state, metrics)``.

    ``module`` is a :class:`~embeddingnet_tpu_torch.models.registry.
    SiameseModule` (its ``distance_type`` decides the head). The
    contrastive loss on the pair distances (``targets`` 1 for a
    same-class pair) plus the L2 penalty is differentiated; ``metrics``
    holds the loss and the pair accuracy at the 0.5 threshold, as device
    scalars. The two streams' augmentation draws come from
    ``state.generator``, the first stream's first, then the masks of both
    streams' forwards, the first's first; ``aug_draws`` is a pair of the
    preset's draws that overrides the former, ``drop_draws`` the masks in
    that order. ``parallel``: the data-parallel step (the module
    docstring), on this rank's pairs."""

    def step(state: TrainState, images_1, images_2, targets,
             aug_draws: Optional[Tuple[List[Draws], List[Draws]]] = None,
             drop_draws: Optional[List[torch.Tensor]] = None
             ) -> Tuple[TrainState, dict]:
        if state.module is not module:
            raise ValueError("the state was created for another module")
        module.train()
        device, (images_1, images_2, targets) = _on_device(
            module, images_1, images_2, targets)
        rows = _rows(parallel, images_1.shape[0])
        draws_1, draws_2 = aug_draws if aug_draws is not None else (None,
                                                                    None)
        with batchnorm_context.global_statistics(parallel):
            x1 = _preprocess(images_1, compute_dtype, augment_fn,
                             state.generator, draws_1, rows)
            x2 = _preprocess(images_2, compute_dtype, augment_fn,
                             state.generator, draws_2, rows)
            d, _, _ = _forward(module, (x1, x2), state.generator,
                               drop_draws, rows)
            d = d.float()
            share = _share(parallel, contrastive_loss(
                targets, d, contrastive_margin), rows)
            _backward_and_update(state, module, optimizer, share, reg_rules,
                                 device, parallel)
        acc = _share(parallel, accuracy(targets, d.detach()), rows)
        return state, _global(parallel, {"loss": share.detach(),
                                         "accuracy": acc})

    return step


def _global(parallel: Optional[DataParallel], metrics: dict) -> dict:
    """The ranks' shares of the metrics summed (one all-reduce)."""
    if parallel is None:
        return metrics
    summed = collectives.reduce_sum(torch.stack(list(metrics.values())),
                                    parallel.group)
    return dict(zip(metrics, summed.unbind()))


def make_siamese_eval_step(module: torch.nn.Module, *,
                           contrastive_margin: float = 1.0,
                           compute_dtype: torch.dtype = torch.float32):
    """Val loss and pair accuracy on a batch of pairs, the module in eval
    mode; ``step(state, images_1, images_2, targets) -> {"loss",
    "accuracy"}`` (device scalars). Each stream's uint8 batch is divided
    by :func:`preprocess` (T2 for uint8 to bf16)."""

    @torch.no_grad()
    def step(state, images_1, images_2, targets) -> dict:
        module.eval()
        _, (images_1, images_2, targets) = _on_device(
            module, images_1, images_2, targets)
        d, _, _ = module((preprocess(images_1, compute_dtype),
                          preprocess(images_2, compute_dtype)))
        d = d.float()
        return {"loss": contrastive_loss(targets, d, contrastive_margin),
                "accuracy": accuracy(targets, d)}

    return step


def make_arcface_train_step(module: torch.nn.Module,
                            optimizer: OptimizerSpec, *, n_classes: int,
                            margin: float = 0.5, scale: float = 64.0,
                            augment_fn: Optional[Augment] = None,
                            compute_dtype: torch.dtype = torch.float32,
                            remat: bool = False,
                            parallel: Optional[DataParallel] = None):
    """ArcFace step; returns ``step(state, images_u8, labels,
    aug_draws=None) -> (state, {"loss"})``. ``module`` is an
    :class:`~embeddingnet_tpu_torch.models.registry.ArcFaceModule` with
    ``n_classes`` class weights; the loss takes its embeddings and class
    weights in f32 (float64 in a float64 module), inside an ``arcface``
    span. The augmentation's draws, then the module's masks,
    come from ``state.generator`` unless ``aug_draws`` and ``drop_draws``
    give them. ``remat``: the backbone's blocks under checkpoints, as
    :func:`make_triplet_train_step`'s. ``parallel``: the data-parallel step
    (the module docstring), on this rank's rows; the loss is a mean over
    the global batch, so each rank back-propagates its rows' sum over
    it."""

    def step(state: TrainState, images, labels,
             aug_draws: Optional[List[Draws]] = None,
             drop_draws: Optional[List[torch.Tensor]] = None
             ) -> Tuple[TrainState, dict]:
        if state.module is not module:
            raise ValueError("the state was created for another module")
        module.train()
        device, (images, labels) = _on_device(module, images, labels)
        rows = _rows(parallel, images.shape[0])
        with batchnorm_context.global_statistics(parallel), \
                _remat.rematerialize(remat):
            x = _preprocess(images, compute_dtype, augment_fn,
                            state.generator, aug_draws, rows)
            emb, weights = _forward(module, x, state.generator, drop_draws,
                                    rows)
            tp = getattr(module, "tp", None)
            if getattr(module, "n_classes", weights.shape[0]) != n_classes:
                raise ValueError(f"the module has {module.n_classes} class "
                                 f"weights, the step {n_classes} classes")
            with trace.span("arcface"):
                share = _share(parallel, arcface_loss(
                    at_least_f32(emb), labels, at_least_f32(weights),
                    margin=margin, scale=scale, tp=tp,
                    class_offset=getattr(module, "class_offset", 0)), rows)
            _backward_and_update(state, module, optimizer, share, (), device,
                                 parallel)
        return state, _global(parallel, {"loss": share.detach()})

    return step


def _softmax_tp(module: torch.nn.Module):
    """The model group of a softmax module whose logits are split by class
    (``parallel/tp.py``), else None."""
    head = getattr(module, "softmax_head", None)
    return getattr(head, "tp", None)


def _softmax_metrics(logits: torch.Tensor, labels: torch.Tensor,
                     n_classes: int, tp=None):
    """(cross-entropy, accuracy) of f32 ``logits``; with ``tp`` the logits
    are this rank's span of the classes, and the argmax is the first
    largest over every rank's."""
    if tp is None:
        loss = softmax_cross_entropy(logits, one_hot(labels, n_classes))
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc
    lo, hi = tp.span(n_classes)
    loss = softmax_cross_entropy(logits, one_hot(labels, hi - lo, lo), tp)
    best, idx = logits.detach().max(-1)
    both = torch.stack([best.to(torch.float64), (idx + lo).to(torch.float64)])
    parts = [torch.empty_like(both) for _ in range(tp.size)]
    torch.distributed.all_gather(parts, both, group=tp.group)
    values = torch.stack([p[0] for p in parts])          # [ranks, B]
    # the ranks hold ascending spans: the first rank with the largest value
    # holds the first argmax
    first = values.argmax(0)
    pred = torch.stack([p[1] for p in parts]).gather(0, first[None])[0]
    acc = (pred.long() == labels).float().mean()
    return loss, acc


def make_softmax_train_step(module: torch.nn.Module,
                            optimizer: OptimizerSpec, *, n_classes: int,
                            augment_fn: Optional[Augment] = None,
                            compute_dtype: torch.dtype = torch.float32):
    """Softmax pretraining step; returns ``step(state, images_u8, labels,
    aug_draws=None) -> (state, {"loss", "accuracy"})``. ``module`` is a
    :class:`~embeddingnet_tpu_torch.models.registry.SoftmaxModule`; the
    cross-entropy of its f32 logits is differentiated. Draws as
    :func:`make_arcface_train_step`'s."""

    def step(state: TrainState, images, labels,
             aug_draws: Optional[List[Draws]] = None,
             drop_draws: Optional[List[torch.Tensor]] = None
             ) -> Tuple[TrainState, dict]:
        if state.module is not module:
            raise ValueError("the state was created for another module")
        module.train()
        device, (images, labels) = _on_device(module, images, labels)
        x = _preprocess(images, compute_dtype, augment_fn, state.generator,
                        aug_draws)
        logits = _forward(module, x, state.generator, drop_draws).float()
        loss, acc = _softmax_metrics(logits, labels, n_classes,
                                     _softmax_tp(module))
        _backward_and_update(state, module, optimizer, loss, (), device)
        return state, {"loss": loss.detach(), "accuracy": acc.detach()}

    return step


def make_softmax_eval_step(module: torch.nn.Module, *, n_classes: int,
                           compute_dtype: torch.dtype = torch.float32):
    """Val cross-entropy and accuracy of the softmax pretraining, the
    module in eval mode; ``step(state, images_u8, labels) -> {"loss",
    "accuracy"}`` (device scalars). :func:`preprocess` runs T2 for uint8
    to bf16."""

    @torch.no_grad()
    def step(state, images, labels) -> dict:
        module.eval()
        _, (images, labels) = _on_device(module, images, labels)
        logits = module(preprocess(images, compute_dtype)).float()
        loss, acc = _softmax_metrics(logits, labels, n_classes,
                                     _softmax_tp(module))
        return {"loss": loss, "accuracy": acc}

    return step


def _encode_eval(module: torch.nn.Module, images: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    module.eval()
    device = next(module.parameters()).device
    images = torch.as_tensor(images).to(device, non_blocking=True)
    return module(preprocess(images, compute_dtype)).float()


def make_triplet_eval_step(module: torch.nn.Module, *, margin: float = 0.5,
                           compute_dtype: torch.dtype = torch.float32):
    """Val loss on offline (anchor, positive, negative) batches; returns
    ``step(state, anchors, positives, negatives) -> {"loss": mean hinge}``
    (a device scalar). The three uint8 batches go through one eval-mode
    forward of three times the batch, as the JAX step concatenates them;
    :func:`preprocess` runs T2 for uint8 to bf16."""

    @torch.no_grad()
    def step(state, anchors, positives, negatives) -> dict:
        stacked = torch.cat([torch.as_tensor(anchors),
                             torch.as_tensor(positives),
                             torch.as_tensor(negatives)])
        e_a, e_p, e_n = _encode_eval(module, stacked,
                                     compute_dtype).chunk(3)
        return {"loss": triplet_hinge(e_a, e_p, e_n, margin).mean()}

    return step


def make_eval_step(module: torch.nn.Module, *,
                   compute_dtype: torch.dtype = torch.float32):
    """Plain encode step, ``step(state, images) -> f32 embeddings`` on the
    module's device (eval mode)."""

    @torch.no_grad()
    def step(state, images) -> torch.Tensor:
        return _encode_eval(module, images, compute_dtype)

    return step
