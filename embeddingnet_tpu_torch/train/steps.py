"""The triplet train step (port of ``make_triplet_train_step`` in
``embeddingnet_tpu/train/steps.py``).

One step: uint8 P-K batch -> ``/255`` in the compute dtype
(:func:`~embeddingnet_tpu_torch.ops.preprocess.preprocess`) -> encoder in
train mode (BatchNorm on batch statistics, running averages updated) -> f32
embeddings -> mined triplet loss + L2 penalty -> backward -> optimizer
update with the learning rate of the schedule at this step. Augmentation is
not ported yet (``ROADMAP.md``); the JAX step's ``augment_fn`` has no
counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from embeddingnet_tpu_torch.ops import mining
from embeddingnet_tpu_torch.ops.preprocess import preprocess
from embeddingnet_tpu_torch.train.optim import OptimizerSpec, l2_penalty
from embeddingnet_tpu_torch.train.state import TrainState


def make_triplet_train_step(module: torch.nn.Module,
                            optimizer: OptimizerSpec, *,
                            margin: float = 0.5, mode: str = "semihard",
                            reg_rules: Sequence = (),
                            compute_dtype: torch.dtype = torch.float32,
                            max_positives: Optional[int] = None):
    """Online-mining triplet step over P-K batches; returns
    ``step(state, images_u8, labels) -> (state, metrics)``.

    The step updates ``state`` in place (parameters, BatchNorm statistics,
    optimizer moments, step count) and returns it. ``metrics`` holds device
    scalars — ``loss`` (without the penalty), ``n_triplets``,
    ``frac_mined``, ``mean_pos_dist``, ``mean_neg_dist`` — read them with
    ``.item()`` where the host needs them. ``optimizer`` is the spec the
    state was created from; its schedule sets the learning rate. Images and
    labels are moved to the module's device; the step differentiates
    ``loss + l2_penalty``, as the JAX step's ``loss_fn`` does."""

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[TrainState, dict]:
        if state.module is not module:
            raise ValueError("the state was created for another module")
        module.train()
        device = next(module.parameters()).device
        images = torch.as_tensor(images).to(device, non_blocking=True)
        labels = torch.as_tensor(labels).to(device, non_blocking=True)
        emb = module(preprocess(images, compute_dtype)).float()
        loss, stats = mining.mined_triplet_loss(
            emb, labels, margin=margin, mode=mode,
            max_positives=max_positives)
        total = loss
        if reg_rules:
            total = total + l2_penalty(module.named_parameters(),
                                       reg_rules).to(device)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in module.parameters():
            # optax updates every leaf: a parameter the loss does not reach
            # (the classifier head) takes a zero gradient, not none
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = optimizer.lr_at(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics = {
            "loss": loss.detach(),
            "n_triplets": stats.n_triplets,
            "frac_mined": stats.frac_mined,
            "mean_pos_dist": stats.mean_pos_dist,
            "mean_neg_dist": stats.mean_neg_dist,
        }
        return state, metrics

    return step
