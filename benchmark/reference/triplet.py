"""Plain triplet training steps: augmentation, the float32 encoder in train
mode, the mined triplet loss, autograd's gradients and Adam's update, from
the definitions (Hermans et al., arXiv:1703.07737, for batch-all and
batch-hard; Kingma & Ba, arXiv:1412.6980, for Adam).

* Distances are squared euclidean; a triplet's loss is ``max(d(a, p) -
  d(a, n) + margin, 0)``; positives are the other images of the anchor's
  class, negatives the images of other classes.
* batch-all: the mean over the triplets whose loss is positive (0 when
  none is).
* batch-hard: per anchor the farthest positive and the closest negative,
  the mean over the anchors that have both.
* Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, the learning
  rate ``lr * decay ** floor(epoch / step_size)`` of the step's epoch,
  times ``min(1, (step + 1) / (warmup_epochs * steps_per_epoch))`` during
  a warm-up.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import augment, models

B1, B2, EPS = 0.9, 0.999, 1e-8


def sq_dists(e: torch.Tensor) -> torch.Tensor:
    d = (e[:, None, :] - e[None, :, :]).square().sum(-1)
    return d


def batch_all_loss(e: torch.Tensor, labels: torch.Tensor,
                   margin: float) -> torch.Tensor:
    d = sq_dists(e)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(len(labels), dtype=torch.bool, device=e.device)
    pos = same & ~eye
    n_pos = int(pos.sum(1).max())
    # each anchor's positives, padded with invalid entries
    order = torch.argsort((~pos).to(torch.int8), dim=1, stable=True)
    pidx = order[:, :n_pos]
    pvalid = pos.gather(1, pidx)
    dap = d.gather(1, pidx)                                    # [B, P]
    loss = dap[:, :, None] - d[:, None, :] + margin            # [B, P, B]
    valid = pvalid[:, :, None] & ~same[:, None, :]
    hinge = torch.where(valid, loss.clamp_min(0.0), 0.0)
    active = ((hinge > 0) & valid).sum()
    return hinge.sum() / active.clamp_min(1)


def batch_hard_loss(e: torch.Tensor, labels: torch.Tensor,
                    margin: float) -> torch.Tensor:
    d = sq_dists(e)
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(len(labels), dtype=torch.bool, device=e.device)
    pos, neg = same & ~eye, ~same
    hp = torch.where(pos, d, float("-inf")).amax(1)
    hn = torch.where(neg, d, float("inf")).amin(1)
    valid = pos.any(1) & neg.any(1)
    per = torch.where(valid, (hp - hn + margin).clamp_min(0.0), 0.0)
    return per.sum() / valid.sum().clamp_min(1)


LOSSES = {"batch_all": batch_all_loss, "batch_hard": batch_hard_loss}


def mean_pos_dist(e: torch.Tensor, labels: torch.Tensor) -> float:
    """The mean euclidean distance between two images of one class."""
    same = labels[:, None] == labels[None, :]
    pos = same & ~torch.eye(len(labels), dtype=torch.bool, device=e.device)
    e = e.double()
    n = e.square().sum(-1)
    d = (n[:, None] + n[None, :] - 2.0 * e @ e.T).clamp_min(0.0).sqrt()
    return float(d[pos].mean())


def learning_rate(step: int, lr: float, decay: float, step_size: int,
                  steps_per_epoch: int, warmup_epochs: float) -> float:
    epoch = step // max(steps_per_epoch, 1)
    out = lr * decay ** math.floor(epoch / step_size)
    warm = warmup_epochs * max(steps_per_epoch, 1)
    if warm > 0:
        out *= min(1.0, (step + 1) / warm)
    return out


class Steps:
    """Runs a configuration's first triplet steps from given weights,
    batches and draws; keeps what the benchmark compares."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 quant=None, remat: bool = True):
        model, gen, train = cfg["MODEL"], cfg["GENERATOR"], cfg["TRAIN"]
        self.backbone = model["backbone_name"]
        self.encodings_len = model["encodings_len"]
        self.margin = gen["margin"]
        self.mode = gen["negatives_selection_mode"]
        self.preset = gen.get("augmentations") or None
        self.schedule = dict(
            lr=train["learning_rate"], decay=train.get("decay_factor", 1.0),
            step_size=train.get("step_size", 1),
            steps_per_epoch=gen["n_batches"],
            warmup_epochs=train.get("warmup_epochs", 0))
        self.quant, self.remat = quant, remat
        names = models.parameter_names(self.backbone, self.encodings_len)
        self.P = {k: v.detach().clone().float() for k, v in weights.items()}
        self.params = [self.P[n].requires_grad_() for n in names]
        self.names = names
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0
        self.losses: List[float] = []
        self.pos_dists: List[float] = []
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None
        self.first_bn_vars: Dict[str, torch.Tensor] = {}

    def step(self, images_u8: torch.Tensor, labels: torch.Tensor,
             aug_draws: Sequence[dict], drop_masks: Sequence[torch.Tensor]):
        x = images_u8.float()
        if self.preset:
            x = augment.apply(self.preset, x, aug_draws)
        x = x / 255.0
        stats = self.first_bn_vars if self.t == 0 else None
        e = models.embed(self.P, self.backbone, x, True, drop_masks,
                         self.quant, self.remat, stats)
        loss = LOSSES[self.mode](e, labels, self.margin)
        self.pos_dists.append(mean_pos_dist(e.detach(), labels))
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if self.first_grads is None:
            self.first_grads = {n: g.detach().clone()
                                for n, g in zip(self.names, grads)}
        lr = learning_rate(self.t, **self.schedule)
        self.t += 1
        with torch.no_grad():
            for p, g, m, v in zip(self.params, grads, self.m, self.v):
                m.mul_(B1).add_(g, alpha=1 - B1)
                v.mul_(B2).addcmul_(g, g, value=1 - B2)
                mhat = m / (1 - B1 ** self.t)
                vhat = v / (1 - B2 ** self.t)
                p.sub_(lr * mhat / (vhat.sqrt() + EPS))
        self.losses.append(float(loss.detach()))

    def parameters(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in zip(self.names, self.params)}
