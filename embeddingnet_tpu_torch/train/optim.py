"""Optimizer factory, learning-rate schedule and L2 penalty (port of
``embeddingnet_tpu/train/optim.py``).

:func:`get_optimizer` returns an :class:`OptimizerSpec`: which
``torch.optim`` class to build, its settings, and the learning rate as a
number or a schedule of the step count. :class:`~embeddingnet_tpu_torch.
train.state.TrainState` builds the optimizer from it, and the train step
sets the learning rate from the schedule before every update, as optax
reads its schedule at the update's count (0 for the first step).

The JAX Trainer's optimizer chain maps onto torch as follows:

* ``scaled_by_plateau`` (``optax.scale(s)`` after the whole optimizer): the
  learning rate set before each update is ``schedule(step) * s``, with
  ``s`` the state's ``plateau_scale``; for Adam, AdamW (its decoupled decay
  included) and SGD the update is then ``s`` times optax's;
* ``masked`` (``freeze_backbone``): the frozen parameters stay out of the
  optimizer's groups, so they take no update, no moments and no decay;
* ``track_param_ema``: :func:`init_param_ema` and :func:`update_param_ema`.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, Mapping, Sequence, Tuple,
                    Union)

import torch

Schedule = Callable[[int], float]


def step_decay_schedule(initial_lr: float, decay_factor: float,
                        step_size_epochs: int, steps_per_epoch: int,
                        warmup_epochs: float = 0.0) -> Schedule:
    """``lr * decay^floor(epoch / step_size)`` with ``epoch = count //
    steps_per_epoch``, optionally preceded by a linear warm-up over
    ``warmup_epochs``."""
    warmup_steps = warmup_epochs * max(steps_per_epoch, 1)

    def schedule(count: int) -> float:
        epoch = count // max(steps_per_epoch, 1)
        lr = initial_lr * decay_factor ** math.floor(epoch / step_size_epochs)
        if warmup_steps > 0:
            lr = lr * min(1.0, (count + 1) / warmup_steps)
        return lr

    return schedule


@dataclass(frozen=True)
class OptimizerSpec:
    """A ``torch.optim`` class, its keyword settings, and the learning rate
    (a number, or a schedule of the step count)."""

    cls: type
    learning_rate: Union[float, Schedule]
    kwargs: Mapping = field(default_factory=dict)

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def build(self, params: Iterable[torch.nn.Parameter]
              ) -> torch.optim.Optimizer:
        return self.cls(params, lr=self.lr_at(0), **self.kwargs)


def get_optimizer(name: str, learning_rate, **kwargs) -> OptimizerSpec:
    """Name -> :class:`OptimizerSpec`, with optax's semantics:

    * ``adam``: ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2
      0.999, eps 1e-8 added outside the square root — torch's rule too);
    * ``adamw``: ``torch.optim.AdamW``, decoupled decay ``weight_decay``
      (optax's default 1e-4);
    * ``sgd``: plain ``torch.optim.SGD``.

    ``rms_prop`` and ``radam`` raise ``NotImplementedError`` naming
    ``ROADMAP.md``: their optax semantics are not yet matched."""
    name = (name or "sgd").lower()
    if name == "adam":
        return OptimizerSpec(torch.optim.Adam, learning_rate,
                             {"betas": (0.9, 0.999), "eps": 1e-8, **kwargs})
    if name == "adamw":
        kwargs.setdefault("weight_decay", 1e-4)
        return OptimizerSpec(torch.optim.AdamW, learning_rate,
                             {"betas": (0.9, 0.999), "eps": 1e-8, **kwargs})
    if name in ("rms_prop", "radam"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to PyTorch yet (see "
            f"ROADMAP.md, item 5); ported: adam, adamw, sgd")
    return OptimizerSpec(torch.optim.SGD, learning_rate, dict(kwargs))


def flax_path(name: str, param: torch.Tensor) -> str:
    """The JAX parameter path of a port parameter name
    (``backbone.stem_conv.weight`` -> ``backbone/stem_conv/kernel``), the
    names the regularisation rules are written against."""
    *prefix, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if param.ndim >= 2 else "scale"
    return "/".join(prefix + [leaf])


def l2_penalty(named_params: Iterable[Tuple[str, torch.Tensor]],
               rules: Sequence[Tuple[str, float]]) -> torch.Tensor:
    """Keras-style kernel regularisation, ``sum(coeff * sum(w^2))`` over the
    parameters whose JAX path matches a rule's regex (first match wins; no
    factor 1/2). With no rules: a zero scalar."""
    if not rules:
        return torch.zeros(())
    compiled = [(re.compile(pat), coeff) for pat, coeff in rules]
    total = None
    for name, param in named_params:
        path = flax_path(name, param)
        for pat, coeff in compiled:
            if pat.match(path):
                term = coeff * param.float().square().sum()
                total = term if total is None else total + term
                break
    return total if total is not None else torch.zeros(())


def reg_rules_for(backbone_name: str) -> Sequence[Tuple[str, float]]:
    """Kernel-regulariser coefficients per backbone: none for the zoo
    backbones. ``simple`` and ``simple2``, which have some, are not ported
    yet."""
    if backbone_name in ("simple", "simple2"):
        raise NotImplementedError(
            f"backbone {backbone_name!r} is not ported to PyTorch yet (see "
            f"ROADMAP.md, item 12)")
    return ()


# -- parameter EMA -----------------------------------------------------------
#
# The JAX ``track_param_ema`` chains after the optimizer and keeps
# ``d * ema + (1 - d) * p`` of the post-update parameters (not the BatchNorm
# statistics) in the optimizer state; here :class:`~embeddingnet_tpu_torch.
# train.state.TrainState` holds the EMA tensors and the train step updates
# them after ``optimizer.step()``.

def init_param_ema(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of every parameter of ``module``, by name (the EMA's start,
    as optax initialises it from the parameters)."""
    return {n: p.detach().clone() for n, p in module.named_parameters()}


@torch.no_grad()
def update_param_ema(ema: Dict[str, torch.Tensor], module: torch.nn.Module,
                     decay: float) -> None:
    """``ema = decay * ema + (1 - decay) * p`` in place, for every parameter
    of ``module``."""
    names = list(ema)
    params = dict(module.named_parameters())
    tensors = [ema[n] for n in names]
    torch._foreach_mul_(tensors, decay)
    torch._foreach_add_(tensors, [params[n].detach() for n in names],
                        alpha=1.0 - decay)
