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

``radam`` and ``rms_prop`` are optax's update rules written as
``torch.optim.Optimizer`` subclasses (:class:`RAdam`, :class:`RMSProp`):
``torch.optim.RAdam`` rectifies only where rho_t > 5 (optax's gate, with
the JAX package's threshold, is rho_t >= 4, as keras-radam's), and
``torch.optim.RMSprop`` adds eps outside the square root with decay 0.99
where optax's default is ``g / sqrt(nu + eps)`` with decay 0.9.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, Mapping, Sequence, Tuple,
                    Union)

import numpy as np
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
    * ``rms_prop``: :class:`RMSProp`, optax's ``rmsprop`` defaults;
    * ``radam``: :class:`RAdam`, optax's ``radam`` with the JAX package's
      ``threshold=4.0``;
    * anything else: plain ``torch.optim.SGD``."""
    name = (name or "sgd").lower()
    if name == "adam":
        return OptimizerSpec(torch.optim.Adam, learning_rate,
                             {"betas": (0.9, 0.999), "eps": 1e-8, **kwargs})
    if name == "adamw":
        kwargs.setdefault("weight_decay", 1e-4)
        return OptimizerSpec(torch.optim.AdamW, learning_rate,
                             {"betas": (0.9, 0.999), "eps": 1e-8, **kwargs})
    if name == "rms_prop":
        return OptimizerSpec(RMSProp, learning_rate, dict(kwargs))
    if name == "radam":
        kwargs.setdefault("threshold", 4.0)
        return OptimizerSpec(RAdam, learning_rate, dict(kwargs))
    return OptimizerSpec(torch.optim.SGD, learning_rate, dict(kwargs))


def _f32_power(x: float, n: int) -> np.float32:
    """``x ** n`` in float32 by square-and-multiply (XLA's ``pow`` of a
    float and an integer)."""
    x, acc = np.float32(x), np.float32(1.0)
    while n:
        if n & 1:
            acc = acc * x
        x = x * x
        n >>= 1
    return acc


class RAdam(torch.optim.Optimizer):
    """Rectified Adam with optax's ``scale_by_radam`` semantics: moments
    ``m``, ``v`` as Adam's, ``rho_inf = 2 / (1 - b2) - 1`` and at count
    ``t`` ``rho_t = rho_inf - 2 t b2^t / (1 - b2^t)``; where
    ``rho_t >= threshold`` the step is ``r_t m_hat / (sqrt(v_hat) + eps)``
    with ``r_t = sqrt((rho_t - 4)(rho_t - 2) rho_inf / ((rho_inf - 4)
    (rho_inf - 2) rho_t))``, else ``m_hat``; the parameter moves by ``-lr``
    times the step. The count is a host integer per parameter, and the
    scalars ``b^t``, ``rho_t`` and ``r_t`` are evaluated in float32 on the
    host, as optax evaluates them (float32 puts rho_t about 0.026 below its
    exact value, which moves r_t by 1% at the first rectified step)."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      threshold=threshold))

    @staticmethod
    def _scalars(t: int, b1: float, b2: float):
        """``(1 - b1^t, 1 - b2^t, rho_t, r_t)`` in float32 in optax's order
        of operations, ``b^t`` by square-and-multiply as XLA raises a float
        to an integer power (rho_t turns on the last bit of ``b2^t``); r_t
        is None below rho_t = 4."""
        f32 = np.float32
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _f32_power(b2, t)
        rho = f32(rho_inf) - f32(2 * t) * b2t / (f32(1.0) - b2t)
        r = None
        if rho >= 4.0:
            # optax's constant factor is a Python float, rounded once
            const = f32((rho_inf - 4.0) * (rho_inf - 2.0))
            r = np.sqrt((rho - f32(4.0)) * (rho - f32(2.0)) * f32(rho_inf)
                        / (const * rho))
        return f32(1.0) - _f32_power(b1, t), f32(1.0) - b2t, rho, r

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                bc1, bc2, rho, r = self._scalars(state["step"], b1, b2)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(p.grad, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
                m_hat = m / float(bc1)
                if rho >= group["threshold"] and r is not None:
                    update = float(r) * m_hat / (
                        (v / float(bc2)).sqrt() + group["eps"])
                else:
                    update = m_hat
                p.add_(update, alpha=-group["lr"])


class RMSProp(torch.optim.Optimizer):
    """RMSProp with optax's ``rmsprop`` defaults: ``nu = decay nu + (1 -
    decay) g^2`` from 0 (no bias correction, no momentum, not centred) and
    the step ``g / sqrt(nu + eps)`` (eps inside the square root); the
    parameter moves by ``-lr`` times the step."""

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay = group["decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["square_avg"] = torch.zeros_like(p)
                nu = state["square_avg"]
                nu.mul_(decay).addcmul_(p.grad, p.grad, value=1.0 - decay)
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt(),
                           value=-group["lr"])


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
    """Kernel-regulariser coefficients per backbone, from the reference's
    layer specs: ``simple`` and ``simple2`` have theirs
    (:data:`~embeddingnet_tpu_torch.models.simple.SIMPLE_REG_RULES`,
    :data:`~embeddingnet_tpu_torch.models.simple.SIMPLE2_REG_RULES`), the
    zoo backbones none."""
    if backbone_name == "simple":
        from embeddingnet_tpu_torch.models.simple import SIMPLE_REG_RULES
        return SIMPLE_REG_RULES
    if backbone_name == "simple2":
        from embeddingnet_tpu_torch.models.simple import SIMPLE2_REG_RULES
        return SIMPLE2_REG_RULES
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
