"""TrainState: what a training run carries from step to step (port of
``embeddingnet_tpu/train/state.py``).

JAX keeps parameters, optimizer state, BatchNorm statistics, the random key
and the step count in one immutable pytree. Here the module holds the
parameters and the BatchNorm statistics, the ``torch.optim`` optimizer its
moments, and the step updates them in place (no second copy of the model);
the state adds the step count, a ``torch.Generator`` for the step's random
draws (the augmentation's), the plateau scale of the learning rate and,
with ``PERFORMANCE.ema_decay``, the parameters' EMA — the parts of the JAX
optimizer state that ``torch.optim`` has no place for.

:meth:`TrainState.state_dict` and :meth:`TrainState.load_state_dict` carry
all of it through a checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from embeddingnet_tpu_torch.train.optim import OptimizerSpec, init_param_ema


@dataclass
class TrainState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    plateau_scale: float = 1.0
    ema: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0

    @classmethod
    def create(cls, module: nn.Module, optimizer: OptimizerSpec,
               generator: Optional[torch.Generator] = None,
               trainable: Optional[Mapping[str, bool]] = None,
               ema_decay: float = 0.0) -> "TrainState":
        """Optimizer state at zero over ``module``'s parameters, or over
        those that ``trainable`` (name -> bool, :func:`~embeddingnet_tpu_
        torch.models.registry.backbone_param_mask`) marks True;
        ``generator`` defaults to one seeded with 0 on the device of the
        module's parameters, so that the step's draws stay there;
        ``ema_decay`` > 0 keeps an EMA of the parameters."""
        if generator is None:
            device = next(module.parameters()).device
            generator = torch.Generator(device=device).manual_seed(0)
        params = [p for n, p in module.named_parameters()
                  if trainable is None or trainable[n]]
        return cls(module=module, optimizer=optimizer.build(params),
                   generator=generator,
                   ema=init_param_ema(module) if ema_decay > 0 else None,
                   ema_decay=ema_decay)

    def state_dict(self) -> dict:
        """Module, optimizer, generator, step count, plateau scale and EMA,
        as tensors and plain Python values (``torch.save`` with
        ``weights_only`` loading)."""
        return {"module": self.module.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(),
                "step": self.step,
                "plateau_scale": self.plateau_scale,
                "ema": self.ema}

    def load_state_dict(self, state: Mapping) -> None:
        """Restore what :meth:`state_dict` saved, in place."""
        self.module.load_state_dict(state["module"])
        optimizer = state["optimizer"]
        for entry in optimizer["state"].values():
            # torch.optim keeps a loaded "step" where it lies; on the card
            # Adam would read each step back to the host, a sync per
            # parameter per update, so it goes back to the host as saved
            if torch.is_tensor(entry.get("step")):
                entry["step"] = entry["step"].cpu()
        self.optimizer.load_state_dict(optimizer)
        self.generator.set_state(state["generator"].cpu())
        self.step = int(state["step"])
        self.plateau_scale = float(state["plateau_scale"])
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the checkpoint's EMA does not match "
                             "PERFORMANCE.ema_decay")
        if self.ema is not None:
            for name, value in state["ema"].items():
                self.ema[name].copy_(value)
