"""TrainState: what a training run carries from step to step (port of
``embeddingnet_tpu/train/state.py``).

JAX keeps parameters, optimizer state, BatchNorm statistics, the random key
and the step count in one immutable pytree. Here the module holds the
parameters and the BatchNorm statistics, the ``torch.optim`` optimizer its
moments, and the step updates them in place (no second copy of the model);
the state adds the step count and a ``torch.Generator`` for the step's
random draws (batch-all mining, the one mode ported, draws none).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from embeddingnet_tpu_torch.train.optim import OptimizerSpec


@dataclass
class TrainState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, optimizer: OptimizerSpec,
               generator: Optional[torch.Generator] = None) -> "TrainState":
        """Optimizer state at zero over ``module``'s parameters;
        ``generator`` defaults to one seeded with 0."""
        return cls(module=module,
                   optimizer=optimizer.build(module.parameters()),
                   generator=(generator if generator is not None
                              else torch.Generator().manual_seed(0)))
