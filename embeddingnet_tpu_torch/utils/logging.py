"""Per-epoch metrics logging (the port's own copy of
``embeddingnet_tpu/utils/logging.py``).

:class:`MetricsLogger` always writes JSONL and mirrors to TensorBoard
(through the pure-Python :mod:`embeddingnet_tpu_torch.utils.tb_writer`) and
wandb when ``GENERAL.tensorboard_callback`` / ``GENERAL.wandb_callback``
ask for them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, *, tensorboard: bool = False,
                 wandb_enabled: bool = False, run_name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, f"{run_name}_metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._tb_writer = None
        self._wandb = None
        if tensorboard:
            from embeddingnet_tpu_torch.utils.tb_writer import TBEventWriter
            self._tb_writer = TBEventWriter(log_dir)
        if wandb_enabled:
            try:
                import wandb
                wandb.init(project=run_name)
                self._wandb = wandb
            except ImportError:
                pass

    def log(self, step: int, metrics: Dict[str, float],
            prefix: Optional[str] = None):
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}/{k}" if prefix else k
            record[key] = float(v)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb_writer is not None:
            for k, v in record.items():
                if k not in ("step", "time"):
                    self._tb_writer.add_scalar(k, v, step)
            self._tb_writer.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items()
                             if k not in ("step", "time")}, step=step)

    def close(self):
        self._jsonl.close()
        if self._tb_writer is not None:
            self._tb_writer.close()
