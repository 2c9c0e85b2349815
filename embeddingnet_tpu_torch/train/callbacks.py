"""Host-loop training control: the reference's Keras callback stack as
explicit logic (the port's own copy of ``embeddingnet_tpu/train/
callbacks.py``; it is framework-free).

* :class:`ReduceLROnPlateau` — factor 0.1, patience 4 defaults like the
  reference; its scale becomes the train state's ``plateau_scale``.
* :class:`EarlyStopping` — patience 10 by default.
* :class:`History` — per-epoch metric lists, consumable by
  ``utils.viz.plot_grapths`` like the Keras ``history`` object.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional


def monitor_mode(monitor: str) -> str:
    """'max' for higher-is-better metrics (recall/accuracy), else 'min'.

    Deliberate deviation from Keras mode='auto' (which only flips to max
    for names containing 'acc'/'fmeasure', so 'val_recall1' would resolve
    to min and the best-checkpoint logic would save the WORST epoch): here
    recall-family metrics are recognized too. Matching is on whole
    '_'-separated tokens with an allowed numeric suffix ('val_recall1',
    'top5_acc'), not substrings, so a metric merely containing the letters
    'acc' mid-token is not max-moded.
    """
    tokens = (monitor or "").lower().replace("-", "_").split("_")
    maxish = ("recall", "acc", "accuracy", "fmeasure", "precision", "top",
              "auc", "f1", "map")
    for t in tokens:
        stem = t.rstrip("0123456789")
        if stem in maxish or t in maxish:
            return "max"
    return "min"


class ReduceLROnPlateau:
    """Keras-semantics plateau scaler (``tools/train.py:82-83``)."""

    def __init__(self, monitor: str = "val_loss", factor: float = 0.1,
                 patience: int = 4, min_delta: float = 1e-4,
                 verbose: bool = True, mode: str = "auto"):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_delta = min_delta
        self.verbose = verbose
        self.mode = monitor_mode(monitor) if mode == "auto" else mode
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0
        self.scale = 1.0

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def update(self, metrics: Dict[str, float]) -> float:
        """Feed end-of-epoch metrics; returns the current LR scale."""
        value = metrics.get(self.monitor)
        if value is None:
            return self.scale
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.scale *= self.factor
                self.wait = 0
                if self.verbose:
                    print(f"ReduceLROnPlateau: new lr scale {self.scale:g}")
        return self.scale

    def state_dict(self):
        return {"best": self.best, "wait": self.wait, "scale": self.scale}

    def load_state_dict(self, d):
        self.best, self.wait, self.scale = d["best"], d["wait"], d["scale"]


class EarlyStopping:
    """Keras-semantics early stop (``tools/train.py:84-86``)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 10,
                 min_delta: float = 0.0, verbose: bool = True,
                 mode: str = "auto"):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.verbose = verbose
        self.mode = monitor_mode(monitor) if mode == "auto" else mode
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0
        self.stopped = False

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def update(self, metrics: Dict[str, float]) -> bool:
        """Returns True when training should stop."""
        value = metrics.get(self.monitor)
        if value is None:
            return False
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
                if self.verbose:
                    print(f"EarlyStopping: no {self.monitor} improvement "
                          f"for {self.patience} epochs")
        return self.stopped

    def state_dict(self):
        return {"best": self.best, "wait": self.wait,
                "stopped": self.stopped}

    def load_state_dict(self, d):
        self.best, self.wait, self.stopped = (d["best"], d["wait"],
                                              d["stopped"])


class History:
    """Keras ``history.history``-shaped metric record."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def append(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(float(v))

    def last(self, key: str) -> Optional[float]:
        vals = self.history.get(key)
        return vals[-1] if vals else None
