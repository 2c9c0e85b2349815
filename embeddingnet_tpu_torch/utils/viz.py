"""History plots (the port of ``plot_grapths`` in
``embeddingnet_tpu/utils/viz.py``). matplotlib is imported inside the
function, with the headless Agg backend."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence


def plot_grapths(history, save_path: str) -> List[str]:
    """One PNG per metric, ``<save_path>/<metric>.png``; ``history`` is a
    :class:`~embeddingnet_tpu_torch.train.callbacks.History` (or any object
    with ``.history``) or a plain dict of metric lists."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    hist: Dict[str, Sequence[float]] = getattr(history, "history", history)
    outs = []
    for k, v in hist.items():
        fig, ax = plt.subplots()
        ax.plot(list(range(len(v))), v)
        ax.set(xlabel="epoch", ylabel=str(k), title=str(k))
        ax.grid()
        out = os.path.join(save_path, f"{k}.png")
        fig.savefig(out)
        plt.close(fig)
        outs.append(out)
    return outs
