"""Visualisation (the port of ``embeddingnet_tpu/utils/viz.py``): the
t-SNE scatter of an encodings DB (matplotlib, or plotly's interactive
variant), the per-metric history curves and batch mosaics. sklearn,
matplotlib (the headless Agg backend), plotly and cv2 are imported inside
the functions that need them.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt


def load_encodings(path_to_encodings: str):
    """The encodings DB pickle of ``EmbeddingNet.save_encodings`` (the
    reference's ``utils.py:29-33``; a pickle: load only files this program
    wrote)."""
    with open(path_to_encodings, "rb") as f:
        return pickle.load(f)


def plot_tsne(encodings_path: str, save_plot_dir: str, show: bool = False):
    """t-SNE scatter of the encodings DB (``utils.py:36-58``)."""
    from sklearn.manifold import TSNE
    plt = _plt()
    encodings = load_encodings(encodings_path) if isinstance(
        encodings_path, str) else encodings_path
    labels = list(set(encodings["labels"]))
    n = len(encodings["labels"])
    tsne = TSNE(perplexity=min(30.0, max(2.0, (n - 1) / 3.0)))
    tsne_train = tsne.fit_transform(np.asarray(encodings["encodings"]))
    fig, ax = plt.subplots(figsize=(16, 16))
    lab_arr = np.array(encodings["labels"])
    for label in labels:
        xs = tsne_train[lab_arr == label, 0]
        ys = tsne_train[lab_arr == label, 1]
        ax.scatter(xs, ys, label=label)
        for x, y in zip(xs, ys):
            ax.annotate(label, (x, y), size=8, textcoords="offset points",
                        xytext=(0, 10), ha="center")
    ax.legend(bbox_to_anchor=(1.05, 1), fontsize="small", ncol=2)
    out = os.path.join(save_plot_dir, "tsne.png")
    fig.savefig(out)
    plt.close(fig)
    return out


def plot_tsne_interactive(encodings):
    """Plotly scatter (``utils.py:61-91``); requires plotly (optional)."""
    try:
        import plotly.graph_objects as go
    except ImportError as e:
        raise ImportError(
            "plotly is not installed; plot_tsne_interactive is optional "
            "(use plot_tsne for the matplotlib variant)") from e
    from sklearn.manifold import TSNE
    if isinstance(encodings, str):
        encodings = load_encodings(encodings)
    labels = list(set(encodings["labels"]))
    tsne_train = TSNE().fit_transform(np.asarray(encodings["encodings"]))
    fig = go.Figure()
    lab_arr = np.array(encodings["labels"])
    rng = np.random.default_rng(0)
    for label in labels:
        xs = tsne_train[lab_arr == label, 0]
        ys = tsne_train[lab_arr == label, 1]
        color = "rgba({},{},{},0.8)".format(*rng.integers(0, 255, 3))
        fig.add_trace(go.Scatter(x=xs, y=ys, mode="markers",
                                 marker=dict(color=color, size=10),
                                 text=str(label), name=str(label)))
    fig.update_layout(title=go.layout.Title(text="t-SNE plot", xref="paper",
                                            x=0),
                      autosize=False, width=1000, height=1000)
    return fig


def plot_grapths(history, save_path: str) -> List[str]:
    """One PNG per metric, ``<save_path>/<metric>.png``; ``history`` is a
    :class:`~embeddingnet_tpu_torch.train.callbacks.History` (or any object
    with ``.history``) or a plain dict of metric lists."""
    plt = _plt()
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


def plot_batch_simple(data, targets, class_names, save_path=None):
    """Horizontal mosaic of a classification batch (``utils.py:106-120``)."""
    import cv2
    plt = _plt()
    imgs = np.asarray(data[0] if isinstance(data, (list, tuple)) else data)
    num_imgs, img_h, img_w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    full_img = np.zeros((img_h, num_imgs * img_w, 3), dtype=np.uint8)
    indxs = np.argmax(np.asarray(targets), axis=1)
    names = [class_names[i] for i in indxs]
    for i in range(num_imgs):
        tile = imgs[i]
        if tile.dtype != np.uint8:
            tile = (tile[..., ::-1] * 255).astype(np.uint8)  # BGR->RGB
        full_img[:, i * img_w:(i + 1) * img_w, :] = tile
        cv2.putText(full_img, str(names[i]), (img_w * i + 5, 20),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.2, (0, 255, 0), 1,
                    cv2.LINE_AA)
    fig = plt.figure(figsize=(20, 2))
    plt.imshow(full_img)
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
    return full_img


def plot_batch(data, targets, save_path=None):
    """Grid mosaic of pair/triplet batches (``utils.py:123-140``)."""
    import cv2
    plt = _plt()
    num_imgs = np.asarray(data[0]).shape[0]
    it_val = len(data)
    fig, axs = plt.subplots(num_imgs, it_val,
                            figsize=(30, 50), facecolor="w", edgecolor="k")
    fig.subplots_adjust(hspace=.5, wspace=.001)
    axs = np.atleast_2d(axs)
    for img_idx in range(num_imgs):
        for j in range(it_val):
            image = np.asarray(data[j][img_idx])
            if image.dtype != np.uint8:
                image = (image * 255).astype(np.uint8)
            img = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
            axs[img_idx, j].imshow(img)
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
