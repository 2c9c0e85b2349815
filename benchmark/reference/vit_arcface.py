"""Plain float32 ArcFace training steps of a Vision Transformer, written from
the papers: ViT-B/16 (Dosovitskiy et al., arXiv:2010.11929, Table 1: patch
16, 12 pre-norm encoder blocks of width 768, 12 heads of 64, MLP 3,072,
exact GELU, a class token and learned position embeddings), the ArcFace
loss (Deng et al., arXiv:1801.07698: an additive angular margin ``m`` on the
target class's angle between the L2-normalised embedding and class weight,
logits ``s`` times the cosines, softmax cross-entropy), autograd's
gradients, and Adam (Kingma & Ba, arXiv:1412.6980) with the warm-up
schedule of :mod:`benchmark.reference.triplet`.

Departures from the papers, each the program's as well:

* the class token is folded into the patch grid, ``grid + cls / (gh *
  gw)``, and the embedding is that grid's mean, then Dense(len / 2) ->
  ReLU -> Dense(len) -> ReLU (the CNNs' embedding head), where the paper
  reads the class token alone;
* LayerNorm eps 1e-12, and no LayerNorm before the first block;
* ArcFace: no easy-margin branch, the cosines clipped to +-(1 - 1e-7), no
  penalty on the weights;
* the augmentation is the ``deepfake`` preset, a horizontal flip at p =
  0.5 on the 0..255 images, from recorded per-image gates; the images are
  flipped and divided by 255 in float32, as the program's batches are,
  whatever the ``dtype`` of the steps.

The weights are a flat ``{name: tensor}`` dict under the program's names
(``encoder.backbone.block3.attn.query.weight``, ``class_weights``, ...), so
the benchmark hands the same values to both. ``quant`` rounds the operands
of every product (the patch embed, each Dense, attention's two batched
products) to a narrower type (:mod:`benchmark.reference.precision`); the
ArcFace cosines stay float32, as the program computes them whatever its
compute dtype, and so do LayerNorm, softmax, GELU and the pooling.
``remat`` runs each encoder block under a checkpoint, so that a batch of
256 at 224 px fits beside what the program leaves on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.models import _q, conv, dense
from benchmark.reference.triplet import B1, B2, EPS, learning_rate

LN_EPS = 1e-12
BACKBONE = "encoder.backbone"


class Shape(NamedTuple):
    patch: int
    dim: int
    depth: int
    heads: int
    mlp: int


VARIANTS = {"vit-b16": Shape(patch=16, dim=768, depth=12, heads=12,
                             mlp=3072)}

Leaf = Tuple[str, Tuple[int, ...], str, int]


def leaves(shape: Shape, image_size: int, encodings_len: int,
           n_classes: int) -> List[Leaf]:
    """Every parameter: ``(name, shape, kind, fan_in)``."""
    d, b = shape.dim, BACKBONE
    tokens = (image_size // shape.patch) ** 2 + 1

    def dense_(name, cin, cout, kind="lecun"):
        return [(name + ".weight", (cout, cin), kind, cin),
                (name + ".bias", (cout,), "zero", 0)]

    def ln(name):
        return [(name + ".weight", (d,), "one", 0),
                (name + ".bias", (d,), "zero", 0)]

    out = [("class_weights", (n_classes, encodings_len), "class", 0),
           (b + ".cls_token", (1, 1, d), "embed", 0),
           (b + ".pos_embed", (1, tokens, d), "embed", 0),
           (b + ".patch_embed.weight", (d, 3, shape.patch, shape.patch),
            "lecun", 3 * shape.patch ** 2),
           (b + ".patch_embed.bias", (d,), "zero", 0)]
    for i in range(shape.depth):
        blk = f"{b}.block{i + 1}"
        out += ln(blk + ".ln1")
        for proj in ("query", "key", "value", "out"):
            out += dense_(f"{blk}.attn.{proj}", d, d)
        out += ln(blk + ".ln2")
        out += dense_(blk + ".mlp.fc1", d, shape.mlp)
        out += dense_(blk + ".mlp.fc2", shape.mlp, d)
    out += ln(b + ".ln_final")
    out += dense_("encoder.head.dense_1", d, encodings_len // 2, "he")
    out += dense_("encoder.head.dense_2", encodings_len // 2, encodings_len,
                  "he")
    return out


def make_weights(shape: Shape, image_size: int, encodings_len: int,
                 n_classes: int, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter from ``seed``, drawn on ``device`` in one call:
    the patch embed and the encoder's Dense layers normal with variance
    1 / fan-in (Flax's ``lecun_normal``, untruncated), the head's Dense
    layers 2 / fan-in (He, before a ReLU), the class token and position
    embedding normal(0.02), the class weights normal(0.01), biases 0,
    LayerNorm scales 1."""
    spec = leaves(shape, image_size, encodings_len, n_classes)
    std = {"lecun": lambda fan: math.sqrt(1.0 / fan),
           "he": lambda fan: math.sqrt(2.0 / fan),
           "embed": lambda fan: 0.02, "class": lambda fan: 0.01}
    drawn = [(n, s, std[k](f)) for n, s, k, f in spec if k in std]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, s, scale in drawn:
        n = math.prod(s)
        out[name] = flat[at:at + n].view(s) * scale
        at += n
    for name, s, kind, _ in spec:
        if kind == "one":
            out[name] = torch.ones(s, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(s, device=device)
    return {name: out[name] for name, _, _, _ in spec}


# -- the forward -------------------------------------------------------------

def flip(x: torch.Tensor, draws: Sequence[dict]) -> torch.Tensor:
    """The ``deepfake`` preset on NHWC images: each image mirrored left to
    right where its gate (``draws[0]["gate"]``, [B, 1, 1, 1]) is 1."""
    (d,) = draws
    g = d["gate"]
    return x * (1.0 - g) + x.flip(2) * g


def sample_flip(batch: int, generator: torch.Generator, device,
                p: float = 0.5) -> List[dict]:
    """The ``deepfake`` preset's draws for a batch: its one op's per-image
    gate, 1.0 with probability ``p`` ([B, 1, 1, 1], float32)."""
    u = torch.rand((batch, 1, 1, 1), generator=generator,
                   device=generator.device)
    return [{"gate": (u < p).float().to(device)}]


def _matmul(a, b, quant):
    y = _q(quant, a) @ _q(quant, b)
    return y if quant is None else quant.output(y)


def _layer_norm(P, name, x):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                        P[name + ".bias"], LN_EPS)


def attention(P, name, x, heads, quant=None):
    """Multi-head self-attention: the q, k, v projections, q scaled by
    1 / sqrt(head_dim), the softmax of q k^T over the keys, its product
    with v, the heads merged, the out projection."""
    b, n, d = x.shape
    hd = d // heads

    def split(t):
        return t.view(b, n, heads, hd).transpose(1, 2)

    q = split(dense(P, name + ".query", x, quant)) / math.sqrt(hd)
    k = split(dense(P, name + ".key", x, quant))
    v = split(dense(P, name + ".value", x, quant))
    w = torch.softmax(_matmul(q, k.transpose(-2, -1), quant), dim=-1)
    y = _matmul(w, v, quant).transpose(1, 2).reshape(b, n, d)
    return dense(P, name + ".out", y, quant)


def block(P, name, x, heads, quant=None):
    """A pre-norm encoder block (ViT Eq. 2-3)."""
    x = x + attention(P, name + ".attn", _layer_norm(P, name + ".ln1", x),
                      heads, quant)
    h = _layer_norm(P, name + ".ln2", x)
    h = F.gelu(dense(P, name + ".mlp.fc1", h, quant))
    return x + dense(P, name + ".mlp.fc2", h, quant)


def embed(P, shape: Shape, x_nhwc: torch.Tensor, quant=None,
          remat: bool = False) -> torch.Tensor:
    """Images [B, H, W, 3] in [0, 1] -> embeddings [B, encodings_len]."""
    b = x_nhwc.shape[0]
    x = conv(P, BACKBONE + ".patch_embed", x_nhwc.permute(0, 3, 1, 2),
             stride=shape.patch, quant=quant, bias=True)
    gh, gw = x.shape[2:]
    x = x.flatten(2).transpose(1, 2)                         # [B, L, D]
    cls = P[BACKBONE + ".cls_token"].expand(b, 1, shape.dim)
    x = torch.cat([cls, x], dim=1) + P[BACKBONE + ".pos_embed"]
    for i in range(shape.depth):
        args = (P, f"{BACKBONE}.block{i + 1}", x, shape.heads, quant)
        x = (checkpoint(block, *args, use_reentrant=False) if remat
             else block(*args))
    x = _layer_norm(P, BACKBONE + ".ln_final", x)
    grid = x[:, 1:] + x[:, :1] / (gh * gw)                   # the fold
    h = F.relu(dense(P, "encoder.head.dense_1", grid.mean(1), quant))
    return F.relu(dense(P, "encoder.head.dense_2", h, quant))


def arcface_loss(e: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
                 margin: float, scale: float) -> torch.Tensor:
    """ArcFace (Deng et al., Eq. 3): the mean softmax cross-entropy of
    ``scale * cos(theta_y + margin)`` for the target class and ``scale *
    cos(theta_j)`` for the others."""
    cos = (F.normalize(e, dim=-1, eps=1e-12)
           @ F.normalize(w, dim=-1, eps=1e-12).T).clamp(-1.0 + 1e-7,
                                                          1.0 - 1e-7)
    target = F.one_hot(labels.long(), w.shape[0]).bool()
    logits = scale * torch.where(target, torch.cos(torch.arccos(cos)
                                                    + margin), cos)
    return F.cross_entropy(logits, labels.long())


class Steps:
    """Runs a configuration's first ArcFace steps from given weights,
    batches and flip draws, in ``dtype`` (float32; float64 for the tests);
    keeps what the benchmark compares."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 quant=None, remat: bool = True, scale: float = 64.0,
                 shape: Optional[Shape] = None,
                 dtype: torch.dtype = torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model, gen, train = cfg["MODEL"], cfg["GENERATOR"], cfg["TRAIN"]
        self.shape = shape or VARIANTS[model["backbone_name"]]
        self.margin, self.scale = gen["margin"], scale
        preset = gen.get("augmentations") or None
        if preset not in (None, "deepfake"):
            raise ValueError(f"no reference for the {preset!r} preset")
        self.flip = preset == "deepfake"
        self.schedule = dict(
            lr=train["learning_rate"], decay=train.get("decay_factor", 1.0),
            step_size=train.get("step_size", 1),
            steps_per_epoch=gen["n_batches"],
            warmup_epochs=train.get("warmup_epochs", 0))
        self.quant, self.remat, self.dtype = quant, remat, dtype
        self.names = list(weights)
        self.P = {k: v.detach().clone().to(dtype).requires_grad_()
                  for k, v in weights.items()}
        self.params = [self.P[n] for n in self.names]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0
        self.losses: List[float] = []
        self.first_embeddings: Optional[torch.Tensor] = None
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    def step(self, images_u8: torch.Tensor, labels: torch.Tensor,
             aug_draws: Optional[Sequence[dict]] = None):
        x = images_u8.float()
        if self.flip:
            x = flip(x, aug_draws)
        x = (x / 255.0).to(self.dtype)
        e = embed(self.P, self.shape, x, self.quant, self.remat)
        if self.first_embeddings is None:
            self.first_embeddings = e.detach().clone()
        loss = arcface_loss(e, labels, self.P["class_weights"], self.margin,
                            self.scale)
        grads = torch.autograd.grad(loss, self.params)
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
