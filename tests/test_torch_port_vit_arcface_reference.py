"""The port's ArcFace step on a ViT against the benchmark's plain reference
(``benchmark/reference/vit_arcface.py``), on the CPU: a tiny ViT-B/16 (32
px, patch 8, width 64, depth 2, 4 heads; its ``_VARIANTS`` entry replaced)
under ``ArcFaceModule``, weights drawn by the reference's
``make_weights``, the ``deepfake`` flip on recorded gates, one step of Adam
with its warm-up.

* float64 (1e-10) and float32 (1e-5): the first forward's embeddings
  (relative L2), the loss (relative), every gradient (each leaf's L2 gap
  over the larger of its norm and the median leaf's: the key biases'
  exact gradient is zero, so theirs is rounding), and the parameters
  after the step (the same gap; in float64 their change over the step
  too), key biases left out: Adam turns a rounding-level gradient into a
  step of up to ``lr`` of either sign. In float32 the change alone is
  1.4e-5 apart: Adam's step of an entry whose gradient is within a few
  ``eps`` of zero follows that gradient's rounding.
* bf16 compute (the configuration's): the embeddings within 3e-2 and the
  loss within 5e-3 of the float32 reference, at about four times what was
  measured (8.0e-3 and 1.2e-3); bf16's unit roundoff is 3.9e-3.
"""

import statistics

import pytest

torch = pytest.importorskip("torch")

from benchmark.reference import vit_arcface as ref  # noqa: E402
from embeddingnet_tpu_torch.models import vit as tvit  # noqa: E402
from embeddingnet_tpu_torch.models.registry import ArcFaceModule  # noqa
from embeddingnet_tpu_torch.ops.augment import get_aug  # noqa: E402
from embeddingnet_tpu_torch.train import optim, steps  # noqa: E402
from embeddingnet_tpu_torch.train.state import TrainState  # noqa: E402

SHAPE = ref.Shape(patch=8, dim=64, depth=2, heads=4, mlp=256)
SIZE, ENC, CLASSES, BATCH = 32, 32, 6, 8
CFG = {"MODEL": {"backbone_name": "vit-b16"},
       "GENERATOR": {"margin": 0.5, "n_batches": 4,
                     "augmentations": "deepfake"},
       "TRAIN": {"learning_rate": 0.01, "decay_factor": 0.95,
                 "step_size": 1, "warmup_epochs": 1}}
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
KEY_BIAS = ".attn.key.bias"


@pytest.fixture(autouse=True)
def _tiny_vit(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(tvit._VARIANTS, "vit-b16",
                        dict(patch=SHAPE.patch, dim=SHAPE.dim,
                             depth=SHAPE.depth, heads=SHAPE.heads))
    yield
    torch.set_num_threads(n)


def _batch():
    g = torch.Generator().manual_seed(7)
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.arange(BATCH) % CLASSES
    gate = torch.tensor([1.0, 0.0] * (BATCH // 2)).view(BATCH, 1, 1, 1)
    return images, labels, [{"gate": gate}]


def _both(param_dtype, compute_dtype):
    """One program step and one reference step from the same weights:
    ``(program, reference)``, each a dict of the embeddings, the loss, the
    gradients and the parameters before and after."""
    w0 = ref.make_weights(SHAPE, SIZE, ENC, CLASSES, seed=11, device="cpu")
    images, labels, draws = _batch()
    module = ArcFaceModule("vit-b16", ENC, n_classes=CLASSES,
                           input_shape=(SIZE, SIZE, 3), dtype=compute_dtype)
    module.load_state_dict(w0)
    module.to(param_dtype)
    t = CFG["TRAIN"]
    spec = optim.get_optimizer("adam", optim.step_decay_schedule(
        t["learning_rate"], t["decay_factor"], t["step_size"],
        CFG["GENERATOR"]["n_batches"], t["warmup_epochs"]))
    state = TrainState.create(module, spec,
                              generator=torch.Generator().manual_seed(3))
    augment = get_aug("deepfake", (SIZE, SIZE, 3))
    step = steps.make_arcface_train_step(
        module, spec, n_classes=CLASSES, margin=0.5, augment_fn=augment,
        compute_dtype=compute_dtype or param_dtype)
    before = {k: v.detach().clone() for k, v in module.named_parameters()}
    with torch.no_grad():
        x = (augment.apply(images.float(), draws) / 255.0).to(
            compute_dtype or param_dtype)
        emb = module(x)[0]
    _, metrics = step(state, images, labels, aug_draws=draws)
    prog = {"emb": emb.double(), "loss": float(metrics["loss"]),
            "grads": {k: p.grad.double() for k, p in
                      module.named_parameters()},
            "before": before,
            "after": {k: p.detach().double() for k, p in
                      module.named_parameters()}}
    r = ref.Steps(CFG, w0, remat=True, shape=SHAPE,
                  dtype=torch.float64 if param_dtype == torch.float64
                  else torch.float32)
    r.step(images, labels, draws)
    reference = {"emb": r.first_embeddings.double(), "loss": r.losses[0],
                 "grads": {k: g.double() for k, g in r.first_grads.items()},
                 "after": {k: p.double() for k, p in
                           r.parameters().items()}}
    return prog, reference


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _leaf_gaps(got, want):
    """Each leaf's L2 gap over the larger of its norm and the median
    leaf's."""
    norms = {k: float(v.norm()) for k, v in want.items()}
    med = statistics.median(norms.values())
    return {k: float((got[k] - want[k]).norm()) / max(norms[k], med)
            for k in want}


@pytest.fixture(scope="module")
def _steps():
    """``_both`` in a dtype, once per module (under ``_tiny_vit``)."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = _both(dtype, None)
        return cache[dtype]
    return get


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_embeddings_and_loss_match_the_reference(dtype, _steps):
    prog, want = _steps(dtype)
    assert _rel(prog["emb"], want["emb"]) <= TOL[dtype]
    assert abs(prog["loss"] - want["loss"]) / abs(want["loss"]) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_every_gradient_matches_the_reference(dtype, _steps):
    prog, want = _steps(dtype)
    assert set(prog["grads"]) == set(want["grads"])
    gaps = _leaf_gaps(prog["grads"], want["grads"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TOL[dtype], worst


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_one_adam_step_with_warm_up_matches_the_reference(dtype, _steps):
    prog, want = _steps(dtype)
    names = [k for k in want["after"] if not k.endswith(KEY_BIAS)]
    assert len(names) == len(want["after"]) - SHAPE.depth
    gaps = _leaf_gaps({k: prog["after"][k] for k in names},
                      {k: want["after"][k] for k in names})
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TOL[dtype], worst
    if dtype == torch.float64:
        # exact to rounding: the change itself, not only its sum with w0
        before = {k: prog["before"][k] for k in names}
        gaps = _leaf_gaps({k: prog["after"][k] - before[k] for k in names},
                          {k: want["after"][k] - before[k] for k in names})
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= TOL[dtype], worst
    before = prog["before"]["class_weights"].double()
    # the warm-up's first step: lr / (warmup_epochs * n_batches), so an
    # entry with a gradient well above eps moves by about 0.0025
    step = (want["after"]["class_weights"] - before).abs()
    assert float(step.max()) == pytest.approx(0.01 / 4, rel=1e-3)


def test_bf16_compute_stays_near_the_float32_reference():
    prog, want = _both(torch.float32, torch.bfloat16)
    assert _rel(prog["emb"], want["emb"]) <= 3e-2
    assert abs(prog["loss"] - want["loss"]) / abs(want["loss"]) <= 5e-3
