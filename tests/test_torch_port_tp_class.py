"""The ArcFace and softmax-pretraining steps with their class axis split
over a model group (``parallel/tp.py``, the class-split losses of
``ops/losses.py``), on 2 gloo ranks (``data=1, model=2``) against the JAX
package's one-device steps in float64: the tiny ViT of ``tests/test_tp.py``
(patch 8, dim 32, depth 2, 4 heads, 16x16) under both heads, 5 classes
split 3 + 2 (``tensor_split``'s uneven split, where GSPMD pads), 2 SGD
steps. The losses (and the softmax step's accuracy, an argmax over both
ranks' classes) to LOSS_RTOL, the parameters to CLASS_TOL of each tensor's
largest entry (as ``tests/test_torch_port_arcface.py``'s PARAM_TOL:
ArcFace's f32 cosines at scale 64); the key biases, whose gradient is zero
in exact arithmetic, are not held.

The ranks live in ``tests/_torch_port_spawn.py``, which imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from embeddingnet_tpu.models import registry as jregistry  # noqa: E402
from embeddingnet_tpu.models import vit as jvit  # noqa: E402
from embeddingnet_tpu.train.state import TrainState as JTrainState  # noqa
from embeddingnet_tpu.train import steps as jsteps  # noqa: E402

from embeddingnet_tpu_torch.models import registry, vit  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa

import _torch_port_spawn as ranks  # noqa: E402
from _torch_port import numpy_tree  # noqa: E402

SIZE, C = 16, 5
TINY = dict(patch=8, dim=32, depth=2, heads=4)
LOSS_RTOL = 5e-5
CLASS_TOL = 1e-5


def _port_sd(variables, module):
    return {k: v.double() for k, v in
            flax_to_torch(variables, module).items()}


@pytest.fixture(scope="module")
def class_split(tmp_path_factory):
    out = {}
    for kind in ("arcface", "softmax"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(jvit._VARIANTS, "vit-b16", TINY)
            mp.setitem(vit._VARIANTS, "vit-b16", TINY)
            if kind == "arcface":
                jm = jregistry.ArcFaceModule(backbone_name="vit-b16",
                                             encodings_len=16, n_classes=C)
                pm = registry.ArcFaceModule("vit-b16", encodings_len=16,
                                            n_classes=C,
                                            input_shape=(SIZE, SIZE, 3))
            else:
                jm = jregistry.SoftmaxModule(backbone_name="vit-b16",
                                             n_classes=C)
                pm = registry.SoftmaxModule("vit-b16", n_classes=C,
                                            input_shape=(SIZE, SIZE, 3))
            variables = numpy_tree(jm.init(
                {"params": jax.random.PRNGKey(2)},
                jnp.zeros((2, SIZE, SIZE, 3))))
            rng = np.random.default_rng(3)
            batches = [(rng.integers(0, 256, (8, SIZE, SIZE, 3),
                                     dtype=np.uint8),
                        rng.integers(0, C, 8).astype(np.int32))
                       for _ in range(2)]
            tx = optax.sgd(0.05)
            with jax.enable_x64(True):
                state = JTrainState.create(jax.tree.map(
                    lambda a: np.asarray(a, np.float64), variables), tx)
                make = (jsteps.make_arcface_train_step if kind == "arcface"
                        else jsteps.make_softmax_train_step)
                kw = {"margin": 0.5} if kind == "arcface" else {}
                step = jax.jit(make(jm, tx, n_classes=C,
                                    compute_dtype=jnp.float64, **kw))
                jmetrics = []
                for images, labels in batches:
                    state, metrics = step(state, jnp.asarray(images),
                                          jnp.asarray(labels))
                    jmetrics.append({k: float(v)
                                     for k, v in metrics.items()})
                target = flax_to_torch({"params": numpy_tree(state.params),
                                        **({"batch_stats": variables[
                                            "batch_stats"]}
                                           if "batch_stats" in variables
                                           else {})}, pm)
            sd = _port_sd(variables, pm)
        out[kind] = (sd, batches, jmetrics, target)
    spawn_dir = tmp_path_factory.mktemp("class_split")
    runs = ranks.spawn(ranks.tp_class_cases_worker, 2, spawn_dir, 2,
                       {k: v[:2] for k, v in out.items()}, C, TINY)
    return out, runs


@pytest.mark.parametrize("kind", ["arcface", "softmax"])
def test_class_split_steps_match_jax_float64(class_split, kind):
    """5 classes over 2 ranks: rows 0-2 and 3-4 of the class weights (the
    softmax head's logits), the loss and the SGD updates as JAX's."""
    want, runs = class_split
    _, _, jmetrics, target = want[kind]
    for rank, run in enumerate(runs):
        got = run[kind]
        for g, w in zip(got["metrics"], jmetrics):
            assert g.keys() == w.keys()
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL,
                                           err_msg=key)
        for name, value in target.items():
            gap = float((got["state"][name].double() - value.double()
                         ).abs().max() / value.abs().max().clamp_min(1e-30))
            assert gap <= CLASS_TOL or name.endswith(".attn.key.bias"), (
                name, gap)
        local = got["local"]
        rows = 3 if rank == 0 else 2
        if kind == "arcface":
            assert local["class_weights"] == (rows, 16)
        else:
            assert local["softmax_head.logits.weight"][0] == rows
