"""Tensor parallelism of the port (``parallel/tp.py``, ``parallel/mesh.py``
``build_grid``) on gloo ranks, against the JAX package's one-device steps.

* The rule table: every rule of ``embeddingnet_tpu/parallel/tp.py`` splits,
  through ``models/convert.py``'s mapping, the same slices of the port's
  parameter as the JAX sharding does, and every parameter that JAX keeps
  whole the port keeps whole (tiny ViT, ArcFace and softmax modules).
* The grid: rank ``d * model + m``, its groups and row blocks.
* Steps in float64 (``tests/test_tp.py``'s tiny ViT: patch 8, dim 32,
  depth 2, 4 heads, 16x16, batch-all): SGD
  (1e-2) steps on 2 ranks (``data=1, model=2``) and on 4 (``data=2,
  model=2``) against JAX's one-device step, and against the port's one
  process. The steps cast the embeddings to f32 for the miner and the
  loss, as JAX's do, so a step agrees to f32's rounding, not float64's:
  the batch-all losses to LOSS_RTOL (measured 1.7e-5 against JAX, 1e-5
  against the port's one process: a triplet near its margin), the
  parameters after 2 SGD steps to PARAM_ATOL (measured 6e-8 and 3e-8).
  Without the casts the split arithmetic is float64's: the tiny ViT's
  embeddings and the gradient of their sum of squares on 2 and 4 ranks
  match one process to EXACT_TOL of each tensor's largest entry. Adam
  (1e-2), the optimizer
  of ``tests/test_tp.py``, moves a parameter whose gradient is zero in
  exact arithmetic (the head's and the final LayerNorm's biases: batch-all
  sees distances only; the key biases: the softmax ignores a shift) by up
  to a whole step from rounding alone, so its run holds those to Adam's
  bound and the rest to ADAM_ATOL. In float32 the TP step matches the
  port's one-process step to F32_TOL.
* The ArcFace and softmax steps with their classes split:
  ``tests/test_torch_port_tp_class.py``; the Trainer at ``MESH.model: 2``:
  ``tests/test_torch_port_tp_trainer.py``.

The ranks live in ``tests/_torch_port_spawn.py``, which imports no JAX.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from embeddingnet_tpu.parallel.tp import _RULES as JAX_RULES  # noqa: E402
from embeddingnet_tpu.parallel.tp import spec_for_path  # noqa: E402
from embeddingnet_tpu.train.state import TrainState as JTrainState  # noqa
from embeddingnet_tpu.train import steps as jsteps  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from embeddingnet_tpu_torch.models import registry, vit  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.parallel import tp as tensor_parallel  # noqa
from embeddingnet_tpu_torch.parallel.collectives import (  # noqa: E402
    ModelParallel)

import _torch_port_spawn as ranks  # noqa: E402
from _torch_port import numpy_tree  # noqa: E402
from test_tp import TinyViTEncoder as JTinyViTEncoder  # noqa: E402

SIZE, C, LR = 16, 5, 1e-2
TINY = dict(patch=8, dim=32, depth=2, heads=4)
LOSS_RTOL = 5e-5      # the steps' f32 losses
PARAM_ATOL = 2e-7     # SGD parameters after 2 steps
EXACT_TOL = 1e-12     # float64 forward and gradient, no f32 cast
ADAM_ATOL = 1e-5      # Adam: parameters with a gradient in exact arithmetic
F32_TOL = 1e-5        # float32 TP against float32 one process
# Adam's largest step per update is about lr * (1 - b1) / sqrt(1 - b2) on
# the first; a parameter moved by rounding alone lands anywhere within it
ADAM_BOUND = 2 * 3.2 * LR
# the parameters whose gradient is zero in exact arithmetic
TRANSLATION = ("head.bias", "vit.ln_final.bias", ".attn.key.bias")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n=2, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8),
             np.repeat(np.arange(b // 2), 2).astype(np.int32))
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _tiny_variables():
    """The JAX tiny ViT and its variables (one ``init`` a session)."""
    module = JTinyViTEncoder()
    variables = numpy_tree(module.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((2, SIZE, SIZE, 3), jnp.float32), train=False))
    rng = np.random.default_rng(5)

    def visit(node):        # biases and scales off their initial values
        for key, value in node.items():
            if isinstance(value, dict):
                visit(value)
            elif key in ("bias", "scale"):
                node[key] = (value + rng.normal(0, 0.1, value.shape)
                             ).astype(np.float32)
    visit(variables["params"])
    return module, variables


def _jax_triplet_steps(module, variables, batches, tx):
    with jax.enable_x64(True):
        state = JTrainState.create(jax.tree.map(
            lambda a: np.asarray(a, np.float64), variables), tx)
        step = jax.jit(jsteps.make_triplet_train_step(
            module, tx, margin=0.5, mode="batch_all",
            compute_dtype=jnp.float64))
        losses = []
        for images, labels in batches:
            state, metrics = step(state, jnp.asarray(images),
                                  jnp.asarray(labels))
            losses.append(float(metrics["loss"]))
        return losses, numpy_tree(state.params)


def _port_sd(variables, module):
    return {k: v.double() for k, v in
            flax_to_torch(variables, module).items()}


def _assert_states(got, want, atol, what, bound=None):
    for name, value in want.items():
        gap = float((got[name].double() - value.double()).abs().max())
        limit = bound if bound is not None and name.endswith(
            TRANSLATION) else atol
        assert gap <= limit, (what, name, gap, limit)


# -- the rule table ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trees():
    """(JAX variables, the port module) for every kind of parameter the
    rules name: the tiny ViT's from JAX's ``init``; the ArcFace and softmax
    modules' trees from the port (``torch_to_flax``, whose tree the
    converters' tests hold to JAX's), which spares their JAX ``init``."""
    from embeddingnet_tpu_torch.models.convert import torch_to_flax
    _, variables = _tiny_variables()
    out = [(variables, ranks.TinyViTEncoder())]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(vit._VARIANTS, "vit-b16", TINY)
        for module in (registry.ArcFaceModule("vit-b16", encodings_len=16,
                                              n_classes=8,
                                              input_shape=(SIZE, SIZE, 3)),
                       registry.SoftmaxModule("vit-b16", n_classes=8,
                                              input_shape=(SIZE, SIZE, 3))):
            out.append((torch_to_flax(module), module))
    return out


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def _set(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


@pytest.mark.parametrize("model", [2, 4])
def test_every_jax_rule_splits_the_same_slices(jax_trees, model):
    """Each leaf is tagged with its index along the axis JAX shards over
    ``model``, converted to the port's layout, and split by the port's
    rule: each rank's slice holds exactly the indices of JAX's shard."""
    matched = set()
    for variables, module in jax_trees:
        for path, value in list(_leaves(variables["params"])):
            spec = spec_for_path(path, value.ndim)
            name = ".".join(path[:-1]) + "." + {
                "kernel": "weight", "scale": "weight"}.get(path[-1],
                                                          path[-1])
            name = name.lstrip(".")
            port = dict(module.named_parameters())[name]
            dim = tensor_parallel.shard_dim(name, port.ndim)
            if spec == P():
                assert dim is None, name
                continue
            assert dim is not None, name
            axis = list(spec).index("model")
            n = value.shape[axis]
            shape = [1] * value.ndim
            shape[axis] = n
            tagged = {"params": jax.tree.map(np.copy, variables["params"])}
            if "batch_stats" in variables:
                tagged["batch_stats"] = variables["batch_stats"]
            _set(tagged["params"], path, np.broadcast_to(
                np.arange(n, dtype=np.float32).reshape(shape),
                value.shape).copy())
            converted = flax_to_torch(tagged, module)[name]
            per = n // model
            for m in range(model):
                lo, hi = ModelParallel(m, model, None).span(
                    converted.shape[dim])
                part = converted.narrow(dim, lo, hi - lo)
                assert set(part.unique().tolist()) == set(
                    range(m * per, (m + 1) * per)), (name, m)
            for suffix, _ in JAX_RULES:
                if path[-len(suffix):] == suffix:
                    matched.add(suffix)
    # every JAX rule met a parameter
    assert matched == {suffix for suffix, _ in JAX_RULES}


def test_shard_module_rejects_heads_that_do_not_divide():
    with pytest.raises(ValueError, match="4 attention heads"):
        tensor_parallel.shard_module(ranks.TinyViTEncoder(),
                                     ModelParallel(0, 3, None))


# -- the steps ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    module, variables = _tiny_variables()
    batches = _batches()
    sd = _port_sd(variables, ranks.TinyViTEncoder())
    spawn_dir = tmp_path_factory.mktemp("tp")
    want = {name: _jax_triplet_steps(module, variables, batches, tx)
            for name, tx in (("sgd", optax.sgd(LR)),
                             ("adam", optax.adam(LR)))}
    runs = {
        "2": ranks.spawn(ranks.tp_vit_cases_worker, 2, spawn_dir, 2, sd,
                         batches),
        "4": ranks.spawn(ranks.tp_vit_cases_worker, 4, spawn_dir, 2, sd,
                         batches, ("sgd",)),
    }
    alone = {("sgd", dtype): ranks.tiny_vit_steps(sd, batches, dtype,
                                                  optimizer="sgd")
             for dtype in ("float64", "float32")}
    return {"want": want, "runs": runs, "alone": alone, "sd": sd}


@pytest.mark.parametrize("world", ["2", "4"])
def test_tp_forward_and_gradient_match_one_process_float64(tiny, world):
    images = _batches()[0][0]
    want = ranks.tiny_vit_gradient(tiny["sd"], images)
    for run in tiny["runs"][world]:
        got = run["exact"]
        largest = max(float(g.abs().max()) for g in want["grads"].values())
        pairs = [("emb", got["emb"], want["emb"])] + [
            (n, got["grads"][n], g) for n, g in want["grads"].items()]
        for name, a, b in pairs:
            # the key biases' gradient is zero in exact arithmetic: of the
            # model's largest gradient entry
            scale = largest if name.endswith(".attn.key.bias") else float(
                b.abs().max())
            gap = float((a - b).abs().max()) / scale
            assert gap <= EXACT_TOL, (name, gap)


@pytest.mark.parametrize("world", ["2", "4"])
def test_tp_sgd_steps_match_jax_float64(tiny, world):
    losses, jparams = tiny["want"]["sgd"]
    target = _port_sd({"params": jparams}, ranks.TinyViTEncoder())
    alone = tiny["alone"][("sgd", "float64")]
    for run in tiny["runs"][world]:
        got = run["sgd-float64"]
        np.testing.assert_allclose(got["losses"], losses,
                                   rtol=LOSS_RTOL)
        _assert_states(got["state"], target, PARAM_ATOL, "jax")
        # against the port's one process: the same f32 miner on the same
        # rounded embeddings
        np.testing.assert_allclose(got["losses"], alone["losses"],
                                   rtol=LOSS_RTOL)
        _assert_states(got["state"], alone["state"], PARAM_ATOL, "alone")
        # the split is real: half of fc1's rows, half of out's columns
        assert got["local"]["vit.block1.mlp.fc1.weight"] == (64, 32)
        assert got["local"]["vit.block1.attn.out.weight"] == (32, 16)
        assert got["local"]["head.weight"] == (16, 32)


def test_tp_adam_steps_match_jax_float64(tiny):
    losses, jparams = tiny["want"]["adam"]
    target = _port_sd({"params": jparams}, ranks.TinyViTEncoder())
    for run in tiny["runs"]["2"]:
        got = run["adam-float64"]
        np.testing.assert_allclose(got["losses"], losses,
                                   rtol=LOSS_RTOL)
        _assert_states(got["state"], target, ADAM_ATOL, "jax",
                       bound=ADAM_BOUND)
        # the optimizer's moments are whole too
        moments = [e["exp_avg"] for e in got["optimizer"]["state"].values()]
        assert sorted(tuple(m.shape) for m in moments) == sorted(
            tuple(v.shape) for v in tiny["sd"].values())


def test_tp_float32_step_matches_one_process(tiny):
    alone = tiny["alone"][("sgd", "float32")]
    a, b = tiny["runs"]["2"]
    got = a["sgd-float32"]
    np.testing.assert_allclose(got["losses"], alone["losses"], rtol=F32_TOL)
    for name, value in alone["state"].items():
        gap = float((got["state"][name] - value).abs().max())
        assert gap <= F32_TOL * max(float(value.abs().max()), 1.0), name
    # the model group's ranks end with one model
    for name, value in got["state"].items():
        assert torch.equal(value, b["sgd-float32"]["state"][name]), name


def test_grid_layout(tiny):
    for world, runs in tiny["runs"].items():
        for rank, run in enumerate(runs):
            grid = run["grid"]
            d, m = divmod(rank, 2)
            assert (grid["d"], grid["m"]) == (d, m)
            assert grid["members"]["model"] == [d * 2, d * 2 + 1]
            assert grid["members"]["data"] == [
                di * 2 + m for di in range(int(world) // 2)]
            data = int(world) // 2
            assert grid["rows"] == (d * 8 // data, (d + 1) * 8 // data)
            assert grid["span5"] == ((0, 3) if m == 0 else (3, 5))
