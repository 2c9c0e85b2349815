"""Helpers shared by the ``test_torch_port_*`` files: JAX variables with
non-trivial BatchNorm statistics, as numpy trees the port's converter
takes; the JAX augmentation draws; and the JAX tool that T1 ports, its
inputs and the one-bf16-ulp comparison of its outputs."""

import contextlib
import importlib.util
import os

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX T1 kernel's batch tile: its B is a multiple of it
JAX_T1_BATCH = 128


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def randomize_bn(variables, seed=0):
    """Copy of ``variables`` (numpy) whose BatchNorm gammas (where the
    BatchNorm has a scale), betas, running means and variances are random,
    so that eval-mode normalisation matters in a parity test."""
    rng = np.random.default_rng(seed)
    out = numpy_tree(variables)

    def visit(params, stats):
        for key, value in params.items():
            if not isinstance(value, dict):
                continue
            if key in stats and "mean" in stats[key]:
                n = value["bias"].shape
                if "scale" in value:
                    value["scale"] = rng.uniform(0.8, 1.2, n).astype(
                        np.float32)
                value["bias"] = rng.normal(0, 0.05, n).astype(np.float32)
                stats[key]["mean"] = rng.normal(0, 0.05, n).astype(
                    np.float32)
                stats[key]["var"] = rng.uniform(0.6, 1.4, n).astype(
                    np.float32)
            else:
                visit(value, stats.get(key, {}))

    visit(out["params"], out.get("batch_stats", {}))
    return out


def port_variables(module, seed=0):
    """The port's ``module`` initialised as JAX initialises it (from
    ``seed``), its BatchNorms then randomised (:func:`randomize_bn`) and
    loaded back: its variables as the JAX package's numpy tree. Building
    the reference's variables from the port spares a JAX ``init`` of the
    large graphs; the converters' tests hold the tree to JAX's."""
    import torch
    from embeddingnet_tpu_torch.models.convert import (flax_to_torch,
                                                       torch_to_flax)
    from embeddingnet_tpu_torch.models import registry
    generator = torch.Generator().manual_seed(seed)
    if isinstance(module, (registry.EmbeddingModule, registry.SiameseModule,
                           registry.ArcFaceModule, registry.SoftmaxModule)):
        module.reset_parameters(generator)
    else:
        registry._reset_backbone(module, generator)
    variables = randomize_bn(torch_to_flax(module), seed)
    module.load_state_dict(flax_to_torch(variables, module))
    return variables


def biases_moved(variables, seed=5, positive=False):
    """``variables`` with every conv and Dense bias moved off its zero
    start (normal, standard deviation 0.1; its absolute value with
    ``positive``), so that a parameter's comparison after a step is
    relative to more than its own update."""
    rng = np.random.default_rng(seed)

    def visit(node):
        for value in node.values():
            if isinstance(value, dict):
                if "kernel" in value and "bias" in value:
                    shift = rng.normal(0, 0.1, value["bias"].shape)
                    value["bias"] = (value["bias"] + (
                        np.abs(shift) if positive else shift)).astype(
                        np.float32)
                visit(value)
    visit(variables["params"])
    return variables


def tree_shapes(tree):
    """``{"params/a/kernel": shape}`` of a variables tree (arrays or
    ``jax.ShapeDtypeStruct``s)."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(
        leaf.shape) for path, leaf in jax.tree_util.tree_leaves_with_path(
        tree)}


def rel_err(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def zoo_eval_reference(name, seed, size, batch, dim):
    """``(port module, its variables, JAX's variable shapes, input, JAX's
    eval embeddings)`` for backbone ``name``: the port's embedding module
    (eval mode) initialised by :func:`port_variables`, the shapes of
    JAX's ``init`` by ``jax.eval_shape`` (no JAX init is run), and one
    jitted JAX eval forward on a seeded ``[batch, size, size, 3]`` input."""
    import jax.numpy as jnp
    from embeddingnet_tpu.models.registry import EmbeddingModule as JModule
    from embeddingnet_tpu_torch.models import registry
    module = registry.EmbeddingModule(name, encodings_len=dim).eval()
    variables = port_variables(module, seed=seed)
    jmodule = JModule(backbone_name=name, encodings_len=dim)
    x = np.random.default_rng(seed).uniform(
        size=(batch, size, size, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), jnp.asarray(x), method="init_all"))
    want = np.asarray(jax.jit(lambda v, x: jmodule.apply(
        v, x, train=False))(variables, jnp.asarray(x)))
    return module, variables, shapes, x, want


def jax_init(module, x, **kw):
    """Jitted ``module.init`` (eager init dispatches op by op and is slow)."""
    return jax.jit(lambda k, x: module.init({"params": k}, x, train=False,
                                            **kw))(jax.random.PRNGKey(0), x)


def jax_aug_draws(op, key, shape, noise_dtype=None):
    """The random draws the JAX augmentation op ``op.name`` (with the
    keyword arguments ``op.params``) makes from ``key`` for a batch of
    ``shape``, as the port's draws (torch tensors in the dtypes JAX draws
    them in: float64 under x64). The splits follow each JAX op
    (``embeddingnet_tpu/ops/augment.py``) and its helpers ``_gate`` and
    ``_uniform``; ``noise_dtype`` is the images' dtype that ``gauss_noise``
    draws its noise in (default: JAX's default float)."""
    import jax.numpy as jnp
    import torch
    from embeddingnet_tpu.ops.augment import _gate, _uniform

    def t(a):
        return torch.from_numpy(np.array(a))

    b, hh, ww = shape[:3]
    p = op.params
    gate = op.params["p"]
    name = op.name
    if name in ("clahe_tiled", "clahe_approx", "horizontal_flip",
                "vertical_flip", "center_crop_resize", "blur3"):
        return {"gate": t(_gate(key, gate, b))}
    if name == "brightness_contrast":
        r1, r2, r3 = jax.random.split(key, 3)
        cl, bl = p["contrast_limit"], p["brightness_limit"]
        return {"alpha": t(1.0 + _uniform(r1, b, -cl, cl)),
                "beta": t(_uniform(r2, b, -bl, bl) * 255.0),
                "gate": t(_gate(r3, gate, b))}
    if name in ("random_brightness", "random_contrast", "random_gamma"):
        r1, r2 = jax.random.split(key)
        if name == "random_gamma":
            lo, hi = p["gamma_limit"]
            draws = {"gamma": t(_uniform(r1, b, lo / 100.0, hi / 100.0))}
        elif name == "random_brightness":
            draws = {"beta": t(_uniform(r1, b, -p["limit"], p["limit"])
                               * 255.0)}
        else:
            draws = {"alpha": t(1.0 + _uniform(r1, b, -p["limit"],
                                               p["limit"]))}
        return {**draws, "gate": t(_gate(r2, gate, b))}
    if name == "hue_saturation_value":
        r1, r2, r3, r4 = jax.random.split(key, 4)
        h, s, v = (p["hue_shift_limit"], p["sat_shift_limit"],
                   p["val_shift_limit"])
        return {"h_shift": t(_uniform(r1, b, -h, h)[..., 0] * 2.0),
                "s_shift": t(_uniform(r2, b, -s, s)[..., 0] / 255.0),
                "v_shift": t(_uniform(r3, b, -v, v)[..., 0]),
                "gate": t(_gate(r4, gate, b))}
    if name == "random_rotate90":
        r1, r2 = jax.random.split(key)
        return {"k": t(jax.random.randint(r1, (b,), 0, 4)),
                "gate": t(_gate(r2, gate, b))}
    if name == "random_crop":
        ch = max(int(hh * p["scale"]), 1)
        cw = max(int(ww * p["scale"]), 1)
        r1, r2, r3 = jax.random.split(key, 3)
        return {"top": t(jax.random.randint(r1, (b,), 0, hh - ch + 1)),
                "left": t(jax.random.randint(r2, (b,), 0, ww - cw + 1)),
                "gate": t(_gate(r3, gate, b))}
    if name == "gauss_noise":
        r1, r2, r3 = jax.random.split(key, 3)
        lo, hi = p["var_limit"]
        dtype = noise_dtype or jnp.asarray(0.0).dtype
        return {"var": t(_uniform(r1, b, lo, hi)),
                "noise": t(jax.random.normal(r2, tuple(shape), dtype)),
                "gate": t(_gate(r3, gate, b))}
    raise ValueError(f"no JAX draws for {name}")


def jax_preset_draws(augment, key, shape):
    """A preset's draws as the JAX ``_compose`` makes them: one key per op,
    split from ``key``, in order."""
    keys = jax.random.split(key, len(augment.ops))
    return [jax_aug_draws(op, k, shape) for op, k in zip(augment.ops, keys)]


def load_file(name, relpath):
    """The module in the repo's file ``relpath``, imported as ``name``."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def jax_t1_tool():
    """``tools/pallas_fused_conv.py`` imported with FC_INTERPRET=1 and
    FC_BATCH=128, which stay set while the context is open: the tool reads
    FC_BATCH when it is imported and FC_INTERPRET when its kernel is
    traced."""
    saved = {k: os.environ.get(k) for k in ("FC_INTERPRET", "FC_BATCH")}
    os.environ.update(FC_INTERPRET="1", FC_BATCH=str(JAX_T1_BATCH))
    try:
        yield load_file("pallas_fused_conv", "tools/pallas_fused_conv.py")
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def t1_inputs(b, s, c, seed=0):
    """The JAX tool's inputs (``main``): x [B, S, S, C] and w [3, 3, C, C]
    as bf16 values, scale and bias [C] f32; numpy float32 arrays."""
    import torch
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, s, c))
    w = rng.normal(size=(3, 3, c, c)) * 0.02
    scale = rng.uniform(0.5, 1.5, (c,))
    bias = rng.normal(size=(c,)) * 0.1

    def bf16_values(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float() \
            .numpy()

    return (bf16_values(x), bf16_values(w), scale.astype(np.float32),
            bias.astype(np.float32))


# Next to the ReLU's 0 a bf16 ulp is tiny: there the f32 sums' own error
# (4,608 products at C=512, summed in two orders; measured 2.4e-7) decides
ZERO_ATOL = 1e-5


def assert_within_one_bf16_ulp(got, want):
    """Each bf16 value equal to, or one bf16 ulp from, the other's (or
    within ZERO_ATOL of it next to 0); returns how many differ. Both sides
    accumulate in f32 in different orders, so a value next to a rounding
    boundary of bf16 may round the other way."""
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(big > 0, 2.0 ** (np.floor(np.log2(np.where(
        big > 0, big, 1.0))) - 7), 0.0)
    diff = np.abs(got - want)
    assert (diff <= np.maximum(ulp, ZERO_ATOL)).all(), (diff - ulp).max()
    return int((diff > 0).sum())


def triplet_steps_against_jax(jmodule, variables, module, batches, masks,
                              holder, *, context=None, reg_rules=(),
                              lr=0.05, mode="batch_hard", margin=0.5,
                              remat=False, port_float64=False):
    """SGD triplet steps of the JAX package (float64) and of the port
    (float32, or float64 with ``port_float64``: the deep models, whose
    float32 train-mode BatchNorm amplifies rounding past the tolerances)
    on ``batches``, each port step starting from the JAX state before it
    (reloaded into ``module``, so that float32 rounding does not compound
    over the steps). ``masks[i]`` are step i's keep masks in
    layer order: the port's step takes them as ``drop_draws``, the JAX
    module through a test-local patch of its stochastic layers that reads
    ``holder["masks"][holder["i"]]`` (traced inputs, one jit for every
    step) inside ``context``. ``remat`` rematerialises both steps. Returns,
    per step, ``(port loss, JAX loss, port state_dict, JAX state as the
    port's state_dict)``."""
    import contextlib

    import jax.numpy as jnp
    import optax
    import torch
    from embeddingnet_tpu.train.state import TrainState as JTrainState
    from embeddingnet_tpu.train.steps import make_triplet_train_step as jmk
    from embeddingnet_tpu_torch.models.convert import flax_to_torch
    from embeddingnet_tpu_torch.train import optim, steps
    from embeddingnet_tpu_torch.train.state import TrainState

    tx = optax.sgd(lr)
    trajectory = []
    with jax.enable_x64(True), (context or contextlib.nullcontext()):
        state = JTrainState.create(jax.tree.map(
            lambda a: np.asarray(a, np.float64), variables), tx)
        jstep = jmk(jmodule, tx, margin=margin, mode=mode,
                    reg_rules=reg_rules, compute_dtype=jnp.float64,
                    remat=remat)

        def run(state, images, labels, masks):
            holder["masks"], holder["i"] = masks, 0
            return jstep(state, images, labels)
        run = jax.jit(run)
        for (images, labels), step_masks in zip(batches, masks):
            before = {"params": numpy_tree(state.params),
                      "batch_stats": numpy_tree(state.batch_stats)}
            state, metrics = run(state, jnp.asarray(images),
                                 jnp.asarray(labels),
                                 [jnp.asarray(m) for m in step_masks])
            after = {"params": numpy_tree(state.params),
                     "batch_stats": numpy_tree(state.batch_stats)}
            trajectory.append((before, after, float(metrics["loss"])))

    if port_float64:
        module.double()
    spec = optim.get_optimizer("sgd", lr)
    tstate = TrainState.create(module, spec)
    step = steps.make_triplet_train_step(
        module, spec, margin=margin, mode=mode, reg_rules=reg_rules,
        remat=remat, compute_dtype=(torch.float64 if port_float64
                                    else torch.float32))
    out = []
    for (images, labels), step_masks, (before, after, jloss) in zip(
            batches, masks, trajectory):
        module.load_state_dict(flax_to_torch(before, module))
        tstate, metrics = step(tstate, torch.from_numpy(images),
                               torch.from_numpy(labels),
                               drop_draws=[torch.from_numpy(m)
                                           for m in step_masks])
        out.append((metrics["loss"].item(), jloss,
                    {k: v.clone() for k, v in module.state_dict().items()},
                    flax_to_torch(after, module)))
    return out
