"""The training slice as a whole: the port's triplet train step against the
JAX package's ``make_triplet_train_step`` (``embeddingnet_tpu/train/
steps.py``), from the same converted weights and batches, for one and two
steps of ResNet-18 at 64 px (its stride-1 3x3 convs at 8x8x128, 4x4x256 and
2x2x512: the mixed op, K1 and K3 with their backward), batch-all P-K mining
(4 classes x 4), Adam on a step-decay schedule, BatchNorm momentum 0.9,
with ``fast_conv`` off and on (the JAX side in Pallas interpret mode);
and one step with the ``default`` augmentation preset from the JAX step's
own draws. Also the schedule and the preprocessing against JAX's.

The port runs in float32. The reference is the JAX step in float64 (x64
on, float64 variables and compute dtype; the mining casts to float32 on
both sides). On the CPU the JAX step's own float32 run is off its float64
run by up to 1.8e-2 (relative L2) in the gradients of the early
BatchNorm layers, ten times the port's float32 error (1.7e-3), so the
float32 JAX step cannot serve as a tight reference."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu.ops.augment import get_aug as j_get_aug  # noqa: E402
from embeddingnet_tpu.train import optim as joptim  # noqa: E402
from embeddingnet_tpu.train.state import TrainState as JTrainState  # noqa
from embeddingnet_tpu.train.steps import _preprocess as j_preprocess  # noqa
from embeddingnet_tpu.train.steps import \
    make_triplet_train_step as j_make_step  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.models.registry import EmbeddingModule  # noqa
from embeddingnet_tpu_torch.ops.augment import get_aug  # noqa: E402
from embeddingnet_tpu_torch.ops import fused_conv as tfc  # noqa: E402
from embeddingnet_tpu_torch.ops import preprocess as tpre  # noqa: E402
from embeddingnet_tpu_torch.train import optim as toptim  # noqa: E402
from embeddingnet_tpu_torch.train.state import TrainState  # noqa: E402
from embeddingnet_tpu_torch.train.steps import \
    make_triplet_train_step  # noqa: E402

from _torch_port import jax_init, jax_preset_draws, randomize_bn  # noqa

P, K, SIZE, D = 4, 4, 64, 32
LR, DECAY = 1e-3, 0.5     # one-step epochs: step 2 runs at LR * DECAY
METRICS = ("loss", "n_triplets", "frac_mined", "mean_pos_dist",
           "mean_neg_dist")
# The port in float32 against the float64 reference, for the same state:
# metrics and BatchNorm statistics to 1e-5 relative (measured 1.1e-6);
# gradients and Adam's moments to 1e-2 relative L2 per tensor (measured
# 1.7e-3 at the first step and 5.0e-3 at the second, in the 32x32 stem and
# stage-1 layers, whose BatchNorm reduces 16,384 values per channel in
# float32; the JAX step's own float32 run is off by 1.8e-2 there).
RTOL = 1e-5
GRAD_REL_L2 = 1e-2
# Adam's first step moves each entry by about lr * sign(g), so an entry
# whose gradient is within the float32 error of zero can move the other
# way. Entries with |g| >= SURE * max|g| of their tensor are held to 1e-5
# relative, the others to 2 lr.
SURE = 2e-2
# Two steps from the same start: the first step's sign flips (above) move
# the second step's start, which moves its metrics by 1.4e-3 relative and
# the BatchNorm statistics by 3.8e-4 (measured; the JAX step's own float32
# run is off its float64 run by 8.8e-3 in the same metrics).
TRAJECTORY_RTOL = 1e-2


def _batches(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        images = rng.integers(0, 256, (P * K, SIZE, SIZE, 3), np.uint8)
        labels = np.repeat(rng.permutation(50)[:P], K).astype(np.int32)
        out.append((images, labels))
    return out


def _jax_module(fast_conv):
    return JEmbeddingModule(backbone_name="resnet18", encodings_len=D,
                            fast_conv=fast_conv, bn_momentum=0.9)


def _jax_run(fast_conv, variables, batches, augment_fn=None):
    """The JAX step in float64: states and metrics after each step."""
    tx = optax.adam(joptim.step_decay_schedule(LR, DECAY, 1, 1))
    with jax.enable_x64(True):
        state = JTrainState.create(
            jax.tree.map(lambda a: np.asarray(a, np.float64), variables), tx)
        step = jax.jit(j_make_step(_jax_module(fast_conv), tx, margin=0.5,
                                   mode="batch_all", augment_fn=augment_fn,
                                   compute_dtype=jnp.float64,
                                   max_positives=K - 1))
        out = []
        for images, labels in batches:
            state, metrics = step(state, jnp.asarray(images),
                                  jnp.asarray(labels))
            out.append((jax.tree.map(np.asarray, state),
                        {k: float(v) for k, v in metrics.items()}))
    return out


def _port_step(module, state, step, images, labels, **kw):
    """One port step; (state_dict, metrics, grads, Adam moments) after it."""
    state, metrics = step(state, torch.from_numpy(images),
                          torch.from_numpy(labels), **kw)
    return (
        {k: v.detach().clone() for k, v in module.state_dict().items()},
        {k: float(v) for k, v in metrics.items()},
        {n: p.grad.clone() for n, p in module.named_parameters()},
        {n: {k: v.clone() for k, v in state.optimizer.state[p].items()}
         for n, p in module.named_parameters()})


def _jax_as_torch(module, tree, batch_stats):
    """A JAX params-like tree (params, or an Adam moment) under the port's
    names."""
    return flax_to_torch({"params": tree, "batch_stats": batch_stats},
                         module)


def _load_jax_state(module, state, jstate):
    """Put the JAX state (parameters, BatchNorm statistics, Adam's moments
    and count) into the port's module and optimizer."""
    module.load_state_dict(flax_to_torch(jstate.variables, module))
    adam = jstate.opt_state[0]
    mu = _jax_as_torch(module, adam.mu, jstate.batch_stats)
    nu = _jax_as_torch(module, adam.nu, jstate.batch_stats)
    for name, p in module.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(adam.count)),
            "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    state.step = int(jstate.step)


@pytest.fixture(scope="module", params=[False, True],
                ids=["fast_conv_off", "fast_conv_on"])
def runs(request):
    """The JAX reference after steps 1 and 2; the port after its own steps
    1 and 2 ("trajectory"); and the port's step 2 taken from the JAX state
    after step 1 ("second")."""
    fast_conv = request.param
    batches = _batches(2)
    x0 = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    variables = randomize_bn(jax_init(_jax_module(False), x0,
                                      method="init_all"))
    jax_steps = _jax_run(fast_conv, variables, batches)

    module = EmbeddingModule("resnet18", encodings_len=D,
                             fast_conv=fast_conv, bn_momentum=0.9)
    module.load_state_dict(flax_to_torch(variables, module))
    spec = toptim.get_optimizer(
        "adam", toptim.step_decay_schedule(LR, DECAY, 1, 1))
    state = TrainState.create(module, spec)
    step = make_triplet_train_step(module, spec, margin=0.5,
                                   mode="batch_all", max_positives=K - 1)
    tfc.reset_launch_counts()
    trajectory = [_port_step(module, state, step, *b) for b in batches]
    assert state.step == 2
    _load_jax_state(module, state, jax_steps[0][0])
    second = _port_step(module, state, step, *batches[1])
    # the CPU route runs the plain versions and launches nothing
    assert not any(tfc.LAUNCHES.values())
    return module, jax_steps, trajectory, second


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_metrics(got, want, rtol):
    for name in METRICS:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=1e-7, err_msg=name)
    assert got["n_triplets"] > 0


def _assert_batch_stats(sd, want, rel):
    for key, value in sd.items():
        if "running_" in key:
            ref = want[key].double().numpy()
            np.testing.assert_allclose(
                value.double().numpy(), ref, rtol=0,
                atol=rel * max(np.abs(ref).max(), 1e-30), err_msg=key)


def _assert_grads_and_moments(module, port, jstate, jprev=None):
    """Each parameter's gradient and Adam's moments after the step. The JAX
    state holds the gradient in its first moment: ``mu = b1 mu_prev +
    (1 - b1) g``, with ``mu_prev`` from ``jprev`` (zero at the first
    step)."""
    _, _, grads, moments = port
    adam = jstate.opt_state[0]
    mu = _jax_as_torch(module, adam.mu, jstate.batch_stats)
    nu = _jax_as_torch(module, adam.nu, jstate.batch_stats)
    mu_prev = (_jax_as_torch(module, jprev.opt_state[0].mu,
                             jprev.batch_stats) if jprev is not None
               else None)
    for name, g in grads.items():
        want_mu, want_nu = mu[name].double().numpy(), nu[name].double().numpy()
        want_g = want_mu - (0.9 * mu_prev[name].double().numpy()
                            if mu_prev is not None else 0.0)
        want_g = want_g / 0.1
        got_g = g.double().numpy()
        if not want_mu.any():
            # the classifier head: the loss does not reach it
            assert not got_g.any(), name
            continue
        assert _rel_l2(got_g, want_g) < GRAD_REL_L2, name
        assert _rel_l2(moments[name]["exp_avg"].double().numpy(),
                       want_mu) < GRAD_REL_L2, name
        assert _rel_l2(moments[name]["exp_avg_sq"].double().numpy(),
                       want_nu) < 2 * GRAD_REL_L2, name


def _assert_first_step_parameters(module, sd, want_sd, grads):
    for name, _ in module.named_parameters():
        got, ref = sd[name].double().numpy(), want_sd[name].double().numpy()
        g = np.abs(grads[name].double().numpy())
        sure = g >= SURE * max(g.max(), 1e-30)
        np.testing.assert_allclose(got[sure], ref[sure], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got[~sure], ref[~sure], rtol=0,
                                   atol=2 * LR, err_msg=name)


def test_first_step_matches_jax(runs):
    """Step 1: metrics, BatchNorm statistics, gradients, Adam's moments and
    the parameters."""
    module, jax_steps, trajectory, _ = runs
    jstate, jmetrics = jax_steps[0]
    port = trajectory[0]
    _assert_metrics(port[1], jmetrics, RTOL)
    want = flax_to_torch(jstate.variables, module)
    _assert_batch_stats(port[0], want, RTOL)
    _assert_grads_and_moments(module, port, jstate)
    _assert_first_step_parameters(module, port[0], want, port[2])
    assert not port[2]["classifier.output_img.weight"].any()


def test_second_step_matches_jax(runs):
    """Step 2 from the JAX state after step 1 (parameters, statistics,
    Adam's moments and count): the schedule's decayed rate, Adam's bias
    correction at count 2 and the statistics' second update."""
    module, jax_steps, trajectory, second = runs
    jstate, jmetrics = jax_steps[1]
    _assert_metrics(second[1], jmetrics, RTOL)
    want = flax_to_torch(jstate.variables, module)
    _assert_batch_stats(second[0], want, RTOL)
    _assert_grads_and_moments(module, second, jstate,
                              jax_steps[0][0])
    # The second update, lr m/sqrt(v), is no longer lr sign(g): it carries
    # the moments' float32 error, held above. Here: the port's parameters
    # are optax's Adam update at count 2, with the decayed rate, of the
    # start it was given and its own moments, and lie within the Adam step
    # bound of the JAX parameters.
    start = flax_to_torch(jax_steps[0][0].variables, module)
    b1, b2, lr = 0.9, 0.999, LR * DECAY
    for name, _ in module.named_parameters():
        mu = second[3][name]["exp_avg"].double()
        nu = second[3][name]["exp_avg_sq"].double()
        update = lr * (mu / (1 - b1 ** 2)) / (
            (nu / (1 - b2 ** 2)).sqrt() + 1e-8)
        got = second[0][name].double()
        torch.testing.assert_close(got, start[name].double() - update,
                                   rtol=1e-5, atol=1e-7, msg=name)
        np.testing.assert_allclose(got.numpy(), want[name].double().numpy(),
                                   rtol=0, atol=2 * lr, err_msg=name)


def test_two_step_trajectory_matches_jax(runs):
    """Two port steps from the same start as the JAX run: metrics and
    BatchNorm statistics after each (see TRAJECTORY_RTOL)."""
    module, jax_steps, trajectory, _ = runs
    for (jstate, jmetrics), port in zip(jax_steps, trajectory):
        _assert_metrics(port[1], jmetrics, TRAJECTORY_RTOL)
        _assert_batch_stats(port[0], flax_to_torch(jstate.variables, module),
                            TRAJECTORY_RTOL)


def test_step_decay_schedule_matches_jax():
    for args in [(1e-3, 0.99, 1, 500, 0.0), (1e-3, 0.5, 2, 3, 0.0),
                 (3e-4, 0.9, 1, 10, 1.5)]:
        want = joptim.step_decay_schedule(*args)
        got = toptim.step_decay_schedule(*args)
        for count in (0, 1, 2, 3, 5, 6, 9, 10, 11, 14, 15, 499, 500, 501,
                      1000, 12345):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-6, atol=1e-12,
                                       err_msg=f"{args} {count}")


def test_get_optimizer_maps_and_refuses():
    spec = toptim.get_optimizer("adam", 1e-3)
    opt = spec.build([torch.nn.Parameter(torch.zeros(3))])
    assert isinstance(opt, torch.optim.Adam)
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8
    assert isinstance(toptim.get_optimizer("adamw", 1e-3).build(
        [torch.nn.Parameter(torch.zeros(3))]), torch.optim.AdamW)
    # radam and rms_prop are optax's rules (held to optax in
    # tests/test_torch_port_siamese.py), with the JAX package's settings
    radam = toptim.get_optimizer("radam", 1e-3).build(
        [torch.nn.Parameter(torch.zeros(3))])
    assert isinstance(radam, toptim.RAdam)
    assert radam.defaults["threshold"] == 4.0
    rms = toptim.get_optimizer("rms_prop", 1e-3).build(
        [torch.nn.Parameter(torch.zeros(3))])
    assert isinstance(rms, toptim.RMSProp)
    assert (rms.defaults["decay"], rms.defaults["eps"]) == (0.9, 1e-8)
    assert isinstance(toptim.get_optimizer("nope", 1e-3).build(
        [torch.nn.Parameter(torch.zeros(3))]), torch.optim.SGD)


def test_l2_penalty_matches_jax():
    """The penalty over the JAX paths of the port's parameter names."""
    rules = ((r".*conv2.*kernel", 2e-4), (r".*dense_1.*kernel", 1e-3),
             (r".*bn1.*scale", 0.5))
    module = EmbeddingModule("resnet18", encodings_len=D)
    x0 = jnp.zeros((2, 32, 32, 3), jnp.float32)
    variables = randomize_bn(jax_init(
        JEmbeddingModule(backbone_name="resnet18", encodings_len=D), x0,
        method="init_all"))
    module.load_state_dict(flax_to_torch(variables, module))
    want = float(joptim.l2_penalty(variables["params"], rules))
    got = toptim.l2_penalty(module.named_parameters(), rules)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    assert toptim.l2_penalty(module.named_parameters(), ()).item() == 0.0
    assert toptim.reg_rules_for("resnet50") == ()


def test_preprocess_f32_equals_jax():
    images = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    images = np.repeat(images, 3, axis=-1)
    want = np.asarray(j_preprocess(jnp.asarray(images), jnp.float32, None,
                                   None))
    got = tpre.preprocess(torch.from_numpy(images), torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_preprocess_bf16_is_the_exact_divide():
    """bf16: T2's plain version and the port's preprocessing equal the
    exact f32 divide, rounded once, on all 256 u8 values. JAX's float16
    bridge differs from it on exactly 31 of them, each by one bf16 ulp."""
    u8 = np.arange(256, dtype=np.uint8)
    exact = (torch.from_numpy(u8).float() / 255.0).bfloat16()
    got = tpre.preprocess(torch.from_numpy(u8), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, exact)
    assert torch.equal(tpre._plain_normalize_u8(torch.from_numpy(u8)), exact)

    bridge = np.asarray(j_preprocess(jnp.asarray(u8), jnp.bfloat16, None,
                                     None).astype(jnp.float32))
    exact32 = exact.float().numpy()
    differ = np.flatnonzero(bridge != exact32)
    assert len(differ) == 31
    # one bf16 ulp at each value: 2^(exponent - 7)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(exact32[differ],
                                              bridge[differ]))) - 7)
    np.testing.assert_array_equal(np.abs(bridge[differ] - exact32[differ]),
                                  ulp)


def test_normalize_u8_refuses_what_the_kernel_cannot_take():
    """Off the CPU the wrapper launches T2 or raises (a meta tensor: no
    card needed)."""
    x = torch.empty((2, 4, 4, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="uint8"):
        tpre.normalize_u8(x)
    assert tpre.LAUNCHES == {"normalize_u8": 0}


def test_augmented_step_matches_jax():
    """One step with the ``default`` augmentation preset: the JAX step
    (float64) with ``augment_fn=get_aug("default")``, and the port's step
    with ``aug_draws`` reproduced from the JAX step's augmentation key
    (``split(state.rng, 4)[1]``), drawn as the x64 run draws them (float64,
    so the port's augmentation promotes to float64 as JAX's does). Held as
    the first step without augmentation is."""
    (images, labels), = _batches(1)
    x0 = jnp.zeros((2, SIZE, SIZE, 3), jnp.float32)
    variables = randomize_bn(jax_init(_jax_module(False), x0,
                                      method="init_all"))
    (jstate, jmetrics), = _jax_run(False, variables, [(images, labels)],
                                   augment_fn=j_get_aug("default"))
    augment = get_aug("default")
    with jax.enable_x64(True):
        aug_key = jax.random.split(jax.random.PRNGKey(0), 4)[1]
        draws = jax_preset_draws(augment, aug_key, images.shape)
    assert draws[0]["alpha"].dtype == torch.float64
    assert draws[-1]["noise"].dtype == torch.float64
    assert 0 < sum(float(d["gate"].sum()) for d in draws) < 6 * P * K

    module = EmbeddingModule("resnet18", encodings_len=D, bn_momentum=0.9)
    module.load_state_dict(flax_to_torch(variables, module))
    spec = toptim.get_optimizer(
        "adam", toptim.step_decay_schedule(LR, DECAY, 1, 1))
    state = TrainState.create(module, spec)
    step = make_triplet_train_step(module, spec, margin=0.5,
                                   mode="batch_all", augment_fn=augment,
                                   max_positives=K - 1)
    port = _port_step(module, state, step, images, labels, aug_draws=draws)
    _assert_metrics(port[1], jmetrics, RTOL)
    want = flax_to_torch(jstate.variables, module)
    _assert_batch_stats(port[0], want, RTOL)
    _assert_grads_and_moments(module, port, jstate)
    _assert_first_step_parameters(module, port[0], want, port[2])

    # the augmentation moved the step: the same batch without it differs
    plain = EmbeddingModule("resnet18", encodings_len=D, bn_momentum=0.9)
    plain.load_state_dict(flax_to_torch(variables, plain))
    plain_state = TrainState.create(plain, spec)
    plain_step = make_triplet_train_step(plain, spec, margin=0.5,
                                         mode="batch_all",
                                         max_positives=K - 1)
    _, metrics = plain_step(plain_state, torch.from_numpy(images),
                            torch.from_numpy(labels))
    assert abs(float(metrics["loss"]) - port[1]["loss"]) > 1e-4


def test_augmented_step_draws_from_the_state_generator():
    """Without ``aug_draws`` the step samples the preset from
    ``state.generator``: two states seeded alike take the same step, and
    the generator advances."""
    (images, labels), = _batches(1)
    results = []
    for _ in range(2):
        torch.manual_seed(0)
        module = EmbeddingModule("resnet18", encodings_len=D)
        spec = toptim.get_optimizer("adam", 1e-3)
        state = TrainState.create(module, spec)
        assert state.generator.device == torch.device("cpu")
        before = state.generator.get_state().clone()
        step = make_triplet_train_step(module, spec, mode="batch_all",
                                       augment_fn=get_aug("default"),
                                       max_positives=K - 1)
        _, metrics = step(state, torch.from_numpy(images),
                          torch.from_numpy(labels))
        assert not torch.equal(state.generator.get_state(), before)
        results.append(float(metrics["loss"]))
    assert np.isfinite(results[0]) and results[0] == results[1]
