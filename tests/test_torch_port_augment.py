"""The port's augmentation (``embeddingnet_tpu_torch/ops/augment.py``)
against the JAX package's (``embeddingnet_tpu/ops/augment.py``): each op
and each preset from the same images and the same random draws (the JAX
ops' own draws, reproduced from their keys by ``tests/_torch_port.py``), in
f32 on the CPU, to 1e-4 gray levels; CLAHE also against the numpy oracle of
``tests/test_augment.py``."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.ops import augment as jaug  # noqa: E402
from embeddingnet_tpu_torch.config import params_from_dict  # noqa: E402
from embeddingnet_tpu_torch.ops import augment as taug  # noqa: E402

from _torch_port import jax_aug_draws, jax_preset_draws  # noqa: E402
from test_augment import np_clahe_tiled  # noqa: E402

# f32 on both sides, the same arithmetic in the same order: 1e-4 gray
# levels (of 0..255) covers the few ulps by which the two libraries' pow,
# division and summation orders differ
ATOL = 1e-4
N_BINS = 64

OPS = [
    taug.brightness_contrast(p=1.0),
    taug.random_brightness(p=1.0),
    taug.random_contrast(p=1.0),
    taug.random_gamma(p=1.0),
    taug.hue_saturation_value(p=1.0),
    taug.hue_saturation_value(p=1.0, hue_shift_limit=50, sat_shift_limit=15,
                              val_shift_limit=15),
    taug.clahe_tiled(p=1.0),
    taug.clahe_tiled(p=1.0, stats_stride=1),
    taug.clahe_approx(p=1.0),
    taug.horizontal_flip(p=1.0),
    taug.vertical_flip(p=1.0),
    taug.random_rotate90(p=1.0),
    taug.random_crop(p=1.0),
    taug.center_crop_resize(p=1.0),
    taug.blur3(p=1.0),
    taug.gauss_noise(p=1.0),
    taug.gauss_noise(p=0.5, var_limit=(10, 50)),
]
PRESETS = ["default", "plates", "deepfake", "plates2"]


def _ids(ops):
    return [f"{op.name}-{i}" for i, op in enumerate(ops)]


def _images(seed, shape=(4, 32, 32, 3)):
    """Uniform 0..255 f32 BGR images whose luminance lies at least 1e-3
    gray levels from every CLAHE bin edge (a multiple of 256 / N_BINS), so
    that the two libraries' luminance roundings cannot bin a pixel apart."""
    x = np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)
    lum = 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]
    width = 256.0 / N_BINS
    near = np.abs(lum / width - np.round(lum / width)) * width < 2e-3
    x[near] = np.clip(x[near] + np.where(x[near] < 128, 0.01, -0.01), 0, 255)
    return x


def _jax_op(op):
    """The JAX op with ``op.params``, run op by op under the matmul
    precision that the JAX presets set (``_compose``; it changes nothing on
    the CPU), so that the presets' tests reuse these ops' compiled
    primitives. Not jitted: under jit, XLA's fused f32 arithmetic on the
    CPU moves the HSV conversion by up to 2.4e-4 gray levels (16 ulps at
    255) from the op-by-op result, which the port's eager ops match to
    1e-4."""
    fn = functools.partial(getattr(jaug, op.name), **op.params)

    def run(x, key):
        with jax.default_matmul_precision("bfloat16"):
            return fn(x, key)

    return run


def _assert_gray_close(got, want, atol=ATOL):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("op", OPS, ids=_ids(OPS))
def test_op_matches_jax(op):
    """Each op applied with the JAX op's own draws gives the JAX op's
    output."""
    x = _images(1)
    key = jax.random.PRNGKey(3)
    want = _jax_op(op)(jnp.asarray(x), key)
    draws = jax_aug_draws(op, key, x.shape)
    got = op.apply(torch.from_numpy(x), draws)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _assert_gray_close(got, want)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax(name):
    """Each preset from the draws JAX's ``_compose`` makes gives the JAX
    preset's output. The CLAHE input here is the earlier ops' output, whose
    luminance the test cannot keep off the bin edges; no pixel came out
    binned apart at this seed, and the test says so if one does."""
    x = _images(2)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jaug.get_aug(name)(jnp.asarray(x), key), np.float64)
    augment = taug.get_aug(name)
    got = augment.apply(torch.from_numpy(x),
                        jax_preset_draws(augment, key, x.shape))
    assert got.dtype == torch.float32 and got.shape == x.shape
    off = np.abs(got.double().numpy() - want).max(-1) > ATOL
    assert not off.any(), (
        f"{int(off.sum())} of {off.size} pixels differ by more than {ATOL}")


@pytest.mark.parametrize("name", PRESETS)
def test_sampled_draws_have_the_jax_draws_structure(name):
    """The port's own sampler makes, per op, the draws the JAX op makes:
    the same names, shapes and kinds (float or integer)."""
    shape = (4, 32, 32, 3)
    augment = taug.get_aug(name)
    ours = augment.sample(shape, torch.Generator().manual_seed(0))
    theirs = jax_preset_draws(augment, jax.random.PRNGKey(0), shape)
    assert len(ours) == len(theirs) == len(augment.ops)
    for op, a, b in zip(augment.ops, ours, theirs):
        assert sorted(a) == sorted(b), op.name
        for k in a:
            assert a[k].shape == b[k].shape, (op.name, k)
            assert a[k].is_floating_point() == b[k].is_floating_point()
    # and it runs end to end from them
    out = augment(torch.from_numpy(_images(4, shape)),
                  torch.Generator().manual_seed(1))
    assert out.shape == shape and torch.isfinite(out).all()
    assert out.min() >= 0 and out.max() <= 255


def test_sampler_ranges_and_gate_rate():
    """Draws fall in the ops' ranges, and the gate fires at rate p."""
    gen = torch.Generator().manual_seed(0)
    b = 20000
    d = taug.brightness_contrast(p=0.4).sample((b, 2, 2, 3), gen, "cpu")
    assert abs(d["gate"].mean().item() - 0.4) < 0.02
    assert set(d["gate"].unique().tolist()) == {0.0, 1.0}
    assert d["alpha"].min() >= 0.8 and d["alpha"].max() <= 1.2
    assert d["beta"].min() >= -51 and d["beta"].max() <= 51
    d = taug.gauss_noise(p=0.3).sample((64, 8, 8, 3), gen, "cpu")
    assert d["var"].min() >= 50 and d["var"].max() <= 80
    assert abs(d["noise"].std().item() - 1.0) < 0.05
    d = taug.random_crop().sample((b, 12, 12, 3), gen, "cpu")
    assert d["top"].min() == 0 and d["top"].max() == 12 - 8
    d = taug.random_rotate90().sample((b, 4, 4, 3), gen, "cpu")
    assert sorted(d["k"].unique().tolist()) == [0, 1, 2, 3]


@pytest.mark.parametrize("op", OPS, ids=_ids(OPS))
def test_p0_is_identity(op):
    x = torch.from_numpy(_images(5))
    params = {**op.params, "p": 0.0}
    zero = getattr(taug, op.name)(**params)
    out = zero.apply(x, zero.sample(x.shape, torch.Generator(), "cpu"))
    assert torch.equal(out, x)


def test_clahe_tiled_matches_numpy_oracle(rng_np):
    """Against the oracle of ``tests/test_augment.py`` at stats_stride=1,
    to that file's tolerance: the luminance mapping on unclipped pixels."""
    x = rng_np.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    op = taug.clahe_tiled(p=1.0, grid=4, stats_stride=1)
    out = op.apply(torch.from_numpy(x), {"gate": torch.ones(2, 1, 1, 1)})
    out = out.numpy()
    lum = 0.114 * x[..., 0] + 0.587 * x[..., 1] + 0.299 * x[..., 2]
    out_lum = 0.114 * out[..., 0] + 0.587 * out[..., 1] + 0.299 * out[..., 2]
    for b in range(2):
        expected = np_clahe_tiled(lum[b], grid=4, stats_stride=1)
        unclipped = (out[b] < 254.5).all(axis=-1)
        np.testing.assert_allclose(out_lum[b][unclipped],
                                   expected[unclipped], rtol=5e-3, atol=0.5)


def test_clahe_tiled_falls_back_on_awkward_shapes():
    """30x30 does not divide into 4x4 even tiles: clahe_tiled is then
    clahe_approx, in both packages."""
    x = _images(6, (2, 30, 30, 3))
    key = jax.random.PRNGKey(0)
    op = taug.clahe_tiled(p=1.0)
    draws = jax_aug_draws(op, key, x.shape)
    got = op.apply(torch.from_numpy(x), draws)
    assert torch.equal(got, taug.apply_clahe_approx(torch.from_numpy(x),
                                                    draws))
    # jitted: one compile for this shape (the fallback has no HSV step)
    _assert_gray_close(got, jax.jit(functools.partial(
        jaug.clahe_tiled, **op.params))(jnp.asarray(x), key))


def test_presets_and_config():
    assert taug.get_aug("nope") is None
    assert [op.name for op in taug.get_aug("default").ops] == [
        "brightness_contrast", "random_gamma", "hue_saturation_value",
        "clahe_tiled", "blur3", "gauss_noise"]
    cfg = {"MODEL": {"backbone_name": "resnet50",
                     "input_shape": [64, 64, 3]},
           "GENERATOR": {"augmentations": "default"}}
    augment = taug.augment_from_params(params_from_dict(cfg))
    assert [op.name for op in augment.ops] == [
        op.name for op in taug.get_aug("default").ops]
    cfg["GENERATOR"] = {"augmentations": "none"}
    assert taug.augment_from_params(params_from_dict(cfg)) is None
    del cfg["GENERATOR"]
    assert taug.augment_from_params(params_from_dict(cfg)) is None


def test_flagship_config_builds_the_default_preset():
    """``configs/resnet50_batchall_1024.yml`` names ``default``."""
    pytest.importorskip("yaml")
    import os
    from embeddingnet_tpu_torch.config import parse_params
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = parse_params(os.path.join(root, "configs",
                                       "resnet50_batchall_1024.yml"))
    augment = taug.augment_from_params(params)
    assert augment is not None
    assert [op.params for op in augment.ops] == [
        op.params for op in taug.get_aug("default").ops]
