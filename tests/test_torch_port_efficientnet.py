"""The port's depthwise family (``embeddingnet_tpu_torch/models/
efficientnet.py`` and ``mobilenet.py``) against the JAX package.

TF ``"SAME"`` padding against ``jax.lax.conv_general_dilated``, plain and
depthwise, exact on integer inputs; ``round_filters``/``round_repeats`` and
every B0..B7 variant's block table and drop-connect rates; the full-width
B3 (96 px) and B1 (48 px) trees, from ``jax.eval_shape`` of ``init`` and a
seed, converting with no missing or extra key; reduced EfficientNet and
MobileNet v1/v2 in eval and train mode (outputs and running statistics)
with drop-connect fed the same masks on both sides (a test-local
``monkeypatch`` of the JAX ``drop_connect``); the masks' keep rate; each
family's initialiser against JAX's; the triplet step on a small
EfficientNet against the JAX step in float64; the ``Trainer`` built from
both EfficientNet configs, their data paths cut.

Small sizes: width 0.25, half the repeats, 32 px, B=8, f32; one torch
thread (a module fixture)."""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models import efficientnet as jefn  # noqa: E402
from embeddingnet_tpu.models import mobilenet as jmob  # noqa: E402
from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu_torch.config import parse_params  # noqa: E402
from embeddingnet_tpu_torch.data import ENDataLoader  # noqa: E402
from embeddingnet_tpu_torch.models import efficientnet as efn  # noqa: E402
from embeddingnet_tpu_torch.models import mobilenet as mob  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.models.stochastic import MaskSource  # noqa
from embeddingnet_tpu_torch.train import optim  # noqa: E402
from embeddingnet_tpu_torch.train.loop import Trainer  # noqa: E402

from _torch_port import (jax_init, numpy_tree, randomize_bn,  # noqa: E402
                         triplet_steps_against_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, B, D = 32, 8, 16
SMALL = (0.25, 0.5)          # width and depth of the reduced EfficientNet
FWD_TOL = 1e-5               # f32 forward and statistics, of the largest
# the train-mode forward in f32 against JAX in float64: train-mode BatchNorm
# on batch statistics (E[x^2] - E[x]^2, as Flax) amplifies f32 rounding; at
# these sizes the port lands 2.3e-5 from float64 on the MobileNets and JAX's
# own float32 run 3.6e-4
TRAIN_FWD_TOL = 5e-5
# the port's f32 step against the JAX step in float64, from the same state:
# the loss to 1e-5 relative (f32 train-mode BatchNorm, as
# tests/test_torch_port_siamese.py holds its ResNet step), every parameter
# to 2e-5 of its tensor's largest entry (measured 7e-6 to 1e-5 at B = 8 to
# 32: the depthwise kernels' gradients, f32 sums over B*H*W positions
# through train-mode BatchNorm)
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5
LR = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (name, err)


# -- SAME padding ------------------------------------------------------------

def test_same_padding_puts_the_odd_pixel_high():
    assert efn.same_padding(3, 5, 2) == (2, 2)
    assert efn.same_padding(6, 3, 2) == (0, 1)
    assert efn.same_padding(96, 3, 2) == (0, 1)
    assert efn.same_padding(7, 3, 1) == (1, 1)


@pytest.mark.parametrize("n", [3, 5, 6, 7, 33, 48])
def test_same_conv_matches_jax(n):
    """Plain and depthwise, k in {3, 5}, s in {1, 2}: integer inputs and
    kernels make every sum exact in f32, so the outputs are equal."""
    rng = np.random.default_rng(n)
    c = 4
    x = rng.integers(-4, 5, (2, n, n, c)).astype(np.float32)
    for k in (3, 5):
        for s in (1, 2):
            for groups in (1, c):
                w = rng.integers(-4, 5, (k, k, c // groups, c)).astype(
                    np.float32)
                want = jax.lax.conv_general_dilated(
                    x, w, (s, s), "SAME",
                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                    feature_group_count=groups)
                conv = efn.SameConv2d(c, c, k, s, groups=groups, bias=False)
                with torch.no_grad():
                    conv.weight.copy_(torch.from_numpy(
                        w.transpose(3, 2, 0, 1).copy()))
                    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
                np.testing.assert_array_equal(
                    got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                    err_msg=f"n={n} k={k} s={s} groups={groups}")


# -- the block tables --------------------------------------------------------

def test_round_filters_and_repeats_match_jax():
    for width in (0.25, 1.0, 1.1, 1.2, 1.4, 1.6, 1.8, 2.0):
        for filters in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
            assert (efn.round_filters(filters, width)
                    == jefn.round_filters(filters, width))
    for depth in (0.1, 0.5, 1.0, 1.1, 1.4, 2.2, 3.1):
        for r in range(1, 5):
            assert efn.round_repeats(r, depth) == jefn.round_repeats(r, depth)


def _jax_blocks(module, x):
    """(name, in, out, expand, kernel, stride, drop_rate) of each JAX
    MBConv, in call order, from an abstract ``init``."""
    seen = []

    def record(next_fun, args, kwargs, context):
        m = context.module
        if isinstance(m, jefn.MBConv) and context.method_name == "__call__":
            seen.append((m.name, m.in_channels, m.out_channels,
                         m.expand_ratio, m.kernel, m.stride,
                         float(m.drop_rate)))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    return seen


@pytest.mark.parametrize("name", sorted(efn.SCALINGS))
def test_variant_block_table_matches_jax(name):
    jmodule = jefn.build_efficientnet(name)
    want = _jax_blocks(jmodule, jnp.zeros((1, SIZE, SIZE, 3)))
    model = efn.build_efficientnet(name)
    got = []
    for block_name in model.block_names:
        block = getattr(model, block_name)
        expand = (block.expand_conv.out_channels // block.expand_conv
                  .in_channels if block.expand_conv is not None else 1)
        got.append((block_name, block.dw_conv.in_channels // expand,
                    block.project_conv.out_channels, expand,
                    block.dw_conv.kernel_size[0], block.dw_conv.stride[0],
                    float(block.drop_rate)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:6] == w[:6] and g[6] == pytest.approx(w[6], abs=1e-12), (
            g, w)
    w = efn.SCALINGS[name][0]
    assert model.stem_conv.out_channels == efn.round_filters(32, w)
    assert model.out_channels == efn.round_filters(1280, w)


@pytest.mark.parametrize("name,size", [("efficientnet-b3", 96),
                                       ("efficientnet-b1", 48)])
def test_full_width_tree_converts(name, size):
    """The configs' full-width embedding modules: the JAX tree's shapes
    from ``jax.eval_shape`` (no compile), filled from a seed, load into
    the port's module with no missing or extra key."""
    jmodule = JEmbeddingModule(backbone_name=name, encodings_len=256)
    shapes = jax.eval_shape(lambda: jmodule.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, size, size, 3)),
        method="init_all"))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    variables = jax.tree.map(np.asarray, variables)
    module = registry.EmbeddingModule(name, encodings_len=256,
                                      input_shape=(size, size, 3))
    state = flax_to_torch(variables, module)
    module.load_state_dict(state)
    n_jax = sum(np.size(a) for a in jax.tree.leaves(variables["params"]))
    assert n_jax == sum(p.numel() for p in module.parameters())
    dw = module.backbone.stage2_block1.dw_conv
    kernel = variables["params"]["backbone"]["stage2_block1"]["dw_conv"][
        "kernel"]                                           # [k, k, 1, C]
    assert dw.groups == dw.in_channels == kernel.shape[-1]
    np.testing.assert_array_equal(dw.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))


# -- the reduced models, eval and train --------------------------------------

def _families():
    return {
        "efficientnet": (jefn.EfficientNet(*SMALL),
                         lambda: efn.EfficientNet(*SMALL)),
        "mobilenetv2": (jmob.MobileNetV2(0.25),
                        lambda: mob.MobileNetV2(0.25)),
        "mobilenet": (jmob.MobileNetV1(0.25), lambda: mob.MobileNetV1(0.25)),
    }


@functools.lru_cache(maxsize=None)
def _jax_variables(family):
    """The reduced JAX model's initial variables (numpy), once a family."""
    jmodule, _ = _families()[family]
    return numpy_tree(jax_init(jmodule, jnp.zeros((1, SIZE, SIZE, 3))))


def _masks(n, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=batch) < 0.6 for _ in range(n)]


def _feed_jax_masks(monkeypatch, holder):
    """The JAX ``drop_connect`` replaced by one that takes the next mask of
    ``holder["masks"]`` (traced inputs, so one jit serves every step)."""
    def fake(x, rng, rate):
        mask = holder["masks"][holder["i"]]
        holder["i"] += 1
        return jnp.where(mask[:, None, None, None], x / (1.0 - rate), 0.0)
    monkeypatch.setattr(jefn, "drop_connect", fake)


def _n_drop_blocks(model):
    return sum(isinstance(m, efn.MBConv) and m.drops
               for m in model.modules())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", ["efficientnet", "mobilenetv2",
                                    "mobilenet"])
def test_reduced_model_matches_jax(family, train, monkeypatch):
    """Outputs and running statistics, B=16 at 64 px. Eval mode against
    JAX in float32 to FWD_TOL; train mode against JAX in float64, the
    output to TRAIN_FWD_TOL and the statistics to FWD_TOL."""
    batch, size = 2 * B, 2 * SIZE
    jmodule, build = _families()[family]
    x = np.random.default_rng(2).uniform(0, 1, (batch, size, size, 3)
                                         ).astype(np.float32)
    variables = randomize_bn(_jax_variables(family))
    model = build()
    model.load_state_dict(flax_to_torch(variables, model))
    model.train(train)
    n = _n_drop_blocks(model) if train else 0
    assert (n > 0) == (train and family == "efficientnet")
    masks = _masks(n, batch=batch)
    holder = {}
    _feed_jax_masks(monkeypatch, holder)

    def run(v, x, masks):
        holder["masks"], holder["i"] = masks, 0
        if not train:
            return jmodule.apply(v, x, train=False), v["batch_stats"]
        out, mut = jmodule.apply(v, x, train=True, mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        return out, mut["batch_stats"]

    dtype = np.float64 if train else np.float32
    with jax.enable_x64(train):
        ref = jax.tree.map(lambda a: np.asarray(a, dtype), variables)
        want, stats = jax.jit(run)(ref, jnp.asarray(x, dtype),
                                   [jnp.asarray(m) for m in masks])
        want, stats = np.asarray(want), numpy_tree(stats)
    assert holder["i"] == n
    source = MaskSource([torch.from_numpy(m) for m in masks])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = (model(xt, source) if family == "efficientnet" else model(xt))
    source.check_used()
    _close(got.detach().permute(0, 2, 3, 1).numpy(), want,
           TRAIN_FWD_TOL if train else FWD_TOL)
    after = flax_to_torch({"params": ref["params"], "batch_stats": stats},
                          model)
    for key, value in model.state_dict().items():
        if "running_" in key:
            _close(value.numpy(), after[key].numpy(), FWD_TOL, key)


def test_drop_connect_masks():
    """One [B] mask per residual block with a positive rate, in block
    order, kept at 1 - rate; B0's rates are 0.2 * block_idx / 16; the
    draws come from the generator given, and given masks must all be
    used."""
    model = efn.build_efficientnet("efficientnet-b0")
    rates = [getattr(model, n).drop_rate for n in model.block_names]
    assert rates == pytest.approx([0.2 * i / 16 for i in range(16)])
    drops = [getattr(model, n).drops for n in model.block_names]
    assert sum(drops) == 9 == _n_drop_blocks(model)
    g = torch.Generator().manual_seed(0)
    source = MaskSource(generator=g)
    keep = 0.7
    masks = [source.next((20000,), keep, torch.device("cpu"))
             for _ in range(3)]
    rate = torch.stack(masks).float().mean().item()
    assert abs(rate - keep) < 4 * np.sqrt(keep * (1 - keep) / 60000)
    again = MaskSource(generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.next((20000,), keep, torch.device("cpu")),
                       masks[0])
    with pytest.raises(ValueError, match="used 0"):
        MaskSource([masks[0]]).check_used()
    with pytest.raises(ValueError, match="shape"):
        MaskSource([masks[0]]).next((5,), keep, torch.device("cpu"))


@pytest.mark.parametrize("family", ["efficientnet", "mobilenetv2",
                                    "mobilenet"])
def test_initialiser_matches_jax(family):
    """Every conv kernel: an untruncated normal of variance 2 / fan_out
    (fan_out = out channels x kernel area, C k^2 for a depthwise kernel),
    as JAX's ``conv_init`` draws it; zero biases (the SE convs')."""
    _, build = _families()[family]
    jax_state = flax_to_torch(_jax_variables(family), build())
    model = build()
    registry._reset_backbone(model, torch.Generator().manual_seed(0))
    checked = 0
    for name, p in model.named_parameters():
        w = p.detach().numpy()
        if name.endswith(".bias") and "_bn" not in name:
            assert not w.any(), name
        if p.dim() != 4 or p.numel() < 512:
            continue
        std = np.sqrt(2.0 / (p.shape[0] * p.shape[2] * p.shape[3]))
        for label, a in (("port", w), ("jax", jax_state[name].numpy())):
            assert abs(a.std() / std - 1) < 0.15, (label, name)
            assert np.abs(a).max() > 2.5 * std, (label, name)  # untruncated
        checked += 1
    assert checked >= 5


# -- the triplet step against JAX in float64 ---------------------------------

@pytest.fixture
def small_b0(monkeypatch):
    """``efficientnet-b0`` shrunk to width 0.25 and half the repeats on
    both sides."""
    monkeypatch.setitem(jefn.SCALINGS, "efficientnet-b0", SMALL + (224,))
    monkeypatch.setitem(efn.SCALINGS, "efficientnet-b0", SMALL + (224,))


def _biases_moved(variables, seed=5):
    """``variables`` with every Dense and conv bias moved off its zero
    start, so that a parameter's comparison after a step is relative to
    more than its own update."""
    rng = np.random.default_rng(seed)

    def visit(node, path=""):
        for key, value in node.items():
            if isinstance(value, dict):
                visit(value, f"{path}/{key}")
            elif key == "bias" and "_bn" not in path:
                node[key] = (value + rng.normal(0, 0.1, value.shape)
                             ).astype(np.float32)
    visit(variables["params"])
    return variables


def test_triplet_step_matches_jax_float64(small_b0, monkeypatch):
    """Two batch-hard SGD steps of the embedding module over the small
    EfficientNet, drop-connect on with the same masks, each from the JAX
    float64 trajectory's state: the loss, every parameter and the running
    statistics after each step."""
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 256, (B, SIZE, SIZE, 3), np.uint8),
                np.repeat(np.arange(B // 2), 2).astype(np.int32))
               for _ in range(2)]
    jmodule = JEmbeddingModule(backbone_name="efficientnet-b0",
                               encodings_len=D)
    variables = _biases_moved(randomize_bn(jax_init(
        jmodule, jnp.zeros((2, SIZE, SIZE, 3)), method="init_all")))
    module = registry.EmbeddingModule("efficientnet-b0", encodings_len=D)
    n = _n_drop_blocks(module)
    assert n > 0
    holder = {}
    _feed_jax_masks(monkeypatch, holder)
    results = triplet_steps_against_jax(
        jmodule, variables, module, batches,
        [_masks(n, seed=10 + i) for i in range(len(batches))], holder,
        lr=LR)
    for loss, jloss, got, want in results:
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        for name, p in module.named_parameters():
            _close(got[name].numpy(), want[name].numpy(), PARAM_TOL, name)
        for key in got:
            if "running_" in key:
                _close(got[key].numpy(), want[key].numpy(), FWD_TOL, key)
    start = flax_to_torch(variables, module)
    moved = [name for name, _ in module.named_parameters()
             if not torch.equal(results[0][2][name], start[name])]
    assert len(moved) > 0.9 * len(list(module.parameters()))


# -- the Trainer on the configs ----------------------------------------------

def _write_images(root, classes=4, per_class=5, size=24):
    import cv2
    rng = np.random.default_rng(0)
    rows = []
    for c in range(classes):
        os.makedirs(os.path.join(root, f"sign_{c}"))
        for i in range(per_class):
            rel = f"sign_{c}/{i}.png"
            cv2.imwrite(os.path.join(root, rel),
                        rng.integers(0, 256, (size, size, 3), np.uint8))
            rows.append((rel, f"sign_{c}"))
    return rows


def _config(tmp_path, source, changes):
    """The repo's config ``source`` with ``changes`` ({(section, key):
    value}), a work dir in ``tmp_path`` and no plots."""
    import yaml
    with open(os.path.join(ROOT, "configs", source)) as f:
        cfg = yaml.safe_load(f)
    for (section, key), value in changes.items():
        cfg[section][key] = value
    cfg["GENERAL"]["work_dir"] = str(tmp_path / "work")
    cfg["TRAIN"]["plot_history"] = False
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return parse_params(str(path))


def test_trainer_builds_the_b3_config(tmp_path):
    """``configs/efficientnetb3_batchhard_1024.yml`` with its dataset path
    cut to a folder of PNGs: EfficientNet-B3 at full width, bf16, the
    warm-up mining stages (semihard for 4 epochs, then batch_hard)."""
    _write_images(str(tmp_path / "data"))
    params = _config(tmp_path, "efficientnetb3_batchhard_1024.yml",
                     {("DATALOADER", "dataset_path"): str(tmp_path / "data")})
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    trainer = Trainer(params, loader, device="cpu", log_fn=lambda *a: None)
    assert isinstance(trainer.module.backbone, efn.EfficientNet)
    assert trainer.module.backbone.out_channels == 1536
    assert trainer.compute_dtype == torch.bfloat16
    assert trainer._mining_mode == "semihard"
    assert [trainer._mining_mode_for_epoch(e) for e in (3, 4)] == [
        "semihard", "batch_hard"]
    assert trainer._decode_cache is not None
    assert trainer.augment_fn is not None
    bn = trainer.module.backbone.stem_bn
    assert bn.eps == 1e-3 and bn.momentum == pytest.approx(0.1)


def test_trainer_builds_the_road_signs_config_on_a_csv(tmp_path):
    """``configs/road_signs_tpu.yml`` on a CSV index with its
    ``file_path``/``class_name`` columns: EfficientNet-B1 at 48 px,
    semihard, radam."""
    rows = _write_images(str(tmp_path / "data"), per_class=6)
    for split, part in (("train", rows[::2] + rows[1::4]),
                        ("val", rows[3::4])):
        with open(tmp_path / f"{split}.csv", "w") as f:
            f.write("file_path,class_name\n" + "".join(
                f"{p},{c}\n" for p, c in part))
    params = _config(tmp_path, "road_signs_tpu.yml", {
        ("DATALOADER", "dataset_path"): str(tmp_path / "data"),
        ("DATALOADER", "train_csv_file"): str(tmp_path / "train.csv"),
        ("DATALOADER", "val_csv_file"): str(tmp_path / "val.csv")})
    loader = ENDataLoader(**{k: params.dataloader[k]
                             for k in params.dataloader.keys()})
    assert loader.n_classes == 4 and loader.val_data
    trainer = Trainer(params, loader, device="cpu", log_fn=lambda *a: None)
    assert isinstance(trainer.module.backbone, efn.EfficientNet)
    assert trainer.module.backbone.out_channels == 1280
    assert trainer._mining_mode == "semihard"
    assert isinstance(trainer.state.optimizer, optim.RAdam)
