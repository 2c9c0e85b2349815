"""The port's ViT (``embeddingnet_tpu_torch/models/vit.py``) against the JAX
package's, both families (plain ViT: exact GELU, biased patch embed, eps
1e-12; CLIP tower: ``ln_pre``, quick-GELU, bias-free patch embed, ``proj``,
eps 1e-5), each registry name cut to a tiny size by replacing its
``_VARIANTS`` entry on both sides (patch 7-16, dims 24-48, depth 2-3,
16-32 px): the backbone, the encoder under ``EmbeddingModule`` and
``EmbeddingNet.encode`` from weights converted by ``flax_to_torch``, in
float32; the converter on ViT and ArcFace trees; and the initialisers'
spread against Flax's.

In float32 the two sides round the attention's products and LayerNorm's
variance (Flax: E[x^2] - E[x]^2; torch: two passes) differently, about
1e-6 relative (measured 1.5e-6 on the embeddings): RTOL 1e-5, and for
entries near zero ATOL, 1e-6 of the tensor's largest entry (the grid's
errors are 1e-6 of its scale wherever an entry lies)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models import vit as jvit  # noqa: E402
from embeddingnet_tpu.models.registry import \
    ArcFaceModule as JArcFaceModule  # noqa: E402
from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu_torch.models import vit  # noqa: E402
from embeddingnet_tpu_torch.models.api import EmbeddingNet  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa
from embeddingnet_tpu_torch.models.registry import (  # noqa: E402
    ArcFaceModule, EmbeddingModule, list_backbones)

from _torch_port import numpy_tree  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
CLIP = dict(ln_pre=True, use_quick_gelu=True, patch_bias=False, ln_eps=1e-5)
# registry name -> (tiny variant of its family, input shape)
TINY = {
    "vit-b16": (dict(patch=8, dim=32, depth=2, heads=4), (32, 24, 3)),
    "vit-b32": (dict(patch=16, dim=32, depth=2, heads=2), (32, 32, 3)),
    "vit-l16": (dict(patch=8, dim=48, depth=3, heads=4), (16, 24, 3)),
    "vit-l14": (dict(patch=7, dim=32, depth=2, heads=4, proj_dim=24, **CLIP),
                (28, 21, 3)),
    "clip-vit-b16": (dict(patch=8, dim=32, depth=2, heads=4, proj_dim=16,
                          **CLIP), (24, 32, 3)),
    "clip-vit-b32": (dict(patch=16, dim=32, depth=2, heads=2, proj_dim=16,
                          **CLIP), (32, 16, 3)),
}
NAMES = sorted(TINY)
ENC = 16


@pytest.fixture(autouse=True)
def tiny_variants(monkeypatch):
    for name, (kw, _) in TINY.items():
        monkeypatch.setitem(jvit._VARIANTS, name, kw)
        monkeypatch.setitem(vit._VARIANTS, name, kw)


def _perturb(tree, seed):
    """The tree (numpy) with every bias, LayerNorm scale and raw parameter
    moved off its initial value, so that none of them is a no-op."""
    rng = np.random.default_rng(seed)

    def visit(node):
        for key, value in node.items():
            if isinstance(value, dict):
                visit(value)
            elif key in ("bias", "scale"):
                node[key] = (value + rng.normal(0, 0.1, value.shape)
                             ).astype(np.float32)
        return node
    return visit(numpy_tree(tree))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


def _images(shape, n=3, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (n,) + tuple(shape)).astype(np.float32)


def _jax_init(module, x, method=None):
    kw = {"method": method} if method else {}
    return numpy_tree(jax.jit(lambda k, x: module.init(
        {"params": k}, x, **kw))(jax.random.PRNGKey(1), x))


@pytest.mark.parametrize("name", NAMES)
def test_backbone_matches_flax(name):
    """The token grid (class token folded in), NHWC on the JAX side and
    NCHW on the port's."""
    _, shape = TINY[name]
    x = _images(shape)
    jmodule = jvit.build_vit(name)
    variables = {"params": _perturb(_jax_init(jmodule, x)["params"], 1)}
    want = np.asarray(jmodule.apply(variables, x))
    module = vit.build_vit(name, shape)
    module.load_state_dict(flax_to_torch(variables, module))
    got = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    kw, _ = TINY[name]
    assert got.shape[1] == kw.get("proj_dim", kw["dim"])
    _close(got.permute(0, 2, 3, 1).detach().numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_encoder_and_embedding_net_match_flax(name):
    """The ViT under ``EmbeddingModule`` (GAP head, L2 norm) and
    ``EmbeddingNet.encode`` of uint8 images, against the JAX
    ``EmbeddingModule`` on the same converted weights."""
    _, shape = TINY[name]
    u8 = np.random.default_rng(2).integers(0, 256, (4,) + shape, np.uint8)
    x = u8.astype(np.float32) / 255.0
    jmodule = JEmbeddingModule(backbone_name=name, encodings_len=ENC)
    variables = _jax_init(jmodule, x, "init_all")
    variables = {"params": _perturb(variables["params"], 3)}
    want = np.asarray(jmodule.apply(variables, x))
    want_feats = np.asarray(jmodule.apply(variables, x, method="features"))
    module = EmbeddingModule(name, encodings_len=ENC, input_shape=shape)
    module.load_state_dict(flax_to_torch(variables, module))
    with torch.no_grad():
        _close(module(torch.from_numpy(x)).numpy(), want)
        _close(module.features(torch.from_numpy(x)).numpy(), want_feats)
    params = {"model": {"backbone_name": name, "encodings_len": ENC,
                        "embeddings_normalization": True,
                        "input_shape": list(shape)},
              "general": {"seed": 0}}
    net = EmbeddingNet(params, device="cpu")
    net.load_encoder_state(module.state_dict())
    _close(net.encode(u8), want)


@pytest.mark.parametrize("name", ["vit-b16", "vit-l14"])
def test_converter_round_trip(name):
    """``flax_to_torch`` on a ViT tree: every DenseGeneral kernel and bias
    maps back exactly (query/key/value [D, heads, head_dim] and out [heads,
    head_dim, D] through [out, in] Linear weights), the raw parameters keep
    their shapes, and a missing, an extra or a misshapen leaf raises."""
    _, shape = TINY[name]
    x = _images(shape)
    variables = _jax_init(jvit.build_vit(name), x)
    module = vit.build_vit(name, shape)
    state = flax_to_torch(variables, module)
    block = variables["params"]["block1"]["attn"]
    for proj in ("query", "key", "value"):
        kernel, bias = block[proj]["kernel"], block[proj]["bias"]
        assert kernel.ndim == 3 and bias.ndim == 2
        w = state[f"block1.attn.{proj}.weight"].numpy()
        np.testing.assert_array_equal(w.T.reshape(kernel.shape), kernel)
        np.testing.assert_array_equal(
            state[f"block1.attn.{proj}.bias"].numpy().reshape(bias.shape),
            bias)
    kernel = block["out"]["kernel"]
    assert kernel.ndim == 3
    np.testing.assert_array_equal(
        state["block1.attn.out.weight"].numpy().T.reshape(kernel.shape),
        kernel)
    for raw in ("cls_token", "pos_embed"):
        np.testing.assert_array_equal(state[raw].numpy(),
                                      variables["params"][raw])
    module.load_state_dict(state)

    missing = numpy_tree(variables)
    del missing["params"]["cls_token"]
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch(missing, module)
    extra = numpy_tree(variables)
    extra["params"]["block1"]["attn"]["extra"] = {
        "kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(KeyError, match="extra"):
        flax_to_torch(extra, module)
    wrong = numpy_tree(variables)
    wrong["params"]["pos_embed"] = wrong["params"]["pos_embed"][:, :-1]
    with pytest.raises(ValueError, match="pos_embed"):
        flax_to_torch(wrong, module)


@pytest.mark.parametrize("name", ["vit-b16", "clip-vit-b32"])
def test_arcface_tree_converts_and_matches(name):
    """An ``ArcFaceModule`` tree (the encoder without classifier, and
    ``class_weights``) converts, and the port's module returns what the
    JAX module returns."""
    _, shape = TINY[name]
    x = _images(shape, n=5)
    jmodule = JArcFaceModule(backbone_name=name, encodings_len=ENC,
                             n_classes=7)
    variables = {"params": _perturb(_jax_init(jmodule, x)["params"], 4)}
    assert "classifier" not in variables["params"]["encoder"]
    want_emb, want_w = map(np.asarray, jmodule.apply(variables, x))
    module = ArcFaceModule(name, encodings_len=ENC, n_classes=7,
                           input_shape=shape)
    module.load_state_dict(flax_to_torch(variables, module))
    # the eval and export view: an encoder that normalises, holding the
    # training encoder's weights, as the JAX Trainer's encoder view
    view = EmbeddingModule(name, encodings_len=ENC,
                           embeddings_normalization=True, classifier=False,
                           input_shape=shape)
    view.load_state_dict(module.encoder.state_dict())
    with torch.no_grad():
        emb, w = module(torch.from_numpy(x))
        normalized = view(torch.from_numpy(x))
    np.testing.assert_array_equal(w.detach().numpy(), want_w)
    _close(emb.numpy(), want_emb)
    jview = JEmbeddingModule(backbone_name=name, encodings_len=ENC,
                             embeddings_normalization=True)
    _close(normalized.numpy(), np.asarray(jview.apply(
        {"params": variables["params"]["encoder"]}, x)))


# the init check: 16 draws of a dim-256 depth-1 ViT on each side, pooled by
# kind of leaf (16 x 256 class-token entries, the smallest pool: about 1.6%
# standard error per side)
INIT_DRAWS, INIT_DIM = 16, 256
INIT_RTOL = 0.05


@pytest.mark.parametrize("name", ["vit-b16", "vit-l14"])
def test_initialisers_match_flax_spread(name, monkeypatch):
    kw = dict(TINY[name][0], dim=INIT_DIM, depth=1, heads=4)
    if "proj_dim" in kw:
        kw["proj_dim"] = 128
    monkeypatch.setitem(jvit._VARIANTS, name, kw)
    monkeypatch.setitem(vit._VARIANTS, name, kw)
    shape = TINY[name][1]
    jmodule = JArcFaceModule(backbone_name=name, encodings_len=64,
                             n_classes=300)
    x = jnp.zeros((1,) + shape)
    jax_trees = numpy_tree(jax.jit(jax.vmap(
        lambda k: jmodule.init({"params": k}, x)["params"]))(
        jax.random.split(jax.random.PRNGKey(0), INIT_DRAWS)))
    ours = []
    for seed in range(INIT_DRAWS):
        module = ArcFaceModule(name, encodings_len=64, n_classes=300,
                               input_shape=shape)
        module.reset_parameters(torch.Generator().manual_seed(seed))
        ours.append({k: v.detach().numpy() for k, v in
                     module.state_dict().items()})

    # each draw's leaves, in the port's names (leading axis: the draws)
    module = ArcFaceModule(name, encodings_len=64, n_classes=300,
                           input_shape=shape)
    theirs = [flax_to_torch({"params": jax.tree.map(lambda a: a[i],
                                                    jax_trees)}, module)
              for i in range(INIT_DRAWS)]
    for key in ours[0]:
        a = np.stack([d[key] for d in ours])
        b = np.stack([d[key].numpy() for d in theirs])
        if key.endswith(".bias"):
            assert not a.any() and not b.any(), key
        elif ".ln" in key and key.endswith(".weight"):
            assert (a == 1).all() and (b == 1).all(), key
        else:
            assert a.std() == pytest.approx(b.std(), rel=INIT_RTOL), key
            assert abs(a.mean()) < 0.1 * a.std(), key


def test_registry_names_and_input_size():
    """Every JAX ViT name is in the port's registry; ``fast_conv`` is
    ignored by the ViTs; a ViT refuses an image of another size than it
    was built for, and a ViT without ``input_shape``."""
    assert set(jvit._VARIANTS) <= set(list_backbones())
    _, shape = TINY["vit-b16"]
    module = EmbeddingModule("vit-b16", encodings_len=ENC, fast_conv=True,
                             input_shape=shape)
    module(torch.zeros((1,) + shape))
    with pytest.raises(ValueError, match="built for 32x24"):
        module(torch.zeros(1, 24, 32, 3))
    with pytest.raises(ValueError, match="input_shape"):
        EmbeddingModule("vit-b16", encodings_len=ENC)
    with pytest.raises(ValueError, match="not divisible"):
        EmbeddingModule("vit-b16", encodings_len=ENC, input_shape=(30, 24, 3))
