"""The port's ResNet backbones and embedding module against the JAX
package's, on JAX variables converted by ``flax_to_torch``. The JAX side
runs with ``fast_conv=True``, so its Pallas kernels run in interpret mode;
the port runs with ``fast_conv`` on and off. Eval mode, f32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models import resnet as jresnet  # noqa: E402
from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu_torch.models import resnet as tresnet  # noqa: E402
from embeddingnet_tpu_torch.models.convert import flax_to_torch  # noqa: E402
from embeddingnet_tpu_torch.models.registry import \
    EmbeddingModule  # noqa: E402
from embeddingnet_tpu_torch.ops import fused_conv as tfc  # noqa: E402

from _torch_port import jax_init, randomize_bn  # noqa: E402

# f32 on both sides through ~20 layers; sums run in another order
TOL = dict(rtol=1e-4, atol=1e-4)

SMALL = dict(stage_sizes=(1, 1, 2, 2), num_filters=32)


def _images(seed=0, b=8, size=64):
    return np.random.default_rng(seed).uniform(
        size=(b, size, size, 3)).astype(np.float32)


def _jax_reference(slow, fast, x, **init_kw):
    variables = randomize_bn(jax_init(slow, jnp.asarray(x), **init_kw))
    out = jax.jit(lambda v, x: fast.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    return variables, np.asarray(out)


@pytest.fixture(scope="module")
def small_bottleneck():
    x = _images(0)
    make = lambda fast: jresnet.ResNet(  # noqa: E731
        block_cls=jresnet.BottleneckBlock, fast_conv=fast, **SMALL)
    variables, want = _jax_reference(make(False), make(True), x)
    return x, variables, want


@pytest.fixture(scope="module")
def resnet18_embedding():
    x = _images(1)
    make = lambda fast: JEmbeddingModule(  # noqa: E731
        backbone_name="resnet18", encodings_len=32, fast_conv=fast)
    variables, want = _jax_reference(make(False), make(True), x,
                                     method="init_all")
    return x, variables, want


def _counting(fn):
    """Calls of the kernel entry points made while ``fn`` runs."""
    calls = {"conv3x3_small": 0, "conv3x3_small_bn_relu": 0}
    originals = {n: getattr(tfc, n) for n in calls}

    def wrap(name):
        def inner(*a):
            calls[name] += 1
            return originals[name](*a)
        return inner

    try:
        for n in calls:
            setattr(tfc, n, wrap(n))
        return fn(), calls
    finally:
        for n, f in originals.items():
            setattr(tfc, n, f)


@pytest.mark.parametrize("fast_conv", [False, True])
def test_small_bottleneck_resnet_matches_jax(small_bottleneck, fast_conv):
    x, variables, want = small_bottleneck
    model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock,
                           fast_conv=fast_conv, **SMALL).eval()
    model.load_state_dict(flax_to_torch(variables, model))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        got, calls = _counting(lambda: model(xt))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    # stage 3 block 2 at [B,4,4,128] and stage 4 block 2 at [B,2,2,256]
    assert calls == {"conv3x3_small": 0,
                     "conv3x3_small_bn_relu": 2 if fast_conv else 0}


@pytest.mark.parametrize("fast_conv", [False, True])
def test_resnet18_embedding_matches_jax(resnet18_embedding, fast_conv):
    x, variables, want = resnet18_embedding
    model = EmbeddingModule("resnet18", encodings_len=32,
                            fast_conv=fast_conv).eval()
    model.load_state_dict(flax_to_torch(variables, model))
    with torch.inference_mode():
        got, calls = _counting(lambda: model(torch.from_numpy(x)))
        feats = model.features(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert feats.shape == (8, 2, 2, 512)
    # conv1 of stage 3/4 block 2 (K1); conv2 of each block there (K3)
    assert calls == ({"conv3x3_small": 2, "conv3x3_small_bn_relu": 4}
                     if fast_conv else
                     {"conv3x3_small": 0, "conv3x3_small_bn_relu": 0})


def test_classify_head_matches_jax(resnet18_embedding):
    x, variables, _ = resnet18_embedding
    jmod = JEmbeddingModule(backbone_name="resnet18", encodings_len=32)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(
        v, x, method="classify"))(variables, jnp.asarray(x[:2])))
    model = EmbeddingModule("resnet18", encodings_len=32).eval()
    model.load_state_dict(flax_to_torch(variables, model))
    with torch.inference_mode():
        got = model.classify(torch.from_numpy(x[:2]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_converter_rejects_missing_and_extra_keys(small_bottleneck):
    _, variables, _ = small_bottleneck
    model = tresnet.ResNet(block_cls=tresnet.BottleneckBlock, **SMALL)

    def without(collection, *path):
        v = jax.tree.map(lambda a: a, variables)
        node = v[collection]
        for key in path[:-1]:
            node = node[key]
        del node[path[-1]]
        return v

    with pytest.raises(KeyError, match="missing"):
        flax_to_torch(without("batch_stats", "stem_bn", "mean"), model)
    with pytest.raises(KeyError, match="missing"):
        flax_to_torch(without("params", "stage4_block2", "conv2"), model)
    extra = jax.tree.map(lambda a: a, variables)
    extra["params"]["stage9_block1"] = {
        "conv1": {"kernel": np.zeros((1, 1, 8, 8), np.float32)}}
    with pytest.raises(KeyError, match="extra"):
        flax_to_torch(extra, model)
    odd = jax.tree.map(lambda a: a, variables)
    odd["params"]["stem_conv"]["gamma"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unknown leaf"):
        flax_to_torch(odd, model)


def test_unported_backbone_names_roadmap():
    """No backbone is left to port: every name of the JAX registry is in
    the port's, in JAX's order, and builds (on the meta device: shapes
    only) an embedding module whose forward at the family's smallest
    input gives the embedding; an unknown name raises as in JAX."""
    from embeddingnet_tpu.models.registry import list_backbones as jax_list
    from embeddingnet_tpu_torch.models.registry import list_backbones
    names = jax_list()
    assert list_backbones()[:len(names) - 4] == names[:-4]
    assert set(names) <= set(list_backbones())
    assert set(list_backbones()) - set(names) == {"vit-b32", "vit-l16"}
    smallest = {"inceptionv3": 75, "inceptionresnetv2": 75, "xception": 71,
                "simple": 72}
    for name in list_backbones():
        size = smallest.get(name, 224 if "vit" in name else 32)
        with torch.device("meta"):
            module = EmbeddingModule(name, encodings_len=16,
                                     input_shape=(size, size, 3)).eval()
            out = module(torch.empty(2, size, size, 3))
        assert out.shape == (2, 16), name
    with pytest.raises(ValueError, match="unknown backbone"):
        EmbeddingModule("resnet19")


def test_fresh_init_statistics():
    """reset_parameters draws He-normal convs (truncated at 2 std) and
    glorot-uniform Dense kernels, as the JAX initialisers do."""
    model = EmbeddingModule("resnet18", encodings_len=32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    w = model.backbone.stage4_block2.conv2.weight
    std = np.sqrt(2.0 / w[0].numel())
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / .87962566103423978 + 1e-6
    d = model.head.dense_1.weight
    limit = np.sqrt(6.0 / (d.shape[0] + d.shape[1]))
    assert d.abs().max().item() <= limit
    assert model.head.dense_1.bias.abs().max().item() == 0
    again = EmbeddingModule("resnet18", encodings_len=32)
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(again.backbone.stem_conv.weight,
                       model.backbone.stem_conv.weight)


@pytest.mark.slow
@pytest.mark.parametrize("fast_conv", [False, True])
def test_resnet50_embedding_matches_jax(fast_conv):
    x = _images(2)
    make = lambda fast: JEmbeddingModule(  # noqa: E731
        backbone_name="resnet50", encodings_len=32, fast_conv=fast)
    variables, want = _jax_reference(make(False), make(True), x,
                                     method="init_all")
    model = EmbeddingModule("resnet50", encodings_len=32,
                            fast_conv=fast_conv).eval()
    model.load_state_dict(flax_to_torch(variables, model))
    with torch.inference_mode():
        got, calls = _counting(lambda: model(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert calls["conv3x3_small_bn_relu"] == (7 if fast_conv else 0)
