"""Pretrained backbone weights in the port (``embeddingnet_tpu_torch/models/
pretrained.py``, ``models/convert.py`` ``torch_to_flax``, the Trainer's
``MODEL.backbone_weights``, ``tools/convert_weights_torch.py``) against
the JAX package's.

``resolve_weights``' four branches and their errors, message for message;
``load_into``'s partial load (a key the file lacks keeps its value, a key
the module lacks is ignored, a shape mismatch raises, values cast to the
module's dtype), state for state with JAX's ``load_into``; a ``.npz`` of
JAX's ``flatten_params`` loads in the port and the port's in JAX, both
with equal embeddings; a ``.msgpack`` of ``flax.serialization.to_bytes``
(with a bfloat16 leaf) loads in a fresh interpreter where ``flax``,
``msgpack`` and ``jax`` cannot be imported, and a file missing a key
raises as Flax's strict restore does; the torch-source converters against
JAX's on a torchvision-layout ResNet-18 ``state_dict`` and on HuggingFace
ViT and CLIP vision ``state_dict``s of depth 2 (random arrays under their
key names); ``tools/convert_weights_torch.py --source torch`` end to end
through ``get_backbone``'s preset lookup, and ``--source keras`` refused;
``torch_to_flax`` against ``flax_to_torch``. The Trainer's loading is in
``tests/test_torch_port_pretrained_trainer.py``.

ResNet-18 at 32 px; files written from seeded random weights, nothing
downloaded; one torch thread."""

import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from embeddingnet_tpu.models import pretrained as jpre  # noqa: E402
from embeddingnet_tpu.models.registry import \
    EmbeddingModule as JEmbeddingModule  # noqa: E402
from embeddingnet_tpu_torch.models import pretrained  # noqa: E402
from embeddingnet_tpu_torch.models import registry  # noqa: E402
from embeddingnet_tpu_torch.models.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)

from _torch_port import ROOT, port_variables  # noqa: E402

SIZE, D = 32, 16
TOOL = os.path.join(ROOT, "tools", "convert_weights_torch.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(
        leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _module(seed=0, **kw):
    module = registry.EmbeddingModule("resnet18", encodings_len=D, **kw)
    port_variables(module, seed)
    return module.eval()


def _raises_alike(fn_port, fn_jax, error):
    with pytest.raises(error) as got:
        fn_port()
    with pytest.raises(error) as want:
        fn_jax()
    assert str(got.value) == str(want.value)


# -- resolve_weights ---------------------------------------------------------

def test_resolve_weights_branches(tmp_path, monkeypatch):
    monkeypatch.delenv(pretrained.WEIGHTS_DIR_ENV, raising=False)
    assert pretrained.NAMED_PRESETS == jpre.NAMED_PRESETS
    assert pretrained.WEIGHTS_DIR_ENV == jpre.WEIGHTS_DIR_ENV
    # none
    for value in (None, ""):
        assert pretrained.resolve_weights(value, "resnet18") is None
    # a path
    path = tmp_path / "w.npz"
    np.savez(path, x=np.zeros(1))
    assert pretrained.resolve_weights(str(path), "resnet18") == str(path)
    _raises_alike(
        lambda: pretrained.resolve_weights(str(tmp_path / "no.npz"), "a"),
        lambda: jpre.resolve_weights(str(tmp_path / "no.npz"), "a"),
        FileNotFoundError)
    # a preset without the directory, then with it and without its file
    for env in (None, str(tmp_path)):
        if env:
            monkeypatch.setenv(pretrained.WEIGHTS_DIR_ENV, env)
        _raises_alike(
            lambda: pretrained.resolve_weights("imagenet", "resnet18"),
            lambda: jpre.resolve_weights("imagenet", "resnet18"),
            FileNotFoundError)
    # a preset found: .npz before .msgpack
    (tmp_path / "resnet18_noisy-student.msgpack").write_bytes(b"")
    assert pretrained.resolve_weights("noisy-student", "resnet18") == str(
        tmp_path / "resnet18_noisy-student.msgpack")
    np.savez(tmp_path / "resnet18_noisy-student.npz", x=np.zeros(1))
    for fn in (pretrained.resolve_weights, jpre.resolve_weights):
        assert fn("noisy-student", "resnet18") == str(
            tmp_path / "resnet18_noisy-student.npz")


# -- load_into ---------------------------------------------------------------

def test_load_into_partial_semantics_match_jax(tmp_path):
    """The file holds the backbone, the head's first Dense, one array the
    module lacks; the module is in bfloat16. JAX's ``load_into`` on the
    same variables loads the same values; a shape mismatch raises in
    both."""
    source = _module(seed=1)
    flat = pretrained.flatten_params(source)
    kept = {k: v for k, v in flat.items()
            if "/backbone/" in k or "/dense_1/" in k}
    kept["params/backbone/stage9_block1/conv1/kernel"] = np.zeros(3)
    path = str(tmp_path / "w.npz")
    np.savez(path, **kept)

    target = _module(seed=2, dtype=None).to(torch.bfloat16)
    before = {k: v.clone() for k, v in target.state_dict().items()}
    jvars = jax.tree.map(np.asarray, torch_to_flax(_module(seed=2)))
    jvars = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jvars)
    assert pretrained.load_into(target, path) is target
    jloaded = jpre.load_into(jvars, path)
    want = flax_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      jloaded), target)
    for key, value in target.state_dict().items():
        assert value.dtype == before[key].dtype
        if "num_batches" in key:
            continue
        assert torch.equal(value.float(), want[key].to(torch.bfloat16)
                           .float()), key
        loaded = key.startswith("backbone.") or "dense_1" in key
        assert torch.equal(value, before[key]) != loaded or torch.equal(
            before[key], want[key].to(torch.bfloat16)), key
    assert not torch.equal(target.head.dense_2.weight,
                           source.head.dense_2.weight.bfloat16())

    bad = dict(kept)
    bad["params/head/dense_1/bias"] = np.zeros(3, np.float32)
    np.savez(path, **bad)
    _raises_alike(lambda: pretrained.load_into(_module(), path),
                  lambda: jpre.load_into(jax.tree.map(
                      np.asarray, torch_to_flax(_module())), path),
                  ValueError)
    with pytest.raises(ValueError, match="unsupported"):
        pretrained.load_into(_module(), str(tmp_path / "w.h5"))


def test_npz_exchange_both_ways(tmp_path):
    """JAX's ``flatten_params`` file loads in the port, the port's loads in
    JAX: the same embeddings either way."""
    x = np.random.default_rng(0).uniform(size=(4, SIZE, SIZE, 3)).astype(
        np.float32)
    jmodule = JEmbeddingModule(backbone_name="resnet18", encodings_len=D)
    apply = jax.jit(lambda v, x: jmodule.apply(v, x, train=False))
    shapes = jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        method="init_all"))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    jvars = port_variables(_module(seed=3), seed=3)
    np.savez(tmp_path / "jax.npz", **jpre.flatten_params(jvars))
    port = pretrained.load_into(_module(seed=4), str(tmp_path / "jax.npz"))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, apply(jvars, x), rtol=1e-5, atol=1e-6)

    source = _module(seed=5)
    np.savez(tmp_path / "port.npz", **pretrained.flatten_params(source))
    loaded = jpre.load_into(zeros, str(tmp_path / "port.npz"))
    assert _flat(loaded).keys() == _flat(shapes).keys()
    with torch.inference_mode():
        want = source(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(apply(loaded, x), want, rtol=1e-5, atol=1e-6)


MSGPACK_SCRIPT = """
import sys
for name in ("jax", "flax", "msgpack", "optax"):
    sys.modules[name] = None          # import of it raises ImportError
import torch
from embeddingnet_tpu_torch.models import pretrained, registry
module = registry.EmbeddingModule("resnet18", encodings_len={d})
pretrained.load_into(module, sys.argv[1])
want = torch.load(sys.argv[2])
for key, value in module.state_dict().items():
    if not key.endswith("num_batches_tracked"):
        assert torch.equal(value, want[key]), key
try:
    pretrained.load_into(module, sys.argv[3])
except ValueError as e:
    assert "lacks" in str(e) and "classifier" in str(e), e
else:
    raise AssertionError("a file without the classifier loaded")
assert not any(m in sys.modules and sys.modules[m] is not None
               for m in ("jax", "flax", "msgpack"))
assert not any(m.startswith("embeddingnet_tpu.") for m in sys.modules)
print("ok")
""".format(d=D)


def test_msgpack_chunked_arrays_match_flax(monkeypatch):
    """Flax splits an array over ``MAX_CHUNK_SIZE`` bytes into chunks; the
    port's reader joins them as Flax's ``msgpack_restore`` does."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.default_rng(0)
    tree = {"params": {"a": {"kernel": rng.normal(size=(7, 9, 3)).astype(
        np.float32)}, "b": np.arange(5, dtype=np.int32)},
        "step": np.float32(2.0)}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = _flat(pretrained.msgpack_restore(data))
    want = _flat(serialization.msgpack_restore(data))
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key


def test_msgpack_from_flax_loads_without_flax(tmp_path):
    source = _module(seed=6)
    variables = torch_to_flax(source)
    # a bfloat16 leaf, as a bf16 JAX run saves it
    kernel = variables["params"]["head"]["dense_1"]["kernel"]
    variables["params"]["head"]["dense_1"]["kernel"] = kernel.astype(
        jnp.bfloat16)
    (tmp_path / "w.msgpack").write_bytes(serialization.to_bytes(variables))
    want = flax_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                      variables), source)
    torch.save(want, tmp_path / "want.pt")
    del variables["params"]["classifier"]
    (tmp_path / "part.msgpack").write_bytes(serialization.to_bytes(variables))
    tree = pretrained.msgpack_restore((tmp_path / "w.msgpack").read_bytes())
    ref = serialization.msgpack_restore((tmp_path / "w.msgpack").read_bytes())
    assert _flat(tree).keys() == _flat(ref).keys()
    proc = subprocess.run(
        [sys.executable, "-c", MSGPACK_SCRIPT, str(tmp_path / "w.msgpack"),
         str(tmp_path / "want.pt"), str(tmp_path / "part.msgpack")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


# -- converters -------------------------------------------------------------

def _same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _torchvision_resnet18():
    from tests.test_torch_parity import TorchBasicBlock, TorchResNet
    torch.manual_seed(0)
    return TorchResNet(TorchBasicBlock, [2, 2, 2, 2]).eval()


def test_torch_resnet_converter_matches_jax():
    sd = _torchvision_resnet18().state_dict()
    got = pretrained.torch_resnet_to_flax(sd, (2, 2, 2, 2))
    _same_tree(got, jpre.torch_resnet_to_flax(sd, (2, 2, 2, 2)))
    _same_tree(pretrained.torch_resnet_to_flax(
        {k: v.numpy() for k, v in sd.items()}, (2, 2, 2, 2)), got)


def _random_state_dict(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


def _hf_vit_shapes(dim=32, depth=2, mlp=128, tokens=17, patch=8):
    out = {"vit.embeddings.patch_embeddings.projection.weight":
           (dim, 3, patch, patch),
           "vit.embeddings.patch_embeddings.projection.bias": (dim,),
           "vit.embeddings.cls_token": (1, 1, dim),
           "vit.embeddings.position_embeddings": (1, tokens, dim),
           "vit.layernorm.weight": (dim,), "vit.layernorm.bias": (dim,)}
    for i in range(depth):
        p = f"vit.encoder.layer.{i}"
        for name, shape in (
                ("layernorm_before", (dim,)), ("layernorm_after", (dim,)),
                ("attention.attention.query", (dim, dim)),
                ("attention.attention.key", (dim, dim)),
                ("attention.attention.value", (dim, dim)),
                ("attention.output.dense", (dim, dim)),
                ("intermediate.dense", (mlp, dim)),
                ("output.dense", (dim, mlp))):
            out[f"{p}.{name}.weight"] = shape
            out[f"{p}.{name}.bias"] = (shape[0],)
    return out


def _clip_shapes(dim=32, depth=2, mlp=128, tokens=17, patch=8, proj=16):
    vm = "vision_model."
    out = {f"{vm}embeddings.patch_embedding.weight": (dim, 3, patch, patch),
           f"{vm}embeddings.class_embedding": (dim,),
           f"{vm}embeddings.position_embedding.weight": (tokens, dim),
           f"{vm}pre_layrnorm.weight": (dim,),
           f"{vm}pre_layrnorm.bias": (dim,),
           f"{vm}post_layernorm.weight": (dim,),
           f"{vm}post_layernorm.bias": (dim,),
           "visual_projection.weight": (proj, dim)}
    for i in range(depth):
        p = f"{vm}encoder.layers.{i}"
        for name, shape in (
                ("layer_norm1", (dim,)), ("layer_norm2", (dim,)),
                ("self_attn.q_proj", (dim, dim)),
                ("self_attn.k_proj", (dim, dim)),
                ("self_attn.v_proj", (dim, dim)),
                ("self_attn.out_proj", (dim, dim)),
                ("mlp.fc1", (mlp, dim)), ("mlp.fc2", (dim, mlp))):
            out[f"{p}.{name}.weight"] = shape
            out[f"{p}.{name}.bias"] = (shape[0],)
    return out


@pytest.mark.parametrize("kind", ["hf-vit", "clip"])
def test_vit_converters_match_jax(kind, monkeypatch):
    """Depth 2, 2 heads (``__num_heads__``); the converted tree loads into
    the port's ViT of the same size."""
    from embeddingnet_tpu_torch.models import vit
    if kind == "hf-vit":
        sd = _random_state_dict(_hf_vit_shapes())
        convert, jconvert = pretrained.hf_vit_to_flax, jpre.hf_vit_to_flax
        name, kw = "vit-b16", {}
    else:
        sd = _random_state_dict(_clip_shapes())
        convert, jconvert = pretrained.clip_vit_to_flax, jpre.clip_vit_to_flax
        name, kw = "clip-vit-b16", dict(proj_dim=16)
    sd["__num_heads__"] = 2
    got = convert(sd, depth=2)
    _same_tree(got, jconvert(sd, depth=2))
    monkeypatch.setitem(vit._VARIANTS, name, {
        **vit._VARIANTS[name], "patch": 8, "dim": 32, "depth": 2,
        "heads": 2, **kw})
    backbone = vit.build_vit(name, (SIZE, SIZE, 3))
    state = flax_to_torch({"params": got}, backbone)
    backbone.load_state_dict(state)
    _same_tree(torch_to_flax(backbone)["params"], got)


def test_convert_weights_tool_end_to_end(tmp_path, monkeypatch):
    tmodel = _torchvision_resnet18()
    ckpt = tmp_path / "r18.pth"
    torch.save({"state_dict": tmodel.state_dict()}, ckpt)
    main = runpy.run_path(TOOL)["main"]
    out = main(["--backbone", "resnet18", "--source", "torch", "--input",
                str(ckpt), "--preset", "imagenet", "--out",
                str(tmp_path / "w")])
    assert out == str(tmp_path / "w" / "resnet18_imagenet.npz")
    flat = dict(np.load(out))
    params, stats = jpre.torch_resnet_to_flax(tmodel.state_dict(),
                                              (2, 2, 2, 2))
    want = jpre.flatten_params({"params": {"backbone": params},
                                "batch_stats": {"backbone": stats}})
    assert flat.keys() == want.keys()
    for key in flat:
        np.testing.assert_array_equal(flat[key], want[key])

    monkeypatch.setenv(pretrained.WEIGHTS_DIR_ENV, str(tmp_path / "w"))
    module, backbone = registry.get_backbone(
        (SIZE, SIZE, 3), encodings_len=D, backbone_name="resnet18",
        backbone_weights="imagenet", freeze_backbone=True, device="cpu")
    assert backbone is module.backbone
    np.testing.assert_array_equal(
        module.backbone.stem_conv.weight.detach().numpy(),
        tmodel.conv1.weight.detach().numpy())
    np.testing.assert_array_equal(
        module.backbone.stage2_block1.downsample_bn.running_var.numpy(),
        tmodel.layer2[0].downsample[1].running_var.numpy())

    with pytest.raises(SystemExit, match="tools/convert_weights.py"):
        main(["--backbone", "resnet50", "--source", "keras", "--input",
              str(ckpt), "--out", str(tmp_path / "w")])
    with pytest.raises(SystemExit, match="ResNets"):
        main(["--backbone", "vgg16", "--source", "torch", "--input",
              str(ckpt), "--out", str(tmp_path / "w")])


@pytest.mark.parametrize("name", ["efficientnet-b0", "mobilenet",
                                  "simple2"])
def test_torch_to_flax_inverts_flax_to_torch(name):
    """The families whose parity files predate ``torch_to_flax``: the
    port's tree back to the module is the module (the zoo's files and the
    ViT converters' test above run every other family through it)."""
    module = registry.EmbeddingModule(name, encodings_len=D,
                                      input_shape=(SIZE, SIZE, 3))
    module.reset_parameters(torch.Generator().manual_seed(0))
    variables = torch_to_flax(module)
    state = flax_to_torch(variables, module)
    for key, value in module.state_dict().items():
        assert torch.equal(state[key], value), key
