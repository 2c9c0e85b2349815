"""The port's distances and kNN ops against the JAX package's, on the same
numpy embeddings: indices and labels identical, distances within 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.models import heads as jheads  # noqa: E402
from embeddingnet_tpu.ops import distances as jdist  # noqa: E402
from embeddingnet_tpu.ops import knn as jknn  # noqa: E402
from embeddingnet_tpu_torch.models import heads as theads  # noqa: E402
from embeddingnet_tpu_torch.ops import distances as tdist  # noqa: E402
from embeddingnet_tpu_torch.ops import knn as tknn  # noqa: E402

N_DB, N_Q, D, C = 120, 17, 32, 9


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    db = rng.normal(size=(N_DB, D)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = rng.normal(size=(N_Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    labels = rng.integers(0, C, size=N_DB).astype(np.int32)
    return db, q, labels


def _t(a):
    return torch.from_numpy(a)


def test_pairwise_sq_l2(data):
    db, q, _ = data
    np.testing.assert_allclose(
        tdist.pairwise_sq_l2(_t(q), _t(db)).numpy(),
        np.asarray(jdist.pairwise_sq_l2(jnp.asarray(q), jnp.asarray(db))),
        atol=1e-5)
    sym = tdist.pairwise_sq_l2(_t(db)).numpy()
    np.testing.assert_allclose(
        sym, np.asarray(jdist.pairwise_sq_l2(jnp.asarray(db))), atol=1e-5)
    assert np.all(np.diag(sym) == 0) and np.all(sym >= 0)
    # bf16 input: the reduction is still f32
    assert tdist.pairwise_sq_l2(_t(q).bfloat16()).dtype == torch.float32


@pytest.mark.parametrize("k", [1, 5])
def test_knn_classify(data, k):
    db, q, labels = data
    jp, ji = jknn.knn_classify(jnp.asarray(db), jnp.asarray(labels),
                               jnp.asarray(q), k=k, n_classes=C)
    tp, ti = tknn.knn_classify(_t(db), _t(labels), _t(q), k=k, n_classes=C)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_knn_vote_tie_goes_to_nearest():
    """Two classes with two votes each among k=4: the class of the nearest
    neighbour wins (the rank epsilon), on both sides."""
    db = np.array([[0.0], [1.0], [2.0], [3.0]], np.float32)
    labels = np.array([1, 0, 0, 1], np.int32)
    q = np.array([[0.1]], np.float32)
    jp, _ = jknn.knn_classify(jnp.asarray(db), jnp.asarray(labels),
                              jnp.asarray(q), k=4, n_classes=2)
    tp, _ = tknn.knn_classify(_t(db), _t(labels), _t(q), k=4, n_classes=2)
    assert int(tp[0]) == int(jp[0]) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_topk_lowest_index_breaks_ties_as_jax(dtype):
    """Rows full of equal values (-0.0 beside 0.0, NaNs of both signs,
    infinities, negatives): the same values and positions as
    ``jax.lax.top_k`` (the lower position first among equals, its total
    order) and, in the rows without -0.0 or NaN, as a stable descending
    sort."""
    import jax
    rng = np.random.default_rng(1)
    x = (rng.integers(-3, 3, (6, 40)) * 0.5).astype(np.float32)
    x[0, :4] = -0.0
    x[0, 20:23] = np.array([0x7FC00000, 0xFFC00000, 0x7FC00000],
                           np.uint32).view(np.float32)
    x[1, 3:6] = np.inf
    x[2, 10:] = -np.inf
    x[3] = 1.5
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    for k in (1, 7, 40):
        vals, idx = tknn.topk_lowest_index(t, k)
        jv, ji = jax.lax.top_k(jnp.asarray(t.double().numpy(), jnp.float32),
                               k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.double().numpy(), np.asarray(jv))
        sv, si = t[1:].sort(dim=1, descending=True, stable=True)
        assert torch.equal(idx[1:], si[:, :k])
        assert torch.equal(vals[1:], sv[:, :k])


def test_knn_neighbors(data):
    db, q, _ = data
    jd, ji = jknn.knn_neighbors(jnp.asarray(db), jnp.asarray(q), k=5)
    td, ti = tknn.knn_neighbors(_t(db), _t(q), k=5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)


def test_quantized_path(data):
    db, q, labels = data
    jv, js = jknn.quantize_db(jnp.asarray(db))
    tv, ts = tknn.quantize_db(_t(db))
    assert tv.dtype == torch.int8
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    jp, ji = jknn.knn_classify_quantized(jv, js, jnp.asarray(labels),
                                         jnp.asarray(q), k=5, n_classes=C)
    tp, ti = tknn.knn_classify_quantized(tv, ts, _t(labels), _t(q), k=5,
                                         n_classes=C)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_class_centers(data):
    db, _, labels = data
    n_classes = C + 1   # one class without rows: a zero centre
    np.testing.assert_allclose(
        tknn.class_centers(_t(db), _t(labels), n_classes).numpy(),
        np.asarray(jknn.class_centers(jnp.asarray(db), jnp.asarray(labels),
                                      n_classes)), atol=1e-6)


def test_small_heads_match_jax():
    """l2_normalize, the siamese heads and the softmax head on converted
    Dense weights."""
    rng = np.random.default_rng(1)
    e1 = rng.normal(size=(6, 16)).astype(np.float32)
    e2 = rng.normal(size=(6, 16)).astype(np.float32)
    w = rng.normal(size=(16, 1)).astype(np.float32)
    b = rng.normal(size=(1,)).astype(np.float32)
    np.testing.assert_allclose(
        theads.l2_normalize(_t(e1)).numpy(),
        np.asarray(jheads.l2_normalize(jnp.asarray(e1))), rtol=1e-6)
    np.testing.assert_allclose(
        theads.siamese_l2_distance(_t(e1), _t(e2)).numpy(),
        np.asarray(jheads.siamese_l2_distance(jnp.asarray(e1),
                                              jnp.asarray(e2))), rtol=1e-6)
    head = theads.SiameseL1Head(16)
    with torch.no_grad():
        head.output_siamese.weight.copy_(_t(w.T.copy()))
        head.output_siamese.bias.copy_(_t(b))
        got = head(_t(e1), _t(e2)).numpy()
    want = jheads.SiameseL1Head().apply(
        {"params": {"output_siamese": {"kernel": w, "bias": b}}},
        jnp.asarray(e1), jnp.asarray(e2))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)

    feats = rng.normal(size=(2, 3, 3, 16)).astype(np.float32)
    wl = rng.normal(size=(16, 5)).astype(np.float32)
    bl = rng.normal(size=(5,)).astype(np.float32)
    soft = theads.SoftmaxHead(16, 5)
    with torch.no_grad():
        soft.logits.weight.copy_(_t(wl.T.copy()))
        soft.logits.bias.copy_(_t(bl))
        got = soft(_t(feats).permute(0, 3, 1, 2)).numpy()
    want = jheads.SoftmaxHead(5).apply(
        {"params": {"logits": {"kernel": wl, "bias": bl}}},
        jnp.asarray(feats))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
