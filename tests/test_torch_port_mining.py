"""The port's batch-all P-K mining against the JAX package's
(``embeddingnet_tpu/ops/mining.py``): loss, ``MiningStats`` and the
embedding gradient, against ``batch_all_loss(max_positives=K-1)`` and the
O(B^3) oracle, and the NaN poison of a broken P-K layout. Embeddings come
from numpy with a seed; f32 on both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.ops import mining as jmining  # noqa: E402
from embeddingnet_tpu_torch.ops import mining as tmining  # noqa: E402

# f32 on both sides, sums in another order
TOL = dict(rtol=1e-5, atol=1e-5)
STAT_NAMES = ("n_triplets", "n_candidates", "frac_mined", "mean_pos_dist",
              "mean_neg_dist")


def _batch(seed, p, k, d=32, normalize=True):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(p * k, d)).astype(np.float32)
    if normalize:
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = np.repeat(rng.permutation(100)[:p], k).astype(np.int32)
    return emb, labels


def _torch_loss_and_grad(fn, emb, labels, **kw):
    e = torch.from_numpy(emb).requires_grad_()
    loss, stats = fn(e, torch.from_numpy(labels), **kw)
    loss.backward()
    return loss.item(), stats, e.grad.numpy()


def _jax_loss_and_grad(fn, emb, labels, **kw):
    def f(e):
        return fn(e, jnp.asarray(labels), **kw)
    (loss, stats), vjp = jax.vjp(f, jnp.asarray(emb))
    zeros = jax.tree.map(jnp.zeros_like, stats)
    (grad,) = vjp((jnp.ones_like(loss), zeros))
    return float(loss), stats, np.asarray(grad)


def _value(v):
    return float(v.detach() if isinstance(v, torch.Tensor) else v)


def _assert_stats(got, want):
    for name in STAT_NAMES:
        np.testing.assert_allclose(_value(getattr(got, name)),
                                   _value(getattr(want, name)), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("p,k,margin", [(4, 4, 0.5), (8, 2, 0.5),
                                        (16, 4, 0.5), (8, 8, 1.0),
                                        (6, 3, 0.2)])
def test_batch_all_matches_jax(p, k, margin):
    emb, labels = _batch(p * 10 + k, p, k)
    want = _jax_loss_and_grad(jmining.batch_all_loss, emb, labels,
                              margin=margin, max_positives=k - 1)
    got = _torch_loss_and_grad(tmining.batch_all_loss, emb, labels,
                               margin=margin, max_positives=k - 1)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    _assert_stats(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], **TOL)
    assert int(got[1].n_triplets) > 0


@pytest.mark.parametrize("p,k", [(4, 4), (8, 4), (16, 4)])
def test_batch_all_matches_reference_oracles(p, k):
    """The fast path equals both O(B^3) oracles: the port's (autograd) and
    the JAX package's."""
    emb, labels = _batch(p + k, p, k, normalize=False)
    emb *= 0.3
    got = _torch_loss_and_grad(tmining.batch_all_loss, emb, labels,
                               margin=0.5, max_positives=k - 1)
    oracle = _torch_loss_and_grad(tmining.batch_all_loss_reference, emb,
                                  labels, margin=0.5)
    jax_oracle = _jax_loss_and_grad(jmining.batch_all_loss_reference, emb,
                                    labels, margin=0.5)
    for want in (oracle, jax_oracle):
        np.testing.assert_allclose(got[0], want[0], **TOL)
        _assert_stats(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], **TOL)


def test_all_easy_batch_has_zero_loss_and_grad():
    """Classes far apart: no active triplet, loss 0, gradient 0 (the
    denominator is clamped at 1)."""
    p, k = 4, 4
    emb = np.zeros((p * k, 8), np.float32)
    for i in range(p):
        emb[i * k:(i + 1) * k, i] = 10.0
    labels = np.repeat(np.arange(p), k).astype(np.int32)
    loss, stats, grad = _torch_loss_and_grad(
        tmining.batch_all_loss, emb, labels, margin=0.5, max_positives=k - 1)
    assert loss == 0.0 and int(stats.n_triplets) == 0
    assert not grad.any()


@pytest.mark.parametrize("broken", ["split_class", "wrong_k"])
def test_broken_pk_layout_poisons(broken):
    """A batch that breaks the asserted P-K layout gives NaN loss, stats
    and gradient and -1 triplet counts, as in the JAX package."""
    emb, labels = _batch(3, 4, 4)
    if broken == "split_class":
        labels[[3, 4]] = labels[[4, 3]]
    kw = dict(margin=0.5, max_positives=3 if broken == "split_class" else 1)
    got = _torch_loss_and_grad(tmining.batch_all_loss, emb, labels, **kw)
    want = _jax_loss_and_grad(jmining.batch_all_loss, emb, labels, **kw)
    for loss, stats, grad in (got, want):
        assert np.isnan(loss) and np.isnan(grad).all()
        assert int(stats.n_triplets) == -1 and int(stats.n_candidates) == -1
        for name in ("frac_mined", "mean_pos_dist", "mean_neg_dist"):
            assert np.isnan(float(getattr(stats, name)))


def test_mined_triplet_loss_dispatch():
    emb, labels = _batch(5, 4, 4)
    e, lab = torch.from_numpy(emb), torch.from_numpy(labels)
    loss, _ = tmining.mined_triplet_loss(e, lab, margin=0.5,
                                         mode="batch_all", max_positives=3)
    want, _ = tmining.batch_all_loss(e, lab, margin=0.5, max_positives=3)
    assert loss.item() == want.item()
    # the other modes dispatch to their miners (held to the JAX package in
    # tests/test_torch_port_mining_modes.py)
    hard, _ = tmining.mined_triplet_loss(e, lab, margin=0.5,
                                         mode="batch_hard")
    assert hard.item() == tmining.batch_hard_loss(e, lab,
                                                  margin=0.5)[0].item()
    draws = torch.zeros(16, 16, 16)
    for mode in ("semihard", "hardest", "random_hard"):
        got, _ = tmining.mined_triplet_loss(e, lab, margin=0.5, mode=mode,
                                            draws=draws)
        want, _ = tmining._parity_mined_loss(
            e, lab, margin=0.5, mode=mode,
            draws=None if mode == "hardest" else draws)
        assert got.item() == want.item()
    # without max_positives batch_all takes the generic-label path (held
    # to the JAX package in tests/test_torch_port_parallel.py)
    generic, _ = tmining.batch_all_loss(e, lab, margin=0.5)
    oracle, _ = tmining.batch_all_loss_reference(e, lab, margin=0.5)
    torch.testing.assert_close(generic, oracle, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="unknown mining mode"):
        tmining.mined_triplet_loss(e, lab, mode="nope")


def test_bf16_embeddings_mine_in_f32():
    """bf16 embeddings are mined in f32 and the gradient comes back in
    bf16, as JAX casts before its custom VJP."""
    emb, labels = _batch(11, 8, 4)
    e = torch.from_numpy(emb).bfloat16().requires_grad_()
    loss, _ = tmining.batch_all_loss(e, torch.from_numpy(labels),
                                     margin=0.5, max_positives=3)
    loss.backward()
    assert loss.dtype == torch.float32 and e.grad.dtype == torch.bfloat16
    want, _ = tmining.batch_all_loss(e.detach().float(),
                                     torch.from_numpy(labels), margin=0.5,
                                     max_positives=3)
    assert loss.item() == want.item()
