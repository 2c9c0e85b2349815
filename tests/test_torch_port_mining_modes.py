"""The port's mining modes against the JAX package's
(``embeddingnet_tpu/ops/mining.py``): semihard, hardest and random_hard on
their three paths (the [B, B, B] enumeration at B=32, the dense and the
grouped P-K rank-window paths at B=264 = 66 x 4), batch-hard with and
without ``soft``, the large paths' helpers, the distances and losses of
the pair and triplet models.

Both sides get the same numpy inputs and the same random draws: JAX's
``jax.random.gumbel``/``uniform`` of the key its miner takes, fed to the
port as a tensor. The miners compute in float32, so a negative distance
within float error of a window edge could fall on either side of it: each
test first asserts that none lies within 1e-5 of one (nor the two closest
negatives of an anchor within 1e-5 of each other, hardest's edge), so a
flipped selection is a defect.

The embeddings make every squared distance exact in float32 (asserted), so
that both packages compute the same distances in any order: XLA's batched
Gram of the P-K groups adds its last product through a fused multiply-add
where torch's rounds it first, and on generic data that one ulp moves
semihard's few active hinges by 1e-5 of the loss. Classes come in pairs;
each pair is a cluster, ``R`` on its own axis, plus four coordinates of
Gaussian noise on a grid of 1/128 (products and sums exact). An anchor's
windows (margin 1) hold its cluster's other class, and every other
cluster lies beyond them (at a distance of at least ``R * sqrt(2)``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from embeddingnet_tpu.ops import distances as jdist  # noqa: E402
from embeddingnet_tpu.ops import losses as jlosses  # noqa: E402
from embeddingnet_tpu.ops import mining as jmining  # noqa: E402
from embeddingnet_tpu_torch.ops import distances as tdist  # noqa: E402
from embeddingnet_tpu_torch.ops import losses as tlosses  # noqa: E402
from embeddingnet_tpu_torch.ops import mining as tmining  # noqa: E402

MARGIN = 1.0
R = 6.0
NOISE_DIMS, GRID = 4, 128
EDGE = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
# The mean distances are float32 sums of the B^2 masked distances, in
# another order on each side: at B=32 JAX's own sum is 1.17e-6 off the
# float64 mean of its float32 distances (the port's 2.3e-8), so the two
# are held to each other within 2e-6.
MEAN_DIST_RTOL = 2e-6
STAT_NAMES = ("n_triplets", "n_candidates", "frac_mined", "mean_pos_dist",
              "mean_neg_dist")
PARITY = ("semihard", "hardest", "random_hard")
# path -> (classes, samples per class, max_positives)
PATHS = {"enumeration": (8, 4, 3), "dense": (66, 4, None),
         "pk": (66, 4, 3)}


def _batch(p, k, seed=0):
    """``p`` classes of ``k`` points, grouped (see the module's
    docstring)."""
    rng = np.random.default_rng(seed)
    n_clusters = -(-p // 2)
    emb = np.zeros((p * k, n_clusters + NOISE_DIMS))
    emb[np.arange(p * k), np.repeat(np.arange(p) // 2, k)] = R
    noise = np.clip(rng.normal(size=(p * k, NOISE_DIMS)), -3.9, 3.9)
    emb[:, n_clusters:] = np.round(noise * GRID) / GRID
    labels = np.repeat(rng.permutation(1000)[:p], k).astype(np.int32)
    return emb.astype(np.float32), labels


def _assert_no_edge(emb, labels, margin=MARGIN):
    """No negative distance within EDGE of a window edge (``d_ap`` and
    ``d_ap + margin`` of any anchor-positive pair), and each anchor's two
    closest negatives more than EDGE apart; and the float32 squared
    distances exact."""
    sq = pairwise_sq(emb)
    exact = ((emb[:, None].astype(np.float64) - emb[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(sq, exact)
    d = np.sqrt(sq)
    same = labels[:, None] == labels[None, :]
    b = len(labels)
    for a in range(b):
        neg = np.sort(d[a][~same[a]])
        assert neg[1] - neg[0] > EDGE, (a, neg[:2])
        for p in np.nonzero(same[a] & (np.arange(b) != a))[0]:
            for edge in (d[a, p], d[a, p] + margin):
                assert np.abs(neg - edge).min() > EDGE, (a, p, edge)


def pairwise_sq(emb):
    """The port's float32 squared distances, as numpy float64."""
    return tdist.pairwise_sq_l2(torch.from_numpy(emb)).double().numpy()


def _jax_draws(mode, key, b, max_positives):
    shape = tmining.draws_shape(mode, b, max_positives)
    if shape is None:
        return None
    if len(shape) == 3:
        d = jax.random.gumbel(key, shape, jnp.float32)
    else:
        d = jax.random.uniform(key, shape, jnp.float32)
    return torch.from_numpy(np.array(d))


def _jax_run(emb, labels, key, **kw):
    def f(e):
        return jmining.mined_triplet_loss(e, jnp.asarray(labels), rng=key,
                                          **kw)
    (loss, stats), grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(emb))
    return float(loss), stats, np.asarray(grad)


def _port_run(emb, labels, **kw):
    e = torch.from_numpy(emb).requires_grad_()
    loss, stats = tmining.mined_triplet_loss(e, torch.from_numpy(labels),
                                             **kw)
    loss.backward()
    return loss.item(), stats, e.grad.numpy()


def _value(v):
    return float(v.detach() if isinstance(v, torch.Tensor) else v)


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL, atol=0)
    for name in STAT_NAMES:
        rtol = MEAN_DIST_RTOL if name.startswith("mean") else LOSS_RTOL
        np.testing.assert_allclose(_value(getattr(got[1], name)),
                                   _value(getattr(want[1], name)),
                                   rtol=rtol, atol=0, err_msg=name)
    scale = np.abs(want[2]).max()
    np.testing.assert_allclose(got[2], want[2], rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * scale)


def _jax_enumeration_selection(emb, labels, mode, key):
    """The JAX enumeration's (selected, n_star), from its own helpers as
    ``_parity_mined_loss`` combines them."""
    e = jnp.asarray(emb)
    dist = jdist.pairwise_l2(e)
    pos_mask, neg_mask = jmining._masks(jnp.asarray(labels))
    idx = jnp.arange(len(labels))
    pair_mask = pos_mask & (idx[:, None] < idx[None, :])
    lv = dist[:, :, None] - dist[:, None, :] + MARGIN
    neg3 = jnp.broadcast_to(neg_mask[:, None, :], lv.shape)
    if mode == "hardest":
        score = jnp.where(neg3, lv, -jnp.inf)
        n_star = jnp.argmax(score, axis=-1)
        best = jnp.max(score, axis=-1)
        selected = pair_mask & (best > 0.0) & jnp.isfinite(best)
    else:
        cand = neg3 & (lv > 0.0)
        if mode == "semihard":
            cand = cand & (lv < MARGIN)
        n_star = jmining._uniform_choice(key, cand)
        selected = pair_mask & jnp.any(cand, axis=-1)
    return np.asarray(selected), np.asarray(n_star)


@pytest.mark.parametrize("mode", PARITY)
@pytest.mark.parametrize("path", list(PATHS))
def test_parity_modes_match_jax(path, mode):
    p, k, max_positives = PATHS[path]
    emb, labels = _batch(p, k)
    b = p * k
    _assert_no_edge(emb, labels)
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(mode, key, b, max_positives)
    want = _jax_run(emb, labels, key, margin=MARGIN, mode=mode,
                    max_positives=max_positives)
    got = _port_run(emb, labels, margin=MARGIN, mode=mode, draws=draws,
                    max_positives=max_positives)
    _assert_same(got, want)
    assert int(got[1].n_triplets) > 0

    if path == "enumeration":
        sel_want, n_want = _jax_enumeration_selection(emb, labels, mode, key)
        dist = tdist.pairwise_l2(torch.from_numpy(emb))
        _, _, _, sel, n_star = tmining._parity_select(
            dist, torch.from_numpy(labels), MARGIN, mode, draws)
        np.testing.assert_array_equal(sel.numpy(), sel_want)
        np.testing.assert_array_equal(n_star.numpy()[sel_want],
                                      n_want[sel_want])
        return
    k_samples = None if max_positives is None else max_positives + 1
    jl, js, jw, jaux = jmining._parity_forward_large(
        jnp.asarray(emb), jnp.asarray(labels), MARGIN, mode, key, k_samples)
    tl, ts, tw, taux = tmining._parity_forward_large(
        torch.from_numpy(emb), torch.from_numpy(labels), MARGIN, mode,
        draws, k_samples)
    for name in ("selected", "active", "n_star", "k", "k_lo"):
        if jaux[name] is None:
            assert taux[name] is None, name
            continue
        np.testing.assert_array_equal(taux[name].numpy(),
                                      np.asarray(jaux[name]), err_msg=name)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=LOSS_RTOL,
                               atol=0)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)


@pytest.mark.parametrize("soft", [False, True], ids=["hinge", "soft"])
@pytest.mark.parametrize("p,k", [(8, 4), (66, 4)])
def test_batch_hard_matches_jax(p, k, soft):
    emb, labels = _batch(p, k, seed=1)

    def f(e):
        return jmining.batch_hard_loss(e, jnp.asarray(labels), margin=0.5,
                                       soft=soft)
    (loss, stats), grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_()
    got = tmining.batch_hard_loss(e, torch.from_numpy(labels), margin=0.5,
                                  soft=soft)
    got[0].backward()
    _assert_same((got[0].item(), got[1], e.grad.numpy()),
                 (float(loss), stats, np.asarray(grad)))
    if not soft:
        via = _port_run(emb, labels, margin=0.5, mode="batch_hard")
        assert via[0] == got[0].item()


@pytest.mark.parametrize("mode", PARITY)
def test_pk_path_poisons_a_broken_layout(mode):
    """A batch that breaks the asserted P-K layout gives NaN loss, stats and
    gradient and -1 counts on both sides."""
    emb, labels = _batch(66, 4)
    labels[[3, 4]] = labels[[4, 3]]
    key = jax.random.PRNGKey(3)
    draws = _jax_draws(mode, key, len(labels), 3)
    want = _jax_run(emb, labels, key, margin=MARGIN, mode=mode,
                    max_positives=3)
    got = _port_run(emb, labels, margin=MARGIN, mode=mode, draws=draws,
                    max_positives=3)
    for loss, stats, grad in (got, want):
        assert np.isnan(loss) and np.isnan(grad).all()
        assert int(stats.n_triplets) == -1 and int(stats.n_candidates) == -1
        for name in ("frac_mined", "mean_pos_dist", "mean_neg_dist"):
            assert np.isnan(float(getattr(stats, name)))


@pytest.mark.parametrize("inclusive", [True, False])
def test_count_below_matches_jax_with_ties(inclusive):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 6, (5, 17)).astype(np.float32)
    keys[:, -3:] = np.inf                               # masked keys
    queries = rng.integers(-1, 7, (5, 9)).astype(np.float32)
    queries[:, 0] = -np.inf                             # masked queries
    want = jmining._count_below(jnp.asarray(keys), jnp.asarray(queries),
                                inclusive=inclusive)
    got = tmining._count_below(torch.from_numpy(keys),
                               torch.from_numpy(queries),
                               inclusive=inclusive)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fetch_at_rank_and_row_histogram_match_jax():
    rng = np.random.default_rng(1)
    vals = np.sort(rng.integers(0, 5, (4, 11)).astype(np.float32), axis=1)
    vals[:, -2:] = np.inf
    ids = np.stack([rng.permutation(11) for _ in range(4)]).astype(np.int32)
    ranks = rng.integers(0, 11, (4, 7)).astype(np.float32)
    jv, ji = jmining._fetch_at_rank(jnp.asarray(vals), jnp.asarray(ids),
                                    jnp.asarray(ranks))
    tv, ti = tmining._fetch_at_rank(torch.from_numpy(vals),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(ranks))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    hist_ids = rng.integers(0, 10, (4, 25)).astype(np.int32)  # 9: ignored
    want = jmining._row_histogram(jnp.asarray(hist_ids), 9)
    got = tmining._row_histogram(torch.from_numpy(hist_ids), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hardest_needs_no_draws_and_stochastic_modes_need_them():
    emb, labels = _batch(66, 4)
    e, lab = torch.from_numpy(emb), torch.from_numpy(labels)
    for b_cut in (32, 264):
        for mode in ("semihard", "random_hard"):
            with pytest.raises(ValueError, match="requires an rng"):
                tmining.mined_triplet_loss(e[:b_cut], lab[:b_cut],
                                           mode=mode)
            with pytest.raises(ValueError, match="draws of shape"):
                tmining.mined_triplet_loss(e[:b_cut], lab[:b_cut],
                                           mode=mode,
                                           draws=torch.zeros(b_cut, 3))
        a, _ = tmining.mined_triplet_loss(e[:b_cut], lab[:b_cut],
                                          margin=MARGIN, mode="hardest")
        c, _ = tmining.mined_triplet_loss(
            e[:b_cut], lab[:b_cut], margin=MARGIN, mode="hardest",
            rng=torch.Generator().manual_seed(5))
        assert a.item() == c.item()
    with pytest.raises(ValueError, match="unknown mining mode"):
        tmining.mined_triplet_loss(e, lab, mode="nope")
    big = torch.zeros(520, 4)
    with pytest.raises(ValueError, match="dispatches"):
        tmining._parity_mined_loss(big, torch.arange(520), margin=1.0,
                                   mode="hardest")


@pytest.mark.parametrize("b,max_positives", [(32, 3), (264, 3),
                                             (264, None)])
def test_generator_draws_are_the_draws_argument(b, max_positives):
    """Drawing from a generator equals passing what it draws; the
    enumeration's Gumbel noise has the Gumbel mean (Euler's constant)."""
    emb, labels = _batch(b // 4, 4)
    e, lab = torch.from_numpy(emb), torch.from_numpy(labels)
    draws = tmining.sample_draws("semihard", b, max_positives,
                                 torch.Generator().manual_seed(11))
    assert tuple(draws.shape) == tmining.draws_shape("semihard", b,
                                                     max_positives)
    if draws.dim() == 3:
        assert abs(draws.mean().item() - 0.5772) < 0.01
    else:
        assert 0.0 <= draws.min().item() and draws.max().item() < 1.0
    a, _ = tmining.mined_triplet_loss(e, lab, margin=MARGIN, mode="semihard",
                                      rng=torch.Generator().manual_seed(11),
                                      max_positives=max_positives)
    c, _ = tmining.mined_triplet_loss(e, lab, margin=MARGIN, mode="semihard",
                                      draws=draws,
                                      max_positives=max_positives)
    assert a.item() == c.item()
    assert tmining.sample_draws("hardest", b, max_positives,
                                torch.Generator()) is None


def test_large_path_takes_bf16_embeddings():
    """bf16 embeddings are mined in f32 and the gradient comes back in
    bf16, as JAX casts before its custom VJP."""
    emb, labels = _batch(66, 4)
    e = torch.from_numpy(emb).bfloat16().requires_grad_()
    loss, _ = tmining.mined_triplet_loss(e, torch.from_numpy(labels),
                                         margin=0.5, mode="hardest",
                                         max_positives=3)
    loss.backward()
    assert loss.dtype == torch.float32 and e.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("fn", ["pairwise_l2", "pairwise_l1",
                                "pairwise_cosine", "pairwise_sq_l2"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_distances_match_jax(fn, cross):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(13, 16)).astype(np.float32)
    b = rng.normal(size=(7, 16)).astype(np.float32) if cross else None
    want = getattr(jdist, fn)(jnp.asarray(a),
                              None if b is None else jnp.asarray(b))
    got = getattr(tdist, fn)(torch.from_numpy(a),
                             None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pair_and_triplet_losses_match_jax():
    rng = np.random.default_rng(3)
    d = np.abs(rng.normal(size=64)).astype(np.float32)
    y = (rng.random(64) < 0.5).astype(np.float32)
    for margin in (1.0, 0.7):
        np.testing.assert_allclose(
            tlosses.contrastive_loss(torch.from_numpy(y), torch.from_numpy(d),
                                     margin).item(),
            float(jlosses.contrastive_loss(jnp.asarray(y), jnp.asarray(d),
                                           margin)), rtol=1e-6)
    # the 0.5 threshold, with distances on it and on either side
    d[:3] = [0.5, np.nextafter(np.float32(0.5), 0), 0.5001]
    assert tlosses.accuracy(torch.from_numpy(y), torch.from_numpy(d)).item() \
        == float(jlosses.accuracy(jnp.asarray(y), jnp.asarray(d)))
    merged = rng.normal(size=(10, 3 * 8)).astype(np.float32)
    for margin in (0.5, 2.0):
        np.testing.assert_allclose(
            tlosses.triplet_loss(margin)(torch.from_numpy(merged)).numpy(),
            np.asarray(jlosses.triplet_loss(margin)(jnp.asarray(merged))),
            rtol=1e-6, atol=1e-6)
