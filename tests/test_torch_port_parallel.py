"""The port's row-sharded miners, sharded kNN and row blocks
(``embeddingnet_tpu_torch/parallel/``) on 2 and 4 gloo ranks, against the
JAX package's sharded functions on a 2- and 4-device mesh of the virtual
CPU platform, JAX's one-device functions and the port's one-process ones;
and the generic-label batch-all (``batch_all_rowblock``) against JAX's
``batch_all_loss(max_positives=None)``.

Tolerances: losses to 1e-6 relative, the integer stats exactly (the float
stats to 1e-6), embedding gradients (f32) to 1e-5 of the largest entry; a
broken P-K layout poisons the sharded loss, gradient and stats with NaN
(counts -1) as on one device; the kNN's indices and predictions identical,
exact distance ties included.

The ranks' workers import no JAX (a spawned rank imports this module); the
JAX references run in the test process.
"""

import functools
from itertools import islice

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from embeddingnet_tpu_torch.data.samplers import (  # noqa: E402
    PKSampler, ProcessShardSampler)
from embeddingnet_tpu_torch.ops import knn as tknn  # noqa: E402
from embeddingnet_tpu_torch.ops import mining as tmining  # noqa: E402
from embeddingnet_tpu_torch.parallel import sharded  # noqa: E402
from embeddingnet_tpu_torch.parallel import sharded_knn  # noqa: E402
from embeddingnet_tpu_torch.parallel.collectives import (  # noqa: E402
    DataParallel)
from embeddingnet_tpu_torch.parallel.mesh import (  # noqa: E402
    process_row_block)
from test_torch_port_ddp import spawn  # noqa: E402

MARGIN = 0.5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5      # of the largest entry
K = 5
N_CLASSES = 6


# -- inputs -------------------------------------------------------------------


def _embeddings(b, d=8, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _miner_inputs():
    """name -> (embeddings [32, 8], labels, max_positives)."""
    pk = np.repeat(np.arange(8), 4).astype(np.int32)
    rng = np.random.default_rng(1)
    # unequal classes and singletons
    generic = np.array([0] * 7 + [1] * 5 + [2] + [3] * 9 + [4] * 3 + [5]
                       + [6] * 6, np.int32)
    broken = pk.copy()
    broken[[3, 4]] = broken[[4, 3]]          # a class split across groups
    return {
        "pk": (_embeddings(32, seed=2), pk, 3),
        "dense": (_embeddings(32, seed=3), rng.permutation(generic), None),
        "broken_pk": (_embeddings(32, seed=4), broken, 3),
    }


def _knn_inputs():
    """A DB of 37 rows (padding needed on 2 and 4 ranks) with duplicated
    rows (exact distance ties), labels, and 10 queries, two of them DB
    rows."""
    rng = np.random.default_rng(5)
    db = rng.normal(size=(37, 8)).astype(np.float32)
    db[20] = db[3]
    db[30] = db[3]
    db[11] = db[7]
    labels = rng.integers(0, N_CLASSES, 37).astype(np.int32)
    q = rng.normal(size=(10, 8)).astype(np.float32)
    q[0] = db[3]
    q[1] = db[7] + 1e-3
    return db, labels, q


def _pad(db, labels, world):
    pad = (-len(labels)) % world
    db_p = np.concatenate([db, np.full((pad, db.shape[1]), 1e6,
                                       np.float32)])
    return db_p, np.concatenate([labels, np.full(pad, -1, np.int32)])


# -- the ranks ----------------------------------------------------------------


def _miner_worker(rank, world):
    dp = DataParallel.current()
    out = {}
    for name, (emb, labels, max_pos) in _miner_inputs().items():
        lo, hi = dp.rows(len(labels))
        for mode in ("batch_all", "batch_hard"):
            e = torch.from_numpy(emb[lo:hi]).requires_grad_()
            lab = torch.from_numpy(labels[lo:hi])
            if mode == "batch_all":
                fn = sharded.sharded_batch_all_loss(
                    dp, margin=MARGIN, max_positives=max_pos)
            else:
                fn = sharded.sharded_batch_hard_loss(dp, margin=MARGIN)
            loss, stats = fn(e, lab)
            # each rank's share of the replicated loss
            (loss / world).backward()
            out[name, mode] = {"loss": loss.detach(), "grad": e.grad,
                               "stats": [s.detach() for s in stats]}
    db, labels, q = _knn_inputs()
    db_p, lab_p = _pad(db, labels, world)
    lo, hi = dp.rows(len(lab_p))
    pred, dists, idx = sharded_knn.sharded_knn(dp, k=K, n_classes=N_CLASSES)(
        torch.from_numpy(db_p[lo:hi]), torch.from_numpy(lab_p[lo:hi]),
        torch.from_numpy(q))
    out["knn"] = {"pred": pred, "dists": dists, "idx": idx}
    values, scales = tknn.quantize_db(torch.from_numpy(db_p))
    pred, dists, idx = sharded_knn.sharded_knn_quantized(
        dp, k=K, n_classes=N_CLASSES)(values[lo:hi], scales[lo:hi],
                                      torch.from_numpy(lab_p[lo:hi]),
                                      torch.from_numpy(q))
    out["knn_quantized"] = {"pred": pred, "dists": dists, "idx": idx}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    world = request.param
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = spawn(_miner_worker, world,
                        tmp_path_factory.mktemp(f"sharded{world}"))
    finally:
        torch.set_num_threads(n)
    return world, results


# -- references ---------------------------------------------------------------


def _jax_mesh(world):
    import jax
    from embeddingnet_tpu.parallel import build_mesh
    return build_mesh(data=world, model=1, devices=jax.devices()[:world])


@functools.lru_cache(maxsize=None)
def _jax_miner(name, mode, world):
    """(sharded (loss, stats, grad), one-device (loss, stats, grad)) of the
    JAX package (jitted: eager shard_map dispatches op by op)."""
    import jax
    import jax.numpy as jnp
    from embeddingnet_tpu.ops import mining
    from embeddingnet_tpu.parallel.sharded import (sharded_batch_all_loss,
                                                   sharded_batch_hard_loss)
    emb, labels, max_pos = _miner_inputs()[name]
    e, lab = jnp.asarray(emb), jnp.asarray(labels)
    mesh = _jax_mesh(world)
    if mode == "batch_all":
        fn = sharded_batch_all_loss(mesh, margin=MARGIN,
                                    max_positives=max_pos)
        one = lambda x: mining.batch_all_loss(  # noqa: E731
            x, lab, margin=MARGIN, max_positives=max_pos)
        (loss, stats), grad = jax.jit(jax.value_and_grad(
            lambda x: fn(x, lab), has_aux=True))(e)
        sharded_out = (float(loss), stats, np.asarray(grad))
    else:
        fn = sharded_batch_hard_loss(mesh, margin=MARGIN)
        one = lambda x: mining.batch_hard_loss(  # noqa: E731
            x, lab, margin=MARGIN)
        loss, grad = jax.jit(jax.value_and_grad(lambda x: fn(x, lab)))(e)
        sharded_out = (float(loss), None, np.asarray(grad))
    (loss1, stats1), grad1 = jax.jit(jax.value_and_grad(one,
                                                        has_aux=True))(e)
    return sharded_out, (float(loss1), stats1, np.asarray(grad1))


def _port_miner(name, mode):
    emb, labels, max_pos = _miner_inputs()[name]
    e = torch.from_numpy(emb).requires_grad_()
    lab = torch.from_numpy(labels)
    if mode == "batch_all":
        loss, stats = tmining.batch_all_loss(e, lab, margin=MARGIN,
                                             max_positives=max_pos)
    else:
        loss, stats = tmining.batch_hard_loss(e, lab, margin=MARGIN)
    loss.backward()
    return float(loss), stats, e.grad.numpy()


def _grad_close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= GRAD_TOL * scale, f"{what}: {err} > {GRAD_TOL} * {scale}"


def _stats_equal(got, want, what):
    """The integer stats exactly, the float ones to 1e-6."""
    for field, g in zip(tmining.MiningStats._fields, got):
        w = getattr(want, field)
        if field in ("n_triplets", "n_candidates"):
            assert int(g) == int(w), (what, field)
        else:
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6,
                                       err_msg=f"{what} {field}")


@pytest.mark.parametrize("mode", ["batch_all", "batch_hard"])
@pytest.mark.parametrize("name", ["pk", "dense"])
def test_sharded_miner_matches_jax_and_one_device(ranks, name, mode):
    world, results = ranks
    got_loss = float(results[0][name, mode]["loss"])
    for r in results:           # the loss and stats are every rank's
        assert float(r[name, mode]["loss"]) == got_loss
    got_grad = np.concatenate([r[name, mode]["grad"].numpy()
                               for r in results])
    (j_loss, j_stats, j_grad), (o_loss, o_stats, o_grad) = _jax_miner(
        name, mode, world)
    p_loss, p_stats, p_grad = _port_miner(name, mode)
    for label, loss, grad in (("jax sharded", j_loss, j_grad),
                              ("jax one device", o_loss, o_grad),
                              ("port one process", p_loss, p_grad)):
        np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL,
                                   err_msg=label)
        _grad_close(got_grad, grad, f"{name} {mode} vs {label}")
    _stats_equal(results[0][name, mode]["stats"], p_stats, "port")
    _stats_equal(results[0][name, mode]["stats"], o_stats, "jax")
    if j_stats is not None:
        _stats_equal(results[0][name, mode]["stats"], j_stats, "jax sharded")


def test_broken_pk_layout_poisons_as_on_one_device(ranks):
    _, results = ranks
    got = results[0]["broken_pk", "batch_all"]
    one = _port_miner("broken_pk", "batch_all")
    assert np.isnan(float(got["loss"])) and np.isnan(one[0])
    assert np.isnan(np.concatenate([r["broken_pk", "batch_all"]["grad"]
                                    .numpy() for r in results])).all()
    stats = dict(zip(tmining.MiningStats._fields, got["stats"]))
    assert int(stats["n_triplets"]) == int(stats["n_candidates"]) == -1
    for field in ("frac_mined", "mean_pos_dist", "mean_neg_dist"):
        assert np.isnan(float(stats[field]))
    # batch_hard takes any layout
    assert np.isfinite(float(results[0]["broken_pk", "batch_hard"]["loss"]))


def test_generic_label_batch_all_matches_jax():
    """``batch_all_rowblock`` on one device: unequal classes and
    singletons, against JAX's generic path and the O(B^3) oracle."""
    import jax
    import jax.numpy as jnp
    from embeddingnet_tpu.ops import mining
    emb, labels, _ = _miner_inputs()["dense"]
    (j_loss, j_stats), j_grad = jax.value_and_grad(
        lambda x: mining.batch_all_loss(x, jnp.asarray(labels),
                                        margin=MARGIN),
        has_aux=True)(jnp.asarray(emb))
    p_loss, p_stats, p_grad = _port_miner("dense", "batch_all")
    np.testing.assert_allclose(p_loss, float(j_loss), rtol=LOSS_RTOL)
    _grad_close(p_grad, np.asarray(j_grad), "generic batch_all")
    _stats_equal(p_stats, j_stats, "generic batch_all")
    e = torch.from_numpy(emb).requires_grad_()
    oracle, _ = tmining.batch_all_loss_reference(e, torch.from_numpy(labels),
                                                 margin=MARGIN)
    oracle.backward()
    np.testing.assert_allclose(p_loss, float(oracle), rtol=LOSS_RTOL)
    _grad_close(p_grad, e.grad.numpy(), "generic batch_all vs oracle")


@pytest.mark.parametrize("which", ["knn", "knn_quantized"])
def test_sharded_knn_matches_jax_and_one_device(ranks, which):
    import jax
    import jax.numpy as jnp
    from embeddingnet_tpu.parallel.sharded_knn import (sharded_knn as jknn,
                                                       sharded_knn_quantized
                                                       as jknn_quantized)
    world, results = ranks
    db, labels, q = _knn_inputs()
    got = results[0][which]
    for r in results[1:]:
        for key in ("pred", "idx", "dists"):
            assert torch.equal(r[which][key], got[key]), key
    db_p, lab_p = _pad(db, labels, world)
    mesh = _jax_mesh(world)
    if which == "knn":
        j_pred, _, j_idx = jax.jit(jknn(mesh, k=K, n_classes=N_CLASSES))(
            jnp.asarray(db_p), jnp.asarray(lab_p), jnp.asarray(q))
        pred, idx = tknn.knn_classify(torch.from_numpy(db),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(q), k=K,
                                      n_classes=N_CLASSES)
        dists, idx_n = tknn.knn_neighbors(torch.from_numpy(db),
                                          torch.from_numpy(q), k=K)
        assert torch.equal(idx_n, idx)
        torch.testing.assert_close(got["dists"], dists, rtol=1e-6,
                                   atol=1e-6)
    else:
        values, scales = tknn.quantize_db(torch.from_numpy(db_p))
        j_pred, _, j_idx = jax.jit(jknn_quantized(mesh, k=K,
                                                  n_classes=N_CLASSES))(
                jnp.asarray(values.numpy()), jnp.asarray(scales.numpy()),
                jnp.asarray(lab_p), jnp.asarray(q))
        n = len(labels)
        pred, idx = tknn.knn_classify_quantized(
            values[:n], scales[:n], torch.from_numpy(labels),
            torch.from_numpy(q), k=K, n_classes=N_CLASSES)
    # the ties: query 0 is DB rows 3, 20 and 30, in that order
    if which == "knn":
        assert got["idx"][0, :3].tolist() == [3, 20, 30]
    assert torch.equal(got["idx"], idx) and torch.equal(got["pred"], pred)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(j_pred))


# -- row blocks and the sampler -----------------------------------------------


def test_process_row_block_matches_jax_and_checks_blocks():
    import jax
    from embeddingnet_tpu.parallel.mesh import process_row_block as jblock
    mesh = _jax_mesh(8)
    assert process_row_block(64, (0, 1)) == jblock(mesh, 64) == (0, 64)
    assert [process_row_block(64, (r, 4)) for r in range(4)] == [
        (0, 16), (16, 32), (32, 48), (48, 64)]
    assert jax.process_count() == 1
    with pytest.raises(ValueError, match="non-contiguous batch rows"):
        process_row_block(64, (1, 4), spans=[(0, 8), (24, 32)])
    with pytest.raises(ValueError, match="not the equal 16-row share"):
        process_row_block(64, (1, 4), spans=[(16, 40)])
    with pytest.raises(ValueError, match="must divide by the world"):
        process_row_block(66, (0, 4))


def test_process_shard_sampler_matches_jax(tiny_dataset):
    from embeddingnet_tpu.data.samplers import PKSampler as JPKSampler
    from embeddingnet_tpu.data.samplers import \
        ProcessShardSampler as JProcessShardSampler
    from embeddingnet_tpu_torch.data import ENDataLoader
    dl = ENDataLoader(tiny_dataset, val_ratio=0.2)
    seen = []
    for lo, hi in ((0, 6), (6, 12)):
        mine = ProcessShardSampler(
            PKSampler(dl.train_data, dl.class_names, 4, 3, seed=9), lo, hi,
            global_check=lambda labels: seen.append(labels.copy()))
        theirs = JProcessShardSampler(
            JPKSampler(dl.train_data, dl.class_names, 4, 3, seed=9), lo, hi)
        for (p1, l1), (p2, l2) in zip(islice(mine, 3), islice(theirs, 3)):
            assert p1 == p2
            np.testing.assert_array_equal(l1, l2)
            assert len(p1) == hi - lo
    # the check sees the global labels, the same on every rank
    assert all(len(s) == 12 for s in seen)
    np.testing.assert_array_equal(seen[0], seen[3])
