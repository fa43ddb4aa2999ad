"""Dense-sweep optimizer unit tests: closed-form multiplicity math and
end-to-end behavior vs the sampling path."""

import numpy as np
import jax
import jax.numpy as jnp

from annembed_tpu.knn.brute import knn_graph_brute
from annembed_tpu.graph.kgraph import KGraph
from annembed_tpu.graph.proba import to_proba_edges
from annembed_tpu.optim.dense import (_attraction_sweep, _repulsion_sweep,
                                      run_dense_optimization)
from annembed_tpu.optim.ce import embedded_scales_from_initial, \
    ce_value_dense
from annembed_tpu.params import EmbedderParams


def _ref_sample(y, i, j, w, scale, gamma):
    """One reference per-sample attraction update (embedder.rs:1216-1239,
    attraction part), applied sequentially."""
    d2 = float(((y[i] - y[j]) ** 2).sum())
    d2s = d2 / scale ** 2
    coeff = 2.0 / (1.0 + d2s) / scale ** 2
    rep = 1.0 / max(d2s ** 2, 1e4)
    c = max(gamma * coeff * (-w + (1 - w) * rep), -0.49)
    if d2s <= 0:
        return y
    g = (y[j] - y[i]) * c
    y = y.copy()
    y[i] -= g
    y[j] += g
    return y


def test_attraction_closed_form_matches_sequential():
    """The pair-shared closed form reproduces the gap of truly
    sequential clipped samples (clip-active regime: exact)."""
    indices = jnp.array([[1], [0]], jnp.int32)
    w = jnp.array([[1.0], [1.0]], jnp.float32)
    emb_scale = jnp.array([0.2, 0.2], jnp.float32)
    y0 = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    gamma = 1.0
    m = 2

    # sequential oracle: alternate the two directed edges, m samples each
    y_seq = y0.copy()
    for _ in range(m):
        y_seq = _ref_sample(y_seq, 0, 1, 1.0, 0.2, gamma)
        y_seq = _ref_sample(y_seq, 1, 0, 1.0, 0.2, gamma)
    gap_seq = np.linalg.norm(y_seq[0] - y_seq[1])

    # f_min=1e-9 disables the anti-collapse closure floor so the raw
    # closed-form math can be checked against the sequential oracle
    d_self, d_rev = _attraction_sweep(
        jnp.asarray(y0), indices, w, jnp.full((2, 1), float(m)),
        w, jnp.full((2, 1), float(m)), emb_scale, jnp.float32(gamma), 1.0,
        f_min=1e-9)
    y_m = jnp.asarray(y0) + d_self
    y_m = y_m.at[indices.reshape(-1)].add(d_rev.reshape(-1, 2))
    gap_m = float(jnp.linalg.norm(y_m[0] - y_m[1]))
    # clip active throughout: gap shrinks exactly by 0.02 per sample
    np.testing.assert_allclose(np.log(gap_m), np.log(gap_seq), rtol=0.05)
    # and the closed form must be monotone (no sign flip / oscillation)
    assert gap_m > 0 and gap_m < 1e-3


def test_repulsion_moves_away():
    n, d = 16, 2
    key = jax.random.PRNGKey(0)
    y = jax.random.normal(key, (n, d))
    indices = jnp.tile(jnp.arange(4, dtype=jnp.int32)[None, :], (n, 1))
    emb_scale = jnp.full((n,), 0.2, jnp.float32)
    perm = jax.random.permutation(jax.random.PRNGKey(1), n)
    delta = _repulsion_sweep(y, y[perm], jnp.array(0), indices, emb_scale,
                             jnp.float32(1.0), 1.0, perm, 4)
    assert np.isfinite(np.asarray(delta)).all()
    # mean displacement points outward from the centroid of negatives
    y2 = y + delta
    spread0 = float(jnp.var(y))
    spread1 = float(jnp.var(y2))
    assert spread1 >= spread0 * 0.99  # repulsion never contracts


def test_dense_optimization_end_to_end(rng):
    centers = rng.normal(size=(3, 10)) * 10
    x = np.concatenate([centers[i] + rng.normal(size=(100, 10))
                        for i in range(3)]).astype(np.float32)
    labels = np.repeat(np.arange(3), 100)
    idx, dist = knn_graph_brute(x, k=8)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (300, 2)).astype(np.float32))
    params = EmbedderParams(nb_grad_batch=10, optimizer="dense")
    ce0 = float(ce_value_dense(y0, g, npar.probas, npar.scale, 1.0))
    y, info = run_dense_optimization(y0, g, npar, params)
    ce1 = float(ce_value_dense(y, g, npar.probas, npar.scale, 1.0))
    assert np.isfinite(np.asarray(y)).all()
    assert ce1 < ce0
    mus = np.stack([np.asarray(y)[labels == i].mean(0) for i in range(3)])
    d_to = np.linalg.norm(np.asarray(y)[:, None] - mus[None], axis=-1)
    acc = (d_to.argmin(1) == labels).mean()
    assert acc > 0.9, acc


def test_ce_value_dense_matches_flat(rng):
    from annembed_tpu.optim.ce import build_edge_set, ce_value
    x = rng.normal(size=(200, 6)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=5)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    es = build_edge_set(g, npar)
    y = jnp.asarray(rng.normal(size=(200, 2)).astype(np.float32))
    a = float(ce_value(y, es, b=1.0))
    b_ = float(ce_value_dense(y, g, npar.probas, npar.scale, 1.0))
    np.testing.assert_allclose(a, b_, rtol=1e-4)


def test_dense_with_class_sorted_input(rng):
    """Input rows sorted by cluster: the one-time relabeling must keep
    the rolled identity-pool negatives uniform (without it, a node's
    negatives would all be same-cluster neighbours)."""
    centers = rng.normal(size=(3, 8)) * 10
    # deliberately sorted by class
    x = np.concatenate([centers[i] + rng.normal(size=(100, 8))
                        for i in range(3)]).astype(np.float32)
    labels = np.repeat(np.arange(3), 100)
    idx, dist = knn_graph_brute(x, k=6)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (300, 2)).astype(np.float32))
    y, _ = run_dense_optimization(y0, g, npar,
                                  EmbedderParams(nb_grad_batch=10,
                                                 optimizer="dense"))
    y = np.asarray(y)
    assert np.isfinite(y).all()
    mus = np.stack([y[labels == i].mean(0) for i in range(3)])
    d_to = np.linalg.norm(y[:, None] - mus[None], axis=-1)
    acc = (d_to.argmin(1) == labels).mean()
    assert acc > 0.9, acc
    # clusters must not collapse onto each other (loose check — the
    # hard criterion is nearest-centroid accuracy above)
    inter = min(np.linalg.norm(mus[i] - mus[j])
                for i in range(3) for j in range(i + 1, 3))
    intra = max(y[labels == i].std() for i in range(3))
    assert inter > 0.5 * intra


def test_dense_b_not_one(rng):
    """b != 1 exercises the general Cauchy exponent path of
    _common_coeff (embedder.rs:1216-1222)."""
    x = rng.normal(size=(200, 6)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=5)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (200, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=5, b=0.5)
    y, _ = run_dense_optimization(y0, g, npar, p)
    assert np.isfinite(np.asarray(y)).all()
    ce0 = float(ce_value_dense(y0, g, npar.probas, npar.scale, 0.5))
    ce1 = float(ce_value_dense(y, g, npar.probas, npar.scale, 0.5))
    assert ce1 < ce0


def test_closure_floor_caps_single_sweep_collapse():
    """dense_f_min floors the per-sweep pair closure: with multiplicity
    m=4 at the clip, the raw closed form shrinks the gap by 0.02^8
    (below f32 resolution at unit coordinates — the absorbing
    pile-collapse state); with the floor, the gap after one sweep is at
    least f_min * gap."""
    indices = jnp.array([[1], [0]], jnp.int32)
    w = jnp.array([[1.0], [1.0]], jnp.float32)
    emb_scale = jnp.array([0.2, 0.2], jnp.float32)
    y0 = jnp.array([[0.0, 0.0], [1.0, 0.0]], jnp.float32)
    m = jnp.full((2, 1), 4.0)
    d_self, d_rev = _attraction_sweep(y0, indices, w, m, w, m, emb_scale,
                                      jnp.float32(1.0), 1.0, f_min=0.02)
    y1 = y0 + d_self
    y1 = y1.at[indices.reshape(-1)].add(d_rev.reshape(-1, 2))
    gap = float(jnp.linalg.norm(y1[0] - y1[1]))
    assert gap >= 0.02 * 0.999, gap


def test_mask_preserves_expected_displacement():
    """The bernoulli edge mask keeps the expected per-sweep displacement
    close to the unmasked one (linear regime) and adds variance."""
    from annembed_tpu.optim.dense import _attraction_sweep_scatter_free
    rng = np.random.default_rng(0)
    n, k, d = 64, 4, 2
    y = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    indices = jnp.asarray(
        rng.integers(0, n, size=(n, k)).astype(np.int32))
    w = jnp.asarray(rng.uniform(0.1, 0.3, (n, k)).astype(np.float32))
    m_e = jnp.full((n, k), 0.05, jnp.float32)  # small: linear regime
    m_rev = jnp.zeros((n, k), jnp.float32)
    emb_scale = jnp.full((n,), 0.2, jnp.float32)
    base = _attraction_sweep_scatter_free(
        y, indices, w, m_e, m_rev, m_rev, emb_scale,
        jnp.float32(0.05), 1.0)
    p = 0.5
    acc = jnp.zeros_like(base)
    trials = 64
    for t in range(trials):
        mask = jax.random.bernoulli(
            jax.random.PRNGKey(t), p, (n, k)).astype(jnp.float32)
        acc = acc + _attraction_sweep_scatter_free(
            y, indices, w, m_e, m_rev, m_rev, emb_scale,
            jnp.float32(0.05), 1.0, mask=mask, mask_p=p)
    mean_masked = np.asarray(acc / trials)
    np.testing.assert_allclose(mean_masked, np.asarray(base),
                               rtol=0.25, atol=5e-4)


def test_dense_masked_quality_holds(rng):
    """Masked + floored dense optimization still separates clusters."""
    n = 600
    labels = rng.integers(0, 3, n)
    centers = np.array([[0, 0, 0], [8, 0, 0], [0, 8, 0]], np.float32)
    x = centers[labels] + rng.normal(size=(n, 3)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=6)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (n, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=10, dense_f_min=0.02,
                       dense_mask_p=0.5)
    y, info = run_dense_optimization(y0, g, npar, p)
    y = np.asarray(y)
    assert np.isfinite(y).all()
    assert info["mask_p"] == 0.5
    mus = np.stack([y[labels == i].mean(0) for i in range(3)])
    d_to = np.linalg.norm(y[:, None] - mus[None], axis=-1)
    acc = (d_to.argmin(1) == labels).mean()
    assert acc > 0.9, acc


def test_hubness_importance_weights_match_weighted_draws(rng):
    """W-pin for the hubness-negative approximation.

    The reference draws negatives from an alias table with probability
    proportional to w_i = clip(in_degree, 1, n) (embedder.rs:810-837);
    the dense path keeps UNIFORM draws and multiplies each kick by the
    mean-normalized clamped weight (optim/dense.py:579-585).  Expected
    per-node kick mass is n * p_i(reference) = w_i / mean(w) =
    importance weight, so the two coincide EXACTLY wherever the
    normalized weight is inside the [0.25, 4] clamp, and the clamp
    bounds the tail deviation by w_i / (4 mean(w)).  This test builds a
    hub-heavy graph and asserts both facts numerically."""
    n, k = 512, 6
    # hub-heavy: every node lists node 0 (in-degree ~n) plus random
    # tail neighbours
    idx = rng.integers(1, n, size=(n, k)).astype(np.int32)
    idx[:, 0] = 0
    idx[1, 0] = 2  # node 0's own row must not self-reference
    g = KGraph(indices=jnp.asarray(idx),
               dists=jnp.asarray(rng.random((n, k)).astype(np.float32)))

    from annembed_tpu.optim.embedder import hubness_sampling_weights
    nw = np.asarray(hubness_sampling_weights(g))
    # reference expected kick mass per node under weighted draws,
    # relative to uniform: n * (w_i / sum w) = w_i / mean w == nw
    clamped = np.clip(nw / max(nw.mean(), 1e-30), 0.25, 4.0)

    # clamping touches only the distribution tails: the hub (above)
    # and the in-degree<=1 anti-hubs (below); the bulk is exact
    in_range = (nw >= 0.25) & (nw <= 4.0)
    assert in_range.sum() > 0.9 * n
    np.testing.assert_allclose(clamped[in_range], nw[in_range],
                               rtol=1e-6)

    # the hub IS clamped: reference mass nw[0] ~ n*k/mean_indeg >> 4;
    # our kick uses exactly the documented cap, so the deviation is
    # bounded by the clamp ratio and nowhere else
    assert nw[0] > 4.0
    assert clamped[0] == 4.0
    deviation = np.abs(clamped - nw)
    assert (deviation[~in_range] <= nw[~in_range]).all()
    assert deviation[in_range].max() < 1e-5


def test_n_sub_schedule_single_phase_is_identity(rng):
    """A one-phase schedule ((nb, s),) must reproduce the flat n_sub=s
    run BIT-exactly (same key stream, same gamma, same rotation)."""
    from annembed_tpu.optim.dense import run_dense_optimization
    x = rng.normal(size=(250, 8)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=6)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (250, 2)).astype(np.float32))
    p_flat = EmbedderParams(nb_grad_batch=8, optimizer="dense")
    p_sched = EmbedderParams(nb_grad_batch=8, optimizer="dense",
                             n_sub_schedule=((8, 24),))
    y1, i1 = run_dense_optimization(y0, g, npar, p_flat, n_sub=24)
    y2, i2 = run_dense_optimization(y0, g, npar, p_sched, n_sub=24)
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    assert i1["sweeps"] == i2["sweeps"] == 7 * 24


def test_n_sub_schedule_two_phase(rng):
    """Coarse->fine schedule: runs the global gamma decay across two
    granularities, skips the zero-gamma final batch, reports the
    executed sweep count, and still optimizes the CE objective."""
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.ce import ce_value_dense
    centers = rng.normal(size=(3, 8)) * 8
    x = np.concatenate([centers[i] + rng.normal(size=(100, 8))
                        for i in range(3)]).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=6)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (300, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=10, optimizer="dense",
                       n_sub_schedule=((5, 12), (5, 24)))
    ce0 = float(ce_value_dense(y0, g, npar.probas, npar.scale, 1.0))
    y, info = run_dense_optimization(y0, g, npar, p, n_sub=12)
    ce1 = float(ce_value_dense(y, g, npar.probas, npar.scale, 1.0))
    assert np.isfinite(np.asarray(y)).all()
    assert ce1 < ce0
    # phase A: batches 0..5 -> 5*12; phase B: batches 5..10, the last
    # global batch is zero-gamma -> 4*24
    assert info["sweeps"] == 5 * 12 + 4 * 24
    assert info["n_sub_schedule"] == ((5, 12), (5, 24))


def test_n_sub_schedule_must_sum_to_nb_grad_batch(rng):
    from annembed_tpu.optim.dense import run_dense_optimization
    import pytest
    x = rng.normal(size=(100, 6)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=5)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-1, 1, (100, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=10, n_sub_schedule=((4, 12),))
    with pytest.raises(ValueError, match="must sum"):
        run_dense_optimization(y0, g, npar, p)


def test_repulsion_block_whole_array_matches_rolled(rng):
    """_repulsion_block_T with ONE block spanning all nodes must
    reproduce _repulsion_sweep_rolledT exactly (same strided pool,
    same sequential kicks) — the wraparound dynamic-slice pool is a
    pure re-layout of the roll."""
    from annembed_tpu.optim.dense import (_repulsion_block_T,
                                          _repulsion_sweep_rolledT)
    n, d, k, n_neg = 97, 2, 5, 4
    yT = jnp.asarray(rng.normal(size=(d, n)).astype(np.float32))
    idxT = jnp.asarray(rng.integers(0, n, size=(k, n)), jnp.int32)
    scaleT = jnp.asarray(
        rng.uniform(0.1, 0.4, size=(1, n)).astype(np.float32))
    nw = jnp.asarray(rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32))
    for offset in (0, 13, 90):
        ref = _repulsion_sweep_rolledT(yT, jnp.int32(offset), idxT,
                                       scaleT, 0.7, 1.0, n_neg,
                                       neg_weight=nw)
        yT_ext = jnp.concatenate([yT, yT], axis=1)
        nw_ext = jnp.concatenate([nw, nw])
        got = _repulsion_block_T(yT_ext, yT, 0, n, jnp.int32(offset),
                                 idxT, scaleT, 0.7, 1.0, n_neg,
                                 neg_weight_ext=nw_ext) - yT
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=0, atol=0)


def test_dense_n_blocks_optimizes(rng):
    """Block sub-sweeps (the large-n gather-volume lever): CE must
    improve comparably to the flat path at the same sweep budget, stay
    finite, and report n_blocks."""
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.ce import ce_value_dense
    centers = rng.normal(size=(3, 8)) * 8
    x = np.concatenate([centers[i] + rng.normal(size=(110, 8))
                        for i in range(3)]).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=6)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (330, 2)).astype(np.float32))
    ce0 = float(ce_value_dense(y0, g, npar.probas, npar.scale, 1.0))
    p_flat = EmbedderParams(nb_grad_batch=10, optimizer="dense")
    y_flat, _ = run_dense_optimization(y0, g, npar, p_flat, n_sub=24)
    ce_flat = float(ce_value_dense(y_flat, g, npar.probas, npar.scale,
                                   1.0))
    p_blk = EmbedderParams(nb_grad_batch=10, optimizer="dense",
                           dense_n_blocks=4)
    y_blk, info = run_dense_optimization(y0, g, npar, p_blk, n_sub=24)
    ce_blk = float(ce_value_dense(y_blk, g, npar.probas, npar.scale,
                                  1.0))
    assert np.isfinite(np.asarray(y_blk)).all()
    assert info["n_blocks"] == 4
    assert ce_blk < ce0
    # same objective, same budget: the block path must land in the
    # same CE basin as the flat path (loose band, different dynamics)
    assert ce_blk < ce_flat + 0.25 * (ce0 - ce_flat)


def test_dense_n_blocks_divisibility_error(rng):
    from annembed_tpu.optim.dense import run_dense_optimization
    import pytest
    x = rng.normal(size=(100, 6)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=5)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-1, 1, (100, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=6, dense_n_blocks=5)
    with pytest.raises(ValueError, match="divisible"):
        run_dense_optimization(y0, g, npar, p, n_sub=24)


def test_packed_gather_bit_identical(rng):
    """dense_packed_gather reroutes the neighbour gather through a
    complex64 lane pack — it must be BIT-identical to the pair gather
    (complex64 stores the two f32 coordinates exactly), flat and
    blocked, scheduled or not."""
    from annembed_tpu.optim.dense import run_dense_optimization
    x = rng.normal(size=(300, 8)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=6)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (300, 2)).astype(np.float32))
    for extra in ({}, {"dense_n_blocks": 2},
                  {"n_sub_schedule": ((4, 24), (4, 48))}):
        p0 = EmbedderParams(nb_grad_batch=8, optimizer="dense", **extra)
        p1 = EmbedderParams(nb_grad_batch=8, optimizer="dense",
                            dense_packed_gather=True, **extra)
        y_a, _ = run_dense_optimization(y0, g, npar, p0, n_sub=24)
        y_b, _ = run_dense_optimization(y0, g, npar, p1, n_sub=24)
        np.testing.assert_array_equal(np.asarray(y_a), np.asarray(y_b),
                                      err_msg=str(extra))


def test_multi_segment_schedule_and_blocks(rng, monkeypatch):
    """At 11M the per-program sweep cap splits every phase into many
    segments (cap ~ 12 sweeps); exercise that path on small data by
    shrinking the cap: scheduled (use_rot0) and blocked runs must stay
    finite and optimize across segment boundaries, including segments
    that start mid-batch and at non-zero rotation."""
    import annembed_tpu.optim.dense as dense_mod
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.ce import ce_value_dense
    monkeypatch.setattr(dense_mod, "_MAX_SWEEPS_PER_PROGRAM", 7)
    monkeypatch.setattr(dense_mod, "_SWEEP_REFERENCE_N", 1)

    centers = rng.normal(size=(3, 8)) * 8
    x = np.concatenate([centers[i] + rng.normal(size=(90, 8))
                        for i in range(3)]).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=6)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (270, 2)).astype(np.float32))
    ce0 = float(ce_value_dense(y0, g, npar.probas, npar.scale, 1.0))
    for extra in ({"n_sub_schedule": ((5, 12), (5, 24))},
                  {"dense_n_blocks": 2},
                  {"n_sub_schedule": ((5, 12), (5, 24)),
                   "dense_n_blocks": 2}):
        p = EmbedderParams(nb_grad_batch=10, optimizer="dense", **extra)
        y, info = run_dense_optimization(y0, g, npar, p, n_sub=12)
        ce1 = float(ce_value_dense(y, g, npar.probas, npar.scale, 1.0))
        assert np.isfinite(np.asarray(y)).all(), extra
        assert ce1 < ce0, (extra, ce0, ce1)


def test_neighbor_exclusion_off_runs(rng):
    """dense_neighbor_exclusion=False (wall lever, O(k/n) semantics
    deviation) runs the flat and block paths and stays finite; with
    exclusion ON the result matches the default path bit-for-bit."""
    import jax.numpy as jnp
    from annembed_tpu.knn.brute import knn_graph_brute
    from annembed_tpu.graph.kgraph import KGraph
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.params import EmbedderParams
    x = rng.normal(size=(240, 8)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (240, 2)).astype(np.float32))
    p_on = EmbedderParams(nb_grad_batch=3)
    p_off = EmbedderParams(nb_grad_batch=3,
                           dense_neighbor_exclusion=False)
    y_on, _ = run_dense_optimization(y0, g, npar, p_on, n_sub=6)
    y_off, _ = run_dense_optimization(y0, g, npar, p_off, n_sub=6)
    assert np.isfinite(np.asarray(y_off)).all()
    # the rolled pool rarely hits a neighbour at n=240, but the two
    # runs share every random draw, so equality would only hold if no
    # kick ever hit a neighbour; just require both to be sane
    assert np.abs(np.asarray(y_off) - np.asarray(y_on)).max() < 10.0
    p_blk = EmbedderParams(nb_grad_batch=3, dense_n_blocks=2,
                           dense_neighbor_exclusion=False)
    y_blk, _ = run_dense_optimization(y0, g, npar, p_blk, n_sub=8)
    assert np.isfinite(np.asarray(y_blk)).all()


def test_neighbor_rejection_mask_equivalence(rng):
    """The vectorized rejection mask equals a scalar python oracle
    ("is (pos_i + shift_t) mod n one of i's neighbours?") bit-for-bit
    across random shapes/offsets — embedder.rs:1246-1252 semantics."""
    import jax.numpy as jnp
    from annembed_tpu.optim.dense import _neighbor_rejection
    for trial in range(8):
        n = int(rng.integers(40, 200))
        nb = int(rng.integers(8, n + 1))
        lo = int(rng.integers(0, n - nb + 1))
        k = int(rng.integers(2, 8))
        n_neg = (int(rng.integers(8, 16)) if trial % 2 == 0
                 else int(rng.integers(1, 8)))
        stride = max(1, n // n_neg)
        offset = int(rng.integers(0, n))
        idx_np = rng.integers(0, n, size=(k, nb)).astype(np.int32)
        idxT = jnp.asarray(idx_np)
        pos = lo + jnp.arange(nb, dtype=jnp.int32)
        shifts = (offset + stride * jnp.arange(n_neg, dtype=jnp.int32)) % n
        oracle = np.zeros((n_neg, nb), bool)
        for t in range(n_neg):
            s = int(np.asarray(shifts)[t])
            for i in range(nb):
                partner = (lo + i + s) % n
                oracle[t, i] = partner in idx_np[:, i]
        fast = _neighbor_rejection(pos, idxT, shifts, n, n_neg)
        np.testing.assert_array_equal(np.asarray(fast), oracle,
                                      err_msg=str((n, nb, lo, k, n_neg,
                                                   offset)))


def test_parallel_kicks_n_neg1_bit_exact(rng):
    """With a single kick the stacked (parallel) formulation and the
    sequential chain are the SAME formula — bit-exact anchor."""
    from annembed_tpu.optim.dense import _repulsion_sweep_rolledT
    n, d, k = 97, 2, 5
    yT = jnp.asarray(rng.normal(size=(d, n)).astype(np.float32))
    idxT = jnp.asarray(rng.integers(0, n, size=(k, n)), jnp.int32)
    scaleT = jnp.asarray(
        rng.uniform(0.1, 0.4, size=(1, n)).astype(np.float32))
    nw = jnp.asarray(rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32))
    for offset in (0, 13, 90):
        seq = _repulsion_sweep_rolledT(yT, jnp.int32(offset), idxT,
                                       scaleT, 0.7, 1.0, 1,
                                       neg_weight=nw)
        par = _repulsion_sweep_rolledT(yT, jnp.int32(offset), idxT,
                                       scaleT, 0.7, 1.0, 1,
                                       neg_weight=nw,
                                       parallel_kicks=True)
        np.testing.assert_allclose(np.asarray(par), np.asarray(seq),
                                   rtol=0, atol=0)


def test_parallel_kicks_matches_numpy_oracle(rng):
    """The stacked kick program equals an explicit numpy evaluation of
    the parallel formula: every kick's coeff from the pre-repulsion
    snapshot, deltas summed, same caps/masks/partners as sequential."""
    from annembed_tpu.optim.dense import _repulsion_sweep_rolledT
    n, d, k, n_neg = 61, 3, 4, 5
    y = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    scale = rng.uniform(0.1, 0.4, size=(n,)).astype(np.float32)
    nw = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    gamma, b, offset = 0.7, 1.0, 17
    stride = max(1, n // n_neg)
    delta = np.zeros_like(y)
    for i in range(n):
        for t in range(n_neg):
            p = (i + offset + t * stride) % n
            if p == i or p in idx[i]:
                continue
            d2s = float(((y[i] - y[p]) ** 2).sum()) / scale[i] ** 2
            if d2s <= 0.0:
                continue
            coeff = 2.0 / (1.0 + d2s) / scale[i] ** 2
            rep = 1.0 / max(d2s ** 2, 1.0 / 16.0)
            c = min(gamma * coeff * rep, 2.0) * nw[p]
            delta[i] += (y[i] - y[p]) * c
    got = _repulsion_sweep_rolledT(
        jnp.asarray(y.T), jnp.int32(offset),
        jnp.asarray(idx.T), jnp.asarray(scale[None, :]),
        gamma, b, n_neg, neg_weight=jnp.asarray(nw),
        parallel_kicks=True)
    np.testing.assert_allclose(np.asarray(got).T, delta,
                               rtol=2e-5, atol=2e-6)


def test_parallel_kicks_end_to_end(rng):
    """dense_parallel_kicks=True runs the full optimizer (flat + block
    paths), stays finite, improves CE, and reports the flag."""
    x = rng.normal(size=(240, 8)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (240, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=4, dense_parallel_kicks=True)
    y, info = run_dense_optimization(y0, g, npar, p, n_sub=6)
    assert np.isfinite(np.asarray(y)).all()
    assert info["parallel_kicks"] == 1
    ce0 = float(ce_value_dense(y0, g, npar.probas, npar.scale, 1.0))
    ce1 = float(ce_value_dense(y, g, npar.probas, npar.scale, 1.0))
    assert ce1 < ce0
    p_blk = EmbedderParams(nb_grad_batch=4, dense_n_blocks=2,
                           dense_parallel_kicks=True)
    y_blk, _ = run_dense_optimization(y0, g, npar, p_blk, n_sub=8)
    assert np.isfinite(np.asarray(y_blk)).all()


def test_gather_reuse_repulsion_only_bit_identical(rng, monkeypatch):
    """With all edge probas zeroed the attraction sweep is a provable
    no-op (alpha == 0 -> F == 1 -> net displacement 0), so the run
    reduces to the repulsion stream — which the stale-gather path must
    reproduce BIT-identically (same per-step key consumption, gamma
    schedule and step indexing as the S=1 scan body).  Run with a tiny
    per-program cap so the S-aligned segmentation + final remainder
    block are exercised too."""
    import dataclasses as _dc
    import annembed_tpu.optim.dense as dense_mod
    monkeypatch.setattr(dense_mod, "_MAX_SWEEPS_PER_PROGRAM", 7)
    monkeypatch.setattr(dense_mod, "_SWEEP_REFERENCE_N", 1)
    x = rng.normal(size=(260, 6)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=6)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    npar0 = _dc.replace(npar, probas=jnp.zeros_like(npar.probas))
    y0 = jnp.asarray(rng.uniform(-5, 5, (260, 2)).astype(np.float32))
    for extra in ({}, {"n_sub_schedule": ((5, 12), (5, 24))}):
        p1 = EmbedderParams(nb_grad_batch=10, optimizer="dense", **extra)
        p4 = EmbedderParams(nb_grad_batch=10, optimizer="dense",
                            dense_gather_reuse=4, **extra)
        y_a, _ = run_dense_optimization(y0, g, npar0, p1, n_sub=12)
        y_b, info = run_dense_optimization(y0, g, npar0, p4, n_sub=12)
        np.testing.assert_array_equal(np.asarray(y_a), np.asarray(y_b),
                                      err_msg=str(extra))
        assert info["gather_reuse"] == 4


def test_gather_reuse_optimizes(rng):
    """gather_reuse=3 (stale neighbour positions, <= 2 sweeps old) must
    still optimize the 3-cluster fixture to a clean separation: finite
    coordinates, CE strictly down, >90% nearest-centroid accuracy."""
    centers = rng.normal(size=(3, 10)) * 10
    x = np.concatenate([centers[i] + rng.normal(size=(100, 10))
                        for i in range(3)]).astype(np.float32)
    labels = np.repeat(np.arange(3), 100)
    idx, dist = knn_graph_brute(x, k=8)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (300, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=10, optimizer="dense",
                       dense_gather_reuse=3)
    ce0 = float(ce_value_dense(y0, g, npar.probas, npar.scale, 1.0))
    y, info = run_dense_optimization(y0, g, npar, p)
    ce1 = float(ce_value_dense(y, g, npar.probas, npar.scale, 1.0))
    assert np.isfinite(np.asarray(y)).all()
    assert ce1 < ce0
    assert info["gather_reuse"] == 3
    mus = np.stack([np.asarray(y)[labels == i].mean(0) for i in range(3)])
    d_to = np.linalg.norm(np.asarray(y)[:, None] - mus[None], axis=-1)
    acc = (d_to.argmin(1) == labels).mean()
    assert acc > 0.9, acc


def test_gather_reuse_rejects_blocks(rng):
    """gather_reuse amortizes the full-array gather; the node-block
    path has its own (block-sized) gather economics — combining them
    is an error, not a silent fallback."""
    import pytest
    x = rng.normal(size=(120, 6)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (120, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=4, dense_n_blocks=2,
                       dense_gather_reuse=2)
    with pytest.raises(ValueError, match="gather_reuse"):
        run_dense_optimization(y0, g, npar, p, n_sub=8)
