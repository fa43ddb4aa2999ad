"""IVF approximate kNN: recall against the exact graph.

The north-star for graph construction is matching HNSW recall
(BASELINE.json); here we assert the IVF local join reaches high
recall@k on both clustered and uniform synthetic data.
"""

import numpy as np
import pytest

from annembed_tpu.knn.brute import knn_graph_brute
from annembed_tpu.knn.ivf import knn_graph_ivf
from annembed_tpu.knn.api import recall_at_k
from annembed_tpu.knn.kmeans import kmeans_fit


def test_kmeans_reduces_inertia(rng):
    x = rng.normal(size=(2000, 8)).astype(np.float32)
    cents, cells = kmeans_fit(x, 16, n_iter=10)
    cents, cells = np.asarray(cents), np.asarray(cells)
    inertia = ((x - cents[cells]) ** 2).sum()
    # one random centroid would give roughly n * d variance
    assert inertia < 0.9 * x.var() * x.size


@pytest.mark.slow
def test_ivf_recall_clustered(rng):
    centers = rng.normal(size=(20, 10)) * 10
    x = (centers[rng.integers(0, 20, 4000)]
         + rng.normal(size=(4000, 10))).astype(np.float32)
    exact_idx, _ = knn_graph_brute(x, k=10)
    ivf_idx, ivf_dist = knn_graph_ivf(x, k=10, nlist=32, nprobe=8)
    rec = recall_at_k(ivf_idx, exact_idx)
    assert rec > 0.95, f"recall {rec}"
    d = np.asarray(ivf_dist)
    assert (np.diff(d, axis=1) >= -1e-6).all()


@pytest.mark.slow
def test_ivf_recall_uniform(rng):
    x = rng.random(size=(3000, 6)).astype(np.float32)
    exact_idx, _ = knn_graph_brute(x, k=8)
    ivf_idx, _ = knn_graph_ivf(x, k=8, nlist=24, nprobe=10)
    rec = recall_at_k(ivf_idx, exact_idx)
    assert rec > 0.9, f"recall {rec}"


@pytest.mark.slow
def test_ivf_no_self_edges(rng):
    x = rng.normal(size=(1500, 5)).astype(np.float32)
    idx, _ = knn_graph_ivf(x, k=6, nlist=16, nprobe=6)
    rows = np.arange(1500)[:, None]
    assert not (np.asarray(idx) == rows).any()


@pytest.mark.slow
def test_ivf_plus_nndescent_via_api(rng):
    from annembed_tpu.params import KnnParams
    from annembed_tpu.knn.api import build_kgraph
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    exact_idx, _ = knn_graph_brute(x, k=8)
    kp = KnnParams(knbn=8, brute_force_limit=1000, nlist=24, nprobe=8,
                   refine_rounds=2)
    g = build_kgraph(x, 8, params=kp)
    rec = recall_at_k(g.indices, exact_idx)
    # lower-probe IVF alone misses neighbours; nn-descent repairs
    kp0 = KnnParams(knbn=8, brute_force_limit=1000, nlist=24, nprobe=8,
                    refine_rounds=0)
    g0 = build_kgraph(x, 8, params=kp0)
    rec0 = recall_at_k(g0.indices, exact_idx)
    assert rec > rec0
    assert rec > 0.95, (rec0, rec)


def test_ivf_tables_virtual_split(rng):
    """Oversized cells split into virtual query rows: every point is
    processed even with a bounded capacity."""
    from annembed_tpu.knn.ivf import build_ivf_tables
    # one monster cell + small cells
    cells = np.concatenate([np.zeros(500, np.int64),
                            rng.integers(1, 8, 100)]).astype(np.int64)
    vt, vp, ct = build_ivf_tables(cells, 8, 600, cap=64)
    # all 600 points appear exactly once in the virtual table
    members = vt[vt < 600]
    assert len(members) == 600
    assert len(np.unique(members)) == 600
    # the monster cell spans ceil(500/64) = 8 virtual rows of parent 0
    assert (vp == 0).sum() == 8
    # candidate table capped at 64
    assert ct.shape == (8, 64)


def test_ivf_tables_device_impl_invariants(rng):
    """The production device-side table builder (_ivf_tables_impl,
    static shapes + decoupled qcap) must satisfy the build_ivf_tables
    invariants across unbalanced cell distributions: every point placed
    exactly once, correct virt_parent, capped candidate tables, and a
    correct used-row count (the trailing rows are all-pad)."""
    import jax.numpy as jnp
    from annembed_tpu.knn.ivf import _ivf_tables_impl

    for dist_kind in ("monster", "uniform", "empty_cells"):
        if dist_kind == "monster":
            cells = np.concatenate([np.zeros(700, np.int32),
                                    rng.integers(1, 12, 150)])
        elif dist_kind == "uniform":
            cells = rng.integers(0, 12, 850)
        else:  # some cells empty
            cells = rng.choice([0, 3, 7], size=850)
        cells = cells.astype(np.int32)
        n, nlist, cap, qcap = len(cells), 12, 96, 64
        v_static = nlist + n // qcap
        vt, vp, ct, v_used = _ivf_tables_impl(
            jnp.asarray(cells), nlist, cap, qcap, v_static)
        vt, vp, ct = np.asarray(vt), np.asarray(vp), np.asarray(ct)
        v_used = int(v_used)

        # every point appears exactly once in the virtual query table
        members = vt[vt < n]
        assert len(members) == n
        assert len(np.unique(members)) == n
        # each virtual row's members all belong to its parent cell
        for r in range(v_static):
            ms = vt[r][vt[r] < n]
            if len(ms):
                assert (cells[ms] == vp[r]).all(), (dist_kind, r)
        # candidate table: capped, and members belong to the right cell
        assert ct.shape == (nlist, cap)
        counts = np.bincount(cells, minlength=nlist)
        for c in range(nlist):
            cm = ct[c][ct[c] < n]
            assert len(cm) == min(counts[c], cap)
            assert (cells[cm] == c).all()
        # used-row count: rows < v_used hold all real members, rows
        # beyond are pure padding
        expected_rows = np.maximum(1, -(-counts // qcap)).sum()
        assert v_used == expected_rows
        assert (vt[v_used:] == n).all()
        assert (vt[:v_used, 0] < n).sum() >= (counts > 0).sum()

        # parity with the host-side builder on the same qcap==cap case
        from annembed_tpu.knn.ivf import build_ivf_tables
        vt2, vp2, ct2 = build_ivf_tables(cells.astype(np.int64), nlist,
                                         n, cap=qcap)
        m2 = vt2[vt2 < n]
        assert sorted(m2.tolist()) == sorted(members.tolist())


@pytest.mark.slow
def test_ivf_unbalanced_lowdim(rng):
    """2-D clustered data (the embedded-space quality case that
    overflowed memory before virtual splitting)."""
    centers = rng.normal(size=(3, 2)) * 20
    sizes = [2500, 300, 200]
    x = np.concatenate([centers[i] + rng.normal(size=(s, 2))
                        for i, s in enumerate(sizes)]).astype(np.float32)
    idx, dist = knn_graph_ivf(x, k=10, nlist=24, nprobe=8)
    rows = np.arange(3000)[:, None]
    assert not (np.asarray(idx) == rows).any()
    exact_idx, _ = knn_graph_brute(x, k=10)
    rec = recall_at_k(idx, exact_idx)
    assert rec > 0.8, rec


@pytest.mark.slow
def test_ivf_all_metrics_recall(rng):
    """IVF + metric-aware NN-descent serves all five reference metrics
    (bin/embed.rs:546-565); recall vs the exact brute graph in the SAME
    metric must be high on clustered data."""
    from annembed_tpu.knn.ivf import knn_graph_ivf
    from annembed_tpu.knn.nndescent import nndescent_refine
    from annembed_tpu.knn.brute import knn_graph_brute
    from annembed_tpu.knn.api import recall_at_k
    n, k = 1500, 6
    centers = rng.normal(size=(12, 10)) * 3
    x = (centers[rng.integers(0, 12, n)]
         + 0.4 * rng.normal(size=(n, 10))).astype(np.float32)
    x_prob = np.abs(x) + 0.05
    x_prob /= x_prob.sum(1, keepdims=True)
    for metric in ("DistL2", "DistCosine", "DistL1", "DistJeffreys",
                   "DistJensenShannon"):
        data = x_prob if metric in ("DistJeffreys",
                                    "DistJensenShannon") else x
        ei, _ = knn_graph_brute(data, k, distance=metric)
        ai, ad = knn_graph_ivf(data, k, distance=metric, nprobe=8,
                               nlist=32)
        ai, ad = nndescent_refine(data, ai, ad, n_rounds=2,
                                  distance=metric)
        r = recall_at_k(ai, ei)
        assert r > 0.9, (metric, r)
        assert np.all(np.asarray(ad) >= 0)


def test_ivf_underfilled_rows_are_valid(rng):
    """Probed cells holding < k candidates must not leak the pad id n
    or inf distances into the returned graph (fix-up duplicates the
    last valid neighbour, keeping rows ascending)."""
    x = rng.normal(size=(300, 4)).astype(np.float32) * 50
    idx, dist = knn_graph_ivf(x, k=10, nlist=64, nprobe=2)
    idx, dist = np.asarray(idx), np.asarray(dist)
    assert idx.max() < 300 and idx.min() >= 0
    assert np.isfinite(dist).all()
    assert (np.diff(dist, axis=1) >= 0).all()
    _ = x[idx]          # numpy consumer must not raise


def test_grid_quantizer_2d(rng):
    """Strip-balanced grid IVF on a 2-D cloud: high recall, no
    duplicate ids, no underfilled rows (every cell holds ~n/g^2
    points by construction)."""
    from annembed_tpu.knn.ivf import knn_graph_ivf
    from annembed_tpu.knn.brute import knn_graph_brute
    from annembed_tpu.knn.api import recall_at_k
    centers = rng.normal(0, 5, (8, 2))
    y = (centers[rng.integers(0, 8, 12000)]
         + rng.normal(0, 0.8, (12000, 2))).astype(np.float32)
    ei, _ = knn_graph_brute(y, 10)
    gi, gd = knn_graph_ivf(y, 10, quantizer="grid")
    gi_np = np.asarray(gi)
    assert recall_at_k(gi, np.asarray(ei)) > 0.97
    assert all(len(set(r.tolist())) == 10 for r in gi_np)
    assert np.isfinite(np.asarray(gd)).all()
    # d != 2 rejected
    import pytest as _pytest
    x3 = rng.normal(size=(500, 3)).astype(np.float32)
    with _pytest.raises(ValueError, match="d == 2"):
        knn_graph_ivf(x3, 5, quantizer="grid")


def test_quality_uses_grid_on_2d_embedding(rng):
    """quality_estimate's full-fraction embedded rebuild takes the grid
    path on a 2-D cloud (forced via a tiny brute_force_limit) and
    produces sane conservation numbers."""
    from annembed_tpu.estimators.quality import quality_estimate
    from annembed_tpu.graph.kgraph import KGraph
    from annembed_tpu.knn.brute import knn_graph_brute
    from annembed_tpu.params import KnnParams
    x = rng.normal(size=(3000, 10)).astype(np.float32)
    idx, dist = knn_graph_brute(x, 6)
    g = KGraph(indices=idx, dists=dist)
    y = x[:, :2]  # fake 'embedding' correlated with the data
    kp = KnnParams(knbn=6, brute_force_limit=1000, refine_rounds=3)
    q = quality_estimate(g, y, nbng=10, knn_params=kp)
    assert q.nb_sampled == 3000
    # a 2-of-10-dim projection conserves some neighbours, not many
    assert q.mean_nb_matched > 0.5
    assert np.isfinite(q.median_ratio)


def test_multi_slab_join_parity(rng, monkeypatch):
    """The bounded-slab dispatch must agree with a single-slab run:
    shrink the slab budget so the join takes many slabs (the 11M path
    always does; tests otherwise only ever exercise one slab)."""
    from annembed_tpu.knn.ivf import knn_graph_ivf
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    i1, d1 = knn_graph_ivf(x, 6, nprobe=8)
    monkeypatch.setenv("ANNEMBED_IVF_SLAB_CANDROWS", "2000")
    i2, d2 = knn_graph_ivf(x, 6, nprobe=8)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-6)


def test_sorted_layout_bit_parity_kmeans(rng):
    """layout="sorted" (contiguous-slice join) must be BIT-identical to
    layout="gathered" (id-table join): same stable cell order, same
    candidate columns, same panel values, same top-k/rerank ties."""
    centers = rng.normal(size=(12, 7)) * 8
    x = (centers[rng.integers(0, 12, 3000)]
         + rng.normal(size=(3000, 7))).astype(np.float32)
    ig, dg = knn_graph_ivf(x, k=9, nlist=25, nprobe=6, layout="gathered")
    is_, ds = knn_graph_ivf(x, k=9, nlist=25, nprobe=6, layout="sorted")
    np.testing.assert_array_equal(np.asarray(ig), np.asarray(is_))
    np.testing.assert_array_equal(np.asarray(dg), np.asarray(ds))


def test_sorted_layout_bit_parity_overflow_and_metrics(rng):
    """Parity must survive cells overflowing cap/qcap (virtual-row
    splits + candidate truncation) and non-L2 panels (no rerank)."""
    # one giant cluster -> its cell overflows any reasonable cap
    x = np.concatenate([
        rng.normal(size=(2500, 5)) * 0.05,
        rng.normal(size=(500, 5)) + 6.0]).astype(np.float32)
    for distance in ("DistL2", "DistCosine"):
        ig, dg = knn_graph_ivf(np.abs(x) if distance != "DistL2" else x,
                               k=5, nlist=9, nprobe=4,
                               distance=distance, layout="gathered")
        is_, ds = knn_graph_ivf(np.abs(x) if distance != "DistL2" else x,
                                k=5, nlist=9, nprobe=4,
                                distance=distance, layout="sorted")
        np.testing.assert_array_equal(np.asarray(ig), np.asarray(is_))
        np.testing.assert_array_equal(np.asarray(dg), np.asarray(ds))


def test_sorted_layout_bit_parity_grid(rng):
    """Grid quantizer (sentinel probe ids, pad candidate cell) through
    the sorted layout."""
    x = rng.normal(size=(4000, 2)).astype(np.float32)
    ig, dg = knn_graph_ivf(x, k=6, quantizer="grid", layout="gathered")
    is_, ds = knn_graph_ivf(x, k=6, quantizer="grid", layout="sorted")
    np.testing.assert_array_equal(np.asarray(ig), np.asarray(is_))
    np.testing.assert_array_equal(np.asarray(dg), np.asarray(ds))


def test_sorted_layout_multi_slab_parity(rng, monkeypatch):
    """Sorted-layout slab loop: a tiny slab budget (many slabs, padded
    tail) must reproduce the single-slab result exactly."""
    x = rng.normal(size=(2000, 6)).astype(np.float32)
    i1, d1 = knn_graph_ivf(x, k=7, nlist=16, nprobe=5, layout="sorted")
    monkeypatch.setenv("ANNEMBED_IVF_SLAB_CANDROWS", "40000")
    i2, d2 = knn_graph_ivf(x, k=7, nlist=16, nprobe=5, layout="sorted")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


@pytest.mark.parametrize("n", [2048, 3001])
def test_cluster_sums_match_numpy(rng, n):
    """The k-means update's fixed-order sums equal a plain numpy
    accumulation, also when n is not a multiple of the block."""
    from annembed_tpu.knn.kmeans import cluster_sums
    x = rng.normal(size=(n, 5)).astype(np.float32)
    cells = rng.integers(0, 37, n).astype(np.int32)
    cells[:3] = 36                       # a busy last cluster
    sums, counts = cluster_sums(x, cells, 40, block_rows=1024)
    ref_s = np.zeros((40, 5))
    np.add.at(ref_s, cells, x.astype(np.float64))
    np.testing.assert_allclose(np.asarray(sums), ref_s, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(counts),
                                  np.bincount(cells, minlength=40))
