"""Multi-device tests on the virtual 8-device CPU mesh: sharded kNN
matches single-device, sharded CE step preserves finiteness and moves
points, and the full dryrun compiles + executes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from annembed_tpu.knn.brute import knn_graph_brute
from annembed_tpu.graph.kgraph import KGraph
from annembed_tpu.graph.proba import to_proba_edges
from annembed_tpu.optim.ce import build_edge_set
from annembed_tpu.parallel.sharded import (make_mesh, sharded_knn_graph,
                                           make_sharded_train_step,
                                           shard_edge_set)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    return make_mesh(8)


def test_sharded_knn_matches_single(rng, mesh):
    x = jnp.asarray(rng.normal(size=(300, 12)).astype(np.float32))
    idx_s, dist_s = sharded_knn_graph(x, 6, mesh, block_rows=64)
    idx_1, dist_1 = knn_graph_brute(x, 6, block_rows=64)
    # compare distances (the sharded path skips exact reranking, so
    # allow panel-precision tolerance and compare sets via distances)
    np.testing.assert_allclose(np.asarray(dist_s), np.asarray(dist_1),
                               atol=5e-3)
    agree = (np.asarray(idx_s) == np.asarray(idx_1)).mean()
    assert agree > 0.97


def test_sharded_brute_exact_parity(rng, mesh):
    """The sharded brute build (panel + top-k + exact rerank) must equal
    the single-chip graph EXACTLY — same math, rows partitioned."""
    from annembed_tpu.parallel.sharded_knn import sharded_knn_graph_brute
    x = jnp.asarray(rng.normal(size=(300, 12)).astype(np.float32))
    idx_s, dist_s = sharded_knn_graph_brute(x, 6, mesh, block_rows=64)
    idx_1, dist_1 = knn_graph_brute(x, 6, block_rows=64)
    np.testing.assert_array_equal(np.asarray(idx_s), np.asarray(idx_1))
    np.testing.assert_allclose(np.asarray(dist_s), np.asarray(dist_1),
                               atol=1e-6)


def test_sharded_brute_non_l2(rng, mesh):
    from annembed_tpu.parallel.sharded_knn import sharded_knn_graph_brute
    x = np.abs(rng.normal(size=(200, 10)).astype(np.float32)) + 0.05
    x /= x.sum(1, keepdims=True)
    for metric in ("DistCosine", "DistL1", "DistJensenShannon"):
        idx_s, dist_s = sharded_knn_graph_brute(jnp.asarray(x), 5, mesh,
                                                distance=metric,
                                                block_rows=32)
        idx_1, dist_1 = knn_graph_brute(x, 5, distance=metric,
                                        block_rows=32)
        agree = (np.asarray(idx_s) == np.asarray(idx_1)).mean()
        assert agree > 0.99, (metric, agree)
        np.testing.assert_allclose(np.asarray(dist_s),
                                   np.asarray(dist_1), atol=1e-5)


@pytest.mark.slow
def test_sharded_ivf_join_parity(rng, mesh):
    """Sharded IVF local join == single-chip IVF graph (same quantizer
    seeds; only the join rows are distributed)."""
    from annembed_tpu.knn.ivf import knn_graph_ivf
    from annembed_tpu.parallel.sharded_knn import sharded_knn_graph_ivf
    centers = rng.normal(size=(10, 8)) * 4
    x = (centers[rng.integers(0, 10, 2000)]
         + 0.5 * rng.normal(size=(2000, 8))).astype(np.float32)
    i1, d1 = knn_graph_ivf(x, 6, nlist=24, nprobe=6)
    i2, d2 = sharded_knn_graph_ivf(x, 6, mesh, nlist=24, nprobe=6)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d1), atol=1e-6)
    # cross-layout: the sharded SORTED join must also equal the
    # single-chip GATHERED (id-table) graph bit-for-bit
    i3, d3 = knn_graph_ivf(x, 6, nlist=24, nprobe=6, layout="gathered")
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i3))
    np.testing.assert_array_equal(np.asarray(d2), np.asarray(d3))
    # and the sharded gathered layout stays available and identical
    i4, d4 = sharded_knn_graph_ivf(x, 6, mesh, nlist=24, nprobe=6,
                                   layout="gathered")
    np.testing.assert_array_equal(np.asarray(i4), np.asarray(i1))


@pytest.mark.slow
def test_sharded_nndescent_parity(rng, mesh):
    """Sharded NN-descent rounds == single-chip rounds (same sampling
    seeds), including rho-sampling and bf16 scoring + exact rerank."""
    from annembed_tpu.knn.ivf import knn_graph_ivf
    from annembed_tpu.knn.nndescent import nndescent_refine
    from annembed_tpu.parallel.sharded_knn import sharded_nndescent_refine
    centers = rng.normal(size=(8, 8)) * 4
    x = (centers[rng.integers(0, 8, 1500)]
         + 0.5 * rng.normal(size=(1500, 8))).astype(np.float32)
    ai, ad = knn_graph_ivf(x, 6, nlist=20, nprobe=5)
    for kwargs in ({"n_rounds": 2},
                   {"n_rounds": 2, "rho": 0.5},
                   {"n_rounds": 1, "dtype": "bfloat16"}):
        i1, d1 = nndescent_refine(x, ai, ad, **kwargs)
        i2, d2 = sharded_nndescent_refine(x, ai, ad, mesh, **kwargs)
        np.testing.assert_array_equal(np.asarray(i2), np.asarray(i1))
        np.testing.assert_allclose(np.asarray(d2), np.asarray(d1),
                                   atol=1e-6)


@pytest.mark.slow
def test_sharded_build_kgraph_dispatch(rng, mesh):
    """The sharded dispatcher (brute/IVF + refine) == single-chip
    build_kgraph on both sides of the brute_force_limit."""
    from annembed_tpu.knn.api import build_kgraph
    from annembed_tpu.params import KnnParams
    from annembed_tpu.parallel.sharded_knn import sharded_build_kgraph
    centers = rng.normal(size=(8, 8)) * 4
    x = (centers[rng.integers(0, 8, 1600)]
         + 0.5 * rng.normal(size=(1600, 8))).astype(np.float32)
    for kp in (KnnParams(knbn=6),
               KnnParams(knbn=6, brute_force_limit=500, nlist=20,
                         nprobe=5, refine_rounds=2, nndescent_rho=0.5)):
        g1 = build_kgraph(x, 6, params=kp)
        g2 = sharded_build_kgraph(x, 6, mesh, params=kp)
        np.testing.assert_array_equal(np.asarray(g2.indices),
                                      np.asarray(g1.indices))


def test_sharded_train_step(rng, mesh):
    x = rng.normal(size=(256, 8)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=5)
    g = KGraph(indices=idx, dists=dist)
    es = build_edge_set(g, to_proba_edges(g))
    shards = shard_edge_set(es, mesh)
    step = make_sharded_train_step(mesh, b=1.0, batch_size_per_device=64)
    y0 = jnp.asarray(rng.uniform(-5, 5, size=(256, 2)).astype(np.float32))
    y1 = step(y0, jax.random.PRNGKey(0), *shards, jnp.float32(1.0))
    y1 = np.asarray(y1)
    assert np.isfinite(y1).all()
    assert np.abs(y1 - np.asarray(y0)).max() > 0

    # determinism: same key -> same result
    y1b = np.asarray(step(y0, jax.random.PRNGKey(0), *shards,
                          jnp.float32(1.0)))
    np.testing.assert_array_equal(y1, y1b)


@pytest.mark.slow
def test_graft_dryrun():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_graft_entry_compiles():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert all(np.isfinite(np.asarray(o)).all()
               for o in jax.tree_util.tree_leaves(out))


def test_sharded_dense_step(rng, mesh):
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.params import EmbedderParams
    from annembed_tpu.parallel.sharded import (make_sharded_dense_step,
                                               shard_dense_inputs)
    n = 256
    x = rng.normal(size=(n, 8)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    params = EmbedderParams(n_sub=10)
    inputs = shard_dense_inputs(g, npar, params, mesh)
    step = make_sharded_dense_step(mesh, b=1.0, n_neg=5)
    y0 = jnp.asarray(rng.uniform(-5, 5, size=(n, 2)).astype(np.float32))
    y1 = step(y0, jax.random.PRNGKey(0), *inputs, jnp.float32(1.0))
    y1 = np.asarray(y1)
    assert np.isfinite(y1).all()
    assert np.abs(y1 - np.asarray(y0)).max() > 0
    # determinism
    y1b = np.asarray(step(y0, jax.random.PRNGKey(0), *inputs,
                          jnp.float32(1.0)))
    np.testing.assert_array_equal(y1, y1b)


def test_sharded_dense_optimize_separates(rng, mesh):
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.params import EmbedderParams
    from annembed_tpu.parallel.sharded import sharded_dense_optimize
    centers = rng.normal(size=(2, 8)) * 12
    x = np.concatenate([centers[i] + rng.normal(size=(128, 8))
                        for i in range(2)]).astype(np.float32)
    labels = np.repeat(np.arange(2), 128)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (256, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=8)
    y = np.asarray(sharded_dense_optimize(y0, g, npar, p, mesh))
    assert np.isfinite(y).all()
    mus = np.stack([y[labels == i].mean(0) for i in range(2)])
    d_to = np.linalg.norm(y[:, None] - mus[None], axis=-1)
    acc = (d_to.argmin(1) == labels).mean()
    assert acc > 0.9, acc
    # quality parity with the single-device schedule: same fixture,
    # same params -> final CE within 10%
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.ce import ce_value_dense
    y1, _ = run_dense_optimization(y0, g, npar, p)
    ce_sharded = float(ce_value_dense(jnp.asarray(y), g, npar.probas,
                                      npar.scale, 1.0))
    ce_single = float(ce_value_dense(y1, g, npar.probas, npar.scale, 1.0))
    assert ce_sharded < ce_single * 1.1, (ce_sharded, ce_single)
    # ragged n: 250 is not a multiple of 8 -> inert-row padding path
    y2 = np.asarray(sharded_dense_optimize(y0[:250], KGraph(
        indices=jnp.clip(g.indices[:250], 0, 249), dists=g.dists[:250]),
        to_proba_edges(KGraph(indices=jnp.clip(g.indices[:250], 0, 249),
                              dists=g.dists[:250])), p, mesh))
    assert y2.shape == (250, 2) and np.isfinite(y2).all()


def test_sharded_brute_bf16_candidates_parity(rng, mesh):
    """bf16 panels select candidates by exact top-k, the f32 rerank
    orders them: sharded == single-chip on that path too, and both
    agree with the exact f32 graph."""
    import jax.numpy as jnp
    from annembed_tpu.knn.api import recall_at_k
    from annembed_tpu.knn.brute import knn_graph_brute
    from annembed_tpu.parallel.sharded_knn import sharded_knn_graph_brute
    x = rng.normal(size=(300, 10)).astype(np.float32)
    idx_1, dist_1 = knn_graph_brute(x, 6, dtype="bfloat16")
    idx_s, dist_s = sharded_knn_graph_brute(jnp.asarray(x), 6, mesh,
                                            block_rows=64,
                                            dtype="bfloat16")
    np.testing.assert_array_equal(np.asarray(idx_1), np.asarray(idx_s))
    np.testing.assert_allclose(np.asarray(dist_1), np.asarray(dist_s),
                               rtol=1e-5)
    idx_ex, _ = knn_graph_brute(x, 6)
    assert recall_at_k(idx_s, idx_ex) > 0.97

def test_sharded_ivf_grid_parity(rng, mesh):
    """Grid-quantizer IVF: sharded == single-chip (same strip
    partition, same probe table, rows fanned out)."""
    import jax.numpy as jnp
    from annembed_tpu.knn.ivf import knn_graph_ivf
    from annembed_tpu.parallel.sharded_knn import sharded_knn_graph_ivf
    centers = rng.normal(0, 5, (6, 2))
    y = (centers[rng.integers(0, 6, 4000)]
         + rng.normal(0, 0.7, (4000, 2))).astype(np.float32)
    i1, d1 = knn_graph_ivf(y, 8, quantizer="grid")
    i2, d2 = sharded_knn_graph_ivf(jnp.asarray(y), 8, mesh,
                                   quantizer="grid")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)


@pytest.mark.slow
def test_sharded_dense_optimize_schedule(rng, mesh):
    """n_sub_schedule on the sharded production path: runs the
    coarse->fine phases, stays finite, separates, and lands in the
    single-chip scheduled path's CE basin."""
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.params import EmbedderParams
    from annembed_tpu.parallel.sharded import sharded_dense_optimize
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.ce import ce_value_dense
    centers = rng.normal(size=(2, 8)) * 12
    x = np.concatenate([centers[i] + rng.normal(size=(128, 8))
                        for i in range(2)]).astype(np.float32)
    labels = np.repeat(np.arange(2), 128)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (256, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=8, n_sub_schedule=((4, 24), (4, 48)))
    y = np.asarray(sharded_dense_optimize(y0, g, npar, p, mesh))
    assert np.isfinite(y).all()
    mus = np.stack([y[labels == i].mean(0) for i in range(2)])
    acc = (np.linalg.norm(y[:, None] - mus[None], axis=-1).argmin(1)
           == labels).mean()
    assert acc > 0.9, acc
    y1, info = run_dense_optimization(y0, g, npar, p, n_sub=24)
    assert info["sweeps"] == 4 * 24 + 3 * 48
    ce_sharded = float(ce_value_dense(jnp.asarray(y), g, npar.probas,
                                      npar.scale, 1.0))
    ce_single = float(ce_value_dense(y1, g, npar.probas, npar.scale, 1.0))
    assert ce_sharded < ce_single * 1.1, (ce_sharded, ce_single)
    with pytest.raises(ValueError, match="must sum"):
        sharded_dense_optimize(
            y0, g, npar,
            EmbedderParams(nb_grad_batch=8, n_sub_schedule=((3, 24),)),
            mesh)


def test_sharded_packed_gather_bit_identical(rng, mesh):
    """dense_packed_gather on the sharded production path must be
    bit-identical to the pair gather (complex64 packs the two f32
    coordinates exactly)."""
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.params import EmbedderParams
    from annembed_tpu.parallel.sharded import sharded_dense_optimize
    x = rng.normal(size=(256, 8)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (256, 2)).astype(np.float32))
    p0 = EmbedderParams(nb_grad_batch=6,
                        n_sub_schedule=((3, 12), (3, 24)))
    p1 = EmbedderParams(nb_grad_batch=6, dense_packed_gather=True,
                        n_sub_schedule=((3, 12), (3, 24)))
    y_a = np.asarray(sharded_dense_optimize(y0, g, npar, p0, mesh))
    y_b = np.asarray(sharded_dense_optimize(y0, g, npar, p1, mesh))
    np.testing.assert_array_equal(y_a, y_b)


def test_sharded_svd_coo_parity(rng, mesh):
    """Entry-sharded COO SpMM SVD matches the single-chip randomized
    SVD to f32 roundoff (the psum reassociates the scatter-add sums,
    so bit-exactness is not expected)."""
    from annembed_tpu.graph.kgraph import symmetric_coo
    from annembed_tpu.linalg.rsvd import randomized_svd_coo
    from annembed_tpu.parallel.sharded_svd import sharded_randomized_svd_coo
    x = rng.normal(size=(400, 10)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=6)
    g = KGraph(indices=idx, dists=dist)
    rows, cols, vals = symmetric_coo(g, mode="mean")
    key = jax.random.PRNGKey(4664397)
    r1 = randomized_svd_coo(rows, cols, vals, key, n=400, rank=10)
    r2 = sharded_randomized_svd_coo(rows, cols, vals, key, n=400,
                                    rank=10, mesh=mesh)
    np.testing.assert_allclose(np.asarray(r2.s), np.asarray(r1.s),
                               rtol=2e-4)
    # singular SUBSPACES must agree: compare |u_1^T u_2| per column
    # (sign-independent); skip near-degenerate tail columns
    u1, u2 = np.asarray(r1.u), np.asarray(r2.u)
    s = np.asarray(r1.s)
    lead = s > 0.05 * s[0]
    dots = np.abs((u1 * u2).sum(0))[lead]
    assert (dots > 0.98).all(), dots


def test_dmap_embed_mesh_matches_single(rng, mesh):
    """Spectral init through the sharded SVD produces the same
    diffusion coordinates as the single-chip path (coordinate-wise,
    modest tol: the SVD itself is randomized with a shared seed)."""
    from annembed_tpu.spectral.diffmaps import DiffusionMaps
    from annembed_tpu.params import DiffusionParams, FULL_SVD_SIZE_LIMIT
    import annembed_tpu.graph.laplacian as lap_mod
    x = rng.normal(size=(600, 8)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=8)
    g = KGraph(indices=idx, dists=dist)
    dm = DiffusionMaps(params=DiffusionParams(asked_dim=2, alfa=0.5,
                                              beta=-0.1, t=5.0, gnbn=8))
    # force the randomized path (600 < FULL_SVD_SIZE_LIMIT would take
    # the exact-SVD branch and not exercise the sharded SpMM)
    orig = lap_mod.FULL_SVD_SIZE_LIMIT
    lap_mod.FULL_SVD_SIZE_LIMIT = 100
    try:
        y1 = np.asarray(dm.embed_from_kgraph(g))
        y2 = np.asarray(dm.embed_from_kgraph(g, mesh=mesh))
    finally:
        lap_mod.FULL_SVD_SIZE_LIMIT = orig
    assert np.isfinite(y2).all()
    np.testing.assert_allclose(np.abs(y2), np.abs(y1), atol=5e-3)


def test_api_embed_multichip_parity(rng, mesh):
    """api.embed(n_devices=8) end-to-end matches the single-chip
    result while the sweep count is small: graph build is bit-identical
    (exact sharded joins), the tiny-n spectral init takes the same
    exact-SVD branch, and the sharded optimizer shares the seed stream
    — one sweep agrees to one ulp (the chaotic dynamics amplify the
    reassociation noise past that, so long runs are compared
    functionally in the tests below)."""
    import annembed_tpu as at
    from annembed_tpu.params import EmbedderParams
    x = rng.normal(size=(256, 16)).astype(np.float32)
    p = EmbedderParams(n_sub=4)
    y1, info1 = at.embed(x, dim=2, batch=2, nbng=4, params=p,
                         with_quality=True, quality_nbng=8)
    y2, info2 = at.embed(x, dim=2, batch=2, nbng=4, params=p,
                         with_quality=True, quality_nbng=8, n_devices=8)
    assert info2["n_devices"] == 8
    # 4 sweeps of chaotic dynamics amplify the one-ulp reassociation
    # difference; a handful of nodes can cross a clip/rejection
    # threshold and jump ~0.1, so assert bulk agreement by quantile —
    # the single-sweep agreement is pinned at 1e-6 by the direct
    # optimizer parity check below
    diff = np.abs(np.asarray(y2) - np.asarray(y1))
    assert np.quantile(diff, 0.99) < 2e-2, np.quantile(diff, 0.99)
    assert diff.max() < 0.5, diff.max()
    assert (abs(info2["quality"]["nb_without_match"]
                - info1["quality"]["nb_without_match"]) <= 2)


def test_api_embed_multichip_quality(rng, mesh):
    """Full-length multi-chip embed (one-step AND hierarchical)
    separates clustered data as well as the single-chip run: the
    functional parity that matters once chaotic divergence rules out
    coordinate equality."""
    import annembed_tpu as at
    labels = rng.integers(0, 2, 320)
    centers = np.array([[-6.0] * 12, [6.0] * 12], np.float32)
    x = (centers[labels]
         + rng.normal(size=(320, 12)).astype(np.float32))

    def acc(y):
        mus = np.stack([y[labels == i].mean(0) for i in range(2)])
        return (np.linalg.norm(y[:, None] - mus[None], axis=-1)
                .argmin(1) == labels).mean()

    y2, info2 = at.embed(x, dim=2, batch=4, nbng=4, n_devices=8)
    assert info2["n_devices"] == 8
    assert np.isfinite(y2).all()
    assert acc(y2) > 0.95, acc(y2)

    y3, info3 = at.embed(x, dim=2, batch=4, nbng=4, layer=1,
                         hierarchy_fraction=0.25, n_devices=8)
    assert info3["n_devices"] == 8
    assert np.isfinite(y3).all()
    assert acc(y3) > 0.95, acc(y3)


def test_sharded_dense_single_sweep_ulp_parity(rng, mesh):
    """ONE sweep of the sharded production optimizer agrees with the
    single-chip path to float roundoff (same seed stream, same window
    partners, same closed-form attraction) — the tight anchor behind
    the looser multi-sweep api parity above."""
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.parallel.sharded import sharded_dense_optimize
    from annembed_tpu.params import EmbedderParams
    x = rng.normal(size=(256, 16)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (256, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=2, n_sub=1)
    y1, _ = run_dense_optimization(y0, g, npar, p, n_sub=1)
    y2 = sharded_dense_optimize(y0, g, npar, p, mesh)
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y1),
                               atol=1e-6)


def test_sharded_parallel_kicks_runs(rng, mesh):
    """dense_parallel_kicks reaches the sharded production schedule:
    finite output, CE within 10% of the single-chip parallel-kicks
    run on the same fixture."""
    import jax.numpy as jnp
    from annembed_tpu.knn.brute import knn_graph_brute
    from annembed_tpu.graph.kgraph import KGraph
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.params import EmbedderParams
    from annembed_tpu.parallel.sharded import sharded_dense_optimize
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.ce import ce_value_dense
    x = rng.normal(size=(256, 8)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (256, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=6, dense_parallel_kicks=True)
    y_s = np.asarray(sharded_dense_optimize(y0, g, npar, p, mesh))
    assert np.isfinite(y_s).all()
    y_1, info = run_dense_optimization(y0, g, npar, p)
    assert info["parallel_kicks"] == 1
    ce_s = float(ce_value_dense(jnp.asarray(y_s), g, npar.probas,
                                npar.scale, 1.0))
    ce_1 = float(ce_value_dense(y_1, g, npar.probas, npar.scale, 1.0))
    assert ce_s < ce_1 * 1.1, (ce_s, ce_1)


def test_sharded_gather_reuse_matches_single(rng, mesh):
    """dense_gather_reuse (+ late activation) on the sharded production
    path: mirrors optim/dense.py's stale-block structure — finite,
    separates, and lands in the single-chip stale path's CE basin with
    identical sweep accounting."""
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.params import EmbedderParams
    from annembed_tpu.parallel.sharded import sharded_dense_optimize
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.ce import ce_value_dense
    centers = rng.normal(size=(2, 8)) * 12
    x = np.concatenate([centers[i] + rng.normal(size=(128, 8))
                        for i in range(2)]).astype(np.float32)
    labels = np.repeat(np.arange(2), 128)
    idx, dist = knn_graph_brute(x, k=4)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    y0 = jnp.asarray(rng.uniform(-5, 5, (256, 2)).astype(np.float32))
    p = EmbedderParams(nb_grad_batch=8, n_sub_schedule=((4, 24), (4, 48)),
                       dense_gather_reuse=4,
                       dense_gather_reuse_after=0.5)
    y = np.asarray(sharded_dense_optimize(y0, g, npar, p, mesh))
    assert np.isfinite(y).all()
    mus = np.stack([y[labels == i].mean(0) for i in range(2)])
    acc = (np.linalg.norm(y[:, None] - mus[None], axis=-1).argmin(1)
           == labels).mean()
    assert acc > 0.9, acc
    y1, info = run_dense_optimization(y0, g, npar, p, n_sub=24)
    assert info["gather_reuse"] == 4
    ce_sharded = float(ce_value_dense(jnp.asarray(y), g, npar.probas,
                                      npar.scale, 1.0))
    ce_single = float(ce_value_dense(y1, g, npar.probas, npar.scale, 1.0))
    assert ce_sharded < ce_single * 1.1, (ce_sharded, ce_single)
