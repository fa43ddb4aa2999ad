"""kNN construction tests: exact agreement with a numpy oracle, distance
dispatch, self-exclusion, duplicate-point robustness.

Mirrors the reference test strategy for graph extraction
(src/fromhnsw/kgraph.rs:771-903 uses synthetic uniform data); here we
can assert exactness since the graph builder is brute force.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from annembed_tpu.knn.brute import knn_graph_brute, knn_search_brute
from annembed_tpu.knn import distances as D


def numpy_knn(x, k):
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx, np.sqrt(np.take_along_axis(d2, idx, axis=1))


def test_knn_matches_numpy(rng):
    x = rng.normal(size=(300, 17)).astype(np.float32)
    idx, dist = knn_graph_brute(x, k=8, block_rows=64)
    ref_idx, ref_dist = numpy_knn(x, 8)
    np.testing.assert_allclose(np.asarray(dist), ref_dist, rtol=2e-4, atol=2e-4)
    # indices can differ on exact ties; compare via distances per row
    same = (np.asarray(idx) == ref_idx).mean()
    assert same > 0.99


def test_knn_self_excluded(rng):
    x = rng.normal(size=(100, 5)).astype(np.float32)
    idx, _ = knn_graph_brute(x, k=4)
    rows = np.arange(100)[:, None]
    assert not (np.asarray(idx) == rows).any()


def test_knn_duplicate_points(rng):
    # duplicated points give zero distances; self must still be excluded
    x = rng.normal(size=(50, 3)).astype(np.float32)
    x = np.concatenate([x, x[:10]], axis=0)
    idx, dist = knn_graph_brute(x, k=3)
    rows = np.arange(60)[:, None]
    assert not (np.asarray(idx) == rows).any()
    assert np.asarray(dist).min() == 0.0  # duplicate at distance 0 kept


def test_knn_sorted_rows(rng):
    x = rng.normal(size=(200, 10)).astype(np.float32)
    _, dist = knn_graph_brute(x, k=7)
    d = np.asarray(dist)
    assert (np.diff(d, axis=1) >= -1e-6).all()


def test_search_brute(rng):
    corpus = rng.normal(size=(128, 6)).astype(np.float32)
    queries = rng.normal(size=(37, 6)).astype(np.float32)
    idx, dist = knn_search_brute(queries, corpus, k=5)
    d2 = ((queries[:, None, :] - corpus[None, :, :]) ** 2).sum(-1)
    ref_idx = np.argsort(d2, axis=1)[:, :5]
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(dist),
                               np.sqrt(np.take_along_axis(d2, ref_idx, 1)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("metric,oracle", [
    ("DistL1", lambda a, b: np.abs(a[:, None] - b[None]).sum(-1)),
    ("DistCosine", lambda a, b: 1 - (a @ b.T) / (
        np.linalg.norm(a, axis=1)[:, None] * np.linalg.norm(b, axis=1)[None])),
])
def test_distance_panels(rng, metric, oracle):
    a = rng.normal(size=(20, 9)).astype(np.float32)
    b = rng.normal(size=(33, 9)).astype(np.float32)
    panel = D.get_panel_fn(metric)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(panel), oracle(a, b),
                               rtol=1e-4, atol=1e-5)


def test_probability_distances(rng):
    p = rng.random(size=(10, 16)).astype(np.float32)
    q = rng.random(size=(12, 16)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    q /= q.sum(1, keepdims=True)
    jf = np.asarray(D.jeffreys_panel(jnp.asarray(p), jnp.asarray(q)))
    ref = ((p[:, None] - q[None]) * np.log(p[:, None] / q[None])).sum(-1)
    np.testing.assert_allclose(jf, ref, rtol=1e-3, atol=1e-5)
    js = np.asarray(D.jensenshannon_panel(jnp.asarray(p), jnp.asarray(q)))
    m = 0.5 * (p[:, None] + q[None])
    ref_js = np.sqrt(0.5 * (p[:, None] * np.log(p[:, None] / m)).sum(-1)
                     + 0.5 * (q[None] * np.log(q[None] / m)).sum(-1))
    np.testing.assert_allclose(js, ref_js, rtol=1e-3, atol=1e-5)
    # JS distance of identical distributions is ~0
    js_same = np.asarray(D.jensenshannon_panel(jnp.asarray(p), jnp.asarray(p)))
    assert np.abs(np.diagonal(js_same)).max() < 1e-3


def test_build_kgraph_probability_metric(rng):
    """End-to-end graph build with a probability metric (the reference
    CLI supports DistJensenShannon, bin/embed.rs:546-565)."""
    from annembed_tpu.knn.api import build_kgraph
    p = rng.random(size=(120, 12)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    g = build_kgraph(p, 5, distance="DistJensenShannon")
    assert g.indices.shape == (120, 5)
    d = np.asarray(g.dists)
    assert (d >= 0).all() and (np.diff(d, axis=1) >= -1e-6).all()
    rows = np.arange(120)[:, None]
    assert not (np.asarray(g.indices) == rows).any()


def test_bfloat16_panel_with_rerank(rng):
    """bf16 matmul panels + exact f32 rerank: the graph should agree
    with full-f32 on nearly every edge (the reduced-precision fast
    path)."""
    from annembed_tpu.knn.api import recall_at_k
    x = rng.normal(size=(500, 32)).astype(np.float32)
    i32, d32 = knn_graph_brute(x, k=8, dtype="float32")
    i16, d16 = knn_graph_brute(x, k=8, dtype="bfloat16")
    rec = recall_at_k(i16, i32)
    assert rec > 0.97, rec
    np.testing.assert_allclose(np.asarray(d16), np.asarray(d32),
                               rtol=5e-2, atol=5e-2)


def test_search_corpus_chunked_matches():
    """Chunked-corpus search (large-corpus memory path) must equal the
    single-panel result."""
    import numpy as np
    from annembed_tpu.knn.brute import knn_search_brute
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(500, 8)).astype(np.float32)
    q = rng.normal(size=(40, 8)).astype(np.float32)
    i1, d1 = knn_search_brute(q, corpus, k=5)
    i2, d2 = knn_search_brute(q, corpus, k=5, corpus_chunk=128)
    assert np.array_equal(np.asarray(i1), np.asarray(i2))
    assert np.allclose(np.asarray(d1), np.asarray(d2), atol=1e-6)


def test_chunked_search_remainder_padded(rng):
    """Chunked corpus search pads the remainder chunk (one compiled
    program for all chunks) and still matches the unchunked result."""
    corpus = rng.normal(size=(230, 7)).astype(np.float32)
    queries = rng.normal(size=(19, 7)).astype(np.float32)
    i1, d1 = knn_search_brute(queries, corpus, k=6)
    # corpus_chunk=100 -> chunks of 100/100/30 (remainder padded)
    i2, d2 = knn_search_brute(queries, corpus, k=6, corpus_chunk=100)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)
    # remainder smaller than k: 100/100/30 with k=40
    i3, d3 = knn_search_brute(queries, corpus, k=40, corpus_chunk=100)
    i4, d4 = knn_search_brute(queries, corpus, k=40)
    np.testing.assert_array_equal(np.asarray(i3), np.asarray(i4))


def test_cosine_zero_norm_reference_convention(rng):
    """hnsw_rs DistCosine returns 0 when either norm is zero."""
    a = rng.normal(size=(4, 5)).astype(np.float32)
    a[1] = 0.0
    panel = np.asarray(D.cosine_panel(jnp.asarray(a), jnp.asarray(a)))
    assert np.allclose(panel[1], 0.0)      # zero row vs everything
    assert np.allclose(panel[:, 1], 0.0)
    pair = D.get_pair_fn("DistCosine")
    pd = np.asarray(pair(jnp.asarray(a)[:, None, :], jnp.asarray(a)[None]))
    np.testing.assert_allclose(pd, panel, atol=1e-6)


def test_jeffreys_sparse_clamp(rng):
    """Zero components clamp at hnsw_rs's M_MIN=1e-30, not a loose eps."""
    p = np.array([[0.0, 0.5, 0.5]], np.float32)
    q = np.array([[0.01, 0.495, 0.495]], np.float32)
    got = float(np.asarray(D.jeffreys_panel(jnp.asarray(p), jnp.asarray(q)))[0, 0])
    expect = float(((p - q) * np.log(np.maximum(p, 1e-30) /
                                     np.maximum(q, 1e-30))).sum())
    assert abs(got - expect) / abs(expect) < 1e-4


def test_recall_at_k_duplicates_count_once():
    """IVF's under-filled fallback duplicates the last valid neighbour;
    duplicated ids must count as one hit, not k."""
    import jax.numpy as jnp
    from annembed_tpu.knn.api import recall_at_k
    exact = jnp.asarray(np.array([[1, 2, 3], [4, 5, 6]], np.int32))
    approx = jnp.asarray(np.array([[1, 1, 1], [4, 5, 6]], np.int32))
    # row 0: only id 1 recovered (1/3); row 1: all (3/3) -> 4/6
    assert abs(recall_at_k(approx, exact) - 4 / 6) < 1e-9


def test_search_exact_topk_matches_numpy_across_chunks(rng):
    """The exact top-k candidate selection of knn_search_brute (panel
    top-(k+extra) + exact rerank) equals a numpy oracle, unchunked and
    across the chunked running merge."""
    corpus = rng.normal(size=(300, 6)).astype(np.float32)
    queries = rng.normal(size=(25, 6)).astype(np.float32)
    d2 = ((queries[:, None, :] - corpus[None, :, :]) ** 2).sum(-1)
    ref = np.argsort(d2, axis=1, kind="stable")[:, :7]
    ref_d = np.sqrt(np.take_along_axis(d2, ref, axis=1))
    for chunk in (2_000_000, 120):
        i1, d1 = knn_search_brute(queries, corpus, k=7, corpus_chunk=chunk)
        np.testing.assert_array_equal(np.asarray(i1), ref)
        np.testing.assert_allclose(np.asarray(d1), ref_d, rtol=1e-5)


@pytest.mark.gpu
def test_knn_graph_recall_on_gpu(gpu_device, rng):
    """At d = 784 the panel runs at DEFAULT precision (TF32 on the
    card); the exact f32 rerank keeps the graph's recall against exact
    search at Precision.HIGHEST above 0.99."""
    import jax
    from annembed_tpu.knn.api import recall_at_k
    x = rng.normal(size=(4000, 784)).astype(np.float32)
    idx, _ = knn_graph_brute(x, 6)
    with jax.default_matmul_precision("highest"):
        ref, _ = knn_graph_brute(x, 6)
    assert recall_at_k(idx, ref) >= 0.99
