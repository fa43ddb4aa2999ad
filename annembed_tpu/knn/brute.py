"""Exact kNN graph by tiled distance panels + top-k.

Replaces the reference's HNSW graph construction
(hnsw_rs ``parallel_insert`` + src/fromhnsw/kgraph.rs:440
``kgraph_from_hnsw_all``) for datasets where the full O(n^2 d) distance
computation is affordable (e.g. MNIST-70k: a 70k x 70k panelized matmul).

Design: queries are processed in row panels of ``block_rows`` under
``lax.map`` so at most a (block_rows, n) distance panel is live in
device memory; XLA hands the inner matmul to its GEMM library.  Self edges are masked by index
(not by distance, which would break on duplicate points).

Precision: the matmul form ||q||^2 + ||x||^2 - 2 q.x suffers
cancellation at ~1e-3 relative error in float32, enough to swap
near-tied neighbours.  For DistL2 we therefore select top (k + extra)
candidates from the panel and re-rank them with exact elementwise
(q - x)^2 distances (a cheap (b, k+extra, d) gather), giving
numpy-exact graphs.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from .distances import get_panel_fn, corpus_sqnorm

_RERANK_EXTRA = 8


def _exact_l2_rerank(q, x, cand_idx, k, self_ids=None, valid_n=None):
    """Re-rank candidate indices by exact L2 distance.

    q: (b, d), cand_idx: (b, kk) -> (idx (b, k) int32, dist (b, k)).
    ``self_ids`` (b,) masks the query's own id BEFORE selection: when
    kk reaches n (tiny corpora) the panel's masked self column re-enters
    the candidate set and its recomputed exact distance (0) would win.
    ``valid_n`` (traced scalar) masks padded corpus rows the same way —
    their recomputed distance to the zero pad row must never win.
    """
    xc = x[cand_idx]  # (b, kk, d)
    d2 = jnp.sum(jnp.square(q[:, None, :] - xc), axis=-1)  # (b, kk)
    if self_ids is not None:
        d2 = jnp.where(cand_idx == self_ids[:, None], jnp.inf, d2)
    if valid_n is not None:
        d2 = jnp.where(cand_idx >= valid_n, jnp.inf, d2)
    neg_d2, pos = jax.lax.top_k(-d2, k)
    idx = jnp.take_along_axis(cand_idx, pos, axis=1)
    return idx.astype(jnp.int32), jnp.sqrt(jnp.maximum(-neg_d2, 0.0))


def _block_topk(q, corpus, x_sq, k: int, kk: int, panel_fn, dtype,
                rerank: bool, self_ids=None, valid_n=None):
    """One query-block panel + candidate top-k + optional exact rerank —
    the shared body of the single-chip graph build (`_knn_impl`), the
    corpus search (`_search_impl`) and the sharded brute build
    (parallel/sharded_knn.py), so the three cannot drift."""
    dist = panel_fn(q, corpus, x_sq, dtype=dtype)
    col = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    if self_ids is not None:
        # mask the self column per row
        dist = jnp.where(col == self_ids[:, None], jnp.inf, dist)
    if valid_n is not None:
        dist = jnp.where(col < valid_n, dist, jnp.inf)
    neg_d, idx = jax.lax.top_k(-dist, kk)
    if rerank:
        return _exact_l2_rerank(q, corpus, idx, k, self_ids=self_ids,
                                valid_n=valid_n)
    return idx.astype(jnp.int32), -neg_d


@functools.partial(jax.jit, static_argnames=("k", "distance", "block_rows",
                                             "dtype_name"))
def _knn_impl(x: jnp.ndarray, k: int, distance: str, block_rows: int,
              dtype_name: str):
    n, d = x.shape
    dtype = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    panel_fn = get_panel_fn(distance)
    rerank = distance == "DistL2"
    x_sq = corpus_sqnorm(x) if distance in ("DistL2", "DistCosine") else None

    n_blocks = -(-n // block_rows)
    pad = n_blocks * block_rows - n
    row_ids = jnp.arange(n_blocks * block_rows, dtype=jnp.int32)
    q_pad = jnp.pad(x, ((0, pad), (0, 0)))
    q_blocks = q_pad.reshape(n_blocks, block_rows, d)
    id_blocks = row_ids.reshape(n_blocks, block_rows)
    kk = min(k + _RERANK_EXTRA, n) if rerank else k

    def one_block(args):
        q, ids = args
        return _block_topk(q, x, x_sq, k, kk, panel_fn, dtype, rerank,
                           self_ids=ids)

    idx, dists = jax.lax.map(one_block, (q_blocks, id_blocks))
    idx = idx.reshape(n_blocks * block_rows, -1)[:n, :k]
    dists = dists.reshape(n_blocks * block_rows, -1)[:n, :k]
    return idx, jnp.maximum(dists, 0.0)


def knn_graph_brute(x, k: int, distance: str = "DistL2",
                    block_rows: int = 1024, dtype: str = "float32"):
    """Exact k nearest neighbours of every row of ``x`` (self excluded).

    Returns ``(indices, dists)`` of shape (n, k), distances ascending.
    """
    n = x.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    block_rows = min(block_rows, max(8, n))
    return _knn_impl(jnp.asarray(x), k, distance, block_rows, dtype)


@functools.partial(jax.jit, static_argnames=("k", "distance", "block_rows",
                                             "dtype_name"))
def _search_impl(queries, corpus, valid_n, k, distance, block_rows,
                 dtype_name):
    """``valid_n`` is a TRACED scalar: the number of real corpus rows.
    The chunked caller pads its last chunk to the fixed chunk width so
    every chunk reuses one compiled program; columns >= valid_n are
    masked to +inf (both in the panel and after the exact rerank)."""
    nq, d = queries.shape
    n = corpus.shape[0]
    dtype = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    panel_fn = get_panel_fn(distance)
    rerank = distance == "DistL2"
    x_sq = corpus_sqnorm(corpus) if distance in ("DistL2", "DistCosine") else None

    n_blocks = -(-nq // block_rows)
    pad = n_blocks * block_rows - nq
    q_pad = jnp.pad(queries, ((0, pad), (0, 0)))
    q_blocks = q_pad.reshape(n_blocks, block_rows, d)
    kk = min(k + _RERANK_EXTRA, n) if rerank else k

    def one_block(q):
        return _block_topk(q, corpus, x_sq, k, kk, panel_fn, dtype,
                           rerank, valid_n=valid_n)

    idx, dists = jax.lax.map(one_block, q_blocks)
    idx = idx.reshape(n_blocks * block_rows, -1)[:nq, :k]
    dists = dists.reshape(n_blocks * block_rows, -1)[:nq, :k]
    return idx, jnp.maximum(dists, 0.0)


@jax.jit
def _merge_topk_sorted(d_a, i_a, d_b, i_b):
    """Merge two ascending-(by distance) candidate sets rowwise and
    keep the best k = d_a.shape[1]."""
    k = d_a.shape[1]
    all_d = jnp.concatenate([d_a, d_b], axis=1)
    all_i = jnp.concatenate([i_a, i_b], axis=1)
    neg_d, pos = jax.lax.top_k(-all_d, k)
    return -neg_d, jnp.take_along_axis(all_i, pos, axis=1)


def knn_search_brute(queries, corpus, k: int, distance: str = "DistL2",
                     block_rows: int = 1024, dtype: str = "float32",
                     corpus_chunk: int = 2_000_000):
    """k nearest corpus points for each query (no self-exclusion).

    Replaces ``hnsw.search`` (used e.g. by the quality estimator,
    reference src/embedder.rs:527-554, and the projection step of
    src/fromhnsw/kgproj.rs:195-237).

    Corpora beyond ``corpus_chunk`` rows are processed in chunks with a
    running top-k merge: one (block_rows, n) panel at 11M rows is a
    45 GB buffer the compiler rightly refuses.
    """
    n = corpus.shape[0]
    if k > n:
        raise ValueError("k larger than corpus")
    block_rows = min(block_rows, max(8, queries.shape[0]))
    # cap the per-block (block_rows, chunk) panel at ~1.5 GB: the
    # 2M-row default chunk put an 8.2 GB panel (+ top-k workspace)
    # inside one program at 11M corpus rows, which faulted the device
    # under the rest of a large pipeline's resident buffers
    panel_budget = int(os.environ.get("ANNEMBED_SEARCH_PANEL_BYTES",
                                      1_500_000_000))
    corpus_chunk = max(min(corpus_chunk,
                           panel_budget // max(block_rows * 4, 1)),
                       k + 1)
    queries = jnp.asarray(queries)
    corpus = jnp.asarray(corpus)
    if n <= corpus_chunk:
        return _search_impl(queries, corpus, jnp.int32(n), k, distance,
                            block_rows, dtype)
    best_d = best_i = None
    for c0 in range(0, n, corpus_chunk):
        c1 = min(c0 + corpus_chunk, n)
        chunk = corpus[c0:c1]
        if c1 - c0 < corpus_chunk:
            # pad the remainder chunk to the fixed width so it reuses
            # the compiled program (pad columns are masked by valid_n)
            chunk = jnp.pad(chunk, ((0, corpus_chunk - (c1 - c0)), (0, 0)))
        ci, cd = _search_impl(queries, chunk, jnp.int32(c1 - c0), k,
                              distance, block_rows, dtype)
        cd.block_until_ready()       # serialize chunk workspaces
        ci = ci + c0
        if best_d is None:
            best_d, best_i = cd, ci
        else:
            best_d, best_i = _merge_topk_sorted(best_d, best_i, cd, ci)
    return best_i, best_d
