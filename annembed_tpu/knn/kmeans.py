"""Mini-batch-free Lloyd k-means as distance matmuls, used as the IVF
coarse quantizer (the accelerator-side replacement for HNSW's layer hierarchy as a
search-pruning device; see SURVEY.md §7).

Assignment = one distance panel + argmin; update = segment mean, summed
in a fixed order so that the cells, and every IVF graph built on them,
are the same from run to run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .distances import l2_panel, corpus_sqnorm


@functools.partial(jax.jit, static_argnames=("block_rows",))
def assign_to_centroids(x, centroids, block_rows: int = 4096):
    """Nearest-centroid id for every row of x: (n,) int32."""
    n, d = x.shape
    c_sq = corpus_sqnorm(centroids)
    n_blocks = -(-n // block_rows)
    pad = n_blocks * block_rows - n
    xb = jnp.pad(x, ((0, pad), (0, 0))).reshape(n_blocks, block_rows, d)

    def one(q):
        dist = l2_panel(q, centroids, c_sq)
        return jnp.argmin(dist, axis=1).astype(jnp.int32)

    cells = jax.lax.map(one, xb).reshape(-1)[:n]
    return cells


def cluster_sums(x, cells, n_clusters: int, block_rows: int = 4096):
    """Per-cluster row sums (n_clusters, d) and counts (n_clusters,).

    A scatter-add lowers to atomics on a GPU, whose order, and with it
    the float rounding of each sum, changes from run to run; a few Lloyd
    steps later the cell boundaries differ too.  Here every row block
    adds one one-hot matmul (the counts ride along as a ones column) and
    the blocks accumulate in sequence, so the sums are reproducible."""
    n, d = x.shape
    n_blocks = -(-n // block_rows)
    pad = n_blocks * block_rows - n
    xo = jnp.concatenate([x.astype(jnp.float32),
                          jnp.ones((n, 1), jnp.float32)], axis=1)
    xb = jnp.pad(xo, ((0, pad), (0, 0))).reshape(n_blocks, block_rows,
                                                 d + 1)
    # pad rows carry cell id n_clusters, which no one-hot column matches
    cb = jnp.pad(cells, (0, pad), constant_values=n_clusters).reshape(
        n_blocks, block_rows)
    ids = jnp.arange(n_clusters, dtype=cells.dtype)

    def add_block(acc, blk):
        x_blk, c_blk = blk
        onehot = (c_blk[None, :] == ids[:, None]).astype(jnp.float32)
        return acc + jnp.dot(onehot, x_blk,
                             precision=jax.lax.Precision.HIGHEST), None

    acc, _ = jax.lax.scan(add_block,
                          jnp.zeros((n_clusters, d + 1), jnp.float32),
                          (xb, cb))
    return acc[:, :d], acc[:, d]


@functools.partial(jax.jit, static_argnames=("n_clusters", "n_iter",
                                             "block_rows"))
def kmeans_fit(x, n_clusters: int, n_iter: int = 10, seed: int = 0,
               block_rows: int = 4096):
    """Lloyd iterations from a random-point init.  Empty clusters keep
    their previous centroid.  Returns (centroids, cells)."""
    n, d = x.shape
    key = jax.random.PRNGKey(seed)
    init_ids = jax.random.choice(key, n, (n_clusters,), replace=False)
    centroids = x[init_ids].astype(jnp.float32)

    def body(_, centroids):
        cells = assign_to_centroids(x, centroids, block_rows)
        sums, counts = cluster_sums(x, cells, n_clusters, block_rows)
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where(counts[:, None] > 0, new, centroids)

    centroids = jax.lax.fori_loop(0, n_iter, body, centroids)
    cells = assign_to_centroids(x, centroids, block_rows)
    return centroids, cells
