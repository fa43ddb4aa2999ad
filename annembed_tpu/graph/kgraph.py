"""Fixed-degree kNN graph container and statistics.

Replaces the reference's ``KGraph`` (src/fromhnsw/kgraph.rs:109-120):
a succinct per-node list of sorted out-edges.  On an accelerator the natural
representation is a pair of dense arrays ``indices: (n, k) int32`` and
``dists: (n, k) float32`` (ascending per row) — every downstream graph
operation becomes a gather or a segment reduction.

The DataId<->index ``IndexSet`` remap of the reference (kgraph.rs:330)
is unnecessary here: rows are already positional.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KGraph:
    """k-NN graph: for node i, ``indices[i]`` are its k nearest
    neighbours with distances ``dists[i]`` sorted ascending."""

    indices: jnp.ndarray  # (n, k) int32
    dists: jnp.ndarray    # (n, k) float32

    @property
    def nb_nodes(self) -> int:
        return self.indices.shape[0]

    @property
    def nbng(self) -> int:
        """Max number of neighbours (uniform here), reference
        ``get_max_nbng`` (kgraph.rs)."""
        return self.indices.shape[1]

    def compute_max_edge(self) -> jnp.ndarray:
        """Per-node max out-edge length (reference kgraph.rs:167)."""
        return self.dists[:, -1]


def kgraph_stats(g: KGraph) -> Dict[str, float]:
    """Graph statistics: in-degree extrema and min-radius quantiles.

    Reference ``KGraphStat`` / ``get_kraph_stats`` (kgraph.rs:47,372):
    min/max in-degree, quantiles of the distance to the nearest
    neighbour (min radius) and of the max edge.
    """
    n, k = g.indices.shape
    indeg = jnp.zeros((n,), jnp.int32).at[g.indices.reshape(-1)].add(1)
    qs = jnp.array([0.05, 0.25, 0.5, 0.75, 0.95])
    first = g.dists[:, 0]
    last = g.dists[:, -1]
    stats = {
        "nb_nodes": float(n),
        "nbng": float(k),
        "min_in_degree": float(indeg.min()),
        "max_in_degree": float(indeg.max()),
        "mean_radius": float(first.mean()),
    }
    for q, v in zip(qs.tolist(), jnp.quantile(first, qs).tolist()):
        stats[f"min_radius_q{q:g}"] = float(v)
    for q, v in zip(qs.tolist(), jnp.quantile(last, qs).tolist()):
        stats[f"max_radius_q{q:g}"] = float(v)
    return stats


def symmetric_coo(g: KGraph, weights: jnp.ndarray | None = None,
                  mode: str = "mean", include_self: bool = False,
                  self_weight: float = 1.0):
    """Symmetrize the directed k-NN graph into COO arrays of static size.

    The reference symmetrizes with 1/2 (A + A^T) in dense mode
    (kdumap.rs:276, diffmaps.rs:460) and with max(w_ij, w_ji) in sparse
    diffusion-map mode (diffmaps.rs:531).  (Its CSR kdumap path keeps the
    full weight for one-directional edges, kdumap.rs:316, which is
    inconsistent with its own dense path; we use the exact mean
    everywhere.)  Here we emit both directions of every edge, sort
    lexicographically, and fold duplicates so the total weight at (i, j)
    equals mean or max of the two directions; folded duplicates keep a
    zero weight (static shapes, no compaction needed).

    Returns (rows, cols, vals) each of length 2*n*k (+n if include_self).
    """
    n = g.indices.shape[0]
    plan = symmetric_coo_plan(g)
    vals_out = symmetric_coo_apply(plan, g.dists if weights is None
                                   else weights, mode)
    rows_s, cols_s = plan.rows, plan.cols
    if include_self:
        rows_s = jnp.concatenate([rows_s, jnp.arange(n, dtype=jnp.int32)])
        cols_s = jnp.concatenate([cols_s, jnp.arange(n, dtype=jnp.int32)])
        vals_out = jnp.concatenate(
            [vals_out, jnp.full((n,), self_weight, jnp.float32)])
    return rows_s, cols_s, vals_out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SymCooPlan:
    """Sort plan for :func:`symmetric_coo`, reusable across weight
    vectors on the same graph.

    The lexicographic (row, col) sort is the O(nk log nk) part of the
    symmetrization and depends only on the edge structure; callers that
    symmetrize several kernels on one graph (the diffusion-maps beta<0
    density pass) build the plan once and apply it per weight vector.
    """

    rows: jnp.ndarray   # (2nk,) sorted
    cols: jnp.ndarray   # (2nk,)
    perm: jnp.ndarray   # (2nk,) int32: position in the concatenated list
    dup: jnp.ndarray    # (2nk,) bool: same (row, col) as predecessor


def symmetric_coo_plan(g: KGraph) -> SymCooPlan:
    """Compute the (row, col) sort permutation and duplicate mask once."""
    n, k = g.indices.shape
    src = jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
    dst = g.indices.reshape(-1)
    rows = jnp.concatenate([src, dst])
    cols = jnp.concatenate([dst, src])
    # lexicographic sort by (row, col); avoids building a 64-bit linear key
    # (jax default int is 32-bit and n*n overflows past n ~ 46k)
    iota = jnp.arange(rows.shape[0], dtype=jnp.int32)
    rows_s, cols_s, perm = jax.lax.sort((rows, cols, iota), num_keys=2)
    dup = jnp.concatenate([
        jnp.array([False]),
        (rows_s[1:] == rows_s[:-1]) & (cols_s[1:] == cols_s[:-1]),
    ])
    return SymCooPlan(rows=rows_s, cols=cols_s, perm=perm, dup=dup)


def symmetric_coo_apply(plan: SymCooPlan, weights: jnp.ndarray,
                        mode: str = "mean") -> jnp.ndarray:
    """Symmetrized edge values for one weight vector under a plan."""
    val = weights.reshape(-1).astype(jnp.float32)
    vals_s = jnp.concatenate([val, val])[plan.perm]
    if mode == "mean":
        # both directions contribute w/2 at the same key and sum to the
        # mean; a lone direction contributes w/2, exactly 0.5*(A+A^T).
        return vals_s * 0.5
    if mode != "max":
        raise ValueError(mode)
    # max: fold the duplicate into its predecessor via max, zero it
    folded = jnp.where(plan.dup, 0.0, vals_s)
    # position of the first of a duplicate pair: next is dup
    nxt_dup = jnp.concatenate([plan.dup[1:], jnp.array([False])])
    nxt_val = jnp.concatenate([vals_s[1:], jnp.array([0.0], vals_s.dtype)])
    return jnp.where(nxt_dup, jnp.maximum(vals_s, nxt_val), folded)


def coo_to_dense(rows, cols, vals, n: int) -> jnp.ndarray:
    """Materialize a COO graph as a dense (n, n) matrix (tests / small n)."""
    return jnp.zeros((n, n), vals.dtype).at[rows, cols].add(vals)


def in_degree_counts(g: KGraph) -> jnp.ndarray:
    """k-occurrence counts (reference src/fromhnsw/hubness.rs:39-62,
    atomic increments -> one scatter-add)."""
    n = g.nb_nodes
    return jnp.zeros((n,), jnp.int32).at[g.indices.reshape(-1)].add(1)
