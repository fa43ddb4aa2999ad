"""NN-descent refinement of an approximate kNN graph.

The reference relies on HNSW's navigability for recall; our IVF local
join can miss neighbours that fall outside the probed cells.
NN-descent (Dong et al. 2011) repairs this: neighbours-of-neighbours
are excellent candidates.  Device shape: one round gathers, for every
node, the two-hop candidates of its *symmetrized* neighbourhood
(forward union a fixed-width reverse table), computes exact distances
in row panels (gather + elementwise reduce), and merges with the current
top-k.  Everything is static-shaped; work is dispatched in bounded row
slabs that bound each program's memory.

``rho`` < 1 implements Dong's candidate sampling: each round draws an
independent per-node random subset of size rho*(k+rc) from the
symmetrized neighbourhood and joins over it (outer AND inner hop), so
the dominant (b, C, d) candidate gather shrinks by ~rho^2 while the
round-over-round union of sampled candidates still covers the full
two-hop set.  The node's own (full) neighbourhood is always appended
as direct candidates, so one-hop reverse edges are never lost.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)


def _reverse_table(indices: jnp.ndarray, capacity: int,
                   dists: jnp.ndarray | None = None) -> jnp.ndarray:
    """(n, capacity) table of reverse neighbours (who points at me),
    padded with n; overflow beyond capacity keeps the NEAREST sources
    when ``dists`` is given (the reference's bounded-in-degree HNSW
    keeps the closest too — a plain stable sort would keep the
    lowest-id sources, biasing recall against high-id nodes)."""
    n, k = indices.shape
    flat_dst = indices.reshape(-1)
    flat_src = jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
    # slot per destination: running count of arrivals (via sort by dst,
    # nearest-first within a destination when distances are available)
    if dists is None:
        order = jnp.argsort(flat_dst)
    else:
        order = jnp.lexsort((dists.reshape(-1), flat_dst))
    dst_sorted = flat_dst[order]
    src_sorted = flat_src[order]
    # position within group = index - first index of the group
    first_idx = jnp.searchsorted(dst_sorted, jnp.arange(n), side="left")
    pos = jnp.arange(n * k) - first_idx[dst_sorted]
    keep = pos < capacity
    table = jnp.full((n + 1, capacity), n, dtype=jnp.int32)
    table = table.at[jnp.where(keep, dst_sorted, n),
                     jnp.where(keep, pos, 0)].set(
        jnp.where(keep, src_sorted, n))
    return table[:n]


@functools.partial(jax.jit, static_argnames=("rev_capacity",))
def _union_pp_impl(indices, rev_capacity: int, dists=None):
    """Padded symmetrized neighbourhood table (n+1, k+rc) in one XLA
    program (bounded temporary memory)."""
    n = indices.shape[0]
    rev = _reverse_table(indices, rev_capacity, dists)
    return jnp.pad(jnp.concatenate([indices, rev], axis=1),
                   ((0, 1), (0, 0)), constant_values=n)


@functools.partial(jax.jit, static_argnames=("s",))
def _sample_union_pp(key, union_pp, s: int):
    """Per-row random s-subset of the padded union table (n+1, u) ->
    (n+1, s), valid (non-pad) entries preferred.  One (n, u) uniform +
    top-k — negligible next to the join it shrinks."""
    n = union_pp.shape[0] - 1
    u = jax.random.uniform(key, union_pp.shape)
    # pads sort last; valid entries keep uniform random order
    u = u + 10.0 * (union_pp >= n)
    _, cols = jax.lax.top_k(-u, s)
    return jnp.take_along_axis(union_pp, cols, axis=1)


@functools.partial(jax.jit, static_argnames=("k", "block_rows",
                                             "distance"))
def _nndescent_slab(x_pad, inner_pp, idx_slab, dist_slab, uni_slab,
                    full_slab, rid_slab, k: int, block_rows: int,
                    distance: str = "DistL2"):
    """One bounded slab of the local join (rows of one chunk).

    ``inner_pp`` (n+1, s) is the (possibly rho-sampled) neighbourhood
    used for the inner hop; ``uni_slab`` (rows, s) the outer sampled
    neighbourhood of the slab's rows; ``full_slab`` (rows, u) the
    UNSAMPLED neighbourhood, appended as direct candidates.

    ``x_pad`` may be bfloat16 (candidate SCORING precision only — the
    caller exact-reranks the final lists in f32); distances are
    accumulated in f32 either way.

    Duplicate candidates (one node reached through several lists) are
    removed by an id-sort + adjacent-equal mask before the top-k merge:
    without it both copies of a new node can enter the merged list and
    the graph grows duplicate neighbour entries (measured ~3% of edges
    on clustered data)."""
    from .distances import get_pair_fn
    pair_fn = get_pair_fn(distance)
    n = x_pad.shape[0] - 1
    rows = idx_slab.shape[0]
    n_blocks = -(-rows // block_rows)
    pad_rows = n_blocks * block_rows - rows
    idx_p = jnp.pad(idx_slab, ((0, pad_rows), (0, 0)), constant_values=n)
    dist_p = jnp.pad(dist_slab, ((0, pad_rows), (0, 0)))
    uni_p = jnp.pad(uni_slab, ((0, pad_rows), (0, 0)), constant_values=n)
    full_p = jnp.pad(full_slab, ((0, pad_rows), (0, 0)), constant_values=n)
    rid_p = jnp.pad(rid_slab, (0, pad_rows), constant_values=n)

    def one(args):
        cur_idx, cur_dist, uni, full, rid = args
        # duplicates already inside the current list (e.g. IVF's
        # underfilled-row repair duplicates a neighbour) are inf'd so
        # fresh candidates can evict them — top_k tie-breaks toward
        # the lower-index current entries otherwise
        kk = cur_idx.shape[1]
        eq = cur_idx[:, :, None] == cur_idx[:, None, :]
        earlier = jnp.tril(jnp.ones((kk, kk), bool), -1)[None]
        cur_dist = jnp.where((eq & earlier).any(-1), jnp.inf, cur_dist)
        # candidates: sampled B(sampled B(i)) plus the full B(i)
        cand = jnp.concatenate(
            [inner_pp[uni].reshape(uni.shape[0], -1), full], axis=1)
        # id-sort per row so duplicates are adjacent (candidate order
        # carries no meaning); pads (>= n) sort last
        cand = jnp.sort(cand, axis=1)
        dup = jnp.concatenate(
            [jnp.zeros((cand.shape[0], 1), bool),
             cand[:, 1:] == cand[:, :-1]], axis=1)
        q = x_pad[rid].astype(jnp.float32)
        xc = x_pad[cand].astype(jnp.float32)
        cd = pair_fn(q[:, None, :], xc)
        invalid = (cand >= n) | (cand == rid[:, None]) | dup
        # exclude already-known neighbours (avoid duplicates in merge)
        known = (cand[:, :, None] == cur_idx[:, None, :]).any(-1)
        cd = jnp.where(invalid | known, jnp.inf, cd)
        all_d = jnp.concatenate([cur_dist, cd], axis=1)
        all_i = jnp.concatenate([cur_idx, cand], axis=1)
        neg_d, pos = jax.lax.top_k(-all_d, k)
        new_i = jnp.take_along_axis(all_i, pos, axis=1)
        return new_i.astype(jnp.int32), -neg_d

    ni, nd = jax.lax.map(one, (
        idx_p.reshape(n_blocks, block_rows, -1),
        dist_p.reshape(n_blocks, block_rows, -1),
        uni_p.reshape(n_blocks, block_rows, -1),
        full_p.reshape(n_blocks, block_rows, -1),
        rid_p.reshape(n_blocks, block_rows)))
    return (ni.reshape(-1, k)[:rows],
            jnp.maximum(nd.reshape(-1, k)[:rows], 0.0))


#: rows processed per device program: a slab bounds each jit call's
#: candidate-join workspace
_ROWS_PER_PROGRAM = 200_000


@functools.partial(jax.jit, static_argnames=("distance",))
def _exact_rerank_slab(x, idx_slab, rid_slab, distance: str = "DistL2"):
    """Recompute distances of (rows, k) neighbour lists exactly in f32
    and restore ascending order."""
    from .distances import get_pair_fn
    pair_fn = get_pair_fn(distance)
    q = x[rid_slab]                       # (rows, d)
    xc = x[idx_slab]                      # (rows, k, d)
    d = pair_fn(q[:, None, :], xc)
    # a pad id (>= n) would gather-clamp to x[n-1] and re-enter with a
    # plausible finite distance; keep it inf so it sorts last
    d = jnp.where(idx_slab >= x.shape[0], jnp.inf, d)
    order = jnp.argsort(d, axis=1)
    return (jnp.take_along_axis(idx_slab, order, axis=1),
            jnp.maximum(jnp.take_along_axis(d, order, axis=1), 0.0))


def nndescent_refine(x, indices, dists, n_rounds: int = 2,
                     block_rows: int = 512, rev_capacity: int = 0,
                     distance: str = "DistL2", dtype: str = "float32",
                     rho: float = 1.0, seed: int = 0):
    """Refine (indices, dists) in place over n_rounds, in any of the
    five reference metrics (candidate scoring uses the metric's own
    pair form).  Work is dispatched in bounded row slabs
    (device-program time limit).

    ``dtype="bfloat16"`` scores candidates from a bf16 copy of x
    (halves the dominant (b, C, d) gather bytes) and exact-reranks the
    final lists in f32, so returned distances stay f32-exact.

    ``rho`` < 1 joins over an independent per-node, per-round random
    subset of the symmetrized neighbourhood (Dong's rho-sampling): the
    per-round candidate volume shrinks ~rho^2 at a modest per-round
    recall cost (see PERF.md round-3 measurements)."""
    x = jnp.asarray(x, jnp.float32)
    n, d = x.shape
    k = indices.shape[1]
    if rev_capacity <= 0:
        rev_capacity = k
    score_bf16 = dtype == "bfloat16"
    x_score = x.astype(jnp.bfloat16) if score_bf16 else x
    x_pad = jnp.concatenate(
        [x_score, jnp.zeros((1, d), x_score.dtype)], axis=0)
    u = k + rev_capacity
    s = u if rho >= 1.0 else max(2, int(round(rho * u)))
    cand_per_row = s * s + u
    # scale the slab down for large candidate sets
    slab = max(block_rows,
               _ROWS_PER_PROGRAM * 196 // max(cand_per_row, 196))
    slab -= slab % block_rows
    ids = jnp.arange(n, dtype=jnp.int32)
    key = jax.random.PRNGKey(seed + 1013)
    for rnd in range(n_rounds):
        # one padded union only (rows [:n] are the union itself) and
        # per-slab in-place updates of preallocated outputs: at 11M the
        # union copy + concat-accumulated slab outputs were ~2 GB of
        # avoidable peak HBM.  The union build is ONE jitted program:
        # run eagerly, _reverse_table's ~8 op-sized temporaries
        # (argsort/gather chains over n*k = 132M elements) all stay
        # live at once and OOM at 11M
        union_pp = _union_pp_impl(indices, rev_capacity, dists)
        if s < u:
            key, k_s = jax.random.split(key)
            inner_pp = _sample_union_pp(k_s, union_pp, s)
        else:
            inner_pp = union_pp
        out_i = jnp.zeros((n, k), jnp.int32)
        out_d = jnp.zeros((n, k), jnp.float32)
        for s0 in range(0, n, slab):
            s1 = min(s0 + slab, n)
            sl_pad = slab - (s1 - s0)
            ni, nd = _nndescent_slab(
                x_pad, inner_pp,
                jnp.pad(indices[s0:s1], ((0, sl_pad), (0, 0)),
                        constant_values=n),
                jnp.pad(dists[s0:s1], ((0, sl_pad), (0, 0))),
                jnp.pad(inner_pp[s0:s1], ((0, sl_pad), (0, 0)),
                        constant_values=n),
                jnp.pad(union_pp[s0:s1], ((0, sl_pad), (0, 0)),
                        constant_values=n),
                jnp.pad(ids[s0:s1], (0, sl_pad), constant_values=n),
                k, block_rows, distance)
            out_i = jax.lax.dynamic_update_slice(out_i, ni[:s1 - s0],
                                                 (s0, 0))
            out_d = jax.lax.dynamic_update_slice(out_d, nd[:s1 - s0],
                                                 (s0, 0))
            # serialize slabs (bounds in-flight join workspaces; see
            # knn/ivf.py)
            out_d.block_until_ready()
        indices, dists = out_i, out_d
    if score_bf16:
        # small slabs bound the (rows, k, d) gather of each program
        rr_slab = min(250_000, n)
        for s0 in range(0, n, rr_slab):
            s1 = min(s0 + rr_slab, n)
            pad_r = rr_slab - (s1 - s0)   # fixed shape: one compile
            ri, rd = _exact_rerank_slab(
                x,
                jnp.pad(indices[s0:s1], ((0, pad_r), (0, 0))),
                jnp.pad(ids[s0:s1], (0, pad_r)), distance)
            indices = jax.lax.dynamic_update_slice(
                indices, ri[:s1 - s0], (s0, 0))
            dists = jax.lax.dynamic_update_slice(
                dists, rd[:s1 - s0], (s0, 0))
            dists.block_until_ready()
    return indices, dists
