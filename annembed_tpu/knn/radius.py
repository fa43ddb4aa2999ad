"""Exact sampled radius search on 2-d embedded clouds.

The quality estimator's sampled path (estimators/quality.py) needs the
exact ``radius_k``-th neighbour distance of m sampled nodes against the
FULL embedded cloud (reference semantics: the radius comes from a real
search over all points, src/embedder.rs:527-554).  The chunked brute
search is exact but top-k-sort bound: at 11M x 200k x k=251 it was
longer than the embed it evaluates.

This module replaces it for d == 2 with a certificate-checked grid
search that returns IDENTICAL f32 distances:

  1. Partition the cloud with the strip-balanced equal-count grid
     (knn/ivf.py::_strip_grid_assign — the quality IVF path's
     quantizer) and physically sort the corpus by cell, y-minor, so
     every cell is a contiguous, y-ordered window.
  2. Each query gathers three CONTIGUOUS candidate spans: w_own cells
     of its own strip around its cell, and w_adj cells of each
     adjacent strip centred on its y value — block dynamic-slices of
     the sorted corpus, no random row gathers.
  3. Exact elementwise squared distances + top-k over the ~19-cell
     candidate set (a few thousand rows instead of n).
  4. EXACTNESS CERTIFICATE: the k-th candidate distance is exact iff
     it is strictly below the distance lower bound to every UNPROBED
     cell.  The bound is computed from per-strip x extrema and
     per-cell running y extrema (points of strip s' have
     x <= strip_max_x[s'], cells are y-ordered within a strip), so it
     is conservative under ties.  Queries whose certificate fails
     fall back to the exact brute search (knn/brute.py) — identical
     by construction.

Both paths produce the k-th distance as sqrt(sum((q - x)^2)) in f32
(brute exact-reranks DistL2 the same way), so certified rows are
bit-identical to the brute rows, not merely close; pinned by
tests/test_radius.py.
"""

from __future__ import annotations

import functools
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np

from .brute import knn_search_brute
from .ivf import _strip_grid_assign

logger = logging.getLogger(__name__)


@functools.partial(jax.jit, static_argnames=("g",))
def _grid_tables(y, g: int):
    """Cell-sorted corpus + the certificate's extremum tables.

    Returns (ys (n, 2) corpus sorted by (cell, y), cells (n,) cell id
    per ORIGINAL row, starts (g*g,), counts (g*g,), bounds (g, g-1),
    cummax_y / cummin_y (g, g) running per-cell y extrema along the
    y-cell axis (empty cells transparent), strip_cummax_x /
    strip_cummin_x (g,) running per-strip x extrema)."""
    n = y.shape[0]
    cells, bounds, _ = _strip_grid_assign(y, g)
    nlist = g * g
    counts = jnp.bincount(cells, length=nlist).astype(jnp.int32)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    iota = jnp.arange(n, dtype=jnp.int32)
    # sort by (cell, y): within a cell rows are y-ordered, so the
    # first/last member give the cell's y extrema
    _, _, order = jax.lax.sort((cells, y[:, 1], iota), num_keys=2)
    ys = y[order]

    nonempty = counts > 0
    first = jnp.clip(starts, 0, n - 1)
    last = jnp.clip(starts + counts - 1, 0, n - 1)
    cell_min_y = jnp.where(nonempty, ys[first, 1], jnp.inf)
    cell_max_y = jnp.where(nonempty, ys[last, 1], -jnp.inf)
    # running extrema along y-cells within each strip: the bound for
    # "all cells <= j" / "all cells >= j" must see through empty cells
    cummax_y = jax.lax.cummax(cell_max_y.reshape(g, g), axis=1)
    cummin_y = jax.lax.cummin(cell_min_y.reshape(g, g), axis=1,
                              reverse=True)

    # per-strip x extrema from the original array (strip of original
    # row i = cells[i] // g)
    strip_of = cells // g
    strip_max_x = jax.ops.segment_max(y[:, 0], strip_of, num_segments=g)
    strip_min_x = jax.ops.segment_min(y[:, 0], strip_of, num_segments=g)
    strip_cummax_x = jax.lax.cummax(strip_max_x)
    strip_cummin_x = jax.lax.cummin(strip_min_x, reverse=True)
    return (ys, cells, starts, counts, bounds, cummax_y, cummin_y,
            strip_cummax_x, strip_cummin_x)


@functools.partial(jax.jit, static_argnames=("k", "g", "w_own", "w_adj",
                                             "cap_cell"))
def _grid_query_dists(ys_pad, q, s, j, starts, counts, bounds,
                      cummax_y, cummin_y, strip_cummax_x,
                      strip_cummin_x, k: int, g: int, w_own: int,
                      w_adj: int, cap_cell: int):
    """Candidate top-k + certificate for one query block.

    q (m, 2) are the query coordinates, s/j (m,) their strip and
    y-cell.  Returns (dists (m, k) ascending exact L2, ok (m,) bool —
    True iff the k-th distance is certified exact)."""
    n_pad = ys_pad.shape[0]
    m = q.shape[0]
    ho, ha = w_own // 2, w_adj // 2
    cap_own = w_own * cap_cell
    cap_adj = w_adj * cap_cell

    def span(s_arr, jlo, jhi, valid):
        """Sorted-position span [start, end) of cells jlo..jhi of
        strip s_arr; empty when ``valid`` is False."""
        c_lo = jnp.clip(s_arr * g + jlo, 0, g * g - 1)
        c_hi = jnp.clip(s_arr * g + jhi, 0, g * g - 1)
        st = jnp.where(valid, starts[c_lo], 0)
        en = jnp.where(valid, starts[c_hi] + counts[c_hi], 0)
        return st, en

    # own strip: cells [j-ho, j+ho]
    jloA = jnp.clip(j - ho, 0, g - 1)
    jhiA = jnp.clip(j + ho, 0, g - 1)
    stA, enA = span(s, jloA, jhiA, jnp.ones_like(s, bool))

    # adjacent strips: window of w_adj cells centred on the query's y
    # value (per-strip boundaries differ, so centre by searchsorted)
    def adj_window(sp, valid):
        b_rows = bounds[jnp.clip(sp, 0, g - 1)]            # (m, g-1)
        jc = jax.vmap(
            lambda row, v: jnp.searchsorted(row, v))(b_rows, q[:, 1])
        jc = jc.astype(jnp.int32)
        jlo = jnp.clip(jc - ha, 0, g - 1)
        jhi = jnp.clip(jc + ha, 0, g - 1)
        st, en = span(sp, jlo, jhi, valid)
        return st, en, jlo, jhi

    validB = s - 1 >= 0
    stB, enB, jloB, jhiB = adj_window(s - 1, validB)
    validC = s + 1 <= g - 1
    stC, enC, jloC, jhiC = adj_window(s + 1, validC)

    iota_own = jnp.arange(cap_own, dtype=jnp.int32)
    iota_adj = jnp.arange(cap_adj, dtype=jnp.int32)

    def gather_span(st, en, cap, iota):
        stc = jnp.minimum(st, n_pad - cap)
        blk = jax.vmap(lambda s0: jax.lax.dynamic_slice(
            ys_pad, (s0, 0), (cap, 2)))(stc)               # (m, cap, 2)
        pos = stc[:, None] + iota[None, :]
        valid = (pos >= st[:, None]) & (pos < en[:, None])
        return blk, valid

    blkA, vA = gather_span(stA, enA, cap_own, iota_own)
    blkB, vB = gather_span(stB, enB, cap_adj, iota_adj)
    blkC, vC = gather_span(stC, enC, cap_adj, iota_adj)
    cand = jnp.concatenate([blkA, blkB, blkC], axis=1)     # (m, C, 2)
    valid = jnp.concatenate([vA, vB, vC], axis=1)          # (m, C)

    # expression shape matches knn/brute.py::_exact_l2_rerank exactly
    # (sum-of-squares reduction over the trailing axis) so certified
    # rows are bit-identical to the brute fallback's
    d2 = jnp.sum(jnp.square(q[:, None, :] - cand), axis=-1)
    d2 = jnp.where(valid, d2, jnp.inf)
    neg_d2, _ = jax.lax.top_k(-d2, k)
    dists = jnp.sqrt(jnp.maximum(-neg_d2, 0.0))            # (m, k) asc

    # --- certificate: distance lower bounds to every unprobed cell ---
    qx, qy = q[:, 0], q[:, 1]
    inf = jnp.full_like(qx, jnp.inf)

    def at(tab2d, rows, cols, valid):
        r = jnp.clip(rows, 0, g - 1)
        c = jnp.clip(cols, 0, g - 1)
        return jnp.where(valid, tab2d[r, c], jnp.nan)

    # strips <= s-2 (x <= strip_cummax_x[s-2]) / strips >= s+2
    lb_xm = jnp.where(s - 2 >= 0,
                      qx - strip_cummax_x[jnp.clip(s - 2, 0, g - 1)], inf)
    lb_xp = jnp.where(s + 2 <= g - 1,
                      strip_cummin_x[jnp.clip(s + 2, 0, g - 1)] - qx, inf)

    # own strip, y-cells below/above the window
    lb_yo_lo = jnp.where(jloA - 1 >= 0,
                         qy - at(cummax_y, s, jloA - 1, jloA - 1 >= 0),
                         inf)
    lb_yo_hi = jnp.where(jhiA + 1 <= g - 1,
                         at(cummin_y, s, jhiA + 1, jhiA + 1 <= g - 1)
                         - qy, inf)

    def adj_bounds(sp, valid, jlo, jhi, dx):
        dxc = jnp.maximum(dx, 0.0)
        dy_lo = qy - at(cummax_y, sp, jlo - 1, valid & (jlo - 1 >= 0))
        dy_hi = at(cummin_y, sp, jhi + 1,
                   valid & (jhi + 1 <= g - 1)) - qy
        lo = jnp.where(valid & (jlo - 1 >= 0),
                       jnp.sqrt(jnp.square(dxc)
                                + jnp.square(jnp.maximum(dy_lo, 0.0))),
                       inf)
        # if dy is already negative the y bound is vacuous: the true
        # lower bound degrades to the x term alone
        lo = jnp.where(valid & (jlo - 1 >= 0) & (dy_lo < 0.0), dxc, lo)
        hi = jnp.where(valid & (jhi + 1 <= g - 1),
                       jnp.sqrt(jnp.square(dxc)
                                + jnp.square(jnp.maximum(dy_hi, 0.0))),
                       inf)
        hi = jnp.where(valid & (jhi + 1 <= g - 1) & (dy_hi < 0.0), dxc,
                       hi)
        return jnp.minimum(lo, hi)

    # strip s-1: x <= strip_max_x[s-1] <= qx up to ties
    dx_m = qx - jnp.where(validB,
                          strip_cummax_x[jnp.clip(s - 1, 0, g - 1)], -jnp.inf)
    lb_B = jnp.where(validB, adj_bounds(s - 1, validB, jloB, jhiB, dx_m),
                     inf)
    dx_p = jnp.where(validC,
                     strip_cummin_x[jnp.clip(s + 1, 0, g - 1)], jnp.inf) - qx
    lb_C = jnp.where(validC, adj_bounds(s + 1, validC, jloC, jhiC, dx_p),
                     inf)

    margin = jnp.minimum(
        jnp.minimum(jnp.minimum(lb_xm, lb_xp),
                    jnp.minimum(lb_yo_lo, lb_yo_hi)),
        jnp.minimum(lb_B, lb_C))
    ok = dists[:, k - 1] < margin
    return dists, ok


def grid_radius_search(y, q_ids, k: int, w_own: int = 5, w_adj: int = 7,
                       query_block: int = 4096,
                       min_occupancy: int = 0,
                       keep_cols=None):
    """Exact k smallest L2 distances (self included) from the corpus
    points ``q_ids`` to the full 2-d corpus ``y``.

    Equivalent to ``knn_search_brute(y[q_ids], y, k)[1]`` — certified
    rows are bit-identical, uncertified rows (logged) are computed by
    that very search.  Returns (dists (m, k) f32 ascending,
    n_fallback).

    ``keep_cols`` (tuple of column indices) returns only those columns
    of the sorted distance row — the full-fraction quality path needs
    just the radius_k / radius_k_compat columns, and (n, k+1) would be
    ~11 GB at 11M x 251."""
    y = jnp.asarray(y, jnp.float32)
    n, d = y.shape
    if d != 2:
        raise ValueError(f"grid_radius_search needs d == 2 (got {d})")
    cols = None if keep_cols is None else jnp.asarray(keep_cols)
    occ = max(min_occupancy, 3 * k, 128)
    g = max(2, int(math.sqrt(n / occ)))
    if g < 4 or n < 4 * occ:
        _, sd = knn_search_brute(y[jnp.asarray(q_ids)], y, k=k)
        if cols is not None:
            sd = sd[:, cols]
        return sd, len(np.asarray(q_ids))

    (ys, cells, starts, counts, bounds, cummax_y, cummin_y,
     strip_cummax_x, strip_cummin_x) = _grid_tables(y, g)
    # static per-cell cap: strips hold <= ceil(n/g) rows, cells within
    # a strip differ by <= 1
    strip_max = -(-n // g)
    cap_cell = -(-strip_max // g) + 1
    ys_pad = jnp.pad(ys, ((0, max(w_own, w_adj) * cap_cell), (0, 0)))

    q_ids = jnp.asarray(q_ids, jnp.int32)
    qcells = cells[q_ids]
    s_all = qcells // g
    j_all = qcells % g
    q_all = y[q_ids]
    m = q_all.shape[0]

    sd_parts, ok_parts = [], []
    for i0 in range(0, m, query_block):
        i1 = min(i0 + query_block, m)
        blk = slice(i0, i1)
        if i1 - i0 < query_block and m > query_block:
            # pad the remainder block to reuse the compiled program
            pad = query_block - (i1 - i0)
            qb = jnp.pad(q_all[blk], ((0, pad), (0, 0)))
            sb = jnp.pad(s_all[blk], (0, pad))
            jb = jnp.pad(j_all[blk], (0, pad))
        else:
            pad = 0
            qb, sb, jb = q_all[blk], s_all[blk], j_all[blk]
        sd_b, ok_b = _grid_query_dists(
            ys_pad, qb, sb, jb, starts, counts, bounds, cummax_y,
            cummin_y, strip_cummax_x, strip_cummin_x, k, g, w_own,
            w_adj, cap_cell)
        sd_b.block_until_ready()
        if pad:
            sd_b, ok_b = sd_b[:i1 - i0], ok_b[:i1 - i0]
        if cols is not None:
            sd_b = sd_b[:, cols]
        sd_parts.append(sd_b)
        ok_parts.append(ok_b)
    sd = jnp.concatenate(sd_parts) if len(sd_parts) > 1 else sd_parts[0]
    ok = jnp.concatenate(ok_parts) if len(ok_parts) > 1 else ok_parts[0]

    ok_h = np.asarray(jax.device_get(ok))
    bad = np.nonzero(~ok_h)[0]
    n_fallback = int(bad.size)
    if n_fallback:
        logger.info("grid radius search: %d/%d queries uncertified, "
                    "exact brute fallback", n_fallback, m)
        _, sd_bad = knn_search_brute(y[q_ids[bad]], y, k=k)
        if cols is not None:
            sd_bad = sd_bad[:, cols]
        sd = sd.at[jnp.asarray(bad)].set(sd_bad)
    else:
        logger.info("grid radius search: all %d queries certified "
                    "exact (g=%d)", m, g)
    return sd, n_fallback
