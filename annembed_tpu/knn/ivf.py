"""IVF (inverted-file) approximate kNN for large n — the accelerator-side
replacement for HNSW graph construction at Higgs scale (11M points),
where the exact O(n^2 d) panel is unaffordable
(reference: hnsw_rs build is 25-45%% of wall-clock, README.md:92,131).

Strategy (cell-blocked local join):
  1. k-means coarse quantizer with ``nlist`` centroids.
  2. Padded member table M: (nlist, C) point ids per cell (C = max cell
     size, computed host-side once; pad id = n).
  3. For every cell c: its points are queried against the union of the
     points of the ``nprobe`` cells nearest to centroid c.  All queries
     of a cell share one (C, nprobe*C) distance matmul — large and
     batched — instead of per-query gathers.

Recall depends on (nlist, nprobe); defaults give >0.95 recall@10 on
clustered data (see tests/test_ivf.py), and can be driven to ~1 by
raising nprobe.  NN-descent refinement (knn/nndescent.py) pushes it
further.
"""

from __future__ import annotations

import functools
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np

from .distances import l2_panel, corpus_sqnorm
from .kmeans import kmeans_fit

logger = logging.getLogger(__name__)


def build_ivf_tables(cells: np.ndarray, nlist: int, n: int,
                     cap: int):
    """Query rows + candidate table with bounded shapes.

    Unbalanced quantizers (common for low-d data, e.g. 2-D embedded
    clouds where one cell can hold ~10%% of the points) make the naive
    (nlist, max_count) member table explode — the panel for one cell
    reached 122 GB on a 2M x 2D quality run.  Instead:
      * every cell's members are split into *virtual query rows* of at
        most ``cap`` points (all points are processed),
      * the candidate table keeps only the first ``cap`` members per
        cell (overflow drops candidates only; NN-descent refinement
        recovers the recall).
    Returns (virt_table (V, cap), virt_parent (V,), cand_table
    (nlist, cap)), padded with n.
    """
    counts = np.bincount(cells, minlength=nlist)
    order = np.argsort(cells, kind="stable")
    starts = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])

    cand_table = np.full((nlist, cap), n, dtype=np.int32)
    sorted_cells = cells[order]
    pos = np.arange(len(cells)) - starts[sorted_cells]
    keep = pos < cap
    cand_table[sorted_cells[keep], pos[keep]] = order[keep]

    n_virt_per_cell = np.maximum(1, -(-counts // cap))
    virt_parent = np.repeat(np.arange(nlist, dtype=np.int32),
                            n_virt_per_cell)
    v_total = int(n_virt_per_cell.sum())
    virt_table = np.full((v_total, cap), n, dtype=np.int32)
    virt_starts = np.zeros(nlist + 1, dtype=np.int64)
    np.cumsum(n_virt_per_cell, out=virt_starts[1:])
    virt_row = virt_starts[sorted_cells] + pos // cap
    virt_col = pos % cap
    virt_table[virt_row, virt_col] = order
    return virt_table, virt_parent, cand_table


@functools.partial(jax.jit, static_argnames=("nlist", "cap", "qcap",
                                             "v_static"))
def _ivf_tables_impl(cells, nlist: int, cap: int, qcap: int,
                     v_static: int):
    """Device-side equivalent of ``build_ivf_tables`` with STATIC
    shapes: ``v_static = nlist + n // qcap`` bounds the virtual-row
    count (each cell contributes max(1, ceil(count/qcap)) rows and
    sum(count // qcap) <= n // qcap).  Unused trailing rows hold only
    the pad id ``n`` and are dropped by the result scatter.

    ``qcap`` (query rows per virtual row) is decoupled from ``cap``
    (candidates kept per cell): the join panel is (qcap, nprobe*cap),
    so a smaller qcap bounds panel + top-k workspace memory WITHOUT
    dropping any candidates — at 11M points the (cap, nprobe*cap)
    panel with qcap == cap peaked past HBM.

    Everything stays on device: no cell assignment travels to the
    host and back.
    """
    n = cells.shape[0]
    counts = jnp.bincount(cells, length=nlist)               # (nlist,)
    order = jnp.argsort(cells)                               # stable
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    sorted_cells = cells[order]
    pos = (jnp.arange(n) - starts[sorted_cells]).astype(jnp.int32)
    order32 = order.astype(jnp.int32)

    keep = pos < cap
    cand_table = jnp.full((nlist, cap), n, jnp.int32).at[
        jnp.where(keep, sorted_cells, nlist), jnp.where(keep, pos, 0)
    ].set(order32, mode="drop")

    nvirt = jnp.maximum(1, -(-counts // qcap))
    vstarts = jnp.concatenate([jnp.zeros((1,), nvirt.dtype),
                               jnp.cumsum(nvirt)[:-1]])
    virt_row = (vstarts[sorted_cells] + pos // qcap).astype(jnp.int32)
    virt_table = jnp.full((v_static, qcap), n, jnp.int32).at[
        virt_row, pos % qcap].set(order32, mode="drop")
    # parent of row r = #cells whose first row is <= r (cumsum of
    # start markers for cells 1..nlist-1)
    marks = jnp.zeros((v_static,), jnp.int32).at[
        vstarts[1:].astype(jnp.int32)].add(1, mode="drop")
    virt_parent = jnp.cumsum(marks).astype(jnp.int32)
    return virt_table, virt_parent, cand_table, jnp.sum(nvirt)


@functools.partial(jax.jit, static_argnames=("nlist", "qcap", "v_static"))
def _ivf_rowplan_impl(cells, nlist: int, qcap: int, v_static: int):
    """Row plan for the CELL-SORTED join layout: instead of member/
    candidate id tables (whose per-row corpus gathers bound the join at
    0.01%% MFU — PERF.md roofline), the corpus is physically reordered
    by cell id once, after which every virtual query row and every
    candidate list is a CONTIGUOUS window of the sorted corpus.

    Returns (order (n,) sorted-pos -> original id, starts (nlist,),
    counts (nlist,), virt_parent (v_static,), qstarts (v_static,),
    v_used): virtual row r covers sorted positions
    [qstarts[r], qstarts[r] + qcap) of its parent cell (the trailing
    partial window is masked by the cell end, not padded)."""
    counts = jnp.bincount(cells, length=nlist).astype(jnp.int32)
    order = jnp.argsort(cells).astype(jnp.int32)            # stable
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    nvirt = jnp.maximum(1, -(-counts // qcap))
    vstarts = jnp.concatenate([jnp.zeros((1,), nvirt.dtype),
                               jnp.cumsum(nvirt)[:-1]])
    marks = jnp.zeros((v_static,), jnp.int32).at[
        vstarts[1:].astype(jnp.int32)].add(1, mode="drop")
    virt_parent = jnp.cumsum(marks).astype(jnp.int32)
    r = jnp.arange(v_static, dtype=jnp.int32)
    qstarts = (starts[virt_parent]
               + (r - vstarts[virt_parent].astype(jnp.int32)) * qcap)
    return order, starts, counts, virt_parent, qstarts, jnp.sum(nvirt)


@functools.partial(jax.jit, static_argnames=("k", "qcap", "cap", "n_real",
                                             "dtype_name", "distance"))
def _ivf_join_sorted(xs_pad, qstarts, qparents, starts, counts, cell_nbrs,
                     k: int, qcap: int, cap: int, n_real: int,
                     dtype_name: str, distance: str = "DistL2"):
    """Cell-sorted local join: gather-free except the tiny per-row
    bookkeeping.  ``xs_pad`` is the corpus REORDERED by cell id (plus
    zero pad rows up to max(n+1, cap, qcap)); queries are one
    ``dynamic_slice`` per virtual row, the nprobe candidate lists are
    nprobe contiguous (cap, d) block slices, and the L2 exact rerank
    reads from the in-register candidate block instead of the corpus.
    Replaces the per-row ``x_pad[cand]`` gather of ``_ivf_join``
    (nprobe*cap random corpus rows per virtual row, the measured
    bottleneck of the 11M graph build).

    ``starts``/``counts`` may carry one extra sentinel cell (count 0)
    for the grid quantizer's out-of-range probe id.  Returns
    (members, idx, dist) with members/idx in SORTED-position space
    (invalid members = n_real, the caller's drop row)."""
    from .distances import get_panel_fn
    n_rows, dfeat = xs_pad.shape
    dtype = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    panel_fn = get_panel_fn(distance)
    iota_q = jnp.arange(qcap, dtype=jnp.int32)
    iota_c = jnp.arange(cap, dtype=jnp.int32)

    def one_row(args):
        qs, parent = args                          # (), ()
        qs_c = jnp.clip(qs, 0, n_rows - qcap)
        q = jax.lax.dynamic_slice(xs_pad, (qs_c, 0), (qcap, dfeat))
        qpos = qs_c + iota_q                       # (qcap,)
        qend = starts[parent] + jnp.minimum(counts[parent],
                                            jnp.int32(n_real))
        qvalid = (qpos >= qs) & (qpos < qend) & (qpos < n_real)
        nbrs = cell_nbrs[parent]                   # (nprobe,)
        cs = starts[nbrs]                          # (nprobe,)
        cc = jnp.minimum(counts[nbrs], cap)
        cs_c = jnp.clip(cs, 0, n_rows - cap)
        xc = jax.vmap(lambda s: jax.lax.dynamic_slice(
            xs_pad, (s, 0), (cap, dfeat)))(cs_c)   # (nprobe, cap, d)
        cpos = (cs_c[:, None] + iota_c[None, :]).reshape(-1)
        cvalid = ((cpos >= jnp.repeat(cs, cap))
                  & (cpos < jnp.repeat(cs + cc, cap)))
        xc = xc.reshape(-1, dfeat)                 # (nprobe*cap, d)
        dist = panel_fn(q, xc, dtype=dtype)        # (qcap, nprobe*cap)
        invalid = ((~cvalid)[None, :]
                   | (cpos[None, :] == qpos[:, None])
                   | (~qvalid)[:, None])
        dist = jnp.where(invalid, jnp.inf, dist)
        neg_d, pos = jax.lax.top_k(-dist, k)
        idx = cpos[pos]                            # (qcap, k) sorted pos
        out_d = -neg_d
        if distance == "DistL2":
            # exact rerank (see _ivf_join) — from the small candidate
            # block already on hand, not the full corpus
            xc_sel = xc[pos]                       # (qcap, k, d)
            d_ex = jnp.sqrt(jnp.maximum(jnp.sum(jnp.square(
                q[:, None, :] - xc_sel), -1), 0.0))
            out_d = jnp.where(jnp.isinf(out_d), jnp.inf, d_ex)
            o = jnp.argsort(out_d, axis=1)
            out_d = jnp.take_along_axis(out_d, o, axis=1)
            idx = jnp.take_along_axis(idx, o, axis=1)
        members = jnp.where(qvalid, qpos, jnp.int32(n_real))
        return members, idx.astype(jnp.int32), out_d

    return jax.lax.map(one_row, (qstarts, qparents))


@functools.partial(jax.jit, static_argnames=("k", "dtype_name",
                                             "distance"))
def _ivf_join(x_pad, virt_table, virt_parent, cand_table, cell_nbrs,
              k: int, dtype_name: str, distance: str = "DistL2"):
    """For each virtual query row: exact kNN of its points within the
    probed cells' candidate lists (probe count = cell_nbrs.shape[1]).

    x_pad: (n+1, d) with a zero pad row.  Returns idx/dist
    (V, qcap, k) aligned with virt_table.
    """
    from .distances import get_panel_fn
    n = x_pad.shape[0] - 1
    dtype = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    panel_fn = get_panel_fn(distance)

    def one_row(args):
        members, parent = args                    # (qcap,), ()
        q = x_pad[members]                        # (qcap, d)
        nbrs = cell_nbrs[parent]                  # (nprobe,)
        cand = cand_table[nbrs].reshape(-1)       # (nprobe*cap,)
        xc = x_pad[cand]                          # (nprobe*cap, d)
        dist = panel_fn(q, xc, dtype=dtype)       # (qcap, nprobe*cap)
        invalid = (cand[None, :] == members[:, None]) | (cand[None, :] >= n)
        dist = jnp.where(invalid, jnp.inf, dist)
        neg_d, pos = jax.lax.top_k(-dist, k)
        idx = cand[pos]                           # (qcap, k)
        out_d = -neg_d
        if distance == "DistL2":
            # exact rerank of the selected values: the matmul panel
            # ||q||^2+||x||^2-2qx cancels catastrophically for tiny
            # distances (f32 noise ~1e-5 at coordinate magnitude ~10),
            # which zeroed small kNN radii on embedded 2-D clouds and
            # exploded the quality estimator's ratios
            xc_sel = x_pad[idx]                   # (qcap, k, d)
            d_ex = jnp.sqrt(jnp.maximum(jnp.sum(jnp.square(
                q[:, None, :] - xc_sel), -1), 0.0))
            out_d = jnp.where(jnp.isinf(out_d), jnp.inf, d_ex)
            # exact values can reorder panel near-ties: restore the
            # ascending-distance invariant
            order = jnp.argsort(out_d, axis=1)
            out_d = jnp.take_along_axis(out_d, order, axis=1)
            idx = jnp.take_along_axis(idx, order, axis=1)
        return idx.astype(jnp.int32), out_d

    return jax.lax.map(one_row, (virt_table, virt_parent))


def ivf_sizing(n: int, k: int, nlist: int = 0):
    """Shared IVF table sizing — the ONE place the heuristics live
    (consumed by knn_graph_ivf, the sharded twin, and the MFU
    microbench tool's FLOP accounting):
      * nlist: 4*sqrt(n) keeps cells small so the local join stays
        cheap; the recall lost to finer cells is recovered by the
        NN-descent refinement pass (knn/api.py wiring)
      * cap: candidates capped at 4x the average cell size
      * qcap: query rows bounded separately (memory only, not recall)
    Returns (nlist, cap, qcap)."""
    if nlist <= 0:
        nlist = max(64, int(4 * math.sqrt(n)))
    cap = max(k + 1, int(4 * n / nlist) + 1)
    qcap = min(cap, max(k + 1, 1024))
    return nlist, cap, qcap


@functools.partial(jax.jit, static_argnames=("g",))
def _strip_grid_assign(xq, g: int):
    """Strip-balanced 2-D partition: g equal-mass strips by rank of
    dim 0, then g equal-count cells by rank of dim 1 WITHIN each strip.
    Every cell holds ~n/g^2 points exactly, so cells never overflow the
    candidate cap and never come up empty (a plain per-dim quantile
    grid left near-empty joint cells in low-density corners, which
    starved their kNN rows).  Stays on device.

    Returns (cells (n,) int32, bounds (g, g-1) f32, counts (g,)):
    bounds[s, j-1] is the lower y-boundary of cell j in strip s (used
    by the host-side probe-table construction)."""
    n = xq.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    ord0 = jnp.argsort(xq[:, 0])
    rank0 = jnp.zeros((n,), jnp.int32).at[ord0].set(iota)
    # strip = rank // ceil(n/g): int32-safe for any n < 2^31 (a
    # rank*g product would overflow past n*g ~ 2^31); the last strip
    # may run slightly short — counts/bincount absorb the imbalance
    stripe = -(-n // g)
    strip = (rank0 // stripe).astype(jnp.int32)
    counts = jnp.bincount(strip, length=g).astype(jnp.int32)  # (g,)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    strip_s, y_s, idx_s = jax.lax.sort(
        (strip, xq[:, 1], iota), num_keys=2)
    pos = iota - starts[strip_s]            # < ceil(n/g) per strip
    cnt = jnp.maximum(counts[strip_s], 1)
    cell_y = (pos * g) // cnt               # pos*g <= n: int32-safe
    cells_sorted = strip_s * g + cell_y
    cells = jnp.zeros((n,), jnp.int32).at[idx_s].set(cells_sorted)
    # lower boundary of cell j (j in 1..g-1) in strip s: the y value at
    # the first position of that cell, ceil(j*count/g) into the strip
    j = jnp.arange(1, g, dtype=jnp.int32)[None, :]          # (1, g-1)
    bpos = starts[:, None] + -(-(j * counts[:, None]) // g)  # j*cnt <= n
    bounds = y_s[jnp.clip(bpos, 0, n - 1)]
    return cells, bounds, counts


def _strip_cell_neighbors(bounds: np.ndarray, g: int,
                          w: int = 5) -> np.ndarray:
    """Probe table for the strip-balanced partition: cell (s, j)
    probes (j-1, j, j+1) in its own strip plus up to ``w`` cells in
    each adjacent strip whose y-range overlaps its own (strips have
    independent y-boundaries, so the overlap window is found by
    searchsorted on the neighbour strip's bounds).  Out-of-range slots
    hold the sentinel id g^2 (the caller appends an all-pad candidate
    row); no probe id is duplicated.  Host-side: bounds is a tiny
    (g, g-1) array."""
    nlist = g * g
    probes = np.full((nlist, 3 + 2 * w), nlist, np.int32)
    for s in range(g):
        lo_b = np.concatenate([[-np.inf], bounds[s]])      # (g,)
        hi_b = np.concatenate([bounds[s], [np.inf]])
        for j in range(g):
            c = s * g + j
            col = 0
            for jj in (j - 1, j, j + 1):
                if 0 <= jj < g:
                    probes[c, col] = s * g + jj
                col += 1
            for side, sp in ((0, s - 1), (1, s + 1)):
                base = 3 + side * w
                if not (0 <= sp < g):
                    continue
                jlo = int(np.searchsorted(bounds[sp], lo_b[j],
                                          side="right"))
                jhi = int(np.searchsorted(bounds[sp], hi_b[j],
                                          side="right"))
                # widen by one on each side for boundary ties
                jlo = max(jlo - 1, 0)
                jhi = min(jhi + 1, g - 1)
                for t, jj in enumerate(range(jlo, min(jhi, jlo + w - 1)
                                             + 1)):
                    probes[c, base + t] = sp * g + jj
    return probes


def _quantize_cells(xq, k: int, nlist: int, nprobe: int, quantizer: str,
                    seed: int, sample_size: int, kmeans_iter: int):
    """Coarse-quantizer dispatch shared by the single-chip and sharded
    IVF builds.  Returns (cells, cell_nbrs, nlist, cap, qcap,
    pad_cell): ``pad_cell`` means cell_nbrs contains the sentinel id
    ``nlist`` and the caller must append one all-pad candidate row.

    quantizer="grid" (d == 2 only, e.g. the 2-D embedded cloud the
    quality estimator re-indexes): strip-balanced equal-count cells
    with overlap-mapped block probes (~13 probes replace the ~24-32
    nearest-centroid probes of the k-means quantizer at equal recall,
    and no k-means fit/assignment pass is needed at all).  The tiny
    (g, g-1) boundary readback is safe here: knn_graph_ivf already
    performs its documented one-int readback in the same phase."""
    n, d = xq.shape
    if quantizer == "grid":
        if d != 2:
            raise ValueError(
                f"grid quantizer supports exactly d == 2 (got d={d}); "
                "use quantizer='kmeans'")
        nlist0, _, _ = ivf_sizing(n, k, nlist)
        # keep cells big enough relative to k: the ~13-cell probe
        # window must comfortably contain the k-NN radius, so bound
        # occupancy below by ~3k (matters for small n / large k; at
        # 11M x k=100 the 4*sqrt(n) sizing already satisfies it)
        nlist0 = min(nlist0, max(4, n // (3 * k)))
        g = max(2, int(round(nlist0 ** 0.5)))
        nlist = g * g
        _, cap, qcap = ivf_sizing(n, k, nlist)
        cells, bounds, _ = _strip_grid_assign(xq, g)
        cell_nbrs = jnp.asarray(
            _strip_cell_neighbors(np.asarray(bounds), g))
        return cells, cell_nbrs, nlist, cap, qcap, True
    if quantizer != "kmeans":
        raise ValueError(f"unknown quantizer {quantizer!r}")
    nlist, cap, qcap = ivf_sizing(n, k, nlist)
    nprobe = min(nprobe, nlist)
    if n > sample_size:
        key = jax.random.PRNGKey(seed + 1)
        sub = xq[jax.random.choice(key, n, (sample_size,), replace=False)]
    else:
        sub = xq
    centroids, _ = kmeans_fit(sub, nlist, n_iter=kmeans_iter, seed=seed)
    from .kmeans import assign_to_centroids
    cells = assign_to_centroids(xq, centroids)   # stays on device
    # nearest cells per cell (self included first, exact centroid panel)
    c_sq = corpus_sqnorm(centroids)
    cd = l2_panel(centroids, centroids, c_sq)
    _, cell_nbrs = jax.lax.top_k(-cd, nprobe)
    return cells, cell_nbrs.astype(jnp.int32), nlist, cap, qcap, False


def knn_graph_ivf(x, k: int, distance: str = "DistL2", nlist: int = 0,
                  nprobe: int = 32, dtype: str = "float32",
                  kmeans_iter: int = 10, seed: int = 0,
                  sample_size: int = 500_000,
                  quantizer: str = "kmeans", layout: str = "sorted"):
    """Approximate kNN graph via IVF local join.  Returns (idx, dist).

    All five reference metrics are served (bin/embed.rs:546-565): the
    in-join distances use the metric's own panel; the coarse quantizer
    always partitions in L2 (on L2-normalized vectors for cosine,
    where it is exactly spherical k-means; for L1/Jeffreys/JS the L2
    partition is an approximation whose recall loss is recovered by
    the metric-aware NN-descent refinement, knn/api.py).

    ``quantizer="grid"`` (d <= 3) replaces the k-means cells with an
    equal-mass grid + block probes — see ``_quantize_cells``.

    ``layout="sorted"`` (default) physically reorders the corpus by
    cell id once so the join reads queries and candidates as contiguous
    slices (bit-identical results to ``layout="gathered"``, the
    id-table formulation whose per-row corpus gathers were the measured
    join bottleneck — PERF.md roofline).
    """
    x = jnp.asarray(x, jnp.float32)
    n, d = x.shape

    # quantizer space: L2-normalized vectors for cosine
    if distance == "DistCosine":
        xq = x / jnp.maximum(
            jnp.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    else:
        xq = x
    cells, cell_nbrs, nlist, cap, qcap, pad_cell = _quantize_cells(
        xq, k, nlist, nprobe, quantizer, seed, sample_size, kmeans_iter)
    nprobe = cell_nbrs.shape[1]

    if layout == "sorted":
        return _knn_graph_ivf_sorted(x, cells, cell_nbrs, pad_cell, n, d,
                                     k, nlist, cap, qcap, dtype, distance)
    if layout != "gathered":
        raise ValueError(f"unknown IVF layout {layout!r}")

    v_static = nlist + n // qcap
    virt_table, virt_parent, cand_table, v_used = _ivf_tables_impl(
        cells, nlist, cap, qcap, v_static)
    if pad_cell:
        # sentinel probe id nlist -> one all-pad candidate row
        cand_table = jnp.concatenate(
            [cand_table, jnp.full((1, cap), n, jnp.int32)])

    x_pad = jnp.concatenate([x, jnp.zeros((1, d), x.dtype)], axis=0)

    # dispatch the join in bounded virtual-row slabs: one device program
    # must stay in the seconds range (the runtime kills multi-minute
    # programs); a slab costs ~rows * cap * nprobe gather-rows.
    # Each slab's results scatter into the (n+1, k) output IMMEDIATELY
    # (pad id n drops into the sentinel row) — concatenating all slab
    # outputs first would hold (V, cap, k) idx+dist at once, 5.3 GB at
    # 11M points, the difference between fitting in HBM or not.
    # trim the trailing all-pad virtual rows before the slab loop:
    # v_static = nlist + n // qcap over-allocates by up to ~45% when
    # most cells hold fewer than qcap points (the padded rows would
    # each run a full (qcap, nprobe*cap) panel into the sentinel row).
    # (one int read back to the host)
    v_total = int(v_used)
    # clamp the memory-heuristic slab to the real row count: otherwise
    # a small v_total is padded up to the full slab and the join runs
    # hundreds of all-pad (qcap, nprobe*cap) panels into the sentinel
    import os
    slab_budget = int(os.environ.get("ANNEMBED_IVF_SLAB_CANDROWS",
                                     20_000_000))
    rows_per_slab = min(max(8, slab_budget // max(cap * nprobe, 1)),
                        max(v_total, 1))
    idx = jnp.zeros((n + 1, k), jnp.int32)
    dist = jnp.zeros((n + 1, k), jnp.float32)
    for s0 in range(0, v_total, rows_per_slab):
        s1 = min(s0 + rows_per_slab, v_total)
        pad_r = rows_per_slab - (s1 - s0)
        vt = jnp.pad(virt_table[s0:s1], ((0, pad_r), (0, 0)),
                     constant_values=n)
        vp = jnp.pad(virt_parent[s0:s1], (0, pad_r))
        it, dt = _ivf_join(x_pad, vt, vp, cand_table, cell_nbrs, k,
                           dtype, distance)
        members = vt.reshape(-1)
        idx = idx.at[members].set(it.reshape(-1, k), mode="drop")
        dist = dist.at[members].set(dt.reshape(-1, k), mode="drop")
        # serialize slabs: without this the runtime keeps several slab
        # joins in flight at once and their panel+top-k workspaces
        # (~1 GB each) sum past HBM at 11M points
        dist.block_until_ready()
    return _fixup_underfilled(idx[:n], jnp.maximum(dist[:n], 0.0), n)


def _knn_graph_ivf_sorted(x, cells, cell_nbrs, pad_cell: bool, n: int,
                          d: int, k: int, nlist: int, cap: int, qcap: int,
                          dtype: str, distance: str, join_call=None, slab_round: int = 1):
    """Slab driver for the cell-sorted join layout (see
    ``_ivf_join_sorted``).  Same slab/memory discipline as the gathered
    path: bounded virtual-row slabs, immediate scatter into the (n+1, k)
    output, per-slab sync.  The join runs entirely in sorted-position
    space; one final relabeling pass returns original ids/rows.

    ``join_call(xs_pad, qt, qp, starts, counts) -> (members, idx, dist)``
    lets parallel/sharded_knn.py substitute a shard_map'd join (virtual
    rows sharded over the mesh, tables replicated); ``slab_round`` keeps
    slab sizes a multiple of the mesh size."""
    import os
    v_static = nlist + n // qcap
    order32, starts, counts, virt_parent, qstarts, v_used = \
        _ivf_rowplan_impl(cells, nlist, qcap, v_static)
    if pad_cell:
        # sentinel probe id nlist -> empty cell (count 0)
        starts = jnp.concatenate([starts, jnp.full((1,), n, jnp.int32)])
        counts = jnp.concatenate([counts, jnp.zeros((1,), jnp.int32)])

    xs = x[order32]                                # one-time reorder
    n_rows = max(n + 1, cap, qcap)
    xs_pad = jnp.concatenate(
        [xs, jnp.zeros((n_rows - n, d), x.dtype)], axis=0)
    if join_call is None:
        def join_call(xp, qt, qp, st, ct):
            return _ivf_join_sorted(xp, qt, qp, st, ct, cell_nbrs, k,
                                    qcap, cap, n, dtype, distance)

    v_total = int(v_used)                          # documented readback
    nprobe = cell_nbrs.shape[1]
    slab_budget = int(os.environ.get("ANNEMBED_IVF_SLAB_CANDROWS",
                                     20_000_000))
    rows_per_slab = min(max(8, slab_budget // max(cap * nprobe, 1)),
                        max(v_total, 1))
    rows_per_slab = -(-rows_per_slab // slab_round) * slab_round
    idx = jnp.zeros((n + 1, k), jnp.int32)
    dist = jnp.zeros((n + 1, k), jnp.float32)
    for s0 in range(0, v_total, rows_per_slab):
        s1 = min(s0 + rows_per_slab, v_total)
        pad_r = rows_per_slab - (s1 - s0)
        # pad rows: qstart = n_rows makes every query position invalid
        qt = jnp.pad(qstarts[s0:s1], (0, pad_r), constant_values=n_rows)
        qp = jnp.pad(virt_parent[s0:s1], (0, pad_r))
        members, it, dt = join_call(xs_pad, qt, qp, starts, counts)
        idx = idx.at[members.reshape(-1)].set(it.reshape(-1, k),
                                              mode="drop")
        dist = dist.at[members.reshape(-1)].set(dt.reshape(-1, k),
                                                mode="drop")
        dist.block_until_ready()                  # serialize slabs
    idx_s, dist_s = _fixup_underfilled(
        idx[:n], jnp.maximum(dist[:n], 0.0), n)
    # sorted-position space -> original labels: row r holds point
    # order32[r]; neighbour values are sorted positions
    idx_o = jnp.zeros_like(idx_s).at[order32].set(order32[idx_s])
    dist_o = jnp.zeros_like(dist_s).at[order32].set(dist_s)
    return idx_o, dist_o


def _fixup_underfilled(idx, dist, n: int):
    """Repair rows whose probed cells held < k valid candidates: they
    carry the pad id n at dist = inf, and an out-of-range id crashes
    numpy consumers (and silently clamps in jax).  Valid entries are an
    ascending prefix, so duplicating the row's LAST valid neighbour
    preserves the sorted invariant; a row with no valid candidate at
    all falls back to (i+1) % n at a huge finite distance (its
    downstream edge weight ~ 0, and NN-descent refinement repairs it)."""
    bad = (idx >= n) | jnp.isinf(dist)
    nvalid = jnp.sum(~bad, axis=1)
    last = jnp.maximum(nvalid - 1, 0)[:, None]
    fb_i = jnp.take_along_axis(idx, last, 1)
    fb_d = jnp.take_along_axis(dist, last, 1)
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    none_valid = (nvalid == 0)[:, None]
    fb_i = jnp.where(none_valid, (rows + 1) % n, fb_i)
    fb_d = jnp.where(none_valid, jnp.float32(1e30), fb_d)
    return jnp.where(bad, fb_i, idx), jnp.where(bad, fb_d, dist)
