"""Multi-device kNN graph construction: the graph build sharded over a
1-D ``data`` mesh.

SURVEY.md §2.3 maps "distance-matmul panels sharded row x column" as a
first-class component (reference analogue: parallel HNSW insertion,
examples/higgs.rs:446-458, src/fromhnsw/kgraph.rs:440).  The kNN build
is the largest 11M phase, and it is embarrassingly row-parallel:

  * brute: each device owns a row block of queries against the
    replicated corpus — identical math to knn/brute.py::_knn_impl
    (panel + top-k + exact L2 rerank), all five metrics;
  * IVF local join: virtual query rows sharded, the member/candidate
    tables and centroid neighbour lists replicated;
  * NN-descent: node rows sharded, the (sampled) symmetrized
    neighbourhood table replicated.

Everything reuses the single-chip table/quantizer builders with the
same seeds, so the sharded graph is IDENTICAL to the single-chip graph
(asserted by tests/test_parallel.py); only the distance joins fan out.
No collective is needed inside a join — each device writes its own row
block — so the only cross-device traffic is the replication of the
(n, k) results between slabs.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp

from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..params import KnnParams
from ..graph.kgraph import KGraph

logger = logging.getLogger(__name__)


def _pad_rows(a, rows, fill=0):
    pad = rows - a.shape[0]
    if pad <= 0:
        return a
    cfg = ((0, pad),) + ((0, 0),) * (a.ndim - 1)
    return jnp.pad(a, cfg, constant_values=fill)


# ---------------------------------------------------------------------------
# brute force
# ---------------------------------------------------------------------------

def sharded_knn_graph_brute(x, k: int, mesh: Mesh, distance: str = "DistL2",
                            block_rows: int = 1024,
                            dtype: str = "float32"):
    """Row-sharded exact kNN graph: every device computes the panels of
    its query rows against the replicated corpus.  The per-block body
    IS knn/brute.py::_block_topk (self mask, top-(k+extra), exact f32
    L2 rerank), so the result equals the
    single-chip graph by construction."""
    from ..knn.brute import _block_topk, _RERANK_EXTRA
    from ..knn.distances import get_panel_fn, corpus_sqnorm

    x = jnp.asarray(x, jnp.float32)
    n, d = x.shape
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    ndev = mesh.devices.size
    block_rows = min(block_rows, max(8, n))
    shard_rows = -(-n // (ndev * block_rows)) * block_rows
    xp = _pad_rows(x, ndev * shard_rows)
    panel_fn = get_panel_fn(distance)
    pdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rerank = distance == "DistL2"
    kk = min(k + _RERANK_EXTRA, n) if rerank else k

    def local(q_shard, corpus):
        rows = q_shard.shape[0]
        dev = jax.lax.axis_index("data")
        row0 = dev * rows
        x_sq = (corpus_sqnorm(corpus[:n])
                if distance in ("DistL2", "DistCosine") else None)
        blocks = rows // block_rows
        qb = q_shard.reshape(blocks, block_rows, d)
        ids = (row0 + jnp.arange(rows, dtype=jnp.int32)
               ).reshape(blocks, block_rows)

        def one(args):
            q, rid = args
            return _block_topk(q, corpus[:n], x_sq, k, kk, panel_fn,
                               pdtype, rerank, self_ids=rid)

        idx, dd = jax.lax.map(one, (qb, ids))
        return idx.reshape(rows, -1), dd.reshape(rows, -1)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("data", None), P(None, None)),
                   out_specs=(P("data", None), P("data", None)))
    idx, dist = jax.jit(fn)(xp, xp)
    return idx[:n, :k], jnp.maximum(dist[:n, :k], 0.0)


# ---------------------------------------------------------------------------
# IVF local join
# ---------------------------------------------------------------------------

def sharded_knn_graph_ivf(x, k: int, mesh: Mesh, distance: str = "DistL2",
                          nlist: int = 0, nprobe: int = 32,
                          dtype: str = "float32", kmeans_iter: int = 10,
                          seed: int = 0, sample_size: int = 500_000,
                          quantizer: str = "kmeans",
                          layout: str = "sorted"):
    """IVF local join with the virtual query rows sharded over the
    mesh.  Quantizer fit, cell assignment and table construction reuse
    the single-chip code with the same seeds (they are a small fraction
    of the build), so the output graph is identical to
    knn/ivf.py::knn_graph_ivf.  Both join layouts are served: "sorted"
    (cell-contiguous slices, the production default) and "gathered"
    (id tables)."""
    from ..knn.ivf import (_ivf_tables_impl, _ivf_join, _ivf_join_sorted,
                           _fixup_underfilled, _quantize_cells,
                           _knn_graph_ivf_sorted)

    x = jnp.asarray(x, jnp.float32)
    n, d = x.shape
    ndev = mesh.devices.size

    if distance == "DistCosine":
        xq = x / jnp.maximum(
            jnp.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    else:
        xq = x
    cells, cell_nbrs, nlist, cap, qcap, pad_cell = _quantize_cells(
        xq, k, nlist, nprobe, quantizer, seed, sample_size, kmeans_iter)
    nprobe = cell_nbrs.shape[1]

    if layout == "sorted":
        def local(xp, qt, qp, st, ct, cn):
            return _ivf_join_sorted(xp, qt, qp, st, ct, cn, k, qcap,
                                    cap, n, dtype, distance)

        fn = jax.jit(shard_map(
            local, mesh=mesh,
            in_specs=(P(), P("data"), P("data"), P(), P(), P()),
            out_specs=(P("data", None), P("data", None, None),
                       P("data", None, None))))

        def join_call(xp, qt, qp, st, ct):
            return fn(xp, qt, qp, st, ct, cell_nbrs)

        return _knn_graph_ivf_sorted(
            x, cells, cell_nbrs, pad_cell, n, d, k, nlist, cap, qcap,
            dtype, distance, join_call=join_call,
            slab_round=ndev)
    if layout != "gathered":
        raise ValueError(f"unknown IVF layout {layout!r}")

    v_static = nlist + n // qcap
    virt_table, virt_parent, cand_table, v_used = _ivf_tables_impl(
        cells, nlist, cap, qcap, v_static)
    if pad_cell:
        cand_table = jnp.concatenate(
            [cand_table, jnp.full((1, cap), n, jnp.int32)])
    x_pad = jnp.concatenate([x, jnp.zeros((1, d), x.dtype)], axis=0)

    def local(xp, vt, vp, ct, cn):
        return _ivf_join(xp, vt, vp, ct, cn, k, dtype, distance)

    fn = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P("data", None), P("data"), P(), P()),
        out_specs=(P("data", None, None), P("data", None, None))))

    v_total = int(v_used)
    # one device program stays in the seconds range; each slab is a
    # multiple of the mesh size so shards stay equal
    import os
    slab_budget = int(os.environ.get("ANNEMBED_IVF_SLAB_CANDROWS",
                                     20_000_000))
    rows_per_slab = min(max(8, slab_budget // max(cap * nprobe, 1)),
                        max(v_total, 1))     # clamp: no all-pad slabs
    rows_per_slab = -(-rows_per_slab // ndev) * ndev
    idx = jnp.zeros((n + 1, k), jnp.int32)
    dist = jnp.zeros((n + 1, k), jnp.float32)
    for s0 in range(0, v_total, rows_per_slab):
        s1 = min(s0 + rows_per_slab, v_total)
        vt = _pad_rows(virt_table[s0:s1], rows_per_slab, fill=n)
        vp = _pad_rows(virt_parent[s0:s1], rows_per_slab)
        it, dt = fn(x_pad, vt, vp, cand_table, cell_nbrs)
        members = vt.reshape(-1)
        idx = idx.at[members].set(it.reshape(-1, k), mode="drop")
        dist = dist.at[members].set(dt.reshape(-1, k), mode="drop")
        dist.block_until_ready()    # serialize slab workspaces
    return _fixup_underfilled(idx[:n], jnp.maximum(dist[:n], 0.0), n)


# ---------------------------------------------------------------------------
# NN-descent refinement
# ---------------------------------------------------------------------------

def sharded_nndescent_refine(x, indices, dists, mesh: Mesh,
                             n_rounds: int = 2, block_rows: int = 512,
                             rev_capacity: int = 0,
                             distance: str = "DistL2",
                             dtype: str = "float32", rho: float = 1.0,
                             seed: int = 0):
    """NN-descent with the per-round local join row-sharded over the
    mesh.  The symmetrized-neighbourhood table build and the rho
    sampling run replicated with the single-chip seeds, so the refined
    graph equals knn/nndescent.py::nndescent_refine."""
    from ..knn.nndescent import (_union_pp_impl, _sample_union_pp,
                                 _nndescent_slab, _exact_rerank_slab,
                                 _ROWS_PER_PROGRAM)

    x = jnp.asarray(x, jnp.float32)
    n, d = x.shape
    k = indices.shape[1]
    ndev = mesh.devices.size
    if rev_capacity <= 0:
        rev_capacity = k
    score_bf16 = dtype == "bfloat16"
    x_score = x.astype(jnp.bfloat16) if score_bf16 else x
    x_pad = jnp.concatenate(
        [x_score, jnp.zeros((1, d), x_score.dtype)], axis=0)
    u = k + rev_capacity
    s = u if rho >= 1.0 else max(2, int(round(rho * u)))
    cand_per_row = s * s + u
    slab = max(block_rows,
               _ROWS_PER_PROGRAM * 196 // max(cand_per_row, 196))
    slab = -(-slab // (ndev * block_rows)) * ndev * block_rows
    ids = jnp.arange(n, dtype=jnp.int32)
    key = jax.random.PRNGKey(seed + 1013)

    def local(xp, ip, i_sh, d_sh, u_sh, f_sh, r_sh):
        return _nndescent_slab(xp, ip, i_sh, d_sh, u_sh, f_sh, r_sh,
                               k, block_rows, distance)

    fn = jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P("data", None), P("data", None),
                  P("data", None), P("data", None), P("data")),
        out_specs=(P("data", None), P("data", None))))

    for _ in range(n_rounds):
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
            ni, nd = fn(
                x_pad, inner_pp,
                _pad_rows(indices[s0:s1], slab, fill=n),
                _pad_rows(dists[s0:s1], slab),
                _pad_rows(inner_pp[s0:s1], slab, fill=n),
                _pad_rows(union_pp[s0:s1], slab, fill=n),
                _pad_rows(ids[s0:s1], slab, fill=n))
            out_i = jax.lax.dynamic_update_slice(out_i, ni[:s1 - s0],
                                                 (s0, 0))
            out_d = jax.lax.dynamic_update_slice(out_d, nd[:s1 - s0],
                                                 (s0, 0))
            out_d.block_until_ready()
        indices, dists = out_i, out_d
    if score_bf16:
        rr_slab = -(-250_000 // ndev) * ndev

        def local_rr(xf, i_sh, r_sh):
            return _exact_rerank_slab(xf, i_sh, r_sh, distance)

        fn_rr = jax.jit(shard_map(
            local_rr, mesh=mesh,
            in_specs=(P(), P("data", None), P("data")),
            out_specs=(P("data", None), P("data", None))))
        for s0 in range(0, n, rr_slab):
            s1 = min(s0 + rr_slab, n)
            # pad rid with 0 (valid row) — padded outputs are dropped
            ri, rd = fn_rr(x, _pad_rows(indices[s0:s1], rr_slab),
                           _pad_rows(ids[s0:s1], rr_slab))
            indices = jax.lax.dynamic_update_slice(
                indices, ri[:s1 - s0], (s0, 0))
            dists = jax.lax.dynamic_update_slice(
                dists, rd[:s1 - s0], (s0, 0))
            dists.block_until_ready()
    return indices, dists


# ---------------------------------------------------------------------------
# dispatcher (the sharded twin of knn/api.py::build_kgraph)
# ---------------------------------------------------------------------------

def sharded_build_kgraph(x, knbn: int, mesh: Mesh,
                         distance: str = "DistL2",
                         params: KnnParams | None = None) -> KGraph:
    """Sharded twin of knn/api.py::build_kgraph: brute below the
    brute_force_limit, IVF + NN-descent above, with identical seeds and
    identical results — only the joins are distributed."""
    if params is None:
        params = KnnParams(knbn=knbn, distance=distance)
    n = x.shape[0]
    if n <= params.brute_force_limit:
        idx, dist = sharded_knn_graph_brute(
            x, knbn, mesh, distance=distance,
            block_rows=params.block_rows, dtype=params.dtype)
    else:
        kb = knbn
        if params.refine_rounds > 0 and params.build_k_factor > 1.0:
            kb = max(knbn + 1, int(round(knbn * params.build_k_factor)))
        idx, dist = sharded_knn_graph_ivf(
            x, kb, mesh, distance=distance, nlist=params.nlist,
            nprobe=params.nprobe, dtype=params.dtype,
            quantizer=params.quantizer, layout=params.ivf_layout)
        if params.refine_rounds > 0:
            idx, dist = sharded_nndescent_refine(
                x, idx, dist, mesh, n_rounds=params.refine_rounds,
                distance=distance, dtype=params.dtype,
                rho=params.nndescent_rho)
        idx, dist = idx[:, :knbn], dist[:, :knbn]
    return KGraph(indices=idx, dists=dist)
