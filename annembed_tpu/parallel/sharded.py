"""Multi-device sharding of the embedding pipeline.

The reference is single-node shared-memory (rayon + Hogwild,
SURVEY.md §2.3); the scaling axis here is a 1-D ``data`` mesh:

  * kNN construction: query rows sharded across devices, the corpus
    replicated (or streamed); each device computes its row panel and
    top-k locally — no collective needed for the graph itself
    (the matmul analogue of context parallelism).
  * CE optimization: positive edges sharded across devices; the
    (n, dim) embedding is replicated (it is tiny: n x 2..15 floats).
    Each device samples its own mini-batch from its edge shard,
    computes scatter-add deltas, and a ``psum`` merges them —
    synchronous data-parallel SGD.
  * Laplacian degrees / row sums: segment-sum of the local COO shard
    followed by psum (not yet needed at current sizes).

All collectives are inserted by XLA from ``shard_map`` annotations.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import mesh_utils
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
from jax import shard_map

from ..optim.ce import EdgeSet, NB_NEGATIVE, _common_coeff
from ..params import PROBA_MIN


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    if axis != "data":
        # every sharded function in this module addresses the axis by
        # the literal name "data" (axis_index/PartitionSpec)
        raise ValueError("this module requires the mesh axis name 'data'")
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    grid = mesh_utils.create_device_mesh((n_devices,), devs[:n_devices])
    return Mesh(grid, (axis,))


# ---------------------------------------------------------------------------
# sharded kNN
# ---------------------------------------------------------------------------

def sharded_knn_graph(x, k: int, mesh: Mesh, block_rows: int = 1024):
    """Row-sharded exact kNN (thin alias of the production
    sharded_knn_graph_brute, which carries the top-(k+extra) + exact
    f32 L2 rerank that guards against bf16/f32 panel cancellation)."""
    from .sharded_knn import sharded_knn_graph_brute
    return sharded_knn_graph_brute(jnp.asarray(x, jnp.float32), k, mesh,
                                   block_rows=block_rows)


# ---------------------------------------------------------------------------
# sharded CE training step
# ---------------------------------------------------------------------------

def _local_delta(y, key, src, dst, weight, local_cdf, neighbors,
                 emb_scale, grad_step, b: float, batch_size: int):
    """Delta contribution of one device's edge shard (the body of the
    reference hot loop, embedder.rs:1167-1302, in batched form)."""
    n = y.shape[0]
    k_edge, k_neg = jax.random.split(key)
    u = jax.random.uniform(k_edge, (batch_size,))
    eidx = jnp.minimum(jnp.searchsorted(local_cdf, u),
                       local_cdf.shape[0] - 1)
    i = src[eidx]
    j = dst[eidx]
    w = weight[eidx]
    # draws that land on zero-weight PADDING edges (a shard whose rows
    # are all padding has an all-zero cdf, so every draw clamps there)
    # must be complete no-ops: without this mask the pad edge (0, 0, 0)
    # still fired batch_size * NB_NEGATIVE repulsion kicks at node 0
    valid = w > 0.0
    yi, yj = y[i], y[j]
    scale = emb_scale[i]
    d2s = jnp.sum(jnp.square(yi - yj), -1) / jnp.square(scale)
    coeff = _common_coeff(d2s, scale, b)
    rep_att = 1.0 / jnp.maximum(jnp.square(d2s), 1.0 / PROBA_MIN)
    coeff_ij = jnp.maximum(grad_step * coeff * (-w + (1 - w) * rep_att),
                           -0.49)
    coeff_ij = jnp.where((d2s > 0) & valid, coeff_ij, 0.0)
    g_att = (yj - yi) * coeff_ij[:, None]

    neg = jax.random.randint(k_neg, (batch_size, NB_NEGATIVE), 0, n,
                             dtype=jnp.int32)
    nbrs = neighbors[i]
    reject = ((neg == i[:, None]) | (neg == j[:, None])
              | (neg[:, :, None] == nbrs[:, None, :]).any(-1))
    yk = y[neg]
    d2k = jnp.sum(jnp.square(yi[:, None, :] - yk), -1) \
        / jnp.square(scale)[:, None]
    coeff_k = _common_coeff(d2k, scale[:, None], b)
    rep = 1.0 / jnp.maximum(jnp.square(d2k), 1.0 / 16.0)
    coeff_ik = jnp.minimum(grad_step * coeff_k * rep, 2.0)
    coeff_ik = jnp.where((d2k > 0) & ~reject & valid[:, None],
                         coeff_ik, 0.0)
    g_rep = (yk - yi[:, None, :]) * coeff_ik[:, :, None]

    delta = jnp.zeros_like(y)
    delta = delta.at[i].add(-(g_att + g_rep.sum(1)))
    delta = delta.at[j].add(g_att)
    return delta


def make_sharded_train_step(mesh: Mesh, b: float = 1.0,
                            batch_size_per_device: int = 1024):
    """SEMANTICS CHECK, not the production path: a minimal
    data-parallel form of the per-sample (sampling) optimizer, kept as
    a readable reference + dryrun smoke of edge-sharded psum training.
    The production multi-chip optimizer is ``sharded_dense_optimize``.

    Build a jitted data-parallel CE step over the mesh.

    The embedding y is replicated; src/dst/weight/cdf are edge shards
    (each device's cdf is its local cumulative weight, so sampling is
    stratified by shard); the per-device deltas are psum-merged.
    """

    def step(y, key, src, dst, weight, local_cdf, neighbors, emb_scale,
             grad_step):
        dev = jax.lax.axis_index("data")
        key = jax.random.fold_in(key, dev)
        delta = _local_delta(y, key, src, dst, weight, local_cdf,
                             neighbors, emb_scale, grad_step, b,
                             batch_size_per_device)
        delta = jax.lax.psum(delta, "data")
        return y + delta

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(), P("data"), P("data"), P("data"), P("data"),
                  P(), P(), P()),
        out_specs=P())
    return jax.jit(fn)


def make_sharded_dense_step(mesh: Mesh, b: float = 1.0, n_neg: int = 10):
    """SEMANTICS CHECK, not the production path: one dense sweep in
    row-major layout with a full per-call permutation — the exact
    pattern PERF.md measured 25x slower than the rolled identity pool.
    Kept as a readable scatter-based reference for parity testing; the
    production multi-chip optimizer is ``sharded_dense_optimize``.

    Data-parallel dense sweep: node rows (and their (n, k) edge
    table) sharded across the mesh, the (n, d) embedding replicated.

    Each device computes the attraction of its row shard (self moves +
    reverse contributions gathered from the replicated y) and its rows'
    pool repulsion; the per-device deltas are psum-merged.
    Inputs per device: row0 (1,) first global row of the shard;
    indices/w/m_visit/w_rev/m_rev: (n/ndev, k) shards; emb_scale and y
    replicated."""
    from ..optim.dense import _clipped_alpha

    def step(y, key, row0, indices, w, m_visit, w_rev, m_rev, emb_scale,
             gamma):
        n, d = y.shape
        m_rows, k = indices.shape
        dev = jax.lax.axis_index("data")
        kk = jax.random.fold_in(key, dev)
        r0 = row0[0]
        yi_rows = jax.lax.dynamic_slice(y, (r0, 0), (m_rows, d))
        scale_i = jax.lax.dynamic_slice(emb_scale, (r0,), (m_rows,))

        # attraction (pair-shared closed form, optim/dense.py)
        yi = yi_rows[:, None, :]
        yj = y[indices]
        scale_j = emb_scale[indices]
        d2 = jnp.sum(jnp.square(yi - yj), -1)
        a_f = _clipped_alpha(d2 / jnp.square(scale_i[:, None]),
                             scale_i[:, None], w, gamma, b)
        a_r = _clipped_alpha(d2 / jnp.square(scale_j), scale_j, w_rev,
                             gamma, b)
        f_pair = jnp.power(jnp.clip(1 - 2 * a_f, 1e-3, 1.05), m_visit) \
            * jnp.power(jnp.clip(1 - 2 * a_r, 1e-3, 1.05), m_rev)
        share = m_visit / jnp.maximum(m_visit + m_rev, 1e-30)
        net = share * (1.0 - f_pair) * 0.5
        step_vec = (yj - yi) * net[:, :, None]

        # repulsion from the permuted pool (contiguous slices)
        k_perm, k_off = jax.random.split(kk)
        perm = jax.random.permutation(k_perm, n)
        y_pool = y[perm]
        offset = jax.random.randint(k_off, (), 0, n)
        pos = (r0 * n_neg + jnp.arange(m_rows * n_neg) + offset) % n
        neg_ids = perm[pos].reshape(m_rows, n_neg)
        yk = y_pool[pos].reshape(m_rows, n_neg, d)
        gids = r0 + jnp.arange(m_rows, dtype=neg_ids.dtype)
        reject = (neg_ids == gids[:, None]) \
            | (neg_ids[:, :, None] == indices[:, None, :]).any(-1)
        d2k = jnp.sum(jnp.square(yi - yk), -1) / jnp.square(scale_i)[:, None]
        coeff_k = _common_coeff(d2k, scale_i[:, None], b)
        rep = 1.0 / jnp.maximum(jnp.square(d2k), 1.0 / 16.0)
        coeff_ik = jnp.minimum(gamma * coeff_k * rep, 2.0)
        coeff_ik = jnp.where((d2k > 0) & ~reject, coeff_ik, 0.0)
        d_neg = jnp.sum((yi - yk) * coeff_ik[:, :, None], axis=1)

        delta = jnp.zeros_like(y)
        delta = jax.lax.dynamic_update_slice(
            delta, jnp.sum(step_vec, axis=1) + d_neg, (r0, 0))
        delta = delta.at[indices.reshape(-1)].add(
            -step_vec.reshape(-1, d))
        return y + jax.lax.psum(delta, "data")

    fn = shard_map(step, mesh=mesh,
                   in_specs=(P(), P(), P("data"), P("data", None),
                             P("data", None), P("data", None),
                             P("data", None), P("data", None), P(), P()),
                   out_specs=P())
    return jax.jit(fn)


def shard_dense_inputs(g, npar, params, mesh: Mesh):
    """Build + device_put the sharded dense-step inputs.  Requires n
    divisible by the mesh size (pad upstream if needed)."""
    import numpy as _np
    from ..optim.dense import reverse_edge_info
    from ..optim.ce import embedded_scales_from_initial

    n, k = g.indices.shape
    ndev = mesh.devices.size
    assert n % ndev == 0, "pad n to a multiple of the mesh size"
    w = npar.probas.astype(jnp.float32)
    w_rev = reverse_edge_info(g.indices, w)
    n_sub = params.n_sub
    m_visit = params.nb_sampling_by_edge * k * w / n_sub
    m_rev = params.nb_sampling_by_edge * k * w_rev / n_sub
    emb_scale = embedded_scales_from_initial(npar.scale)
    row0 = jnp.asarray(_np.arange(ndev, dtype=_np.int32) * (n // ndev))

    sh = NamedSharding(mesh, P("data"))
    sh2 = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())
    return (jax.device_put(row0, sh),
            jax.device_put(g.indices, sh2), jax.device_put(w, sh2),
            jax.device_put(m_visit, sh2), jax.device_put(w_rev, sh2),
            jax.device_put(m_rev, sh2), jax.device_put(emb_scale, rep))


def shard_edge_set(es: EdgeSet, mesh: Mesh):
    """Pad + device-put the edge arrays along the mesh; returns the
    tuple consumed by the sharded train step."""
    ndev = mesh.devices.size
    e = es.nb_edges
    if e < ndev:
        # degenerate: fewer edges than devices (all-pad shards would
        # merely waste their draws — _local_delta masks pad-edge draws
        # to no-ops — but such an EdgeSet is a caller bug)
        raise ValueError(f"need at least one edge per device "
                         f"({e} edges, {ndev} devices)")
    pad = (-e) % ndev
    src = jnp.pad(es.src, (0, pad))
    dst = jnp.pad(es.dst, (0, pad))
    w = jnp.pad(es.weight, (0, pad))
    shard_len = (e + pad) // ndev

    # per-shard cumulative weights (stratified sampling)
    w2 = w.reshape(ndev, shard_len)
    cdf = jnp.cumsum(w2, axis=1)
    cdf = cdf / jnp.maximum(cdf[:, -1:], 1e-30)
    cdf = cdf.reshape(-1)

    sharding = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    return (jax.device_put(src, sharding), jax.device_put(dst, sharding),
            jax.device_put(w, sharding), jax.device_put(cdf, sharding),
            jax.device_put(es.neighbors, rep),
            jax.device_put(es.embedded_scale, rep))


def make_sharded_dense_segment(mesh: Mesh, b: float, n_sub: int,
                               n_neg: int, nb_grad_batch: int,
                               n_groups: int, grad_step_init: float,
                               f_min: float, mask_p: float,
                               seg_steps: int, batch0: int = 0,
                               use_rot0: bool = False,
                               packed_gather: bool = False,
                               parallel_kicks: bool = False,
                               gather_reuse: int = 1):
    """One jitted multi-sweep segment of the PRODUCTION dense schedule,
    row-sharded over the mesh.

    The exact optim/dense.py formulation — column-grouped scatter-free
    attraction (closure floor + bernoulli edge masks) and the per-kick
    rolled identity-pool repulsion with sequential kicks — runs per row
    shard under ``lax.scan`` inside ONE program; each half-sweep the
    updated row blocks travel in one ``all_gather`` (the embedding
    is replicated, (dim, n) floats: tiny next to the sweep compute).
    Everything is laid out TRANSPOSED (feature-minor, n last) exactly
    like the single-chip production path.  Each kick's negative pool is a CONTIGUOUS window of the
    replicated embedding (positions [r0 + s_t, r0 + m + s_t) mod n), so
    repulsion stays gather-free on every device.

    ``batch0``/``rot0``/``use_rot0`` carry n_sub SCHEDULE phases
    exactly like optim/dense.py::_dense_segment: gamma decays at batch
    ``batch0 + step//n_sub + 1`` of the GLOBAL nb_grad_batch schedule,
    and the column-group rotation follows the global sweep counter
    ``rot0 + local`` when scheduled.  ``packed_gather`` routes the
    neighbour gather through a complex64 lane pack at d=2, bit-exact
    (see optim/dense.py::_attraction_sweep_sfT)."""
    from ..optim.dense import (_attraction_sweep_sfT, _repulsion_kick_T,
                               _neighbor_rejection)

    def local(y0, indices, w, m_visit, w_rev, m_rev, emb_scale,
              neg_weight, keys, step0, rot0):
        n, dim = y0.shape
        m_rows, k = indices.shape
        assert k % n_groups == 0, (k, n_groups)   # else columns drop
        kg = k // n_groups
        dev = jax.lax.axis_index("data")
        r0 = dev * m_rows
        stride = max(1, n // n_neg)

        # transposed per-shard constants (built once per segment):
        # neighbour ids/weights/multiplicities (kg, m) and the
        # PRE-GATHERED neighbour scales
        idxT_full = indices.T                           # (k, m) global ids
        scale_iT = jax.lax.dynamic_slice(emb_scale, (r0,),
                                         (m_rows,))[None, :]   # (1, m)
        groups = []
        for c in range(n_groups):
            sl = slice(c * kg, (c + 1) * kg)
            idx_g = indices[:, sl]
            groups.append(dict(
                idxT=idx_g.T, wT=w[:, sl].T, mT=m_visit[:, sl].T,
                w_revT=w_rev[:, sl].T, m_revT=m_rev[:, sl].T,
                scale_jT=emb_scale[idx_g].T))

        def make_branch(c, yj_by_group=None):
            gd = groups[c]

            def branch(yT, gamma, mask):
                # yT replicated (dim, n); own rows (dim, m).  The
                # formula lives in optim/dense.py::_attraction_sweep_sfT
                # (y_ownT = this device's block, gathers from the
                # replicated snapshot) — single source, no drift.
                yiT = jax.lax.dynamic_slice(yT, (0, r0), (dim, m_rows))
                yz = (jax.lax.complex(yT[0], yT[1])
                      if packed_gather and dim == 2 else None)
                delta = _attraction_sweep_sfT(
                    yT, gd["idxT"], gd["wT"], gd["mT"], gd["w_revT"],
                    gd["m_revT"], scale_iT, gd["scale_jT"], gamma, b,
                    f_min=f_min, mask=mask, mask_p=mask_p, y_ownT=yiT,
                    yzT=yz,
                    yjT=(None if yj_by_group is None
                         else yj_by_group[c]))
                return yiT + delta

            return branch

        branches = [make_branch(c) for c in range(n_groups)]

        def gather_rows(rowsT):
            return jax.lax.all_gather(rowsT, "data", axis=1, tiled=True)

        pos_local = jnp.arange(m_rows, dtype=jnp.int32)

        def body(yT, args, yj_by_group=None):
            local_idx, kk = args
            step_idx = step0 + local_idx
            batch_idx = batch0 + step_idx // n_sub + 1
            gamma = jnp.maximum(
                grad_step_init * (1.0 - batch_idx.astype(jnp.float32)
                                  / nb_grad_batch), 0.0)
            if mask_p < 1.0:
                kk, k_mask = jax.random.split(kk)
                mask = jax.random.bernoulli(
                    jax.random.fold_in(k_mask, dev), mask_p,
                    (kg, m_rows)).astype(jnp.float32)
            else:
                mask = None
            rot = (rot0 + local_idx if use_rot0 else step_idx) % n_groups
            brs = (branches if yj_by_group is None else
                   [make_branch(c, yj_by_group)
                    for c in range(n_groups)])
            rowsT = jax.lax.switch(rot, brs, yT, gamma, mask)
            yT = gather_rows(rowsT)

            # repulsion: per-kick contiguous window of the replicated
            # embedding (single-chip _repulsion_sweep_rolledT semantics;
            # shared kick formula _repulsion_kick_T).  Everything that
            # does not depend on the sequentially-updated yiT is
            # batched into one op per sweep — shifts (n_neg,), partner
            # ids and rejection masks (n_neg, m) — mirroring the
            # op-overhead fix the single-chip path carries.
            offset = jax.random.randint(kk, (), 0, n)
            ycat = jnp.concatenate([yT, yT], axis=1)       # (dim, 2n)
            nwcat = jnp.concatenate([neg_weight, neg_weight])
            yiT = jax.lax.dynamic_slice(yT, (0, r0), (dim, m_rows))
            shifts = (offset + stride
                      * jnp.arange(n_neg, dtype=jnp.int32)) % n
            nid_all = (r0 + pos_local[None, :] + shifts[:, None]) % n
            ok_all = (nid_all != (r0 + pos_local)[None, :]) \
                & jnp.logical_not(_neighbor_rejection(
                    r0 + pos_local, idxT_full, shifts, n, n_neg))
            if parallel_kicks:
                # stacked kicks against the snapshot (identical math to
                # optim/dense.py::_repulsion_block_T parallel path, so
                # single-chip parity holds bit-for-bit when both flags
                # are set)
                from ..optim.ce import _common_coeff
                yk = jnp.stack([
                    jax.lax.dynamic_slice(ycat, (0, (r0 + shifts[t]) % n),
                                          (dim, m_rows))
                    for t in range(n_neg)])        # (n_neg, dim, m)
                nw = jnp.stack([
                    jax.lax.dynamic_slice(nwcat, ((r0 + shifts[t]) % n,),
                                          (m_rows,))
                    for t in range(n_neg)])[:, None, :]
                yi0 = yiT[None]
                scale3 = scale_iT[None]
                d2s = (jnp.sum(jnp.square(yi0 - yk), 1, keepdims=True)
                       / jnp.square(scale3))
                coeff = _common_coeff(d2s, scale3, b)
                repf = 1.0 / jnp.maximum(jnp.square(d2s), 1.0 / 16.0)
                c = jnp.minimum(gamma * coeff * repf, 2.0) * nw
                c = jnp.where((d2s > 0.0) & ok_all[:, None, :], c, 0.0)
                yiT = yiT + jnp.sum((yi0 - yk) * c, 0)
                return gather_rows(yiT), None
            for t in range(n_neg):
                start = (r0 + shifts[t]) % n
                # partners are from the pre-repulsion snapshot for rows
                # this device owns too (matches the single-chip path,
                # which rolls the snapshot): ycat IS the snapshot.
                yk_t = jax.lax.dynamic_slice(ycat, (0, start),
                                             (dim, m_rows))
                nw_t = jax.lax.dynamic_slice(nwcat, (start,),
                                             (m_rows,))[None, :]
                yiT = _repulsion_kick_T(yiT, yk_t, scale_iT, gamma, b,
                                        ok_all[t][None, :], nw_t)
            return gather_rows(yiT), None

        # the carry becomes device-varying after the first all_gather;
        # mark the (replicated) initial value accordingly
        y0T = y0.astype(jnp.float32).T
        y_init = jax.lax.pcast(y0T, ("data",), to="varying") \
            if hasattr(jax.lax, "pcast") else y0T
        if gather_reuse > 1:
            # stale-gather blocks, mirroring optim/dense.py: ONE
            # full-k gather from the replicated snapshot feeds S
            # sweeps; per-sweep rotation/keys/gamma identical to the
            # fresh path (single-chip parity holds bit-for-bit)
            S = gather_reuse

            def stale_block(yT, blk0, kks, s_count):
                # inner steps under lax.scan: the traced body is ONE
                # sweep (unrolling makes compiles ~S x slower, see
                # optim/dense.py::_stale_block)
                yj_full = yT[:, idxT_full]
                yjg = [jax.lax.slice_in_dim(yj_full, c * kg,
                                            (c + 1) * kg, axis=1)
                       for c in range(n_groups)]

                def inner(yT, args):
                    s, kk = args
                    yT, _ = body(yT, (blk0 + s, kk), yj_by_group=yjg)
                    return yT, None

                yT, _ = jax.lax.scan(
                    inner, yT,
                    (jnp.arange(s_count, dtype=jnp.int32), kks))
                return yT

            n_full, rem = seg_steps // S, seg_steps % S
            keys_full = keys[:n_full * S].reshape(
                (n_full, S) + keys.shape[1:])

            def body_stale(yT, args):
                blk_idx, kks = args
                return stale_block(yT, blk_idx * S, kks, S), None

            yT = y_init
            if n_full:
                yT, _ = jax.lax.scan(
                    body_stale, yT,
                    (jnp.arange(n_full, dtype=jnp.int32), keys_full))
            if rem:
                yT = stale_block(yT, jnp.int32(n_full * S),
                                 keys[n_full * S:], rem)
            return yT.T
        yT, _ = jax.lax.scan(
            body, y_init,
            (jnp.arange(seg_steps, dtype=jnp.int32), keys))
        return yT.T

    # check_vma=False: the output IS replicated (every device holds the
    # full embedding after the final all_gather), but the varying-axes
    # checker cannot infer replication through all_gather(tiled)
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P("data", None), P("data", None), P("data", None),
                  P("data", None), P("data", None), P(), P(), P(), P(),
                  P()),
        out_specs=P(), check_vma=False)
    return jax.jit(fn)


def sharded_dense_optimize(y0, g, npar, params, mesh: Mesh,
                           nb_grad_batch: int | None = None,
                           neg_weights=None):
    """Multi-device dense optimization with the REAL single-chip
    schedule (optim/dense.py::run_dense_optimization semantics):
    relabel-once global permutation, column groups, per-visit
    multiplicities, closure floor + edge masks, hubness importance
    weights — row-sharded over the mesh, sweeps scanned inside bounded
    jitted segments (one compile, few dispatches).

    Ragged n is padded to a multiple of the mesh size with inert rows
    (zero edge weight/multiplicity); the output drops them.

    ``params.n_sub_schedule`` runs coarse->fine phases exactly like the
    single-chip driver.  ``params.dense_n_blocks`` is a single-chip
    memory-layout knob (the sharded sweep already touches only 1/ndev
    of the rows per device) and is intentionally not applied here."""
    import numpy as _np
    from ..optim.dense import (_segment_cap, _auto_groups,
                               prepare_dense_inputs)

    p = params
    n, k = g.indices.shape
    ndev = mesh.devices.size
    n_groups = _auto_groups(k)
    # (an explicit 0 means "no optimization", not "use the default")
    nb = p.nb_grad_batch if nb_grad_batch is None else nb_grad_batch
    schedule = getattr(p, "n_sub_schedule", None)
    if not schedule:
        schedule = ((nb, p.n_sub),)
    else:
        schedule = tuple((int(nbp), int(s)) for nbp, s in schedule)
        if sum(nbp for nbp, _ in schedule) != nb:
            raise ValueError(
                f"n_sub_schedule batches {schedule} must sum to "
                f"nb_grad_batch={nb}")
    n_sub = schedule[0][1]

    # shared relabel/multiplicity prologue — SAME seed stream as the
    # single-chip driver, so the two paths stay in lockstep
    (y0_r, indices_r, w, m_visit, w_rev, m_rev, emb_scale, neg_weight,
     n_neg, key, inv) = prepare_dense_inputs(
        y0, g, npar, p, n_sub, n_groups, neg_weights)

    # pad to a multiple of the mesh size with inert rows
    pad = (-n) % ndev
    if pad:
        key, k_pad = jax.random.split(key)
        y_pad = jax.random.uniform(k_pad, (pad, y0_r.shape[1]),
                                   jnp.float32, -5.0, 5.0)
        y0_r = jnp.concatenate([y0_r, y_pad])
        pad_idx = jnp.tile(jnp.arange(n, n + pad,
                                      dtype=jnp.int32)[:, None], (1, k))
        indices_r = jnp.concatenate([indices_r, pad_idx])
        zeros = jnp.zeros((pad, k), jnp.float32)
        w = jnp.concatenate([w, zeros])
        m_visit = jnp.concatenate([m_visit, zeros])
        w_rev = jnp.concatenate([w_rev, zeros])
        m_rev = jnp.concatenate([m_rev, zeros])
        emb_scale = jnp.concatenate([emb_scale, jnp.ones((pad,),
                                                         jnp.float32)])
        # pad rows must carry ZERO negative weight: they sit in the
        # rolled repulsion pool, and a nonzero weight would kick real
        # rows away from the random ghost coordinates all run long
        if neg_weight is None:
            neg_weight = jnp.ones((n,), jnp.float32)
        neg_weight = jnp.concatenate(
            [neg_weight, jnp.zeros((pad,), jnp.float32)])

    sh2 = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())
    base_args = (jax.device_put(indices_r, sh2), jax.device_put(w, sh2),
                 jax.device_put(m_visit, sh2), jax.device_put(w_rev, sh2),
                 jax.device_put(m_rev, sh2),
                 jax.device_put(emb_scale, rep),
                 jax.device_put(jnp.ones((y0_r.shape[0],), jnp.float32)
                                if neg_weight is None else neg_weight,
                                rep))

    # n_sub SCHEDULE phases, same semantics as the single-chip driver
    # (run_dense_optimization): per-visit multiplicity and n_neg scale
    # 1/n_sub per phase, gamma follows the GLOBAL nb batch decay.
    from ..optim.ce import NB_NEGATIVE

    def run_phase(y, k_p, s_p, batch0, batch1, rot_base, scale_m,
                  n_neg_p):
        # skip the reference schedule's zero-gamma final batch (see
        # optim/dense.py::dense_optimize)
        eff = max(min(batch1, nb - 1) - batch0, 0)
        total_steps = eff * s_p
        if total_steps == 0:
            return y, 0
        # stale-gather lever + late activation, SAME range split as
        # optim/dense.py::dense_optimize (single-chip parity)
        reuse = max(int(getattr(p, "dense_gather_reuse", 1)), 1)
        after = float(getattr(p, "dense_gather_reuse_after", 0.0))
        act = 0
        if reuse > 1 and after > 0.0:
            boundary = int(after * nb)
            act = min(max((boundary - batch0) * s_p, 0), total_steps)
        # the per-program budget scales with PER-DEVICE sweep cost, not
        # the padded global n (each device sweeps its own row shard)
        cap = min(total_steps,
                  _segment_cap(y0_r.shape[0] // ndev, n_groups))
        ranges = ([(0, total_steps, reuse)] if act == 0 else
                  [(0, act, 1), (act, total_steps, reuse)])
        segments = []
        for lo, hi, s_r in ranges:
            if hi <= lo:
                continue
            seg = cap
            if s_r > 1 and seg > s_r:
                seg -= seg % s_r
            pos = lo
            while pos < hi:
                # a range's last segment runs only the remaining steps
                # (one extra compile) — padding to seg would burn
                # zero-gamma no-op sweeps, same fix as dense_optimize
                segments.append((pos, min(seg, hi - pos), s_r))
                pos += seg
        args = base_args
        if scale_m != 1.0:
            args = (args[0], args[1], args[2] * scale_m, args[3],
                    args[4] * scale_m, args[5], args[6])
        cache = {}

        def make_step(seg_steps, s_r):
            if (seg_steps, s_r) not in cache:
                cache[(seg_steps, s_r)] = make_sharded_dense_segment(
                    mesh, b=float(p.b), n_sub=s_p, n_neg=n_neg_p,
                    nb_grad_batch=nb, n_groups=n_groups,
                    grad_step_init=float(p.grad_step),
                    f_min=float(p.dense_f_min),
                    mask_p=float(p.dense_mask_p),
                    seg_steps=seg_steps, batch0=batch0,
                    use_rot0=len(schedule) > 1,
                    packed_gather=(
                        bool(getattr(p, "dense_packed_gather", False))
                        and y0_r.shape[1] == 2),
                    parallel_kicks=bool(getattr(
                        p, "dense_parallel_kicks", False)),
                    gather_reuse=s_r)
            return cache[(seg_steps, s_r)]

        seg_keys = jax.random.split(k_p, len(segments))
        for si, (pos, seg_steps, s_r) in enumerate(segments):
            keys = jax.random.split(seg_keys[si], seg_steps)
            y = make_step(seg_steps, s_r)(y, *args, keys,
                                          jnp.int32(pos),
                                          jnp.int32(rot_base + pos))
        return y, total_steps

    y = jax.device_put(y0_r, rep)
    batch_cursor, rot = 0, 0
    for nbp, s_p in schedule:
        scale_m = schedule[0][1] / s_p
        n_neg_p = (n_neg if len(schedule) == 1 else
                   max(1, round(NB_NEGATIVE * p.nb_sampling_by_edge
                                * k / s_p)))
        if len(schedule) > 1:
            key, k_p = jax.random.split(key)
        else:
            k_p = key          # legacy stream: single phase == old path
        y, executed = run_phase(y, k_p, s_p, batch_cursor,
                                batch_cursor + nbp, rot, scale_m,
                                n_neg_p)
        rot += executed
        batch_cursor += nbp
    return y[:n][inv]
