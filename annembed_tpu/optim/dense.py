"""Dense-sweep CE optimizer — the accelerator-native formulation.

The sampling optimizer (optim/ce.py) reproduces the reference's
per-sample Hogwild update exactly, but pays ~7 random gathers + a
scatter per sample: at the reference's operating point (10 samples per
edge x nb_grad_batch batches = O(10^8) samples on MNIST) random memory
access dominates the device wall-clock.

This module reformulates the same dynamics in the fixed (n, k) edge
layout, replacing per-sample randomness with per-edge *multiplicity*:

  * Edge e = (i, j, w) is sampled on average
    m_e = nb_sampling_by_edge * k * w_e times per batch
    (sampling is proportional to w, and sum_j w_ij = 1).  A clipped
    attraction step moves each endpoint a fraction a of the way to the
    other (a = -coeff_ij <= 0.49, embedder.rs:1228-1239), so m
    consecutive applications shrink the pair distance by
    (1 - 2a)^m — applied here in closed form, per sub-sweep with
    multiplicity m_e / n_subsweeps.  This captures the *sequential*
    clipped dynamics that naive batched summing overshoots.
  * Each node performs nb_sampling_by_edge * k positive samples per
    batch, hence 5x that many negative samples (embedder.rs:1241).
    All nodes are relabeled once by a global random permutation, after
    which negatives are *contiguous slices of y itself* (identity pool,
    rolled by a random per-sweep offset) — zero random gathers for
    repulsion.
  * Attraction is scatter-free by default: each row moves only its own
    endpoint (mutual pairs split the pair closure between their two
    rows; one-sided edges close the full gap from the source — the
    umap-learn move_other=False convention).  Column grouping processes
    a static 1/n_groups slice of the edge table per sweep, so per sync
    step the only random memory op is ONE structured (n/g, k_g, d)
    gather of neighbour coordinates.
  * Empirically (70k bench graph) n_sub = 60 sub-sweeps per batch give
    better neighborhood conservation than the exact per-sample
    replication at ~40%% of its wall-clock; n_sub = 120 improves
    quality well past it.

Constants (clip -0.49, repulsion caps 2.0 and 1/16, annihilation
1/PROBA_MIN, embedded scales 0.2*clamp(rho/mean, 1/4, 4), step decay
gamma_0 (1 - iter/nb_batch)) are identical to the reference.

Known expectation-level deviations from the reference dynamics:
rejected negatives (self/edge/neighbour hits) are zeroed rather than
resampled (embedder.rs:1244-1252 retries until 5 accepted), an O(k/n)
repulsion deficit — negligible at production n; and hubness-weighted
negatives use clamped importance weights instead of weighted draws
(see _repulsion_sweep_rolledT; the deviation is bounded on hub-heavy
fixtures by tests/test_hubness_weighting.py: exact expectation parity
when the clamp does not bind, <15%% field deviation at MNIST-like
~20x hubs, clamped-mass-bounded and direction-preserving even at
pathological ~1400x hubs).
"""

from __future__ import annotations

import functools
import logging
from typing import Tuple

import jax
import jax.numpy as jnp

from ..params import EmbedderParams, PROBA_MIN
from ..graph.kgraph import KGraph
from ..graph.proba import NodeParams
from .ce import NB_NEGATIVE, _common_coeff, embedded_scales_from_initial

logger = logging.getLogger(__name__)


def _clipped_alpha(d2s, scale, w, gamma, b):
    """Per-sample attraction fraction alpha = -coeff_ij
    (embedder.rs:1216-1239)."""
    coeff = _common_coeff(d2s, scale, b)
    rep_att = 1.0 / jnp.maximum(jnp.square(d2s), 1.0 / PROBA_MIN)
    coeff_ij = jnp.maximum(gamma * coeff * (-w + (1.0 - w) * rep_att),
                           -0.49)
    return jnp.where(d2s > 0.0, -coeff_ij, 0.0)


def _attraction_sweep(y, indices, w, m_e, w_rev, m_rev, emb_scale, gamma,
                      b: float, f_min: float = 1e-3, mask=None,
                      mask_p: float = 1.0):
    """Closed-form multi-sample attraction for all edges at once.

    A pair (i, j) is touched by both directed edges (i->j with
    multiplicity m_e and j->i with m_rev; m_rev = 0 when j does not
    list i).  Each sample moves both endpoints a clipped fraction alpha
    of the gap, so the gap shrinks by (1-2a_f)^{m} (1-2a_r)^{m_rev}
    after all samples of the pair — computed identically from either
    row.  Each directed edge applies its multiplicity share of the net
    per-endpoint displacement so mutual pairs are not double-counted
    (the naive per-direction form overshoots by (1-f_ij)(1-f_ji), which
    oscillates at the clip).

    Returns (delta_self (n, d), delta_rev (n, k, d))."""
    n, k = indices.shape
    yi = y[:, None, :]                # (n, 1, d)
    yj = y[indices]                   # (n, k, d)
    scale_i = emb_scale[:, None]      # (n, 1)
    scale_j = emb_scale[indices]      # (n, k)
    d2 = jnp.sum(jnp.square(yi - yj), -1)            # (n, k)

    alpha_f = _clipped_alpha(d2 / jnp.square(scale_i), scale_i, w,
                             gamma, b)
    alpha_r = _clipped_alpha(d2 / jnp.square(scale_j), scale_j, w_rev,
                             gamma, b)
    m_eff = m_e if mask is None else m_e * mask * (1.0 / mask_p)
    f_pair = jnp.power(jnp.clip(1.0 - 2.0 * alpha_f, 1e-3, 1.05), m_eff) \
        * jnp.power(jnp.clip(1.0 - 2.0 * alpha_r, 1e-3, 1.05), m_rev)
    # floor the per-sweep pair closure: closed-form closure deeper than
    # ~f32 resolution in ONE sweep creates an absorbing coincidence
    # state (all pair forces and far-negative kicks round to zero) —
    # the 2M pile-collapse mechanism.  One clipped reference sample
    # closes to (1 - 2*0.49) = 0.02; the default f_min=1e-3 allows ~2
    # samples' worth, verified collapse-free at 2M/11M (PERF.md)
    f_pair = jnp.maximum(f_pair, f_min)
    share = m_e / jnp.maximum(m_e + m_rev, 1e-30)
    net = share * (1.0 - f_pair) * 0.5               # (n, k)
    step_vec = (yj - yi) * net[:, :, None]           # (n, k, d)
    return jnp.sum(step_vec, axis=1), -step_vec


def _attraction_sweep_scatter_free(y, indices, w, m_e, w_rev, m_rev,
                                   emb_scale, gamma, b: float,
                                   f_min: float = 1e-3, mask=None,
                                   mask_p: float = 1.0):
    """ROW-MAJOR REFERENCE VARIANT (kept for parity tests only — the
    production path is the transposed _attraction_sweep_sfT; keep the
    two in sync).  Scatter-free attraction: each row applies only its
    own endpoint's displacement.  A mutual pair is handled half by each of
    its two rows (each moves itself (1-F)/2 toward the other); a
    one-sided edge closes the full gap from the source side (the
    umap-learn move_other=False convention).  Eliminates the reverse
    segment-sum.

    ``mask`` (optional, (n, k) bernoulli(mask_p)) fires each edge's own
    multiplicity stochastically per sweep (scaled 1/mask_p to preserve
    the expected sample count): the per-sweep noise the reference's
    per-sample dynamics have and the deterministic closed form lacks —
    without it, all members of a shared-neighbour clique contract
    toward identical snapshot targets in lockstep every sweep (exact
    pile-ups at multi-million n).  The reverse multiplicity stays at
    its expectation so each side still applies only its bounded half of
    the pair closure (no overshoot/position swap).

    ``f_min`` floors the per-sweep pair closure (anti-collapse) — see
    the rationale in _attraction_sweep.

    Returns delta_self (n, d)."""
    yi = y[:, None, :]
    yj = y[indices]
    scale_i = emb_scale[:, None]
    scale_j = emb_scale[indices]
    d2 = jnp.sum(jnp.square(yi - yj), -1)
    alpha_f = _clipped_alpha(d2 / jnp.square(scale_i), scale_i, w,
                             gamma, b)
    alpha_r = _clipped_alpha(d2 / jnp.square(scale_j), scale_j, w_rev,
                             gamma, b)
    m_eff = m_e if mask is None else m_e * mask * (1.0 / mask_p)
    # exp(m log c1 + m_rev log c2): one exp + two logs instead of two
    # pow (= two exp + two log) — the sweep is elementwise-bound
    f_pair = jnp.exp(
        m_eff * jnp.log(jnp.clip(1.0 - 2.0 * alpha_f, 1e-3, 1.05))
        + m_rev * jnp.log(jnp.clip(1.0 - 2.0 * alpha_r, 1e-3, 1.05)))
    f_pair = jnp.maximum(f_pair, f_min)
    mutual = w_rev > 0.0
    c = jnp.where(mutual, 0.5, 1.0)
    net = c * (1.0 - f_pair)                         # (n, k)
    return jnp.sum((yj - yi) * net[:, :, None], axis=1)


def _repulsion_sweep(y, y_pool, pool_offset, indices, emb_scale, gamma,
                     b: float, ids_pool, n_neg: int):
    """SUM-AT-ORIGINAL-POSITION REFERENCE VARIANT (kept for parity
    tests only — the production path is _repulsion_sweep_rolledT; this
    formulation is the one documented below as the pile-explosion
    failure mode when combined with full closure).  Negative-sample
    repulsion for all nodes from the permuted pool.

    y_pool: (n, d) = y[perm]; ids_pool: (n,) = perm.  Node i's
    negatives are pool positions (i*n_neg + t + offset) mod n — i.e. a
    roll + reshape of the pool, no random gathers.
    Returns delta (n, d) to ADD to y (movement away from negatives)."""
    n, d = y.shape
    total = n * n_neg
    pos = (jnp.arange(total) + pool_offset) % n
    neg_ids = ids_pool[pos].reshape(n, n_neg)        # (n, n_neg)
    yk = y_pool[pos].reshape(n, n_neg, d)            # (n, n_neg, d)

    # rejection: negative == self or a neighbour of self
    # (embedder.rs:1246-1252; j is a neighbour so neg != j is implied)
    reject = (neg_ids == jnp.arange(n, dtype=neg_ids.dtype)[:, None])
    reject |= (neg_ids[:, :, None] == indices[:, None, :]).any(-1)

    yi = y[:, None, :]
    scale = emb_scale[:, None]
    d2 = jnp.sum(jnp.square(yi - yk), -1)            # (n, n_neg)
    d2s = d2 / jnp.square(scale)
    coeff = _common_coeff(d2s, scale, b)
    rep = 1.0 / jnp.maximum(jnp.square(d2s), 1.0 / 16.0)
    coeff_ik = jnp.minimum(gamma * coeff * rep, 2.0)
    coeff_ik = jnp.where((d2s > 0.0) & jnp.logical_not(reject),
                         coeff_ik, 0.0)
    # y_i -= (yk - yi) * coeff_ik  => add (yi - yk) * coeff_ik
    return jnp.sum((yi - yk) * coeff_ik[:, :, None], axis=1)


def _repulsion_sweep_rolled(y, offset, indices, emb_scale, gamma,
                            b: float, n_neg: int, neg_weight=None):
    """Identity-pool repulsion: node at position i takes positions
    (i*n_neg + t + offset*n_neg) mod n of the CURRENT y as negatives — a
    pure roll/reshape, zero gathers.  (The ``offset`` convention differs
    from ``_repulsion_sweep``, which uses it unscaled; the two variants
    are only interchangeable at offset = 0.)  Valid because the caller
    relabels all
    nodes by one global random permutation at build time, so positions
    are uniformly random with respect to the data.

    ``neg_weight`` implements hubness-biased negative sampling
    (embedder.rs:810-837) by importance weighting instead of weighted
    draws: uniform pool negatives, each repulsion kick multiplied by
    the (mean-1-normalized, clamped) hubness weight of the negative —
    same expected update, zero extra gathers (a weighted-gather pool
    was measured ~25x slower per sweep on the previous accelerator)."""
    n, d = y.shape
    # y[(i*n_neg + t + off) % n] == tile(roll(y, -off), n_neg)[i*n_neg+t]:
    # roll lowers to two slices + concat and tile to concat — XLA does
    # NOT recognize a modular index gather as contiguous (measured
    # ~1 ms per sweep at 70k as a real gather, ~0 as roll+tile)
    y_rolled = jnp.roll(y, -offset * n_neg, axis=0)
    yk = jnp.tile(y_rolled, (n_neg, 1)).reshape(n, n_neg, d)
    row_i = jax.lax.broadcasted_iota(jnp.int32, (n, n_neg), 0)
    col_t = jax.lax.broadcasted_iota(jnp.int32, (n, n_neg), 1)
    neg_ids = (row_i * n_neg + col_t
               + (offset * n_neg).astype(jnp.int32)) % n

    reject = (neg_ids == jnp.arange(n, dtype=jnp.int32)[:, None])
    reject |= (neg_ids[:, :, None] == indices[:, None, :]).any(-1)

    if neg_weight is not None:
        nw_rolled = jnp.roll(neg_weight, -offset * n_neg, axis=0)
        nw = jnp.tile(nw_rolled, n_neg).reshape(n, n_neg)
    else:
        nw = None

    # SEQUENTIAL kicks, exactly like the reference's negative loop
    # (embedder.rs:1244-1299): each kick moves y_i, and the next kick's
    # coefficient is computed at the moved position.  Summing the kicks
    # at the original position instead lets coherent point piles
    # compound up to 2*n_neg x displacement per sweep and fly off
    # (observed: |coord| ~ 1e3 and exact pile collapse at 2M).
    scale = emb_scale[:, None]          # (n, 1)
    yi = y
    for t in range(n_neg):
        yk_t = yk[:, t, :]              # (n, d)
        d2s = jnp.sum(jnp.square(yi - yk_t), -1,
                      keepdims=True) / jnp.square(scale)
        coeff = _common_coeff(d2s, scale, b)
        rep = 1.0 / jnp.maximum(jnp.square(d2s), 1.0 / 16.0)
        coeff_ik = jnp.minimum(gamma * coeff * rep, 2.0)
        if nw is not None:
            coeff_ik = coeff_ik * nw[:, t:t + 1]
        ok = (d2s > 0.0) & jnp.logical_not(reject[:, t:t + 1])
        coeff_ik = jnp.where(ok, coeff_ik, 0.0)
        yi = yi + (yi - yk_t) * coeff_ik
    return yi - y


def _attraction_sweep_sfT(yT, idxT, wT, mT, w_revT, m_revT,
                          scale_iT, scale_jT, gamma, b: float,
                          f_min: float = 1e-3, mask=None,
                          mask_p: float = 1.0, y_ownT=None, yzT=None,
                          yjT=None):
    """Transposed (feature-minor) scatter-free attraction.

    Same math as ``_attraction_sweep_scatter_free`` but every array is
    laid out with n LAST: yT (d, n), idxT/wT/mT/w_revT/m_revT/scale_jT
    (kg, n), scale_iT (1, n): with n last every elementwise op runs
    over long contiguous rows instead of the short kg and d minor
    dimensions of the row-major (n, kg)/(n, kg, d) forms.  Which
    layout is faster on a GPU is not measured yet.  ``scale_jT`` is the
    PRE-GATHERED emb_scale[idx] (indices are static across sweeps, so
    the gather happens once at build, not every sweep).

    ``y_ownT`` (d, m): the self-coordinate block when it differs from
    the gather source — the sharded path passes its device's row block
    while gathering neighbours from the replicated yT, so the formula
    lives HERE once for both the single- and multi-chip paths.

    ``yzT`` (n,) complex64: optional PACKED gather source for d=2
    (re=row 0, im=row 1 of yT).  complex64 stores the two f32s
    exactly, so the packed gather is bit-identical to the pair gather
    — it exists purely to halve the gathered element count if the
    hardware gather is per-element-bound (microbench `gather_packing`
    decides; PERF.md gather-floor study).

    ``yjT`` (d, kg, n): optional PRE-GATHERED neighbour coordinates.
    When given, the per-sweep gather is skipped entirely — the caller
    amortizes one gather over several sweeps (the stale-gather lever,
    see _dense_segment gather_reuse).  The neighbour positions are
    then up to gather_reuse-1 sweeps stale, which is within the
    staleness envelope the reference's Hogwild threads already tolerate
    (embedder.rs: unsynchronised reads across a full batch)."""
    y_own = yT if y_ownT is None else y_ownT
    if yjT is not None:
        yj = yjT
    elif yzT is not None:
        z = yzT[idxT]                                  # (kg, n) c64
        yj = jnp.stack([jnp.real(z), jnp.imag(z)])     # (2, kg, n)
    else:
        yj = yT[:, idxT]                               # (d, kg, n)
    diff = yj - y_own[:, None, :]
    d2 = jnp.sum(jnp.square(diff), 0)                  # (kg, n)
    alpha_f = _clipped_alpha(d2 / jnp.square(scale_iT), scale_iT, wT,
                             gamma, b)
    alpha_r = _clipped_alpha(d2 / jnp.square(scale_jT), scale_jT,
                             w_revT, gamma, b)
    m_eff = mT if mask is None else mT * mask * (1.0 / mask_p)
    f_pair = jnp.exp(
        m_eff * jnp.log(jnp.clip(1.0 - 2.0 * alpha_f, 1e-3, 1.05))
        + m_revT * jnp.log(jnp.clip(1.0 - 2.0 * alpha_r, 1e-3, 1.05)))
    f_pair = jnp.maximum(f_pair, f_min)
    c = jnp.where(w_revT > 0.0, 0.5, 1.0)
    net = c * (1.0 - f_pair)                           # (kg, n)
    return jnp.sum(diff * net[None, :, :], axis=1)     # (d, n)


def _repulsion_sweep_rolledT(yT, offset, idxT, emb_scaleT, gamma,
                             b: float, n_neg: int, neg_weight=None,
                             neighbor_exclusion: bool = True,
                             parallel_kicks: bool = False):
    """Transposed identity-pool repulsion: kick ``t`` pairs position i
    with position (i + offset + t*(n//n_neg)) mod n — a pure roll of
    the coordinate block along the n axis, zero gathers and zero
    lane-padded intermediates (the row-major stride trick
    tile+reshape(n, n_neg, d) needs a real transpose in this layout).
    Positions are a global random relabeling of the nodes, so each
    kick's partner is a uniformly random node, exactly like the strided
    pool of ``_repulsion_sweep_rolled``; only the traversal order
    differs.  Kicks stay SEQUENTIAL (embedder.rs:1244-1299) against the
    pre-sweep snapshot.

    Implemented as the whole-array case of ``_repulsion_block_T``: ONE
    wraparound-extended copy of the snapshot per sweep, then each
    kick's partner is a fusible dynamic slice of it — the per-kick
    roll (2 slices + concat, n_neg x per sweep) was the sweep's kernel-
    count floor at bench scale (the arrays are tiny, so the wall is
    per-kernel overhead, not bytes; PERF.md round-4 sweep study).
    Partner values are bit-identical to the roll formulation."""
    d, n = yT.shape
    yT_ext = jnp.concatenate([yT, yT], axis=1)
    nw_ext = (None if neg_weight is None
              else jnp.concatenate([neg_weight, neg_weight]))
    yi = _repulsion_block_T(yT_ext, yT, 0, n, offset, idxT, emb_scaleT,
                            gamma, b, n_neg, neg_weight_ext=nw_ext,
                            neighbor_exclusion=neighbor_exclusion,
                            parallel_kicks=parallel_kicks)
    return yi - yT


def _repulsion_kick_T(yi, yk_t, scaleT, gamma, b: float, ok_mask, nw_t):
    """ONE sequential repulsion kick in transposed layout — the shared
    formula of the single-chip rolled pool (above) and the sharded
    per-device window pool (parallel/sharded.py): coeff capped at 2
    (embedder.rs:1288), pole floored at 1/16, optional hubness
    importance weight, self/neighbour rejection via ``ok_mask``."""
    d2s = jnp.sum(jnp.square(yi - yk_t), 0,
                  keepdims=True) / jnp.square(scaleT)
    coeff = _common_coeff(d2s, scaleT, b)
    rep = 1.0 / jnp.maximum(jnp.square(d2s), 1.0 / 16.0)
    coeff_ik = jnp.minimum(gamma * coeff * rep, 2.0)
    if nw_t is not None:
        coeff_ik = coeff_ik * nw_t
    coeff_ik = jnp.where((d2s > 0.0) & ok_mask, coeff_ik, 0.0)
    return yi + (yi - yk_t) * coeff_ik


def _neighbor_rejection(pos, idxT, shifts, n: int, n_neg: int):
    """(n_neg, nb) mask: kick ``t`` of node at global position ``pos_i``
    pairs it with (pos_i + shifts[t]) mod n — reject when that partner
    is one of its neighbours ``idxT[:, i]`` (embedder.rs:1246-1252).

    Direct (n_neg, k, nb) broadcast compare + any-reduce.  A round-4
    "shift membership" reformulation (searchsorted the (k, nb)
    displacement table against the sorted shifts + one k x nb
    scatter-max, O(k nb log n_neg) elementwise work) was tried and
    lost at every measured shape — XLA scatter's constant dwarfs the
    elementwise savings (Higgs shapes, k=100, nb=440k/2M, n_neg=2:
    CPU A/B 496/2356 ms vs 6/7 ms per mask).  Kept as the single
    formulation;
    tests/test_dense.py pins it against an independent oracle."""
    nid = (pos[None, :] + shifts[:, None]) % n          # (n_neg, nb)
    return (nid[:, None, :] == idxT[None, :, :]).any(1)


def _repulsion_block_T(yT_ext, y_blk, lo, n, offset, idxT_blk_full,
                       scale_blkT, gamma, b: float, n_neg: int,
                       neg_weight_ext=None,
                       neighbor_exclusion: bool = True,
                       parallel_kicks: bool = False):
    """Sequential repulsion kicks for one contiguous node block.

    Kick ``t`` pairs global position p with (p + offset + t*(n//n_neg))
    mod n — the identical strided identity pool of
    ``_repulsion_sweep_rolledT`` — realized as ONE dynamic slice of the
    (d, n + nb) wraparound-extended coordinate snapshot per kick
    instead of a full-array roll (the block touches nb of n nodes, so
    rolling all n per kick would cost n/nb times the block's own
    traffic).  ``idxT_blk_full`` is the block's FULL (k, nb) neighbour
    table (all column groups) for the neighbour-rejection test, exactly
    like the flat sweep."""
    d, nb = y_blk.shape
    pos = lo + jnp.arange(nb, dtype=jnp.int32)
    stride = max(1, n // n_neg)
    shifts = (offset + stride * jnp.arange(n_neg, dtype=jnp.int32)) % n
    nid = (pos[None, :] + shifts[:, None]) % n          # (n_neg, nb)
    ok_all = nid != pos[None, :]
    if neighbor_exclusion:
        # the reference rejects negatives that are neighbours of i
        # (embedder.rs:1246-1252); see _neighbor_rejection for the
        # shift-membership formulation (k x nb work instead of the
        # direct n_neg x k x nb compare — the sweep's biggest
        # elementwise op before round 4).
        # dense_neighbor_exclusion=False skips the test entirely,
        # admitting a neighbour as a negative with probability k/n per
        # kick — an O(k/n) repulsion surplus; kept ON by default to
        # preserve reference semantics.
        ok_all &= jnp.logical_not(
            _neighbor_rejection(pos, idxT_blk_full, shifts, n, n_neg))
    if parallel_kicks:
        # stacked-kick variant (EmbedderParams.dense_parallel_kicks):
        # every kick's coeff reads the post-attraction snapshot y_blk
        # instead of the running yi, so the n_neg dependent fusion
        # chains collapse into ONE stacked (n_neg, d, nb) elementwise
        # program + a sum.  Partners, caps and rejection masks are
        # identical to the sequential path; n_neg == 1 is bit-exact.
        yk = jnp.stack([
            jax.lax.dynamic_slice(yT_ext, (0, (lo + shifts[t]) % n),
                                  (d, nb))
            for t in range(n_neg)])                    # (n_neg, d, nb)
        yi0 = y_blk[None]                              # (1, d, nb)
        scale3 = scale_blkT[None]                      # (1, 1, nb)
        d2s = (jnp.sum(jnp.square(yi0 - yk), 1, keepdims=True)
               / jnp.square(scale3))                   # (n_neg, 1, nb)
        coeff = _common_coeff(d2s, scale3, b)
        rep = 1.0 / jnp.maximum(jnp.square(d2s), 1.0 / 16.0)
        c = jnp.minimum(gamma * coeff * rep, 2.0)
        if neg_weight_ext is not None:
            nw = jnp.stack([
                jax.lax.dynamic_slice(neg_weight_ext,
                                      ((lo + shifts[t]) % n,), (nb,))
                for t in range(n_neg)])[:, None, :]    # (n_neg, 1, nb)
            c = c * nw
        c = jnp.where((d2s > 0.0) & ok_all[:, None, :], c, 0.0)
        return y_blk + jnp.sum((yi0 - yk) * c, 0)
    yi = y_blk
    for t in range(n_neg):
        start = (lo + shifts[t]) % n
        yk_t = jax.lax.dynamic_slice(yT_ext, (0, start), (d, nb))
        nw_t = (None if neg_weight_ext is None else
                jax.lax.dynamic_slice(neg_weight_ext, (start,),
                                      (nb,))[None, :])
        yi = _repulsion_kick_T(yi, yk_t, scale_blkT, gamma, b,
                               ok_all[t][None, :], nw_t)
    return yi


def _block_bounds(n: int, n_blocks: int):
    """Contiguous near-equal node blocks [lo, hi) (sizes differ by at
    most 1; no divisibility requirement on n)."""
    return [(b * n // n_blocks, (b + 1) * n // n_blocks)
            for b in range(n_blocks)]


@jax.jit
def reverse_edge_info(indices: jnp.ndarray, w: jnp.ndarray):
    """Reverse-edge weight: for edge l of node i with j = indices[i, l],
    w_rev[i, l] = w[j -> i] (0 if j does not list i).

    Built one source-column at a time over (k, n) slices: the direct
    (n, k, k) formulation (indices[indices]) materializes ~400M-element
    gather chains at 11M nodes; the column loop peaks at a few (k, n) arrays."""
    n, k = indices.shape
    pos = jnp.arange(n, dtype=indices.dtype)
    idxT = indices.T                       # (k, n)
    wT = w.T
    w_rev_cols = []
    for c in range(k):
        j_c = indices[:, c]                # (n,)
        nbrs_of_j = idxT[:, j_c]           # (k, n): neighbours of j
        hit = nbrs_of_j == pos[None, :]
        w_rev_cols.append(
            jnp.sum(jnp.where(hit, wT[:, j_c], 0.0), axis=0))
    return jnp.stack(w_rev_cols, axis=1)               # (n, k)


# backward-compatible alias used by tests
def reverse_edge_weights(indices, w):
    return reverse_edge_info(indices, w)


@functools.partial(jax.jit, static_argnames=("b", "n_sub", "n_neg",
                                             "nb_grad_batch", "n_groups",
                                             "scatter_free",
                                             "seg_steps", "f_min",
                                             "mask_p", "batch0",
                                             "use_rot0", "n_blocks",
                                             "packed_gather",
                                             "neighbor_exclusion",
                                             "parallel_kicks",
                                             "gather_reuse"))
def _dense_segment(y0, indices, w, m_visit, w_rev, m_rev_visit,
                   emb_scale, key, neg_weight,
                   grad_step_init: float, b: float, n_sub: int,
                   n_neg: int, nb_grad_batch: int, n_groups: int = 1,
                   scatter_free: bool = True, step0=0,
                   seg_steps: int = 0, f_min: float = 1e-3,
                   mask_p: float = 1.0, batch0: int = 0,
                   rot0=0, use_rot0: bool = False, n_blocks: int = 1,
                   packed_gather: bool = False,
                   neighbor_exclusion: bool = True,
                   parallel_kicks: bool = False,
                   gather_reuse: int = 1):
    """Full optimization: nb_grad_batch x n_sub synchronous sub-sweeps
    with the reference's linear step decay.

    Column grouping: each sub-sweep processes a static column slice of
    the (n, k) edge table (1/n_groups of the edges), round-robin, with
    per-visit multiplicity scaled by n_groups.  This keeps the
    per-sync-step displacement (the quality knob) while paying
    1/n_groups of the gather + segment-sum cost per step.

    ``n_blocks`` > 1 (transposed path only) additionally restricts each
    sub-sweep to one contiguous 1/n_blocks NODE block (rotating
    block-fastest, so one group pass is executed as n_blocks
    incremental syncs): per-edge visits per batch drop to
    n_sub / (n_groups * n_blocks) — and with them the per-batch gather
    volume, the 11M wall floor (PERF.md) — while every gathered
    neighbour coordinate is fresher by a factor n_blocks.  The caller
    scales the per-visit multiplicity and n_neg by n_blocks.

    ``batch0``/``rot0`` support n_sub SCHEDULES (run_dense_optimization
    with a phase list): ``step0`` counts steps within the phase, gamma
    decays at batch ``batch0 + step//n_sub + 1`` of the GLOBAL
    nb_grad_batch schedule, and ``rot0`` (the global sweep counter at
    segment start, used when ``use_rot0``) keeps the column-group
    round-robin continuous across phases with different n_sub."""
    n, k = indices.shape
    assert k % n_groups == 0, "k must be divisible by n_groups"
    kg = k // n_groups
    dim = y0.shape[1]

    # NOTE: w_rev / m_rev stay intact even when the reverse edge lives
    # in a different column group.  Each direction applies its half of
    # the pair closure in its own sweep with F computed from BOTH
    # multiplicities; zeroing the cross-group reverse made mutual pairs
    # look one-sided (full closure from both sides in alternating
    # sweeps -> position swapping -> runaway drift of tight cliques,
    # observed as |coord| ~ 1e2-1e3 "flying piles" at 80k+).
    keys = jax.random.split(key, seg_steps)

    def gamma_of(step_idx):
        batch_idx = batch0 + step_idx // n_sub + 1
        return jnp.maximum(
            grad_step_init * (1.0 - batch_idx.astype(jnp.float32)
                              / nb_grad_batch), 0.0)

    def rot_of(step_idx, local_idx):
        # column-group rotation index: the global sweep counter when
        # scheduled (phases may have different n_sub); step_idx else
        return (rot0 + local_idx if use_rot0 else step_idx) % n_groups

    if n_blocks > 1:
        assert scatter_free, "n_blocks > 1 requires the transposed path"
        blocks = _block_bounds(n, n_blocks)
        # block-only constants built once, shared across groups (the
        # full-k neighbour table and own-scale row do not depend on c)
        blk_common = [dict(scale_iT=emb_scale[lo:hi][None, :],
                           idxT_full=indices[lo:hi].T)
                      for lo, hi in blocks]
        gb_data = []
        for c in range(n_groups):
            sl = slice(c * kg, (c + 1) * kg)
            idx_g = indices[:, sl]
            for bi, (lo, hi) in enumerate(blocks):
                idx_gb = idx_g[lo:hi]
                gb_data.append(dict(
                    lo=lo, hi=hi,
                    idxT=idx_gb.T, wT=w[lo:hi, sl].T,
                    mT=m_visit[lo:hi, sl].T,
                    w_revT=w_rev[lo:hi, sl].T,
                    m_revT=m_rev_visit[lo:hi, sl].T,
                    scale_jT=emb_scale[idx_gb].T,
                    **blk_common[bi]))

        def make_branch_gb(j):
            gd = gb_data[j]
            lo, hi = gd["lo"], gd["hi"]
            nb = hi - lo

            def branch(yT, gamma, kk, offset):
                y_blk = jax.lax.slice(yT, (0, lo), (dim, hi))
                if mask_p < 1.0:
                    _, k_mask = jax.random.split(kk)
                    mask = jax.random.bernoulli(
                        k_mask, mask_p, (kg, nb)).astype(jnp.float32)
                else:
                    mask = None
                yz = (jax.lax.complex(yT[0], yT[1])
                      if packed_gather and dim == 2 else None)
                y_blk = y_blk + _attraction_sweep_sfT(
                    yT, gd["idxT"], gd["wT"], gd["mT"], gd["w_revT"],
                    gd["m_revT"], gd["scale_iT"], gd["scale_jT"],
                    gamma, b, f_min=f_min, mask=mask, mask_p=mask_p,
                    y_ownT=y_blk, yzT=yz)
                yT = jax.lax.dynamic_update_slice(yT, y_blk, (0, lo))
                # wraparound-extended snapshot for the strided pool
                yT_ext = jnp.concatenate(
                    [yT, jax.lax.slice(yT, (0, 0), (dim, nb))], axis=1)
                nw_ext = (None if neg_weight is None else
                          jnp.concatenate([neg_weight, neg_weight[:nb]]))
                y_blk = _repulsion_block_T(
                    yT_ext, y_blk, lo, n, offset, gd["idxT_full"],
                    gd["scale_iT"], gamma, b, n_neg,
                    neg_weight_ext=nw_ext,
                    neighbor_exclusion=neighbor_exclusion,
                    parallel_kicks=parallel_kicks)
                return jax.lax.dynamic_update_slice(yT, y_blk, (0, lo))

            return branch

        branches_gb = [make_branch_gb(j)
                       for j in range(n_groups * n_blocks)]

        def body_gb(yT, args):
            local_idx, kk = args
            step_idx = step0 + local_idx
            gamma = gamma_of(step_idx)
            rot = (rot0 + local_idx if use_rot0
                   else step_idx) % (n_groups * n_blocks)
            kk_m, kk_o = jax.random.split(kk)
            offset = jax.random.randint(kk_o, (), 0, n)
            yT = jax.lax.switch(rot, branches_gb, yT, gamma, kk_m,
                                offset)
            return yT, None

        yT, _ = jax.lax.scan(body_gb, y0.astype(jnp.float32).T,
                             (jnp.arange(seg_steps, dtype=jnp.int32),
                              keys))
        return yT.T

    if scatter_free:
        # PRODUCTION path, transposed layout: all per-edge arrays with
        # n LAST (long contiguous rows); neighbour
        # scales pre-gathered once (indices are static across sweeps)
        idxT_full = indices.T                           # (k, n)
        scale_iT = emb_scale[None, :]                   # (1, n)
        groupsT = []
        for c in range(n_groups):
            sl = slice(c * kg, (c + 1) * kg)
            idx_g = indices[:, sl]
            groupsT.append(dict(
                idxT=idx_g.T, wT=w[:, sl].T, mT=m_visit[:, sl].T,
                w_revT=w_rev[:, sl].T, m_revT=m_rev_visit[:, sl].T,
                scale_jT=emb_scale[idx_g].T))

        if gather_reuse > 1:
            # STALE-GATHER path (the (d, kg, n) neighbour gather is
            # the largest op of the large-n sweep).  One gather feeds ``gather_reuse``
            # consecutive sweeps of the SAME column group: the
            # attraction then reads neighbour positions up to
            # gather_reuse-1 sweeps stale while the self position, the
            # repulsion pool and the step schedule stay exactly fresh.
            # The reference's Hogwild threads already read positions a
            # full unsynchronised batch stale (embedder.rs:873-918), so
            # this staleness is in-family; conservation impact is
            # A/B-measured per operating point before use.  Per-step
            # key consumption mirrors body_t exactly, so repulsion-only
            # dynamics (w == 0) are bit-identical to gather_reuse=1.
            S = gather_reuse

            def _one_stale_sweep(yT, kk, step_idx, rot, yj_by_group):
                # one sweep against prefetched neighbour coordinates;
                # key consumption mirrors body_t exactly
                gamma = gamma_of(step_idx)
                if mask_p < 1.0:
                    kk, k_mask = jax.random.split(kk)
                    mask = jax.random.bernoulli(
                        k_mask, mask_p, (kg, n)).astype(jnp.float32)
                else:
                    mask = None

                def mk(c):
                    gd = groupsT[c]

                    def branch(yT_):
                        return yT_ + _attraction_sweep_sfT(
                            yT_, gd["idxT"], gd["wT"], gd["mT"],
                            gd["w_revT"], gd["m_revT"], scale_iT,
                            gd["scale_jT"], gamma, b, f_min=f_min,
                            mask=mask, mask_p=mask_p,
                            yjT=yj_by_group[c])

                    return branch

                yT = jax.lax.switch(rot, [mk(c) for c in
                                          range(n_groups)], yT)
                offset = jax.random.randint(kk, (), 0, n)
                return yT + _repulsion_sweep_rolledT(
                    yT, offset, idxT_full, scale_iT, gamma, b,
                    n_neg, neg_weight=neg_weight,
                    neighbor_exclusion=neighbor_exclusion,
                    parallel_kicks=parallel_kicks)

            def _stale_block(yT, step_blk, ctr_blk, kks, s_count):
                # ONE full-k gather feeds s_count sweeps; the per-sweep
                # column-group rotation is IDENTICAL to the fresh path
                # (mutual pairs keep alternating directions every
                # sweep — same-group blocks were A/B-measured worse:
                # tools/ab_gather_reuse.py, 20k manifold).  The inner
                # steps run under lax.scan so the traced body is ONE
                # sweep (unrolling S sweeps makes compiles ~S x
                # slower).
                yj_full = yT[:, idxT_full]             # (d, k, n)
                yj_by_group = [
                    jax.lax.slice_in_dim(yj_full, c * kg, (c + 1) * kg,
                                         axis=1)
                    for c in range(n_groups)]

                def inner(yT, args):
                    s, kk = args
                    rot = (ctr_blk + s) % n_groups
                    return _one_stale_sweep(yT, kk, step_blk + s, rot,
                                            yj_by_group), None

                yT, _ = jax.lax.scan(
                    inner, yT,
                    (jnp.arange(s_count, dtype=jnp.int32), kks))
                return yT

            n_full, rem = seg_steps // S, seg_steps % S
            keys_full = keys[:n_full * S].reshape(
                (n_full, S) + keys.shape[1:])

            def body_stale(yT, args):
                blk_idx, kks = args
                step_blk = step0 + blk_idx * S
                ctr = rot0 + blk_idx * S if use_rot0 else step_blk
                return _stale_block(yT, step_blk, ctr, kks, S), None

            yT = y0.astype(jnp.float32).T
            if n_full > 0:
                yT, _ = jax.lax.scan(
                    body_stale, yT,
                    (jnp.arange(n_full, dtype=jnp.int32), keys_full))
            if rem > 0:
                step_blk = jnp.int32(step0 + n_full * S)
                ctr = (rot0 + n_full * S if use_rot0 else step_blk)
                yT = _stale_block(yT, step_blk, ctr,
                                  keys[n_full * S:], rem)
            return yT.T

        def make_branch_t(c):
            gd = groupsT[c]

            def branch(yT, gamma, mask):
                yz = (jax.lax.complex(yT[0], yT[1])
                      if packed_gather and dim == 2 else None)
                return yT + _attraction_sweep_sfT(
                    yT, gd["idxT"], gd["wT"], gd["mT"], gd["w_revT"],
                    gd["m_revT"], scale_iT, gd["scale_jT"], gamma, b,
                    f_min=f_min, mask=mask, mask_p=mask_p, yzT=yz)

            return branch

        branches_t = [make_branch_t(c) for c in range(n_groups)]

        def body_t(yT, args):
            local_idx, kk = args
            step_idx = step0 + local_idx
            gamma = gamma_of(step_idx)
            if mask_p < 1.0:
                kk, k_mask = jax.random.split(kk)
                mask = jax.random.bernoulli(k_mask, mask_p,
                                            (kg, n)).astype(jnp.float32)
            else:
                mask = None
            yT = jax.lax.switch(rot_of(step_idx, local_idx), branches_t,
                                yT, gamma, mask)
            offset = jax.random.randint(kk, (), 0, n)
            yT = yT + _repulsion_sweep_rolledT(
                yT, offset, idxT_full, scale_iT, gamma, b, n_neg,
                neg_weight=neg_weight,
                neighbor_exclusion=neighbor_exclusion,
                parallel_kicks=parallel_kicks)
            return yT, None

        yT, _ = jax.lax.scan(body_t, y0.astype(jnp.float32).T,
                             (jnp.arange(seg_steps, dtype=jnp.int32),
                              keys))
        return yT.T

    # reference scatter path (move_other=True semantics), row-major
    groups = []
    for c in range(n_groups):
        sl = slice(c * kg, (c + 1) * kg)
        idx_g = indices[:, sl]
        flat = idx_g.reshape(-1)
        order = jnp.argsort(flat)
        groups.append(dict(
            idx=idx_g, w=w[:, sl], m=m_visit[:, sl],
            w_rev=w_rev[:, sl], m_rev=m_rev_visit[:, sl],
            order=order, dst_sorted=flat[order]))

    def make_branch(c):
        gd = groups[c]

        def branch(y, gamma, mask):
            d_self, d_rev = _attraction_sweep(
                y, gd["idx"], gd["w"], gd["m"], gd["w_rev"], gd["m_rev"],
                emb_scale, gamma, b, f_min=f_min, mask=mask,
                mask_p=mask_p)
            rev_sorted = d_rev.reshape(-1, dim)[gd["order"]]
            rev_sum = jax.ops.segment_sum(rev_sorted, gd["dst_sorted"],
                                          num_segments=n,
                                          indices_are_sorted=True)
            return y + d_self + rev_sum

        return branch

    branches = [make_branch(c) for c in range(n_groups)]

    def body(y, args):
        local_idx, kk = args
        step_idx = step0 + local_idx
        gamma = gamma_of(step_idx)
        if mask_p < 1.0:
            kk, k_mask = jax.random.split(kk)
            mask = jax.random.bernoulli(k_mask, mask_p,
                                        (n, kg)).astype(jnp.float32)
        else:
            mask = None
        y = jax.lax.switch(rot_of(step_idx, local_idx), branches, y,
                           gamma, mask)

        offset = jax.random.randint(kk, (), 0, n)
        d_neg = _repulsion_sweep_rolled(y, offset, indices, emb_scale,
                                        gamma, b, n_neg,
                                        neg_weight=neg_weight)
        return y + d_neg, None

    y, _ = jax.lax.scan(body, y0.astype(jnp.float32),
                        (jnp.arange(seg_steps, dtype=jnp.int32), keys))
    return y


#: bound sequential steps per device program: the cap scales inversely
#: with n (sweep cost is ~linear in n) so that no single program runs
#: for many minutes.  Whether a GPU needs the cap at all is not
#: measured yet (ROADMAP queue 3).
_MAX_SWEEPS_PER_PROGRAM = 2048
_SWEEP_REFERENCE_N = 70_000


def _segment_cap(n: int, n_groups: int) -> int:
    # (group rotation uses the GLOBAL step index, so segment sizes need
    # no n_groups alignment)
    cap = (_MAX_SWEEPS_PER_PROGRAM * _SWEEP_REFERENCE_N
           // max(n, _SWEEP_REFERENCE_N))
    return max(cap, n_groups)


def dense_optimize(y0, indices, w, m_visit, w_rev, m_rev_visit,
                   emb_scale, key, neg_weight,
                   grad_step_init: float, b: float, n_sub: int,
                   n_neg: int, nb_grad_batch: int, n_groups: int = 1,
                   scatter_free: bool = True, f_min: float = 1e-3,
                   mask_p: float = 1.0, batch0: int = 0,
                   batch1: int | None = None, rot_base: int | None = None,
                   n_blocks: int = 1, packed_gather: bool = False,
                   neighbor_exclusion: bool = True,
                   parallel_kicks: bool = False,
                   gather_reuse: int = 1,
                   gather_reuse_after: float = 0.0):
    """Run batches [batch0, batch1) of the global nb_grad_batch
    schedule at this n_sub (defaults = the whole schedule).  Returns
    the updated coordinates; ``rot_base`` (global sweep counter at
    phase start) keeps column-group rotation continuous when phases
    have different n_sub."""
    if batch1 is None:
        batch1 = nb_grad_batch
    # the reference's 1..=nb schedule (embedder.rs:873-876) runs its
    # final batch at gamma = grad_step*(1 - nb/nb) = 0 — a provable
    # no-op for both sweeps — so we keep the schedule and simply don't
    # execute those steps (saves ~1/nb of the optimize wall)
    eff_batches = max(min(batch1, nb_grad_batch - 1) - batch0, 0)
    total_steps = eff_batches * n_sub
    if total_steps == 0:
        return y0
    gather_reuse = max(int(gather_reuse), 1)
    if gather_reuse > 1 and (not scatter_free or n_blocks > 1):
        raise ValueError("gather_reuse > 1 requires the transposed "
                         "scatter-free path with n_blocks=1")
    # stale-gather activation step: sweeps whose GLOBAL batch index is
    # within the first gather_reuse_after fraction of the schedule run
    # exact (fresh gather); later sweeps (small gamma, small per-sweep
    # displacement) run stale.  act is phase-local.
    act = 0
    if gather_reuse > 1 and gather_reuse_after > 0.0:
        boundary = int(gather_reuse_after * nb_grad_batch)  # batches
        act = min(max((boundary - batch0) * n_sub, 0), total_steps)
    # per-sweep cost scales with the block size, so the per-program
    # sweep cap scales with n_blocks (same device seconds per program)
    cap = min(total_steps,
              _segment_cap(max(y0.shape[0] // n_blocks, 1), n_groups))
    ranges = ([(0, total_steps, gather_reuse)] if act == 0 else
              [(0, act, 1), (act, total_steps, gather_reuse)])
    # materialize the segment list first so the per-segment key stream
    # depends only on (total_steps, cap, act) — for gather_reuse=1 it
    # is identical to the historical single-range segmentation
    segments = []
    for lo, hi, s_r in ranges:
        if hi <= lo:
            continue
        seg = cap
        if s_r > 1 and seg > s_r:
            # S-align segment sizes so every stale block except the
            # range's final remainder is a full S sweeps
            seg -= seg % s_r
        pos = lo
        while pos < hi:
            # the last segment of a range runs only the REMAINING
            # steps (one extra compile for the remainder shape):
            # padding it would execute zero-gamma no-op sweeps at full
            # device cost (~4% of the optimize wall at 2M)
            segments.append((pos, min(seg, hi - pos), s_r))
            pos += seg
    y = y0
    keys = jax.random.split(key, len(segments))
    for ki, (pos, seg_steps, s_r) in enumerate(segments):
        y = _dense_segment(y, indices, w, m_visit, w_rev, m_rev_visit,
                           emb_scale, keys[ki], neg_weight,
                           grad_step_init=grad_step_init, b=b,
                           n_sub=n_sub, n_neg=n_neg,
                           nb_grad_batch=nb_grad_batch,
                           n_groups=n_groups, scatter_free=scatter_free,
                           step0=jnp.int32(pos), seg_steps=seg_steps,
                           f_min=f_min, mask_p=mask_p, batch0=batch0,
                           rot0=(jnp.int32(0) if rot_base is None
                                 else jnp.int32(rot_base + pos)),
                           use_rot0=rot_base is not None,
                           n_blocks=n_blocks,
                           packed_gather=packed_gather,
                           neighbor_exclusion=neighbor_exclusion,
                           parallel_kicks=parallel_kicks,
                           gather_reuse=s_r)
    return y


def _auto_groups(k: int) -> int:
    # 2 groups measured best on the transposed sweep: quality beats the
    # round-1 anchor (no_match 14071 vs 18178 at 70k) while the
    # per-sweep gather stays at k/2 columns; 3+ groups slice the edge
    # table too thin per sync step and conservation degrades
    for g in (2, 3, 4):
        if k % g == 0 and k // g >= 2:
            return g
    return 1


def prepare_dense_inputs(y0, g: KGraph, npar: NodeParams,
                         params: EmbedderParams, n_sub: int,
                         n_groups: int, neg_weights=None):
    """Relabel-once prologue shared by the single-chip driver and
    parallel/sharded.py::sharded_dense_optimize (it was a verbatim
    copy there): one global random permutation (uniform rolled-pool
    negatives even on class-sorted input), per-visit multiplicities,
    reverse-edge weights, clamped hubness importance weights.

    Returns (y0_r, indices_r, w, m_visit, w_rev, m_rev_visit,
    emb_scale, neg_weight, n_neg, key, inv); ``inv`` maps positions
    back to the original row order."""
    n, k = g.indices.shape
    key = jax.random.PRNGKey(params.seed)
    key, k_relabel = jax.random.split(key)
    relabel = jax.random.permutation(k_relabel, n)   # position -> old id
    inv = jnp.argsort(relabel)                       # old id -> position
    indices_r = inv[g.indices[relabel]].astype(jnp.int32)
    w = npar.probas.astype(jnp.float32)[relabel]
    emb_scale = embedded_scales_from_initial(npar.scale)[relabel]
    y0_r = jnp.asarray(y0, jnp.float32)[relabel]

    # expected samples of edge e per *visit* (a group is visited every
    # n_groups-th sweep, n_sub / n_groups visits per batch)
    m_visit = params.nb_sampling_by_edge * k * w * n_groups / n_sub
    w_rev = reverse_edge_info(indices_r, w)
    m_rev_visit = params.nb_sampling_by_edge * k * w_rev * n_groups / n_sub
    # negatives per node per sub-sweep
    n_neg = max(1, round(NB_NEGATIVE * params.nb_sampling_by_edge * k
                         / n_sub))
    # hubness weighting via importance weights (mean 1, clamped to
    # [0.25, 4] to bound the per-kick cap)
    neg_weight = None
    if neg_weights is not None:
        nw = jnp.asarray(neg_weights, jnp.float32)[relabel]
        nw = nw / jnp.maximum(jnp.mean(nw), 1e-30)
        neg_weight = jnp.clip(nw, 0.25, 4.0)
    return (y0_r, indices_r, w, m_visit, w_rev, m_rev_visit, emb_scale,
            neg_weight, n_neg, key, inv)


def run_dense_optimization(y0, g: KGraph, npar: NodeParams,
                           params: EmbedderParams,
                           n_sub: int = 60,
                           n_groups: int = 0,
                           neg_weights=None) -> Tuple[jnp.ndarray, dict]:
    """Driver with the reference's parameter semantics.

    Nodes are relabeled by one global random permutation so the rolled
    identity-pool negative sampler sees uniformly random negatives even
    if the input rows are ordered (e.g. sorted by class); the output is
    returned in the original order.

    ``params.n_sub_schedule`` (a tuple of (n_batches, n_sub) phases
    summing to nb_grad_batch) runs the SAME global gamma decay with a
    different sub-sweep granularity per phase — e.g. coarse sub-sweeps
    while gamma is large, fine ones for the late polishing — trading
    conservation against total sweep count (the per-sweep cost is
    granularity-independent; PERF.md gather floor).

    ``params.dense_n_blocks`` > 1 splits every sub-sweep into node
    blocks (see _dense_segment): per-edge visits per batch — and the
    per-batch gather volume that floors the large-n wall — drop to
    n_sub / (n_groups * n_blocks) while the sync granularity stays at
    n_sub * n_blocks block-updates per batch."""
    n, k = g.indices.shape
    if n_groups <= 0:
        n_groups = _auto_groups(k)
    n_blocks = max(int(getattr(params, "dense_n_blocks", 1)), 1)
    if n_blocks > 1 and not params.dense_scatter_free:
        raise ValueError("dense_n_blocks > 1 requires the transposed "
                         "scatter-free path (dense_scatter_free=True)")
    # packed gather applies only where it can be bit-exact: d=2 on the
    # transposed path (complex64 = exactly two f32 lanes)
    packed = (bool(getattr(params, "dense_packed_gather", False))
              and params.dense_scatter_free
              and jnp.asarray(y0).shape[1] == 2)
    schedule = getattr(params, "n_sub_schedule", None)
    if not schedule:
        schedule = ((int(params.nb_grad_batch), n_sub),)
    else:
        schedule = tuple((int(nb), int(s)) for nb, s in schedule)
        if sum(nb for nb, _ in schedule) != int(params.nb_grad_batch):
            raise ValueError(
                f"n_sub_schedule batches {schedule} must sum to "
                f"nb_grad_batch={params.nb_grad_batch}")
    # Equal per-batch (group, block) coverage needs n_sub divisible by
    # n_groups*n_blocks.  Enforced only when blocks are on: the flat
    # path has always accepted any n_sub (group rotation is continuous
    # across batches, so coverage evens out over the run).
    if n_blocks > 1:
        for _, s_p in schedule:
            if s_p % (n_groups * n_blocks) != 0:
                raise ValueError(
                    f"n_sub={s_p} must be divisible by n_groups*"
                    f"n_blocks={n_groups}*{n_blocks} for equal edge "
                    f"coverage")
    (y0_r, indices_r, w, m_visit, w_rev, m_rev_visit, emb_scale,
     neg_weight, n_neg, key, inv) = prepare_dense_inputs(
        y0, g, npar, params, schedule[0][1], n_groups, neg_weights)
    nb_total = int(params.nb_grad_batch)
    y_r, batch_cursor, rot, sweeps = y0_r, 0, 0, 0
    for nb_p, s_p in schedule:
        # per-visit multiplicity and negatives-per-sweep scale as
        # 1/n_sub (prepare computed them for schedule[0][1]) and as
        # n_blocks (each node appears in 1/n_blocks of the sweeps)
        scale_m = schedule[0][1] * n_blocks / s_p
        n_neg_p = max(1, round(NB_NEGATIVE * params.nb_sampling_by_edge
                               * k * n_blocks / s_p))
        if len(schedule) > 1:
            key, k_p = jax.random.split(key)
        else:
            k_p = key          # legacy stream: single phase == old path
        y_r = dense_optimize(y_r, indices_r, w, m_visit * scale_m,
                             w_rev, m_rev_visit * scale_m, emb_scale,
                             k_p, neg_weight,
                             grad_step_init=float(params.grad_step),
                             b=float(params.b), n_sub=s_p, n_neg=n_neg_p,
                             nb_grad_batch=nb_total,
                             n_groups=n_groups,
                             scatter_free=params.dense_scatter_free,
                             f_min=float(params.dense_f_min),
                             mask_p=float(params.dense_mask_p),
                             batch0=batch_cursor,
                             batch1=batch_cursor + nb_p,
                             rot_base=(rot if len(schedule) > 1
                                       else None),
                             n_blocks=n_blocks, packed_gather=packed,
                             neighbor_exclusion=bool(getattr(
                                 params, "dense_neighbor_exclusion",
                                 True)),
                             parallel_kicks=bool(getattr(
                                 params, "dense_parallel_kicks",
                                 False)),
                             gather_reuse=max(int(getattr(
                                 params, "dense_gather_reuse", 1)), 1),
                             gather_reuse_after=float(getattr(
                                 params, "dense_gather_reuse_after",
                                 0.0)))
        executed = max(min(batch_cursor + nb_p, nb_total - 1)
                       - batch_cursor, 0) * s_p
        rot += executed
        sweeps += executed
        batch_cursor += nb_p
    y = y_r[inv]
    info = {"optimizer": "dense", "n_sub": n_sub, "n_neg": n_neg,
            "n_groups": n_groups, "f_min": float(params.dense_f_min),
            "mask_p": float(params.dense_mask_p),
            # executed sweeps: the schedule's zero-gamma final batch is
            # skipped (see total_steps in dense_optimize)
            "sweeps": sweeps}
    if n_blocks > 1:
        info["n_blocks"] = n_blocks
    if len(schedule) > 1:
        info["n_sub_schedule"] = schedule
    if getattr(params, "dense_parallel_kicks", False):
        info["parallel_kicks"] = 1
    if int(getattr(params, "dense_gather_reuse", 1)) > 1:
        info["gather_reuse"] = int(params.dense_gather_reuse)
    return y, info
