"""Cross-entropy embedding optimizer: batched negative-sampling SGD.

Rebuilds the reference's Hogwild hot loop ``ce_optim_edge_shannon``
(src/embedder.rs:1167-1302) as synchronous mini-batched SGD under
``lax.scan`` — lock-per-node asynchronous updates do not map to SIMD
hardware (SURVEY.md §2.3); instead each step samples a batch of
positive edges + 5 negatives each, computes the exact reference
per-sample updates, and applies them with one scatter-add.

Preserved constants and formulas (embedder.rs:1216-1299):
  * embedded weight:  cauchy = 1 / (1 + (d/scale)^{2b})
  * common coeff:     2 b cauchy (d2/scale^2)^{b-1} / scale^2
  * attraction:       coeff_ij = max(step * coeff * (-w + (1-w) *
                      1/max(d2s^2, 1/PROBA_MIN)), -0.49); y_i -= g, y_j += g
                      with g = (y_j - y_i) * coeff_ij
  * repulsion (5 negative samples, neighbours of i excluded,
    embedder.rs:1241-1252): coeff_ik = min(step * coeff *
    1/max(d2s^2, 1/16), 2.0); y_i -= (y_k - y_i) * coeff_ik
  * embedded scales = 0.2 * clamp(rho_i / mean(rho), 1/4, 4)
    (embedder.rs:1356-1373)
  * step decay: gamma = gamma_0 * (1 - iter/nb_batch) across
    nb_grad_batch outer batches (embedder.rs:875)

Weighted positive-edge sampling uses Walker/Vose alias tables built
natively (utils/alias.py, replacing the WeightedAliasIndex of
embedder.rs:987): O(1) per draw, two gathers + a compare; the
inverse-CDF path is kept as fallback and for the sharded stratified
sampler.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..params import EmbedderParams, PROBA_MIN
from ..graph.kgraph import KGraph
from ..graph.proba import NodeParams

logger = logging.getLogger(__name__)

NB_NEGATIVE = 5  # fixed in the reference (embedder.rs:1241)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EdgeSet:
    """Flattened positive edges + sampling tables (EntropyOptim state,
    embedder.rs:936-951, minus the RwLock'd coordinates)."""

    src: jnp.ndarray            # (E,) int32
    dst: jnp.ndarray            # (E,) int32
    weight: jnp.ndarray         # (E,) f32 calibrated edge probabilities
    edge_cdf: jnp.ndarray       # (E,) f32 cumulative weight (last = 1)
    neighbors: jnp.ndarray      # (n, k) int32 for negative rejection
    embedded_scale: jnp.ndarray  # (n,) f32
    # O(1) alias sampling tables (replace the WeightedAliasIndex of the
    # reference; edge_cdf is kept for the stratified sharded path)
    edge_prob: Optional[jnp.ndarray] = None   # (E,) f32
    edge_alias: Optional[jnp.ndarray] = None  # (E,) i32
    # hubness-weighted negative sampling (alias tables; the sharded
    # path builds its own per-shard cdf)
    neg_prob: Optional[jnp.ndarray] = None
    neg_alias: Optional[jnp.ndarray] = None

    @property
    def nb_edges(self) -> int:
        return self.src.shape[0]

    @property
    def nb_nodes(self) -> int:
        return self.neighbors.shape[0]


def embedded_scales_from_initial(scale: jnp.ndarray) -> jnp.ndarray:
    """0.2 * clamp(rho/mean, 1/4, 4) (embedder.rs:1356-1373)."""
    mean = jnp.mean(scale)
    return 0.2 * jnp.clip(scale / jnp.maximum(mean, 1e-30), 0.25, 4.0)


def build_edge_set(g: KGraph, npar: NodeParams,
                   hubness_weights: Optional[jnp.ndarray] = None) -> EdgeSet:
    from ..utils.alias import build_alias_table

    n, k = g.indices.shape
    src = jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
    dst = g.indices.reshape(-1)
    w = npar.probas.reshape(-1).astype(jnp.float32)
    cdf = jnp.cumsum(w)
    cdf = cdf / cdf[-1]
    edge_prob, edge_alias = build_alias_table(w)
    neg_prob = neg_alias = None
    if hubness_weights is not None:
        neg_prob, neg_alias = build_alias_table(hubness_weights)
    return EdgeSet(src=src, dst=dst, weight=w, edge_cdf=cdf,
                   neighbors=g.indices,
                   embedded_scale=embedded_scales_from_initial(npar.scale),
                   edge_prob=edge_prob, edge_alias=edge_alias,
                   neg_prob=neg_prob, neg_alias=neg_alias)


# ---------------------------------------------------------------------------
# CE objective (monitoring)
# ---------------------------------------------------------------------------

def _cauchy_weight(d2_scaled: jnp.ndarray, b: float) -> jnp.ndarray:
    """1 / (1 + (d^2/scale^2)^b), clamped below 1 (embedder.rs:1322-1345)."""
    w = 1.0 / (1.0 + jnp.power(jnp.maximum(d2_scaled, 0.0), b))
    return jnp.minimum(w, 1.0 - 1e-7)


@functools.partial(jax.jit, static_argnames=("b", "n_chunks"))
def ce_value(y: jnp.ndarray, es: EdgeSet, b: float = 1.0,
             n_chunks: int = 16) -> jnp.ndarray:
    """Shannon cross entropy between graph and embedded edge weights
    (embedder.rs:1127-1163)."""
    e = es.nb_edges
    chunk = -(-e // n_chunks)
    pad = n_chunks * chunk - e
    srcp = jnp.pad(es.src, (0, pad))
    dstp = jnp.pad(es.dst, (0, pad))
    wp = jnp.pad(es.weight, (0, pad))
    maskp = jnp.pad(jnp.ones((e,), jnp.float32), (0, pad))

    def one(args):
        s, d_, w, m = args
        yi, yj = y[s], y[d_]
        scale = es.embedded_scale[s]
        d2s = jnp.sum(jnp.square(yi - yj), -1) / jnp.square(scale)
        we = _cauchy_weight(d2s, b)
        term = -w * jnp.log(we) - (1.0 - w) * jnp.log1p(-we)
        return jnp.sum(term * m)

    parts = jax.lax.map(one, (srcp.reshape(n_chunks, chunk),
                              dstp.reshape(n_chunks, chunk),
                              wp.reshape(n_chunks, chunk),
                              maskp.reshape(n_chunks, chunk)))
    return jnp.sum(parts)


@functools.partial(jax.jit, static_argnames=("b", "n_chunks"))
def ce_value_dense(y, g: KGraph, probas, scale, b: float = 1.0,
                   n_chunks: int = 16):
    """Cross entropy directly from the (n, k) layout (used by the dense
    optimizer; same value as ce_value on the flattened edges).

    Row-slabbed under ``lax.map``: the direct form materializes
    (n, k, d) + several (n, k) temporaries (gigabytes at 11M nodes,
    on top of the resident pipeline).  Slabbing caps the temporaries at
    ~1/n_chunks with identical output."""
    n, k = g.indices.shape
    emb_scale = embedded_scales_from_initial(scale)
    chunk = -(-n // n_chunks)
    pad = n_chunks * chunk - n
    idxp = jnp.pad(g.indices, ((0, pad), (0, 0)))
    wp = jnp.pad(probas, ((0, pad), (0, 0)))
    sp = jnp.pad(emb_scale, (0, pad), constant_values=1.0)
    yip = jnp.pad(y, ((0, pad), (0, 0)))
    maskp = jnp.pad(jnp.ones((n,), jnp.float32), (0, pad))

    def one(args):
        yi, idx, w, s, m = args
        yj = y[idx]                                    # (chunk, k, d)
        d2s = jnp.sum(jnp.square(yi[:, None, :] - yj), -1) \
            / jnp.square(s)[:, None]
        we = _cauchy_weight(d2s, b)
        term = -w * jnp.log(we) - (1.0 - w) * jnp.log1p(-we)
        return jnp.sum(term * m[:, None])

    parts = jax.lax.map(one, (yip.reshape(n_chunks, chunk, -1),
                              idxp.reshape(n_chunks, chunk, k),
                              wp.reshape(n_chunks, chunk, k),
                              sp.reshape(n_chunks, chunk),
                              maskp.reshape(n_chunks, chunk)))
    return jnp.sum(parts)


# ---------------------------------------------------------------------------
# one mini-batch update
# ---------------------------------------------------------------------------

def _common_coeff(d2s: jnp.ndarray, scale: jnp.ndarray, b: float):
    """2 b cauchy d2s^{b-1} / scale^2 (embedder.rs:1216-1222)."""
    if b == 1.0:
        cauchy = 1.0 / (1.0 + d2s)
        return 2.0 * cauchy / jnp.square(scale)
    cauchy = 1.0 / (1.0 + jnp.power(jnp.maximum(d2s, 1e-30), b))
    return 2.0 * b * cauchy * jnp.power(jnp.maximum(d2s, 1e-30), b - 1.0) \
        / jnp.square(scale)


def minibatch_update(y: jnp.ndarray, key: jax.Array, es: EdgeSet,
                     grad_step: jnp.ndarray, b: float,
                     batch_size: int,
                     collision_mode: str = "sum") -> jnp.ndarray:
    """One synchronous batch of the reference per-sample update.

    collision_mode: "sum" adds all sampled updates of a node (closest to
    Hogwild for low collision rates); "mean" divides each node's
    accumulated update by its touch count, which bounds the effective
    per-node step like sequential application and allows much larger
    batches.
    """
    n, dim = y.shape
    k_edge, k_neg = jax.random.split(key)

    # --- positive edge sample (weighted, O(1) alias method) ---
    if es.edge_prob is not None:
        from ..utils.alias import alias_sample
        eidx = alias_sample(k_edge, es.edge_prob, es.edge_alias,
                            (batch_size,))
    else:
        u = jax.random.uniform(k_edge, (batch_size,))
        eidx = jnp.minimum(jnp.searchsorted(es.edge_cdf, u),
                           es.nb_edges - 1)
    i = es.src[eidx]
    j = es.dst[eidx]
    w = es.weight[eidx]

    yi = y[i]                       # (B, dim)
    yj = y[j]
    scale = es.embedded_scale[i]    # (B,)
    d2 = jnp.sum(jnp.square(yi - yj), -1)
    d2s = d2 / jnp.square(scale)

    coeff = _common_coeff(d2s, scale, b)
    alfa_att = 1.0 / PROBA_MIN      # repulsion annihilation (embedder.rs:1225)
    coeff_rep_att = 1.0 / jnp.maximum(jnp.square(d2s), alfa_att)
    coeff_ij = jnp.maximum(
        grad_step * coeff * (-w + (1.0 - w) * coeff_rep_att), -0.49)
    coeff_ij = jnp.where(d2s > 0.0, coeff_ij, 0.0)
    g_att = (yj - yi) * coeff_ij[:, None]      # (B, dim)

    # --- negative samples ---
    if es.neg_prob is not None:
        from ..utils.alias import alias_sample
        neg = alias_sample(k_neg, es.neg_prob, es.neg_alias,
                           (batch_size, NB_NEGATIVE))
    else:
        neg = jax.random.randint(k_neg, (batch_size, NB_NEGATIVE), 0, n,
                                 dtype=jnp.int32)
    # reject neg == i, neg == j, or neg in neighbours(i)
    # (embedder.rs:1246-1252); rejected samples contribute nothing
    nbrs_i = es.neighbors[i]                   # (B, k)
    is_nbr = (neg[:, :, None] == nbrs_i[:, None, :]).any(-1)
    reject = (neg == i[:, None]) | (neg == j[:, None]) | is_nbr

    yk = y[neg]                                # (B, 5, dim)
    d2k = jnp.sum(jnp.square(yi[:, None, :] - yk), -1)
    d2ks = d2k / jnp.square(scale)[:, None]
    coeff_k = _common_coeff(d2ks, scale[:, None], b)
    coeff_rep = 1.0 / jnp.maximum(jnp.square(d2ks), 1.0 / 16.0)
    coeff_ik = jnp.minimum(grad_step * coeff_k * coeff_rep, 2.0)
    coeff_ik = jnp.where((d2ks > 0.0) & jnp.logical_not(reject),
                         coeff_ik, 0.0)
    g_rep = (yk - yi[:, None, :]) * coeff_ik[:, :, None]  # (B, 5, dim)

    # --- scatter updates: y_i -= g_att + sum_k g_rep ; y_j += g_att ---
    # single fused scatter over concatenated targets
    delta_i = -(g_att + jnp.sum(g_rep, axis=1))
    all_idx = jnp.concatenate([i, j])
    all_upd = jnp.concatenate([delta_i, g_att])
    if collision_mode == "mean":
        acc = jnp.zeros_like(y).at[all_idx].add(all_upd)
        cnt = jnp.zeros((n, 1), jnp.float32).at[all_idx].add(1.0)
        return y + acc / jnp.maximum(cnt, 1.0)
    return y.at[all_idx].add(all_upd)


@functools.partial(jax.jit,
                   static_argnames=("b", "batch_size", "steps_per_batch",
                                    "nb_grad_batch", "collision_mode"))
def _optimize_segment(y0: jnp.ndarray, es: EdgeSet, keys: jnp.ndarray,
                      step0: jnp.ndarray, grad_step_init: float, b: float,
                      batch_size: int, steps_per_batch: int,
                      nb_grad_batch: int,
                      collision_mode: str = "sum") -> jnp.ndarray:
    """One bounded scan segment (steps [step0, step0 + len(keys)))."""

    def body(y, args):
        local_idx, k = args
        step_idx = step0 + local_idx
        batch_idx = step_idx // steps_per_batch + 1
        # clamp at 0: segment padding steps past the schedule must be
        # no-ops, not negative-step (sign-flipped) updates
        gamma = jnp.maximum(
            grad_step_init * (1.0 - batch_idx.astype(jnp.float32)
                              / nb_grad_batch), 0.0)
        y = minibatch_update(y, k, es, gamma, b, batch_size,
                             collision_mode=collision_mode)
        return y, None

    y, _ = jax.lax.scan(body, y0,
                        (jnp.arange(keys.shape[0], dtype=jnp.int32), keys))
    return y


#: One device program is capped at this many sequential steps (the
#: scan is split into programs of at most this length).
MAX_STEPS_PER_PROGRAM = 8192


def optimize(y0: jnp.ndarray, es: EdgeSet, key: jax.Array,
             grad_step_init: float, b: float, batch_size: int,
             steps_per_batch: int, nb_grad_batch: int,
             collision_mode: str = "sum") -> jnp.ndarray:
    """Full optimization: nb_grad_batch outer batches, linear step decay
    gamma_0 * (1 - iter/nb_batch) (embedder.rs:873-879), each batch made
    of steps_per_batch synchronous mini-batches.  Split into bounded
    scan segments (one compile, several dispatches).

    The schedule's final batch runs at gamma = 0 (batch_idx =
    nb_grad_batch zeroes the linear decay) — a provable per-step no-op,
    so it is skipped outright, same as the dense path."""
    total_steps = steps_per_batch * max(nb_grad_batch - 1, 0)
    if total_steps == 0:
        return y0
    seg = min(total_steps, MAX_STEPS_PER_PROGRAM)
    n_segs = -(-total_steps // seg)
    keys = jax.random.split(key, total_steps)
    y = y0
    for s in range(n_segs):
        # the last segment runs only the remaining steps (one extra
        # compile for the remainder shape) — padding it to seg would
        # execute zero-gamma no-op steps at full sample+gather+scatter
        # cost.  _optimize_segment is module-level jitted — calling it
        # directly keeps one compile cache across optimize()
        # invocations.
        s1 = min((s + 1) * seg, total_steps)
        y = _optimize_segment(
            y, es, keys[s * seg:s1],
            jnp.int32(s * seg), grad_step_init=grad_step_init, b=b,
            batch_size=batch_size, steps_per_batch=steps_per_batch,
            nb_grad_batch=nb_grad_batch, collision_mode=collision_mode)
    return y


def run_entropy_optimization(y0: jnp.ndarray, es: EdgeSet,
                             params: EmbedderParams,
                             compute_ce: bool = True) -> Tuple[jnp.ndarray, dict]:
    """Driver mirroring ``entropy_optimize`` (embedder.rs:794-904).

    The mini-batch size is capped at ~n/7 so that a node is touched
    about once per synchronous batch (each sample updates 2 endpoints +
    5 negatives): summed collisions beyond that overshoot the
    sequential Hogwild dynamics the update constants were tuned for.
    ``params.batch_size`` acts as an upper bound.
    """
    e = es.nb_edges
    n = es.nb_nodes
    if params.collision_mode == "mean":
        batch_size = min(params.batch_size, max(256, e))
    else:
        collision_cap = max(256, n // (2 + NB_NEGATIVE))
        batch_size = min(params.batch_size, collision_cap, max(256, e))
    samples_per_batch = params.nb_sampling_by_edge * e
    steps_per_batch = max(1, -(-samples_per_batch // batch_size))
    info = {}
    if compute_ce:
        # device scalar, NOT float(): converted at the final sync
        info["initial_ce"] = ce_value(y0, es, b=params.b)
    key = jax.random.PRNGKey(params.seed)
    y = optimize(y0.astype(jnp.float32), es, key,
                 grad_step_init=float(params.grad_step), b=float(params.b),
                 batch_size=batch_size, steps_per_batch=steps_per_batch,
                 nb_grad_batch=int(params.nb_grad_batch),
                 collision_mode=params.collision_mode)
    if compute_ce:
        info["final_ce"] = ce_value(y, es, b=params.b)
    info["batch_size"] = batch_size
    info["steps_per_batch"] = steps_per_batch
    return y, info
