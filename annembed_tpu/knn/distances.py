"""Batched distance panels, matmul-first.

Replaces the SIMD distance kernels of the reference's ``hnsw_rs``
dependency (reference Cargo.toml:125-126 SIMD features; distances
DistL1/L2/Cosine/Jeffreys/JensenShannon dispatched in
src/bin/embed.rs:546-565).

The central object is a *panel*: distances between a block of queries
``q: (b, d)`` and the full corpus ``x: (m, d)``.  L2 and cosine are a
single matmul; L1/Jeffreys/JensenShannon are elementwise reductions
computed in corpus tiles to bound memory.

Each metric's elementwise formula lives exactly once, in its
broadcastable pair function (``_l1_pair`` etc.); the elementwise panels are the
same function tiled over the corpus, so panel construction and
gather-style joins (IVF local join, NN-descent scoring) cannot drift.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

Metric = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]

_EPS = 1.0e-12
#: probability-vector clamp used by hnsw_rs (distances.rs ``M_MIN``);
#: materially larger clamps change Jeffreys distances on sparse vectors
_M_MIN = 1.0e-30


# ---------------------------------------------------------------------------
# broadcastable pair-distance forms — the single source of truth per
# metric; used directly for gather-style joins and tiled into panels
# ---------------------------------------------------------------------------

def _l2_pair(a, b):
    return jnp.sqrt(jnp.maximum(jnp.sum(jnp.square(a - b), -1), 0.0))


def _l1_pair(a, b):
    return jnp.sum(jnp.abs(a - b), -1)


def _cosine_pair(a, b):
    num = jnp.sum(a * b, -1)
    na = jnp.sqrt(jnp.sum(jnp.square(a), -1))
    nb = jnp.sqrt(jnp.sum(jnp.square(b), -1))
    cos = num / jnp.maximum(na * nb, _EPS)
    # hnsw_rs DistCosine returns distance 0 when either norm is zero
    # (degenerate input; replicated for graph parity with the reference)
    return jnp.where((na <= 0.0) | (nb <= 0.0), 0.0, 1.0 - cos)


def _jeffreys_pair(a, b):
    # hnsw_rs DistJeffreys clamps components at M_MIN = 1e-30
    ratio = jnp.maximum(a, _M_MIN) / jnp.maximum(b, _M_MIN)
    return jnp.sum((a - b) * jnp.log(ratio), -1)


def _xlogy(p, r):
    # p * log(r) with 0 log 0 = 0
    return jnp.where(p > 0.0, p * jnp.log(jnp.maximum(r, _EPS)), 0.0)


def _js_pair(a, b):
    m = 0.5 * (a + b)
    js = 0.5 * jnp.sum(_xlogy(a, a / jnp.maximum(m, _EPS)), axis=-1) \
        + 0.5 * jnp.sum(_xlogy(b, b / jnp.maximum(m, _EPS)), axis=-1)
    return jnp.sqrt(jnp.maximum(js, 0.0))


_PAIRS = {
    "DistL2": _l2_pair,
    "DistL1": _l1_pair,
    "DistCosine": _cosine_pair,
    "DistJeffreys": _jeffreys_pair,
    "DistJensenShannon": _js_pair,
}


# ---------------------------------------------------------------------------
# panels
# ---------------------------------------------------------------------------

#: below this feature count, f32 panel matmuls run at Precision.HIGHEST.
#: At DEFAULT precision a GPU runs f32 matmuls in TF32 (about three
#: decimal digits); for LOW-d clouds (embedded 2-D coordinates above
#: all) the ||q||^2+||x||^2-2qx cancellation then corrupts
#: near-neighbour ordering so badly that candidate selection returns a
#: quasi-random near-ball — reduced-precision passes were measured to
#: deflate the quality metric's no-match count 4x (PERF.md "quality
#: radius was precision-inflated").  At d <= 32 the matmul is a
#: negligible fraction of the panel wall, so exactness is free; high-d
#: panels keep DEFAULT (reduced-precision candidates + the exact f32
#: rerank cover them).
_HIGHEST_PRECISION_MAX_D = 32


def _panel_precision(d: int, dtype):
    return (jax.lax.Precision.HIGHEST
            if d <= _HIGHEST_PRECISION_MAX_D
            and jnp.dtype(dtype) == jnp.float32 else None)


def l2_panel(q: jnp.ndarray, x: jnp.ndarray, x_sqnorm: jnp.ndarray | None = None,
             dtype=jnp.float32) -> jnp.ndarray:
    """Euclidean distances ||q_i - x_j|| as a (b, m) panel.

    Computed as sqrt(max(||q||^2 + ||x||^2 - 2 q.x, 0)) so the O(b*m*d)
    work is one matmul.  Matches hnsw_rs ``DistL2`` (true euclidean
    norm, not squared).
    """
    qf = q.astype(dtype)
    xf = x.astype(dtype)
    q_sq = jnp.sum(jnp.square(q.astype(jnp.float32)), axis=-1)  # (b,)
    if x_sqnorm is None:
        x_sqnorm = jnp.sum(jnp.square(x.astype(jnp.float32)), axis=-1)  # (m,)
    cross = jnp.dot(qf, xf.T, preferred_element_type=jnp.float32,
                    precision=_panel_precision(q.shape[-1], dtype))
    d2 = q_sq[:, None] + x_sqnorm[None, :] - 2.0 * cross
    return jnp.sqrt(jnp.maximum(d2, 0.0))


def cosine_panel(q: jnp.ndarray, x: jnp.ndarray, x_sqnorm=None,
                 dtype=jnp.float32) -> jnp.ndarray:
    """Cosine distance 1 - cos(q, x), as in hnsw_rs ``DistCosine``
    (including its zero-norm -> distance 0 convention)."""
    qf = q.astype(dtype)
    xf = x.astype(dtype)
    q_n = jnp.sqrt(jnp.sum(jnp.square(q.astype(jnp.float32)), axis=-1))
    if x_sqnorm is None:
        x_sqnorm = jnp.sum(jnp.square(x.astype(jnp.float32)), axis=-1)
    x_n = jnp.sqrt(x_sqnorm)
    cross = jnp.dot(qf, xf.T, preferred_element_type=jnp.float32,
                    precision=_panel_precision(q.shape[-1], dtype))
    cos = cross / jnp.maximum(q_n[:, None] * x_n[None, :], _EPS)
    zero = (q_n[:, None] <= 0.0) | (x_n[None, :] <= 0.0)
    return jnp.where(zero, 0.0, 1.0 - cos)


def _tiled_vpu_panel(q: jnp.ndarray, x: jnp.ndarray, pair_fn,
                     tile: int = 2048) -> jnp.ndarray:
    """Generic (b, m) panel for non-matmul metrics, tiled over the corpus.

    pair_fn maps (q: (b,1,d), xt: (1,t,d)) -> (b, t) distances.
    """
    b = q.shape[0]
    m, d = x.shape
    n_tiles = -(-m // tile)
    pad = n_tiles * tile - m
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    xt = xp.reshape(n_tiles, tile, d)

    def one(x_tile):
        return pair_fn(q[:, None, :], x_tile[None, :, :])

    panels = jax.lax.map(one, xt)  # (n_tiles, b, tile)
    out = jnp.moveaxis(panels, 0, 1).reshape(b, n_tiles * tile)
    return out[:, :m]


def l1_panel(q: jnp.ndarray, x: jnp.ndarray, x_sqnorm=None,
             dtype=jnp.float32) -> jnp.ndarray:
    """L1 (Manhattan) distance panel, hnsw_rs ``DistL1``."""
    del x_sqnorm, dtype
    return _tiled_vpu_panel(q.astype(jnp.float32), x.astype(jnp.float32),
                            _l1_pair)


def jeffreys_panel(q: jnp.ndarray, x: jnp.ndarray, x_sqnorm=None,
                   dtype=jnp.float32) -> jnp.ndarray:
    """Jeffreys divergence sum_i (p_i - q_i) ln(p_i/q_i) for probability
    vectors (hnsw_rs ``DistJeffreys``)."""
    del x_sqnorm, dtype
    return _tiled_vpu_panel(q.astype(jnp.float32), x.astype(jnp.float32),
                            _jeffreys_pair)


def jensenshannon_panel(q: jnp.ndarray, x: jnp.ndarray, x_sqnorm=None,
                        dtype=jnp.float32) -> jnp.ndarray:
    """sqrt of Jensen-Shannon divergence (hnsw_rs ``DistJensenShannon``)."""
    del x_sqnorm, dtype
    return _tiled_vpu_panel(q.astype(jnp.float32), x.astype(jnp.float32),
                            _js_pair)


_PANELS = {
    "DistL2": l2_panel,
    "DistL1": l1_panel,
    "DistCosine": cosine_panel,
    "DistJeffreys": jeffreys_panel,
    "DistJensenShannon": jensenshannon_panel,
}


def get_pair_fn(distance: str):
    """Broadcastable pair-distance dispatch (same names as panels)."""
    if distance not in _PAIRS:
        raise ValueError(
            f"unknown distance {distance!r}; valid: {sorted(_PAIRS)}")
    return _PAIRS[distance]


def get_panel_fn(distance: str):
    """Distance dispatch mirroring reference bin/embed.rs:546-565."""
    if distance not in _PANELS:
        raise ValueError(
            f"unknown distance {distance!r}; valid: {sorted(_PANELS)}")
    return _PANELS[distance]


def corpus_sqnorm(x: jnp.ndarray) -> jnp.ndarray:
    """Precomputed ||x||^2 shared across panels (L2/cosine only)."""
    return jnp.sum(jnp.square(x.astype(jnp.float32)), axis=-1)
