"""Fused L2 distance + running top-1: a Pallas kernel lowered through Triton.

Used by the hierarchical projection (every point -> its nearest sampled
point, knn/hierarchy.py; reference kgproj.rs:195-237).  The plain XLA
form (``knn_search_brute(k=1)``) writes a (block_rows, m) distance
panel to device memory and reads it back for ``top_k``; at the Higgs
projection (11M queries x 440k samples) that panel traffic is ~19 TB.
Here each program owns ``block_q`` queries, walks the corpus in
``tile_m``-row tiles inside the block (``lax.fori_loop``, pipelined by
Triton over ``_NUM_STAGES``) and keeps the running min/argmin in
registers, so no panel ever leaves the SM.

Ranking uses ``||c||^2 - 2 q.c`` (the per-row ``||q||^2`` does not
change the argmin).  The cross term runs at ``Precision.HIGHEST``,
which Triton lowers to IEEE float32 FMA (no TF32 rounding).  The
kernel returns indices only; the wrapper recomputes each chosen
distance exactly as ``||q - c||`` from the gathered corpus row.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

#: ``pl.dot`` on the Triton route needs every operand dimension >= 16
#: and power-of-two block shapes, so features pad to at least this.
_MIN_FEATURES = 16

#: Triton launch parameters: the fastest of the block/warp/stage shapes
#: timed at 2M x 440k x 28 on an H100 (PERF.md findings).
_NUM_WARPS = 4
_NUM_STAGES = 3


def _top1_kernel(q_ref, c_ref, csq_ref, idx_ref, *, tile_m: int):
    q = q_ref[...]                                   # (block_q, dp)
    n_tiles = c_ref.shape[0] // tile_m

    def body(j, carry):
        best, arg = carry
        rows = pl.ds(j * tile_m, tile_m)
        c = c_ref[rows, :]                           # (tile_m, dp)
        score = csq_ref[rows][None, :] - 2.0 * pl.dot(
            q, c, trans_b=True, precision=jax.lax.Precision.HIGHEST)
        t_min = jnp.min(score, axis=1)
        t_arg = jnp.argmin(score, axis=1).astype(jnp.int32) + j * tile_m
        upd = t_min < best
        return jnp.where(upd, t_min, best), jnp.where(upd, t_arg, arg)

    best0 = jnp.full((q.shape[0],), jnp.inf, jnp.float32)
    arg0 = jnp.zeros((q.shape[0],), jnp.int32)
    _, arg = jax.lax.fori_loop(0, n_tiles, body, (best0, arg0))
    idx_ref[...] = arg


def pad_operands(queries, corpus, block_q: int, tile_m: int):
    """Kernel operands: features zero-padded to a power of two (>= 16),
    queries to a multiple of ``block_q``, corpus rows to a multiple of
    ``tile_m``; padded corpus rows get a +inf squared norm so they never
    win the argmin.  Returns (q_pad, c_pad, csq)."""
    nq, d = queries.shape
    m = corpus.shape[0]
    dp = max(_MIN_FEATURES, pl.next_power_of_2(d))
    nq_p = -(-nq // block_q) * block_q
    m_p = -(-m // tile_m) * tile_m
    qp = jnp.pad(queries, ((0, nq_p - nq), (0, dp - d)))
    cp = jnp.pad(corpus, ((0, m_p - m), (0, dp - d)))
    csq = jnp.sum(jnp.square(cp), axis=1)
    csq = jnp.where(jnp.arange(m_p) < m, csq, jnp.inf)
    return qp, cp, csq


@functools.partial(jax.jit, static_argnames=("block_q", "tile_m",
                                             "interpret"))
def top1_l2(queries, corpus, block_q: int = 128, tile_m: int = 64,
            interpret: bool = False):
    """Nearest corpus row of each query: (idx (nq,) int32, dist (nq,)).

    ``block_q`` and ``tile_m`` must be powers of two.  ``interpret``
    runs the kernel in the Pallas interpreter (no GPU needed)."""
    queries = jnp.asarray(queries, jnp.float32)
    corpus = jnp.asarray(corpus, jnp.float32)
    nq = queries.shape[0]
    qp, cp, csq = pad_operands(queries, corpus, block_q, tile_m)
    m_p, dp = cp.shape
    idx = pl.pallas_call(
        functools.partial(_top1_kernel, tile_m=tile_m),
        out_shape=jax.ShapeDtypeStruct((qp.shape[0],), jnp.int32),
        grid=(qp.shape[0] // block_q,),
        in_specs=[
            pl.BlockSpec((block_q, dp), lambda i: (i, 0)),
            pl.BlockSpec((m_p, dp), lambda i: (0, 0)),
            pl.BlockSpec((m_p,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((block_q,), lambda i: (i,)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=_NUM_STAGES),
        interpret=interpret,
        name="top1_l2",
    )(qp, cp, csq)[:nq]
    dist = jnp.sqrt(jnp.sum(jnp.square(queries - corpus[idx]), axis=1))
    return idx, dist
