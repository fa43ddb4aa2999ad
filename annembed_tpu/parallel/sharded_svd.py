"""Sharded randomized SVD of the COO graph Laplacian.

The spectral (diffusion-maps) initialization is the second-hottest
phase of the pipeline (reference analogue: the randomized SVD inside
``embed_from_laplacian``, svdapprox.rs:343); on a mesh it was the last
single-device phase (parallel/sharded.py round-3 note).  Here the COO
SpMM inside the Halko-Tropp subspace iteration is sharded over the
1-D ``data`` mesh:

  * the nnz entry arrays (rows/cols/vals) are sharded; each device
    scatter-adds its entries' contributions into a local (n, r) panel
    and one ``psum`` merges them — SpMM = gather +
    segment-sum + all-reduce.
  * the (n, r) iterate, the QR factorizations and the final small SVD
    are replicated (r ~ rank+oversample ~ 30-35 columns: the QR is
    negligible next to the SpMM at large n, and replicating it keeps
    every device bit-identical without extra collectives).

Numerical note: per-device partial scatter-adds followed by psum
reassociate the float sums, so singular values match the single-chip
``randomized_svd_coo`` to f32 roundoff (parity-tested at rtol 2e-4),
not bit-exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding
from jax import shard_map

from ..linalg.rsvd import SvdResult, randomized_svd_op, spmm_scatter


def sharded_randomized_svd_coo(rows, cols, vals, key, n: int, rank: int,
                               mesh: Mesh, n_iter: int = 5,
                               n_oversample: int = 10) -> SvdResult:
    """Sharded twin of ``linalg/rsvd.py::randomized_svd_coo``: same
    subspace iteration, same reference seed conventions, the SpMM
    distributed by COO-entry shards with a psum merge.

    nnz is padded to a multiple of the mesh size with inert entries
    (val 0 at row/col 0 — the scatter-add of zero contributes
    nothing)."""
    ndev = mesh.devices.size
    nnz = rows.shape[0]
    pad = (-nnz) % ndev
    if pad:
        rows = jnp.pad(rows, (0, pad))
        cols = jnp.pad(cols, (0, pad))
        vals = jnp.pad(vals, (0, pad))
    sh = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())
    rows = jax.device_put(rows, sh)
    cols = jax.device_put(cols, sh)
    vals = jax.device_put(vals, sh)
    key = jax.device_put(key, rep)
    return _sharded_svd_jit(rows, cols, vals, key, mesh, n, rank,
                            n_iter, n_oversample)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "n", "rank", "n_iter",
                                    "n_oversample"))
def _sharded_svd_jit(rows, cols, vals, key, mesh: Mesh, n: int,
                     rank: int, n_iter: int, n_oversample: int):
    def local(r_l, c_l, v_l, key):
        def matmat(x):
            # edge-slabbed above the slab threshold (the per-device
            # (nnz/ndev, r) gather is ~2G at 11M/8dev otherwise)
            part = spmm_scatter(r_l, c_l, v_l, x, n)
            return jax.lax.psum(part, "data")

        res = randomized_svd_op(matmat, matmat, (n, n), rank,
                                n_iter=n_iter,
                                n_oversample=n_oversample, key=key)
        return res.u, res.s, res.vt

    # out is replicated by construction (every device runs the same
    # QR/SVD on the psum-merged panels); the varying-axes checker
    # cannot infer that through the scatter-add, hence check_vma=False
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("data"), P("data"), P("data"), P()),
                   out_specs=P(), check_vma=False)
    u, s, vt = fn(rows, cols, vals, key)
    return SvdResult(u=u, s=s, vt=vt)
