"""Symmetric normalized graph Laplacian in COO form + spectral solve.

Rebuilds reference src/graphlaplace.rs and the Laplacian builders of
src/tools/kdumap.rs:250 (legacy) and src/diffmaps.rs:427 (alfa-weighted,
Coifman-Lafon).  The kernel is always held as fixed-size COO arrays
(2*n*k + n entries); the dense/CSR representation switch of the
reference (FULL_MAT_REPR=5000, graphlaplace.rs:13) is unnecessary —
SpMM-by-scatter-add works at every size, and the exact-vs-randomized
SVD switch is kept (FULL_SVD_SIZE_LIMIT, graphlaplace.rs:15).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import jax
import jax.numpy as jnp

from ..params import FULL_SVD_SIZE_LIMIT
from ..linalg.rsvd import (SvdResult, coo_matmat, full_svd_dense,
                           randomized_svd_coo)
from .kgraph import KGraph, symmetric_coo, coo_to_dense

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GraphLaplacian:
    """Symmetrized kernel D^{-1/2} G D^{-1/2} plus its normalizer.

    ``normalizer`` is what downstream embeddings divide eigenvectors by
    to return to the random-walk Laplacian eigenbasis
    (graphlaplace.rs:21-35): row degrees for the legacy path, sqrt of
    the alfa-weighted degrees q_{eps,alfa} for the diffusion-maps path.
    """

    rows: jnp.ndarray
    cols: jnp.ndarray
    vals: jnp.ndarray
    normalizer: jnp.ndarray          # (n,)
    n: int
    normed_scales: Optional[jnp.ndarray] = None  # (n,) rho_i / mean(rho)
    mean_scale: float = 1.0
    svd_res: Optional[SvdResult] = None

    def matmat(self):
        return coo_matmat(self.rows, self.cols, self.vals, self.n)

    def to_dense(self) -> jnp.ndarray:
        return coo_to_dense(self.rows, self.cols, self.vals, self.n)

    def do_svd(self, asked_dim: int, key=None, mesh=None,
               n_iter: int = 5) -> SvdResult:
        """Exact SVD below FULL_SVD_SIZE_LIMIT, randomized above
        (reference graphlaplace.rs:127 ``do_svd`` dispatch; the
        randomized path uses rank 20 / 5 iterations, :115 —
        ``n_iter`` exposes the iteration count as a knob, default
        = the reference's 5).

        With ``mesh`` (a 1-D 'data' jax mesh), the randomized path's
        COO SpMM is sharded over the mesh devices
        (parallel/sharded_svd.py) — the spectral init then runs
        multi-chip like every other pipeline phase."""
        if self.n <= FULL_SVD_SIZE_LIMIT:
            res = full_svd_dense(self.to_dense(), dtype=self.vals.dtype)
        else:
            rank = max(asked_dim, 20)
            if key is None:
                key = jax.random.PRNGKey(4664397)
            if mesh is not None:
                from ..parallel.sharded_svd import \
                    sharded_randomized_svd_coo
                res = sharded_randomized_svd_coo(
                    self.rows, self.cols, self.vals, key, n=self.n,
                    rank=rank, mesh=mesh, n_iter=n_iter, n_oversample=10)
            else:
                res = randomized_svd_coo(self.rows, self.cols,
                                         self.vals, key, n=self.n,
                                         rank=rank, n_iter=n_iter,
                                         n_oversample=10)
        self.svd_res = res
        return res


def laplacian_from_probas(g: KGraph, probas: jnp.ndarray) -> GraphLaplacian:
    """Legacy Laplacian used by ``get_dmap_embedding``.

    Reference kdumap.rs:250 ``get_laplacian``: symmetrize the
    probability graph with 1/2 (P + P^T), then normalize
    D^{-1/2} G D^{-1/2}; the normalizer kept is the degree vector D
    (kdumap.rs:282-291).
    """
    n = g.nb_nodes
    rows, cols, vals = symmetric_coo(g, weights=probas, mode="mean")
    diag = jnp.zeros((n,), vals.dtype).at[rows].add(vals)
    d_inv_sqrt = 1.0 / jnp.sqrt(jnp.maximum(diag, 1e-30))
    vals = vals * d_inv_sqrt[rows] * d_inv_sqrt[cols]
    return GraphLaplacian(rows=rows, cols=cols, vals=vals, normalizer=diag,
                          n=n)


def alfa_normalize_coo(rows, cols, vals, n: int, alfa):
    """Core alfa weighting + symmetric normalization, shared by
    :func:`laplacian_alfa_weighted` and the fused diffusion-maps program
    (`spectral/diffmaps.py::_dmap_laplacian_impl`):
      q_i   = kernel row sums (proxy density), normalized to mean ~1
      K_ij /= (q_i q_j)^alfa
      D_i   = new row sums (q_{eps,alfa} in Berry-Harlim)
      K_ij /= sqrt(D_i D_j)
    Returns (vals, normalizer=sqrt(D)) (diffmaps.rs:565,579-584)."""
    q = jnp.zeros((n,), vals.dtype).at[rows].add(vals)
    q = q / jnp.mean(q)
    vals = vals / jnp.power(jnp.maximum(q[rows] * q[cols], 1e-30), alfa)
    degrees = jnp.zeros((n,), vals.dtype).at[rows].add(vals)
    d_inv_sqrt = 1.0 / jnp.sqrt(jnp.maximum(degrees, 1e-30))
    vals = vals * d_inv_sqrt[rows] * d_inv_sqrt[cols]
    return vals, jnp.sqrt(jnp.maximum(degrees, 0.0))


def laplacian_alfa_weighted(rows, cols, vals, n: int, alfa: float,
                            normed_scales=None,
                            mean_scale: float = 1.0) -> GraphLaplacian:
    """Diffusion-maps Laplacian with density renormalization exponent alfa.

    Reference diffmaps.rs:427-587 ``compute_laplacian``: starting from an
    already *symmetric* kernel COO (self edges included); see
    :func:`alfa_normalize_coo` for the normalization chain.
    The reference's q_mean uses an odd 1/max_nbng factor
    (diffmaps.rs:469,546) — a global constant that cancels in the final
    D^{-1/2} normalization, so we use the plain mean.
    """
    vals, normalizer = alfa_normalize_coo(rows, cols, vals, n, alfa)
    return GraphLaplacian(rows=rows, cols=cols, vals=vals,
                          normalizer=normalizer,
                          n=n, normed_scales=normed_scales,
                          mean_scale=mean_scale)
