"""Variable-bandwidth diffusion maps (Berry-Harlim).

Rebuilds reference src/diffmaps.rs as vectorized JAX:

  * per-node local scale rho_i = sqrt(mean of squared neighbour
    distances) (diffmaps.rs:1020 ``get_dist_l2_from_node``)
  * gaussian kernel w_ij = exp(-(d_ij / (sqrt(eps) * rho_ij))^2) with
    geometric pairwise scale rho_ij = sqrt(rho_i rho_j)
    (diffmaps.rs:656-657,831-834), floored at PROBA_MIN, self edge of
    weight 1 for ergodicity (diffmaps.rs:632,649)
  * beta < 0: density re-estimation pass — q from the kernel row sums,
    new scales = mean_scale * q^beta, re-kernel (diffmaps.rs:837-848,
    ``kernel0_to_density`` :855)
  * alfa-weighted symmetric normalized Laplacian (diffmaps.rs:427)
  * spectral embedding with diffusion time t:
    coord_ij = clip(lambda_{j+1}^t * u_{i,j+1} / (scale_i *
    sqrt(N_i / mean(N))), 10) where N = the stored normalizer =
    sqrt(D), exactly as the reference applies it (diffmaps.rs:1226-1232
    takes sqrt(normalizer/mean) of the *already-sqrt* degrees stored at
    diffmaps.rs:565; replicated bit-for-bit for parity)
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..params import DiffusionParams, PROBA_MIN
from ..graph.kgraph import (KGraph, symmetric_coo_plan, symmetric_coo_apply)
from ..graph.laplacian import (GraphLaplacian, alfa_normalize_coo,
                               laplacian_from_probas)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# kernel construction
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("gnbn",))
def _local_scales(dists: jnp.ndarray, gnbn: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """rho_i = sqrt(sum_{j<gnbn} d_ij^2 / k); zero scales replaced by the
    mean (diffmaps.rs:784-810).  The reference sums the first gnbn
    squared distances but divides by the full k (diffmaps.rs:1032-1039);
    replicated as documented behaviour."""
    n, k = dists.shape
    s2 = jnp.sum(jnp.square(dists[:, :gnbn]), axis=1) / k
    rho = jnp.sqrt(s2)
    mean = jnp.mean(rho)
    rho = jnp.where(rho <= 0.0, mean, rho)
    return rho, jnp.mean(rho)


@jax.jit
def _kernel_weights(dists, indices, rho, epsil_sqrt):
    """(n, k) kernel weights with pairwise geometric scales; plus the
    all-equal fallback and the self-edge column is handled by caller."""
    rho_from = rho[:, None]                # (n, 1)
    rho_to = rho[indices]                  # (n, k)
    pair_scale = jnp.sqrt(rho_from * rho_to)
    arg = jnp.square(dists / (epsil_sqrt * jnp.maximum(pair_scale, 1e-30)))
    w = jnp.exp(-arg)
    w = jnp.maximum(w, PROBA_MIN)
    # all-equal rows (incl. all-zero distances): uniform over k+1 edges
    # including the self edge (diffmaps.rs:634-647)
    all_equal = dists[:, -1] <= dists[:, 0]
    k = dists.shape[1]
    w = jnp.where(all_equal[:, None], 1.0 / (k + 1.0), w)
    self_w = jnp.where(all_equal, 1.0 / (k + 1.0), 1.0)
    return w, self_w


def _symmetric_kernel_coo(plan, n: int, w: jnp.ndarray, self_w: jnp.ndarray):
    """Symmetrize with max(w_ij, w_ji) (diffmaps.rs:531) and append the
    self edges.  ``plan`` is a precomputed :class:`SymCooPlan` — the
    beta<0 path symmetrizes two kernels on the same edge structure and
    pays the O(nk log nk) sort once."""
    rows = jnp.concatenate([plan.rows, jnp.arange(n, dtype=jnp.int32)])
    cols = jnp.concatenate([plan.cols, jnp.arange(n, dtype=jnp.int32)])
    vals = jnp.concatenate([symmetric_coo_apply(plan, w, mode="max"),
                            self_w.astype(jnp.float32)])
    return rows, cols, vals


def _density_from_kernel(rows, cols, vals, n: int) -> jnp.ndarray:
    """q_i proportional to symmetric-kernel row sums, normalized to mean 1
    (diffmaps.rs:855-952 ``kernel0_to_density``)."""
    q = jnp.zeros((n,), jnp.float32).at[rows].add(vals)
    return q / jnp.mean(q)


@functools.partial(jax.jit, static_argnames=("real_dim", "auto_time"))
def _spectral_coords(lambdas, u, scales, normalizer, t_val,
                     real_dim: int, auto_time: bool):
    """Diffusion coordinates from the spectral data
    (diffmaps.rs:1196-1237): coord_ij = clip(lambda_{j+1}^t u_{i,j+1}
    / (scale_i sqrt(N_i / mean N)), 10) with N the stored normalizer
    (= sqrt(D) on the dmap path, matching the reference exactly)."""
    norm_l = lambdas / lambdas[0]
    if auto_time:
        # t s.t. (lambda_2/lambda_1)^t < 0.9 capped at 5
        # (diffmaps.rs:1216); the ratio clamp below 1 degrades a
        # disconnected graph (lambda_2 == lambda_1) to the t = 5 cap
        # instead of -inf
        ratio = jnp.clip(norm_l[2] / jnp.maximum(norm_l[1], 1e-12),
                         1e-12, 1.0 - 1e-6)
        time = jnp.minimum(5.0, jnp.log(0.9) / jnp.log(ratio))
    else:
        time = t_val
    sum_diag = jnp.mean(normalizer)
    weight = scales * jnp.sqrt(normalizer / sum_diag)      # (n,)
    lam_t = jnp.power(norm_l[1:real_dim + 1], time)        # (dim,)
    coords = lam_t[None, :] * u[:, 1:real_dim + 1] \
        / jnp.maximum(weight, 1e-30)[:, None]
    return jnp.clip(coords, -10.0, 10.0)


@functools.partial(jax.jit, static_argnames=("gnbn", "beta_is_neg"))
def _dmap_laplacian_impl(indices, dists, gnbn: int, epsil, beta, alfa,
                         beta_is_neg: bool):
    """Single fused XLA program building the alfa-weighted Laplacian
    COO from the kNN graph: local scales -> kernel (-> density pass if
    beta < 0) -> symmetrize -> alfa normalization -> D^{-1/2} scaling.
    One jit keeps the dispatch count at one."""
    n = indices.shape[0]
    rho, mean = _local_scales(dists, gnbn)
    epsil_sqrt = jnp.sqrt(epsil)
    g = KGraph(indices=indices, dists=dists)
    plan = symmetric_coo_plan(g)
    if beta_is_neg:
        w, sw = _kernel_weights(dists, indices, rho, epsil_sqrt)
        rows, cols, vals = _symmetric_kernel_coo(plan, n, w, sw)
        q = _density_from_kernel(rows, cols, vals, n)
        beta_scales = jnp.power(q, beta) * mean
        w, sw = _kernel_weights(dists, indices, beta_scales, epsil_sqrt)
    else:
        q = None
        const = jnp.full_like(rho, mean)
        w, sw = _kernel_weights(dists, indices, const, epsil_sqrt)
    rows, cols, vals = _symmetric_kernel_coo(plan, n, w, sw)
    vals, normalizer = alfa_normalize_coo(rows, cols, vals, n, alfa)
    return rows, cols, vals, normalizer, rho, mean, q


# ---------------------------------------------------------------------------
# DiffusionMaps driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DiffusionMaps:
    """Reference ``DiffusionMaps`` (diffmaps.rs:254-271)."""

    params: DiffusionParams
    laplacian: Optional[GraphLaplacian] = None
    normed_scales: Optional[jnp.ndarray] = None
    #: mean local scale — a device scalar after laplacian_from_kgraph
    #: (never read back inside the pipeline; see the note there)
    mean_scale: object = 1.0
    q_density: Optional[jnp.ndarray] = None

    # -- kernel + laplacian -------------------------------------------------
    def laplacian_from_kgraph(self, g: KGraph) -> GraphLaplacian:
        """compute_dmap_nodeparams + compute_laplacian
        (diffmaps.rs:380-422,752-849), fused into one XLA program."""
        k = g.nbng
        gnbn = min(self.params.gnbn or k, k)
        beta = self.params.beta
        if beta > 0:
            raise ValueError("beta cannot be > 0 (diffmaps.rs:827-830)")
        rows, cols, vals, normalizer, rho, mean, q = _dmap_laplacian_impl(
            g.indices, g.dists, gnbn, jnp.float32(self.params.epsil),
            jnp.float32(beta), jnp.float32(self.params.alfa),
            beta_is_neg=beta < 0.0)
        # kept as a DEVICE scalar: the pipeline rule is one host sync
        # point at the very end; convert lazily there.
        self.mean_scale = mean
        self.normed_scales = rho / mean
        self.q_density = q
        return GraphLaplacian(rows=rows, cols=cols, vals=vals,
                              normalizer=normalizer, n=g.nb_nodes,
                              normed_scales=self.normed_scales,
                              mean_scale=self.mean_scale)

    # -- embedding ----------------------------------------------------------
    def embed_from_laplacian(self, lap: GraphLaplacian, asked_dim: int,
                             t_opt: Optional[float], key=None,
                             mesh=None) -> jnp.ndarray:
        """Spectral coordinates from the top eigenvectors
        (diffmaps.rs:1145-1243).  ``mesh`` shards the randomized SVD's
        SpMM over the devices (see GraphLaplacian.do_svd)."""
        svd_res = lap.do_svd(asked_dim + 15, key=key, mesh=mesh,
                             n_iter=self.params.svd_n_iter)
        scales = lap.normed_scales
        if scales is None:
            scales = jnp.ones((lap.n,), jnp.float32)
        return _spectral_coords(svd_res.s, svd_res.u, scales,
                                lap.normalizer,
                                jnp.float32(t_opt if t_opt is not None
                                            else -1.0),
                                real_dim=min(asked_dim,
                                             svd_res.u.shape[1] - 1),
                                auto_time=t_opt is None)

    def embed_from_kgraph(self, g: KGraph, key=None,
                          mesh=None) -> jnp.ndarray:
        """Full chain (diffmaps.rs:1047-1075)."""
        lap = self.laplacian_from_kgraph(g)
        coords = self.embed_from_laplacian(lap, self.params.asked_dim,
                                           self.params.t, key=key,
                                           mesh=mesh)
        self.laplacian = lap
        return coords

    def embed_from_data(self, x, knbn: int = 16, distance: str = "DistL2",
                        key=None) -> jnp.ndarray:
        """Convenience: data -> kNN graph -> diffusion embedding
        (reference ``embed_from_hnsw``, diffmaps.rs:1114)."""
        from ..knn.api import build_kgraph
        g = build_kgraph(x, knbn, distance=distance)
        return self.embed_from_kgraph(g, key=key)


def get_dmap_embedding(g: KGraph, probas: jnp.ndarray, asked_dim: int,
                       t_opt: Optional[float] = None, key=None) -> jnp.ndarray:
    """Legacy initialization path (reference diffmaps.rs:1278-1350
    ``get_dmap_embedding`` on the kdumap Laplacian): used by the
    embedder when ``dmapnew = false``."""
    lap = laplacian_from_probas(g, probas)
    svd_res = lap.do_svd(asked_dim + 25, key=key)
    lambdas, u = svd_res.s, svd_res.u
    # the reference clamps to u.ncols() and would then index column
    # real_dim out of bounds (diffmaps.rs:1326); clamp to ncols-1 as its
    # embed_from_laplacian does (diffmaps.rs:1208) since column 0 is
    # skipped
    real_dim = min(asked_dim, u.shape[1] - 1)
    norm_l = lambdas / lambdas[0]
    if t_opt is not None:
        time = jnp.float32(t_opt)
    else:
        ratio = jnp.clip(norm_l[2] / jnp.maximum(norm_l[1], 1e-12),
                         1e-12, 1.0 - 1e-6)
        time = jnp.minimum(5.0, jnp.log(0.9) / jnp.log(ratio))
    sum_diag = jnp.mean(lap.normalizer)
    weight = jnp.sqrt(lap.normalizer / sum_diag)
    lam_t = jnp.power(norm_l[1:real_dim + 1], time)
    return lam_t[None, :] * u[:, 1:real_dim + 1] \
        / jnp.maximum(weight, 1e-30)[:, None]
