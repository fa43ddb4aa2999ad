"""Hierarchical two-level graph structure for coarse-to-fine embedding.

Replaces the reference's ``KGraphProjection`` (src/fromhnsw/kgproj.rs:35),
which reuses HNSW's layer hierarchy: points on layers >= l (a
geometrically-decaying ~2-4% subsample) form the small graph, and every
lower point is mapped to its nearest upper point.

Here a uniform random subsample of fraction ``sample_fraction`` plays
the role of the upper layers (HNSW layer assignment *is* i.i.d.
geometric, independent of the data, so a uniform sample is
distributionally equivalent); the projection becomes one batched top-1
search of all points against the sample, replacing the per-point layer
search of kgproj.rs:195-237.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import jax
import jax.numpy as jnp

from ..graph.kgraph import KGraph
from ..params import KnnParams
from .api import build_kgraph
from .brute import knn_search_brute

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class KGraphProjection:
    """small graph over a subsample + projection of all points onto it.

    ``proj_small_idx[i]`` is the index *within the sample* of the point
    nearest to i (identity for sampled points, kgproj.rs:254-267), and
    ``proj_dist[i]`` the corresponding distance (0 for sampled points).
    """

    small_graph: KGraph
    large_graph: KGraph
    sample_ids: jnp.ndarray      # (m,) int32 indices into [0, n)
    proj_small_idx: jnp.ndarray  # (n,) int32 indices into [0, m)
    proj_dist: jnp.ndarray       # (n,) float32

    @property
    def nb_small(self) -> int:
        return self.sample_ids.shape[0]

    def projection_distance_quantiles(self):
        """Reference get_projection_distance_quant (kgproj.rs:403).

        Quantiles run over ALL points, sampled ones included at their
        identity-projection distance 0 — the reference does the same
        (kgproj.rs:254-267 inserts weight-0 edges for upper-layer
        points into proj_data, and :405 iterates all of proj_data), so
        the h_embed jitter median (embedder.rs:255) sees those zeros
        there too."""
        qs = jnp.array([0.05, 0.5, 0.95, 0.99])
        return {f"q{q:g}": float(v) for q, v in
                zip(qs.tolist(), jnp.quantile(self.proj_dist, qs).tolist())}


def use_top1_kernel(distance: str) -> bool:
    """The fused top-1 kernel (ops/top1.py, Pallas through Triton)
    serves L2 on a GPU; every other case takes the plain XLA search."""
    return distance == "DistL2" and jax.default_backend() == "gpu"


def project_top1(x, xs, distance: str = "DistL2"):
    """Nearest row of ``xs`` for every row of ``x``:
    (idx (n,) int32, dist (n,))."""
    if use_top1_kernel(distance):
        from ..ops.top1 import top1_l2
        return top1_l2(x, xs)
    idx1, dist1 = knn_search_brute(x, xs, k=1, distance=distance)
    return idx1[:, 0], dist1[:, 0]


def build_projection(x, knbn: int, sample_fraction: float = 0.05,
                     distance: str = "DistL2",
                     params: Optional[KnnParams] = None,
                     seed: int = 0, mesh=None) -> KGraphProjection:
    """Build small graph, large graph and projection (kgproj.rs:59).

    ``mesh`` routes both graph builds through the sharded joins
    (parallel/sharded_knn.py — bit-identical to single-chip)."""
    x = jnp.asarray(x)
    n = x.shape[0]
    m = max(knbn + 1, int(round(n * sample_fraction)))
    key = jax.random.PRNGKey(seed)
    sample_ids = jnp.sort(jax.random.choice(key, n, (m,), replace=False))
    sample_ids = sample_ids.astype(jnp.int32)
    xs = x[sample_ids]

    logger.info("hierarchy: %d sampled of %d (fraction %.3f)", m, n,
                m / n)
    if mesh is not None:
        from ..parallel.sharded_knn import sharded_build_kgraph
        small = sharded_build_kgraph(xs, knbn, mesh, distance=distance,
                                     params=params)
        large = sharded_build_kgraph(x, knbn, mesh, distance=distance,
                                     params=params)
    else:
        small = build_kgraph(xs, knbn, distance=distance, params=params)
        large = build_kgraph(x, knbn, distance=distance, params=params)

    proj_small_idx, proj_dist = project_top1(x, xs, distance)
    # sampled points project to themselves at distance 0
    in_sample_pos = jnp.zeros((n,), jnp.int32).at[sample_ids].set(
        jnp.arange(m, dtype=jnp.int32))
    is_sampled = jnp.zeros((n,), bool).at[sample_ids].set(True)
    proj_small_idx = jnp.where(is_sampled, in_sample_pos, proj_small_idx)
    proj_dist = jnp.where(is_sampled, 0.0, proj_dist)
    return KGraphProjection(small_graph=small, large_graph=large,
                            sample_ids=sample_ids,
                            proj_small_idx=proj_small_idx,
                            proj_dist=proj_dist)
