"""Checkpoint / resume of the expensive pipeline phase.

The reference only checkpoints its HNSW index (HnswIo dump/reload,
examples/higgs.rs:397-474) to skip the 45-minute ANN build.  The
equivalent here persists the (n, k) kNN graph arrays (and
optionally the embedding) with np.savez — the graph is the only
expensive artifact.

Saves go through an opened file handle so the archive lands at EXACTLY
the requested path (a bare ``np.savez_compressed(str)`` silently
appends ``.npz``, which made suffix-less cache paths unfindable on
resume).  Loads still resolve legacy ``<path>.npz`` files written by
older versions.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..graph.kgraph import KGraph

logger = logging.getLogger(__name__)


def _save_npz(path: str | os.PathLike, **data) -> None:
    with open(os.fspath(path), "wb") as f:
        np.savez_compressed(f, **data)


def _resolve(path: str | os.PathLike) -> str:
    p = os.fspath(path)
    if not os.path.exists(p) and os.path.exists(p + ".npz"):
        return p + ".npz"
    return p


def checkpoint_exists(path: str | os.PathLike) -> bool:
    """True if a checkpoint exists at ``path`` (or legacy ``path.npz``)."""
    p = os.fspath(path)
    return os.path.exists(p) or os.path.exists(p + ".npz")


def _check_n(what: str, path, got: int, expect: Optional[int]) -> None:
    if expect is not None and got != expect:
        raise ValueError(
            f"{what} checkpoint {os.fspath(path)!r} holds {got} nodes, "
            f"expected {expect} — stale cache from another run/sampling? "
            "delete it or fix the path")


def save_kgraph(path: str | os.PathLike, g: KGraph,
                extra: Optional[dict] = None) -> None:
    data = {"indices": np.asarray(g.indices), "dists": np.asarray(g.dists)}
    if extra:
        data.update({k: np.asarray(v) for k, v in extra.items()})
    _save_npz(path, **data)
    logger.info("kgraph checkpoint written to %s", path)


def load_kgraph(path: str | os.PathLike,
                expect_n: Optional[int] = None) -> KGraph:
    with np.load(_resolve(path)) as z:
        _check_n("kgraph", path, z["indices"].shape[0], expect_n)
        return KGraph(indices=jnp.asarray(z["indices"]),
                      dists=jnp.asarray(z["dists"]))


def save_projection(path: str | os.PathLike, proj) -> None:
    """Persist a KGraphProjection (small graph + large graph + top-1
    projection) — the hierarchical analogue of the HnswIo dump: at 11M
    the graph build + projection is the dominant phase."""
    _save_npz(
        path,
        small_indices=np.asarray(proj.small_graph.indices),
        small_dists=np.asarray(proj.small_graph.dists),
        large_indices=np.asarray(proj.large_graph.indices),
        large_dists=np.asarray(proj.large_graph.dists),
        sample_ids=np.asarray(proj.sample_ids),
        proj_small_idx=np.asarray(proj.proj_small_idx),
        proj_dist=np.asarray(proj.proj_dist))
    logger.info("projection checkpoint written to %s", path)


def load_projection(path: str | os.PathLike, expect_n: Optional[int] = None):
    from ..knn.hierarchy import KGraphProjection
    with np.load(_resolve(path)) as z:
        _check_n("projection", path, z["large_indices"].shape[0], expect_n)
        return KGraphProjection(
            small_graph=KGraph(indices=jnp.asarray(z["small_indices"]),
                               dists=jnp.asarray(z["small_dists"])),
            large_graph=KGraph(indices=jnp.asarray(z["large_indices"]),
                               dists=jnp.asarray(z["large_dists"])),
            sample_ids=jnp.asarray(z["sample_ids"]),
            proj_small_idx=jnp.asarray(z["proj_small_idx"]),
            proj_dist=jnp.asarray(z["proj_dist"]))


def save_embedding(path: str | os.PathLike, y) -> None:
    _save_npz(path, embedding=np.asarray(y))


def load_embedding(path: str | os.PathLike) -> np.ndarray:
    with np.load(_resolve(path)) as z:
        return z["embedding"]
