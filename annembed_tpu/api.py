"""Top-level API mirroring the reference Python bindings.

Reference src/python.rs exposes ``annembed.embed`` (:109) and
``annembed.dmap_embed`` (:201): csv in -> (n, dim) numpy out, with the
keyword surface of the CLIs.  Here the same two calls run the
JAX pipeline; array inputs are accepted directly in addition to
csv paths.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional, Union

import numpy as np

from .params import EmbedderParams, DiffusionParams, KnnParams
from .utils.cache import enable_persistent_cache

enable_persistent_cache()
from .io.csv_io import get_toembed_from_csv
from .knn.api import build_kgraph
from .knn.hierarchy import build_projection
from .optim.embedder import Embedder
from .spectral.diffmaps import DiffusionMaps

logger = logging.getLogger(__name__)

ArrayLike = Union[str, np.ndarray]


def _finalize_info(info: dict) -> dict:
    """Convert any device scalars left in an info dict to Python floats
    (the pipeline keeps CE values etc. on device until this final
    sync; see optim/embedder.py)."""
    out = {}
    for key, v in info.items():
        if hasattr(v, "block_until_ready") and getattr(v, "ndim", None) == 0:
            out[key] = float(v)
        elif isinstance(v, dict):
            out[key] = _finalize_info(v)
        else:
            out[key] = v
    return out


def _load(data: ArrayLike, delim: str, subsample: float) -> np.ndarray:
    if isinstance(data, (str, bytes)) or hasattr(data, "__fspath__"):
        return get_toembed_from_csv(data, delimiter=delim,
                                    subsample=subsample)
    return np.asarray(data, np.float32)


def embed(csv: ArrayLike, outfile: Optional[str] = None, dim: int = 2,
          batch: int = 20, nbsample: int = 10, layer: int = 0,
          hierarchy_fraction: float = 0.05, scale: float = 1.0,
          quality_sampling: float = 1.0, distance: str = "DistL2",
          nbng: int = 10, knn_params: Optional[KnnParams] = None,
          params: Optional[EmbedderParams] = None, delim: str = ",",
          with_quality: bool = False, seed: int = 0,
          graph_cache: Optional[str] = None,
          graph_cache_eager: bool = False,
          embed_cache: Optional[str] = None,
          quality_fraction: float = 1.0,
          quality_nbng: int = 50,
          quality_radius_compat: int = 0,
          return_graph: bool = False,
          cluster: int = 0,
          n_devices: int = 0,
          mesh=None):
    """Full kNN + CE-optimized embedding (reference python.rs:109,
    bin/embed.rs main flow :402-444).

    Returns (embedding (n, dim) np.ndarray, info dict).

    ``graph_cache`` is written after the full pipeline succeeds; pass
    ``graph_cache_eager=True`` to save right after the build instead
    (crash-safe like the reference's HnswIo dump-after-construction,
    higgs.rs:466-474).

    ``quality_fraction`` < 1 evaluates neighborhood conservation on a
    node subsample with exact embedded radii (the reference's
    subsampled quality runs, io.rs:197-199); ``quality_nbng`` is the
    embedded neighbourhood size (reference uses 50 for MNIST, 100 for
    Higgs).

    ``cluster`` > 0 runs HDBSCAN* on the (already built) kNN graph with
    that min_cluster_size; labels/probabilities land in
    ``info["cluster"]`` and, next to ``outfile``, in ``clusters.csv``
    (completes the reference's hdbscan stub as a pipeline by-product).

    ``n_devices`` > 1 (or an explicit 1-D 'data' ``mesh``) runs the
    WHOLE pipeline multi-chip: graph build (sharded brute/IVF joins,
    bit-identical to single-chip), spectral init (entry-sharded COO
    SpMM + psum), dense CE optimization (row shards, one all_gather
    per half-sweep) and the quality estimator's embedded
    rebuild — SURVEY §2.3's first-class multi-device path.  Graph /
    embedding checkpoints stay host-side npz and are layout-agnostic.
    """
    if mesh is None and n_devices > 1:
        from .parallel.sharded import make_mesh
        mesh = make_mesh(n_devices)
    x = _load(csv, delim, quality_sampling)
    if params is None:
        params = EmbedderParams()
    # the six CLI-surface kwargs always win (callers pass ``params``
    # for the knobs without a kwarg, e.g. grad_factor / n_sub); the
    # caller's object is copied, never mutated
    params = dataclasses.replace(
        params, asked_dim=dim, nb_grad_batch=batch,
        nb_sampling_by_edge=nbsample, scale_rho=scale,
        hierarchy_layer=layer, seed=seed)
    if knn_params is None:
        knn_params = KnnParams(knbn=nbng, distance=distance)

    from .io.checkpoint import checkpoint_exists
    t0 = time.perf_counter()
    if layer > 0:
        if graph_cache and checkpoint_exists(graph_cache):
            from .io.checkpoint import load_projection
            proj = load_projection(graph_cache, expect_n=x.shape[0])
            logger.info("loaded projection checkpoint from %s",
                        graph_cache)
        else:
            proj = build_projection(x, nbng,
                                    sample_fraction=hierarchy_fraction,
                                    distance=distance, params=knn_params,
                                    seed=seed, mesh=mesh)
            if graph_cache and graph_cache_eager:
                from .io.checkpoint import save_projection
                save_projection(graph_cache, proj)
        graph_build_time = time.perf_counter() - t0
        emb = Embedder.from_hkgraph(proj, params, mesh=mesh)
    else:
        # graph checkpoint/resume: the analogue of the reference's
        # HnswIo dump/reload (examples/higgs.rs:397-474)
        if graph_cache and checkpoint_exists(graph_cache):
            from .io.checkpoint import load_kgraph
            g = load_kgraph(graph_cache, expect_n=x.shape[0])
            logger.info("loaded kNN graph checkpoint from %s", graph_cache)
        else:
            if mesh is not None:
                from .parallel.sharded_knn import sharded_build_kgraph
                g = sharded_build_kgraph(x, nbng, distance=distance,
                                         params=knn_params, mesh=mesh)
            else:
                g = build_kgraph(x, nbng, distance=distance,
                                 params=knn_params)
            if graph_cache and graph_cache_eager:
                from .io.checkpoint import save_kgraph
                save_kgraph(graph_cache, g)
                logger.info("eagerly saved kNN graph checkpoint to %s",
                            graph_cache)
        graph_build_time = time.perf_counter() - t0
        emb = Embedder.new(g, params, mesh=mesh)
    if embed_cache and checkpoint_exists(embed_cache):
        # resume: hour-scale optimizes whose quality phase died (e.g.
        # a transient device fault) restart straight into quality
        import jax.numpy as jnp
        from .io.checkpoint import load_embedding
        y_host = load_embedding(embed_cache)
        if y_host.shape != (x.shape[0], dim):
            raise ValueError(
                f"embed_cache {embed_cache!r} has shape {y_host.shape}, "
                f"expected {(x.shape[0], dim)} — stale checkpoint from "
                "another run? delete it or fix the path")
        y_dev = jnp.asarray(y_host)
        emb.embedding = y_dev
        logger.info("loaded embedding checkpoint from %s", embed_cache)
    else:
        y_host = None
        y_dev = emb.embed()
        if embed_cache:
            from .io.checkpoint import save_embedding
            y_host = np.asarray(y_dev)
            save_embedding(embed_cache, y_host)
            logger.info("embedding checkpoint written to %s", embed_cache)
    q = None
    if with_quality:
        q = emb.get_quality_estimate_from_edge_length(
            nbng=quality_nbng, sample_fraction=quality_fraction,
            knn_params=knn_params,
            radius_k_compat=quality_radius_compat or None)
    y = np.asarray(y_dev) if y_host is None else y_host
    info = _finalize_info(emb.info)
    info["graph_build_time"] = graph_build_time
    info["total_time"] = time.perf_counter() - t0
    if return_graph:
        info["kgraph"] = emb.get_kgraph()
    if graph_cache:
        if not checkpoint_exists(graph_cache):
            # pass graph_cache_eager for the crash-safe early dump
            if layer > 0:
                from .io.checkpoint import save_projection
                save_projection(graph_cache, proj)
            else:
                from .io.checkpoint import save_kgraph
                save_kgraph(graph_cache, emb.get_kgraph())
    if cluster > 0:
        from .estimators.hdbscan import hdbscan as _hdbscan
        res = _hdbscan(emb.get_kgraph(), min_cluster_size=cluster)
        info["cluster"] = {
            "n_clusters": len(res.selected),
            "noise_fraction": float((res.labels == -1).mean()),
            "labels": res.labels,
            "probabilities": res.probabilities,
        }
        if outfile:
            from .io.csv_io import write_csv_labeled_array2
            d = os.path.dirname(os.fspath(outfile)) or "."
            write_csv_labeled_array2(os.path.join(d, "clusters.csv"),
                                     res.labels, y)
    if q is not None:
        info["quality"] = q.summary()
        if outfile:
            # per-node diagnostic dumps next to the embedding
            # (reference embedder.rs:729-743 writes first_dist.csv and
            # continuity_ratio.csv).  Under quality sampling the stat
            # rows follow q.sample_ids — pair them with the SAME rows
            # of the embedding, not the first m rows
            from .io.csv_io import write_csv_labeled_array2
            d = os.path.dirname(os.fspath(outfile)) or "."
            y_rows = y if q.sample_ids is None \
                else y[np.asarray(q.sample_ids)]
            write_csv_labeled_array2(os.path.join(d, "first_dist.csv"),
                                     np.asarray(q.first_dist), y_rows)
            write_csv_labeled_array2(
                os.path.join(d, "continuity_ratio.csv"),
                np.asarray(q.ratio_by_node), y_rows)
    if outfile:
        from .io.csv_io import write_csv_array2
        write_csv_array2(outfile, y)
    return y, info


def dmap_embed(csv: ArrayLike, outfile: Optional[str] = None, dim: int = 2,
               alfa: float = 1.0, beta: float = 0.0, time_param: float = 5.0,
               distance: str = "DistL2", nbng: int = 16, layer: int = 0,
               hierarchy_fraction: float = 0.05,
               knn_params: Optional[KnnParams] = None,
               quality_sampling: float = 1.0, delim: str = ",",
               seed: int = 0, n_devices: int = 0, mesh=None,
               svd_n_iter: int = 5):
    """Diffusion-maps-only embedding (reference python.rs:201,
    bin/dmapembed.rs:390-432).  With layer > 0 only the subsample graph
    is embedded (dmapembed.rs:415-422).  ``n_devices``/``mesh`` run the
    graph build and the spectral SVD sharded (see ``embed``).
    ``svd_n_iter`` = subspace iterations of the spectral SVD (the
    reference's 5, graphlaplace.rs:115; a wall/convergence knob at
    multi-M scale — the 6.6M spectral phase is ~40 s/iteration)."""
    if mesh is None and n_devices > 1:
        from .parallel.sharded import make_mesh
        mesh = make_mesh(n_devices)
    x = _load(csv, delim, quality_sampling)
    dp = DiffusionParams(asked_dim=dim, alfa=alfa, beta=beta, t=time_param,
                         gnbn=nbng, svd_n_iter=svd_n_iter)
    if knn_params is None:
        knn_params = KnnParams(knbn=nbng, distance=distance)
    t0 = time.perf_counter()
    dm = DiffusionMaps(params=dp)
    if layer > 0:
        proj = build_projection(x, nbng, sample_fraction=hierarchy_fraction,
                                distance=distance, params=knn_params,
                                seed=seed, mesh=mesh)
        y = np.asarray(dm.embed_from_kgraph(proj.small_graph, mesh=mesh))
        info = {"nb_embedded": int(proj.nb_small),
                "sample_ids": np.asarray(proj.sample_ids)}
    else:
        if mesh is not None:
            from .parallel.sharded_knn import sharded_build_kgraph
            g = sharded_build_kgraph(x, nbng, distance=distance,
                                     params=knn_params, mesh=mesh)
        else:
            g = build_kgraph(x, nbng, distance=distance,
                             params=knn_params)
        t_g = time.perf_counter() - t0
        logger.info("dmap: graph built in %.1fs; spectral embedding", t_g)
        y = np.asarray(dm.embed_from_kgraph(g, mesh=mesh))
        info = {"nb_embedded": int(x.shape[0]),
                "graph_build_time": round(t_g, 1),
                "dmap_time": round(time.perf_counter() - t0 - t_g, 1)}
    info["total_time"] = time.perf_counter() - t0
    if outfile:
        from .io.csv_io import write_csv_array2
        write_csv_array2(outfile, y)
    return y, info
