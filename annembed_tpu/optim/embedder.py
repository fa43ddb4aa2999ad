"""Embedder driver: diffusion-map init + cross-entropy optimization.

Rebuilds the reference ``Embedder`` (src/embedder.rs:84-905):
  * ``one_step_embed`` (embedder.rs:298): diffusion-maps initialization
    (t=5, gnbn=12, alfa=0.5, beta=-0.1, embedder.rs:315-325), box
    normalization to size 10 (``set_data_box``, embedder.rs:345,1376),
    probability-edge calibration, CE optimization.
  * ``h_embed`` (embedder.rs:194): embed the small (subsample) graph
    with grad_factor x batches at grad_step 1, seed the full graph from
    projected neighbours + clipped Gaussian jitter scaled by the
    projection-distance quantile ratio (embedder.rs:259-269), then
    optimize the full graph.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import jax
import jax.numpy as jnp

from ..params import EmbedderParams, DiffusionParams
from ..graph.kgraph import KGraph, in_degree_counts
from ..graph.proba import NodeParams, to_proba_edges
from ..spectral.diffmaps import DiffusionMaps
from ..knn.hierarchy import KGraphProjection
from ..utils.profiling import PhaseTimer, device_trace
from .ce import build_edge_set, run_entropy_optimization

logger = logging.getLogger(__name__)


def set_data_box(data: jnp.ndarray, box_size: float) -> jnp.ndarray:
    """Center columns and rescale so max |coord| = box_size / 2
    (reference embedder.rs:1376-1408)."""
    centered = data - jnp.mean(data, axis=0, keepdims=True)
    max_max = jnp.max(jnp.abs(centered))
    scale = jnp.maximum(max_max / (box_size / 2.0), 1e-30)
    return centered / scale


def hubness_sampling_weights(g: KGraph) -> jnp.ndarray:
    """Negative-sampling weights from in-degree counts, clamped to
    [1, n] (reference embedder.rs:823-833)."""
    counts = in_degree_counts(g).astype(jnp.float32)
    n = g.nb_nodes
    w = jnp.clip(counts, 1.0, float(n))
    return w / jnp.mean(w)


@dataclasses.dataclass
class Embedder:
    """One-shot or hierarchical embedding driver."""

    kgraph: Optional[KGraph] = None
    hkgraph: Optional[KGraphProjection] = None
    params: EmbedderParams = dataclasses.field(default_factory=EmbedderParams)
    #: optional 1-D 'data' jax mesh: the spectral init's SpMM and the
    #: dense CE optimizer run sharded over it (SURVEY §2.3 first-class
    #: multi-device path; single-chip semantics preserved — the sharded
    #: optimizer shares prepare_dense_inputs and the seed stream)
    mesh: object = None

    initial_embedding: Optional[jnp.ndarray] = None
    embedding: Optional[jnp.ndarray] = None
    initial_space: Optional[NodeParams] = None
    info: dict = dataclasses.field(default_factory=dict)
    #: per-phase wall timers (the reference's ProcessTime/SystemTime
    #: pairs around every phase, embedder.rs:871-884)
    timer: PhaseTimer = dataclasses.field(default_factory=PhaseTimer)

    # ------------------------------------------------------------------
    @staticmethod
    def new(kgraph: KGraph, params: EmbedderParams,
            mesh=None) -> "Embedder":
        return Embedder(kgraph=kgraph, params=params, mesh=mesh)

    @staticmethod
    def from_hkgraph(proj: KGraphProjection, params: EmbedderParams,
                     mesh=None) -> "Embedder":
        return Embedder(hkgraph=proj, params=params, mesh=mesh)

    # ------------------------------------------------------------------
    def embed(self) -> jnp.ndarray:
        """Dispatch (embedder.rs:183-191)."""
        if self.kgraph is not None:
            return self.one_step_embed()
        if self.hkgraph is not None:
            return self.h_embed()
        raise ValueError("Embedder needs a kgraph or a graph projection")

    # ------------------------------------------------------------------
    def _dmap_initial(self, g: KGraph, dim: int) -> jnp.ndarray:
        """Diffusion-map initialization with the constants hard-wired in
        one_step_embed (embedder.rs:315-325)."""
        dparams = DiffusionParams(asked_dim=dim, alfa=0.5, beta=-0.1,
                                  t=5.0, gnbn=12)
        dm = DiffusionMaps(params=dparams)
        return dm.embed_from_kgraph(g, mesh=self.mesh)

    def _random_initial(self, n: int, dim: int, size: float) -> jnp.ndarray:
        key = jax.random.PRNGKey(self.params.seed + 17)
        return jax.random.uniform(key, (n, dim), jnp.float32,
                                  -size / 2.0, size / 2.0)

    # ------------------------------------------------------------------
    def one_step_embed(self, g: Optional[KGraph] = None) -> jnp.ndarray:
        g = g if g is not None else self.kgraph
        p = self.params
        dim = p.asked_dim
        with self.timer.phase("initialization") as sync:
            if p.dmap_init:
                init = self._dmap_initial(g, dim)
                init = set_data_box(init, 10.0)
            else:
                init = self._random_initial(g.nb_nodes, dim, 1.0)
            sync.append(init)
        self.info["init_time"] = self.timer.timings["initialization"]
        logger.info("initialization done in %.2fs", self.info["init_time"])

        with self.timer.phase("proba_edges") as sync:
            self.initial_space = to_proba_edges(g, p.scale_rho, p.beta)
            sync.append(self.initial_space.probas)
        self.initial_embedding = init
        y = self._entropy_optimize(g, self.initial_space, init)
        self.embedding = y
        return y

    # ------------------------------------------------------------------
    def h_embed(self) -> jnp.ndarray:
        """Two-step hierarchical embedding (embedder.rs:194-295)."""
        proj = self.hkgraph
        p = self.params

        # step 1: embed the small graph with more batches and step 1.
        # An n_sub_schedule's batch counts target the LARGE phase (they
        # sum to nb_grad_batch); the first step deliberately runs FLAT
        # n_sub: inheriting a grad_factor-scaled schedule was A/B'd on
        # the 100k harness and came out consistently slightly worse on
        # all three quality metrics (no-match 0.1234 vs 0.1208, matched
        # 3.260 vs 3.333 — PERF.md granularity study) for a ~4% e2e
        # wall saving; the seed embedding's quality compounds, so
        # quality wins here.
        first_params = dataclasses.replace(
            p, nb_grad_batch=p.grad_factor * p.nb_grad_batch,
            grad_step=1.0, hierarchy_layer=0, n_sub_schedule=None)
        first = Embedder(kgraph=proj.small_graph, params=first_params,
                         mesh=self.mesh)
        y_small = first.one_step_embed()
        self.info["first_step"] = first.info

        # step 2: seed the full embedding from the projection
        large = proj.large_graph
        n = large.nb_nodes
        dim = p.asked_dim
        median_dist = jnp.quantile(proj.proj_dist, 0.5)
        ratio = proj.proj_dist / jnp.maximum(median_dist, 1e-30)  # (n,)
        correction = jnp.sqrt(ratio / dim)                        # (n,)
        key = jax.random.PRNGKey(p.seed + 23)
        noise = jax.random.normal(key, (n, dim), jnp.float32)
        jitter = jnp.clip(correction[:, None] * noise, -2.0, 2.0)
        init = y_small[proj.proj_small_idx] + jitter
        # sampled points keep their exact small-graph coordinates
        init = init.at[proj.sample_ids].set(y_small)
        self.initial_embedding = init

        self.initial_space = to_proba_edges(large, p.scale_rho, p.beta)
        y = self._entropy_optimize(large, self.initial_space, init)
        self.embedding = y
        return y

    # ------------------------------------------------------------------
    def _entropy_optimize(self, g: KGraph, npar: NodeParams,
                          init: jnp.ndarray) -> jnp.ndarray:
        p = self.params
        t0 = time.perf_counter()
        optimizer = p.optimizer
        if optimizer == "dense!":
            optimizer = "dense"
        # start-of-phase log: the hierarchical path runs TWO of these
        # phases (small then large), and the large one can be silent
        # for its whole multi-minute/hour wall (few long multi-sweep
        # programs).  Two round-4 11M runs were killed as "wedged"
        # because the small phase's end log was mistaken for the whole
        # optimize and the large phase then looked like a stall.
        logger.info("entropy optimization: starting (n=%d, k=%d, "
                    "optimizer=%s, batches=%d)", g.nb_nodes,
                    g.indices.shape[1], optimizer, p.nb_grad_batch)
        with device_trace(p.trace_dir), \
                self.timer.phase("entropy_optimization") as sync:
            if optimizer == "dense":
                from .dense import run_dense_optimization
                from .ce import ce_value_dense
                hub = (hubness_sampling_weights(g) if p.hubness_weighting
                       else None)
                # CE values stay DEVICE scalars; consumers convert at
                # the pipeline's final sync point.
                info = {"initial_ce": ce_value_dense(
                    init, g, npar.probas, npar.scale, p.b)}
                if self.mesh is not None:
                    from ..parallel.sharded import sharded_dense_optimize
                    y = sharded_dense_optimize(init, g, npar, p,
                                               self.mesh,
                                               neg_weights=hub)
                    dinfo = {"optimizer": "dense",
                             "n_devices": int(self.mesh.devices.size),
                             "n_sub": p.n_sub}
                    if getattr(p, "n_sub_schedule", None):
                        dinfo["n_sub_schedule"] = tuple(
                            tuple(ph) for ph in p.n_sub_schedule)
                else:
                    y, dinfo = run_dense_optimization(init, g, npar, p,
                                                      n_sub=p.n_sub,
                                                      neg_weights=hub)
                info.update(dinfo)
                info["final_ce"] = ce_value_dense(
                    y, g, npar.probas, npar.scale, p.b)
            else:
                hub = (hubness_sampling_weights(g) if p.hubness_weighting
                       else None)
                es = build_edge_set(g, npar, hubness_weights=hub)
                y, info = run_entropy_optimization(init, es, p)
            sync.append(y)
        info["optimize_time"] = time.perf_counter() - t0
        # log only host-native values; formatting a device scalar would
        # be a readback (CE values are converted at the final sync)
        logger.info("entropy optimization: %s",
                    {k: v for k, v in info.items()
                     if isinstance(v, (int, float, str))})
        self.info.update(info)
        return y

    # ------------------------------------------------------------------
    def get_embedded(self) -> Optional[jnp.ndarray]:
        return self.embedding

    # Rows are positional (no IndexSet remap needed here),
    # so reindexed == raw (reference embedder.rs:384-405).
    def get_embedded_reindexed(self) -> Optional[jnp.ndarray]:
        return self.embedding

    def get_initial_embedding(self) -> Optional[jnp.ndarray]:
        return self.initial_embedding

    def get_embedded_by_nodeid(self, node: int) -> jnp.ndarray:
        """Row of the embedding (reference embedder.rs:421; node ids are
        positional here so dataid == nodeid)."""
        return self.embedding[node]

    # DataIds are positional row numbers in this build (no IndexSet)
    get_embedded_by_dataid = get_embedded_by_nodeid

    def get_kgraph(self) -> Optional[KGraph]:
        if self.kgraph is not None:
            return self.kgraph
        if self.hkgraph is not None:
            return self.hkgraph.large_graph
        return None

    def get_quality_estimate_from_edge_length(self, nbng: int = 50,
                                              sample_fraction: float = 1.0,
                                              knn_params=None,
                                              radius_k_compat=None):
        from ..estimators.quality import quality_estimate
        g = self.get_kgraph()
        return quality_estimate(g, self.embedding, nbng=nbng,
                                knn_params=knn_params,
                                sample_fraction=sample_fraction,
                                seed=self.params.seed,
                                radius_k_compat=radius_k_compat,
                                mesh=self.mesh)
