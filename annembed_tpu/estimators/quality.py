"""Neighborhood-stability quality estimator.

Rebuilds ``get_quality_estimate_from_edge_length``
(reference src/embedder.rs:620-753):

  1. For every original edge (i, j), compute ||y_i - y_j|| in the
     embedded space (``get_transformed_kgraph``, embedder.rs:478).
  2. Build the kNN graph of the embedded points (second ANN build,
     embedder.rs:527-554 — here another brute/IVF pass) and take
     each node's nbng-th neighbour distance as its embedded radius.
  3. Count, per node, how many original neighbours fall inside that
     radius (match counts), and the ratio distribution
     edge_length / radius (CKMS quantiles -> exact jnp.quantile).

``sample_fraction`` < 1 evaluates the estimator on a random node
subsample — the reference's subsampled quality runs (io.rs:197-199,
README.md:146-148) at Higgs scale.  Sampled queries get their radius
from an EXACT embedded-space kNN search against the full cloud
(chunked brute panels), so the subsampled estimate is exact-radius,
not IVF-approximate.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.kgraph import KGraph
from ..knn.api import build_kgraph
from ..knn.brute import knn_search_brute
from ..params import KnnParams

logger = logging.getLogger(__name__)

_QS = (0.05, 0.25, 0.5, 0.75, 0.85, 0.95)


@dataclasses.dataclass
class QualityEstimate:
    nb_nodes: int
    nbng_used: int          # neighbourhood size of the original graph
    nbng_target: int        # neighbourhood size in embedded space
    nb_without_match: int
    #: mean conserved neighbours over nodes WITH >=1 match — the
    #: reference's semantics ("mean number of neighbours conserved
    #: when match", embedder.rs:679-681: divides by n - nb_without)
    mean_nb_matched: float
    median_ratio: float
    mean_ratio: float
    radii_quantiles: Dict[str, float]
    ratio_quantiles: Dict[str, float]
    #: per-node mean ratio (dumped to continuity_ratio.csv by the CLI);
    #: rows follow ``sample_ids`` when sampling is active
    ratio_by_node: jnp.ndarray
    #: per-node min embedded edge length (first_dist.csv)
    first_dist: jnp.ndarray
    #: nodes actually evaluated (== nb_nodes without sampling)
    nb_sampled: int = 0
    #: exact fraction of evaluated nodes with zero conserved neighbours
    frac_without_match: float = 0.0
    #: evaluated node ids (None = all nodes in order)
    sample_ids: Optional[np.ndarray] = None
    #: mean conserved neighbours over ALL evaluated nodes (zeros
    #: included) — the two headline metrics anti-correlate (rescuing
    #: weakly-matched nodes lowers the conditional mean), so the
    #: marginal disambiguates cross-run comparisons
    mean_nb_matched_marginal: float = 0.0
    #: same headline counts at a second, larger radius_k (the
    #: reference-compat adjacency-radius emulation) computed from the
    #: SAME exact embedded search — None unless radius_k_compat was
    #: passed.  Keys: radius_k, nb_without_match, frac_without_match,
    #: mean_nb_matched, mean_nb_matched_marginal, median_ratio
    compat: Optional[Dict[str, float]] = None

    def summary(self) -> Dict[str, float]:
        out = {
            "nb_without_match": float(self.nb_without_match),
            "mean_nb_matched": self.mean_nb_matched,
            "mean_nb_matched_marginal": self.mean_nb_matched_marginal,
            "median_ratio": self.median_ratio,
            "mean_ratio": self.mean_ratio,
            "frac_without_match": self.frac_without_match,
        }
        if self.nb_sampled != self.nb_nodes:
            out["nb_sampled"] = float(self.nb_sampled)
        if self.compat is not None:
            out.update({f"compat_{k}": v for k, v in self.compat.items()})
        out.update({f"radius_{k}": v for k, v in self.radii_quantiles.items()})
        out.update({f"ratio_{k}": v for k, v in self.ratio_quantiles.items()})
        return out


def _ivf_radius(y, g, k_search, radius_k, radius_k_compat, knn_params,
                mesh):
    """Approximate embedded-space radius via the IVF graph rebuild —
    the full-fraction path for d != 2 clouds and device meshes (the
    2-d single-chip path uses the certified-exact grid search).

    NN-descent refinement is skipped here: at nbng ~ 50 its candidate
    set is (2*nbng)^2 per node (prohibitive at millions of points),
    and the radius estimate only shifts marginally with IVF-level
    recall.  The embedded cloud is low-d, so the grid quantizer's ~13
    block probes replace the k-means quantizer's ~32 nearest-centroid
    probes at equal recall — the dominant cost of this phase at 11M."""
    if knn_params is None:
        knn_params = KnnParams(
            knbn=k_search, refine_rounds=0,
            quantizer="grid" if y.shape[1] == 2 else "kmeans")
    else:
        # caller params carry the ORIGINAL-space tuning; keep the
        # strategy knobs that transfer (brute_force_limit, nlist,
        # nprobe) but force the embedded-space
        # essentials: knbn=nbng, no NN-descent (see above), grid
        # quantizer on the low-d cloud, and FLOAT32 panels — an
        # inherited bfloat16 dtype corrupts low-d candidate
        # selection (cancellation) so badly that the measured
        # radius inflates and no-match deflates ~4x (PERF.md
        # "quality radius was precision-inflated"); the f32 cost
        # at d=2 is negligible next to the phase's gathers
        import dataclasses
        knn_params = dataclasses.replace(
            knn_params, knbn=k_search, refine_rounds=0,
            dtype="float32",
            quantizer="grid" if y.shape[1] == 2
            else knn_params.quantizer)
    if mesh is not None:
        # multi-chip: the embedded-space build (this phase's
        # dominant cost at 11M) rides the same sharded joins as
        # the original-space build — bit-identical results
        from ..parallel.sharded_knn import sharded_build_kgraph
        emb_graph = sharded_build_kgraph(y, k_search, mesh,
                                         distance="DistL2",
                                         params=knn_params)
    else:
        emb_graph = build_kgraph(y, k_search, distance="DistL2",
                                 params=knn_params)
    radius = emb_graph.dists[:, radius_k - 1]                # (n,)
    radius_compat = (emb_graph.dists[:, radius_k_compat - 1]
                     if radius_k_compat else None)
    # drop the graph reference right away: its (n, nbng) indices +
    # dists are ~4.4 GB at 11M x 50 and only the radius column is
    # needed — holding them through the quantile sort below is what
    # pushed the full-fraction path over the 11M HBM budget
    del emb_graph
    return radius, radius_compat


@jax.jit
def _edge_lengths_rows(y_rows, y, indices_rows):
    """(m, k) embedded L2 lengths for a row subset: y_rows (m, d) are
    the evaluated nodes' coordinates, indices_rows (m, k) their original
    neighbour ids into the full cloud ``y``."""
    yj = y[indices_rows]              # (m, k, d)
    return jnp.sqrt(jnp.maximum(
        jnp.sum(jnp.square(y_rows[:, None, :] - yj), axis=-1), 0.0))


def quality_estimate(g: KGraph, y, nbng: int = 50,
                     knn_params: KnnParams | None = None,
                     sample_fraction: float = 1.0,
                     seed: int = 0,
                     radius_k: int | None = None,
                     radius_k_compat: int | None = None,
                     mesh=None) -> QualityEstimate:
    """Compute the neighborhood-conservation summary.

    Note the reference's transformed edge lengths take a running
    minimum over the (unsorted-by-embedded-distance) neighbour list
    (embedder.rs:504-509) — an idiosyncrasy that only affects its
    per-edge list, not the match counts (which we reproduce from the
    raw lengths).

    With ``sample_fraction`` < 1, conservation is measured on a random
    node subsample whose embedded radii come from an exact chunked
    brute search (no second full graph build); ``nb_without_match`` is
    extrapolated to the full node count (``frac_without_match`` holds
    the exact sample fraction).

    ``radius_k`` (default nbng) is the neighbour index whose exact
    embedded distance defines each node's radius.  The default is the
    honest nbng-NN radius.  The reference's radius is the max edge of
    an HNSW *adjacency* (ef_c=64, embedder.rs:524-553) whose
    neighbourhood its doc says "roughly corresponds to 2-3x
    max_nb_connection" (embedder.rs:556-560) — to compare against its
    published rows, pass radius_k ~ 2.5*nbng as an explicit,
    labeled emulation (see examples/mnist_fashion.py --expect).

    ``radius_k_compat`` additionally reports the headline counts at a
    second (larger) radius index from the SAME exact embedded search —
    one pass yields both the honest row and the reference-compat
    emulation (``QualityEstimate.compat``) for ~free."""
    y = jnp.asarray(y, jnp.float32)
    n, k = g.indices.shape
    if radius_k is None:
        radius_k = nbng
    k_search = max(radius_k, radius_k_compat or 0)

    sample_ids = None
    if sample_fraction < 1.0:
        m = max(1, min(n, int(round(n * sample_fraction))))
        rng = np.random.default_rng(seed)
        sample_ids = np.sort(rng.choice(n, size=m, replace=False)
                             ).astype(np.int32)
        sub = jnp.asarray(sample_ids)
        y_rows = y[sub]
        lengths = _edge_lengths_rows(y_rows, y, g.indices[sub])  # (m, k)
        # exact embedded radius: (nbng+1)-NN search against the full
        # cloud includes self at distance 0, so column nbng is the
        # nbng-th true neighbour distance.
        # QUERY SLABS bound each search program's panel and top-k
        # workspace; results are identical (the search is exact per
        # row).
        import os as _os
        if (y.shape[1] == 2 and n > 50_000
                and not _os.environ.get("ANNEMBED_QUALITY_EXACT_BRUTE")):
            # certified grid search: same exact distances (bit-level,
            # tests/test_radius.py) at a small fraction of the brute
            # wall — the 11M quality phase's dominant cost was this
            # search's full-corpus top-k sort
            from ..knn.radius import grid_radius_search
            sd, _ = grid_radius_search(y, sample_ids, k_search + 1)
        else:
            slab = int(_os.environ.get("ANNEMBED_QUALITY_QUERY_SLAB",
                                       "50000"))
            sds = []
            for i0 in range(0, m, slab):
                _, sd_i = knn_search_brute(y_rows[i0:i0 + slab], y,
                                           k=k_search + 1)
                sd_i.block_until_ready()
                sds.append(sd_i)
                logger.info("quality radius search: %d/%d queries",
                            min(i0 + slab, m), m)
            sd = jnp.concatenate(sds, axis=0) if len(sds) > 1 else sds[0]
        radius = sd[:, radius_k]
        radius_compat = (sd[:, radius_k_compat]
                         if radius_k_compat else None)
    else:
        m = n
        y_rows = y
        lengths = _edge_lengths_rows(y, y, g.indices)            # (n, k)

        import os as _os
        if (y.shape[1] == 2 and n > 50_000 and mesh is None
                and not _os.environ.get("ANNEMBED_QUALITY_IVF_RADIUS")):
            # certified grid search gives the EXACT radius (the IVF
            # rebuild below is ~0.992-recall approximate) at a lower
            # wall and O(n) result memory (only the radius columns are
            # kept); the IVF path stays for d != 2, meshes, and via
            # the env escape hatch
            from ..knn.radius import grid_radius_search
            cols = ((radius_k, radius_k_compat) if radius_k_compat
                    else (radius_k,))
            sd2, _ = grid_radius_search(y, np.arange(n, dtype=np.int32),
                                        k_search + 1, keep_cols=cols)
            radius = sd2[:, 0]
            radius_compat = sd2[:, 1] if radius_k_compat else None
            del sd2
        else:
            radius, radius_compat = _ivf_radius(
                y, g, k_search, radius_k, radius_k_compat, knn_params,
                mesh)

    safe_r = jnp.maximum(radius, 1e-30)[:, None]
    matched = lengths <= radius[:, None]                    # (m, k)
    nodes_matched = matched.sum(axis=1)                     # (m,)
    del matched
    if radius_compat is not None:
        nm_compat = (lengths <= radius_compat[:, None]).sum(axis=1)
        ratio_med_compat = jnp.median(
            lengths / jnp.maximum(radius_compat, 1e-30)[:, None])

    first_dist = lengths.min(axis=1)
    ratios = lengths / safe_r                               # (m, k)
    del lengths           # free before the quantile sort workspace
    ratio_flat = ratios.reshape(-1)
    qs = jnp.array(_QS)

    # ONE batched device->host readback of every scalar at the end
    # (one sync instead of one per scalar).  The
    # counts travel as int32 (exact up to 2^31; float32 readback lost
    # integer precision past 2^24 — n*k is ~550M at 11M x 50)
    count_list = [(nodes_matched == 0).sum(), nodes_matched.sum()]
    scalar_list = [jnp.stack([ratio_flat.mean()]),
                   jnp.quantile(ratio_flat, qs),
                   jnp.quantile(radius, qs)]
    if radius_compat is not None:
        count_list += [(nm_compat == 0).sum(), nm_compat.sum()]
        scalar_list.append(jnp.stack([ratio_med_compat]))
    counts = jnp.stack(count_list).astype(jnp.int32)
    scalars = jnp.concatenate(scalar_list)
    ratio_by_node = ratios.mean(axis=1)
    vals_i, vals = jax.device_get((counts, scalars))

    nb_without_sample = int(vals_i[0])
    frac_without = nb_without_sample / m
    # extrapolate the count to the full node count so the headline
    # number stays comparable across sample fractions
    nb_without = (nb_without_sample if m == n
                  else int(round(frac_without * n)))
    nb_with = max(m - nb_without_sample, 1)
    mean_matched = float(int(vals_i[1]) / nb_with)
    nq = len(_QS)
    ratio_q = {f"q{q:g}": float(v) for q, v in zip(_QS, vals[1:1 + nq])}
    radii_q = {f"q{q:g}": float(v) for q, v in
               zip(_QS, vals[1 + nq:1 + 2 * nq])}

    compat = None
    if radius_compat is not None:
        nw_c = int(vals_i[2])
        compat = {
            "radius_k": float(radius_k_compat),
            "nb_without_match": float(nw_c if m == n
                                      else int(round(nw_c / m * n))),
            "frac_without_match": nw_c / m,
            "mean_nb_matched": float(int(vals_i[3]) / max(m - nw_c, 1)),
            "mean_nb_matched_marginal": float(int(vals_i[3]) / m),
            "median_ratio": float(vals[1 + 2 * len(_QS)]),
        }
    est = QualityEstimate(
        nb_nodes=n, nbng_used=k, nbng_target=nbng,
        nb_without_match=nb_without, mean_nb_matched=mean_matched,
        median_ratio=ratio_q["q0.5"],
        mean_ratio=float(vals[0]),
        radii_quantiles=radii_q, ratio_quantiles=ratio_q,
        ratio_by_node=ratio_by_node,
        first_dist=first_dist,
        nb_sampled=m, frac_without_match=frac_without,
        sample_ids=sample_ids,
        mean_nb_matched_marginal=float(int(vals_i[1]) / m),
        compat=compat)
    logger.info(
        "quality: nb_without_match=%d (frac %.4f of %d sampled) "
        "mean_matched=%.3f median_ratio=%.3e mean_ratio=%.3e",
        nb_without, frac_without, m, mean_matched, est.median_ratio,
        est.mean_ratio)
    return est
