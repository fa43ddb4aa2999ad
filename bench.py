#!/usr/bin/env python
"""End-to-end benchmark: the MNIST-shaped embedding pipeline on one GPU.

Workload: the reference's headline shape (examples/mnist_digits.rs:
70k x 784 -> 2-D, knbn=6, nb_grad_batch=30; reference wall 11 s on a
24-core i9, BASELINE.md) on deterministic synthetic data with the same
compute shape.

Stages: exact kNN graph -> diffusion-maps init -> probability-edge
calibration -> dense CE optimizer under the coarse->fine schedule.
One warm-up pass compiles every program; the timed pass follows, each
stage ending in ``block_until_ready``.  The last line of stdout is one
JSON record: the metric ``mnist70k_e2e_wall_s``, the stage walls, the
device (platform, kind, count, card name and power limit), recall of
the graph against exact search, and neighbourhood conservation on the
blob data and on the clustered-manifold fixture.

Exits non-zero without a GPU and on any failure:

    python bench.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

N = 70_000
D = 784
KNBN = 6
DIM = 2
BASELINE_WALL_S = 11.0  # reference README.md:92 (i9 24c/32t)
#: coarse->fine n_sub schedule, 705 executed sweeps (PERF.md findings)
SCHEDULE = ((15, 15), (10, 30), (4, 60))


def _note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_once(x):
    """One pass of the pipeline; returns (y, graph, stage walls)."""
    from annembed_tpu.graph.kgraph import KGraph
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.knn.brute import knn_graph_brute
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.embedder import set_data_box
    from annembed_tpu.params import DiffusionParams, EmbedderParams
    from annembed_tpu.spectral.diffmaps import DiffusionMaps

    t = {}
    t0 = time.perf_counter()
    # bf16 panels select candidates; the exact f32 rerank orders them
    idx, dist = knn_graph_brute(x, KNBN, block_rows=2048, dtype="bfloat16")
    idx.block_until_ready()
    t["knn"] = time.perf_counter() - t0
    g = KGraph(indices=idx, dists=dist)

    t0 = time.perf_counter()
    dm = DiffusionMaps(params=DiffusionParams(
        asked_dim=DIM, alfa=0.5, beta=-0.1, t=5.0, gnbn=12, svd_n_iter=1))
    init = set_data_box(dm.embed_from_kgraph(g), 10.0)
    init.block_until_ready()
    t["dmap_init"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    npar = to_proba_edges(g)
    npar.probas.block_until_ready()
    t["proba"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    params = EmbedderParams(asked_dim=DIM,
                            nb_grad_batch=sum(b for b, _ in SCHEDULE),
                            n_sub_schedule=SCHEDULE,
                            dense_neighbor_exclusion=False)
    y, _ = run_dense_optimization(init, g, npar, params, n_sub=15)
    y.block_until_ready()
    t["optimize"] = time.perf_counter() - t0
    t["total"] = sum(t.values())
    return y, g, t


def _conservation(prefix: str, g, y) -> dict:
    """Conservation at nbng=50, honest and reference-compat radius
    (radius_k = 125 ~ 2.5 * nbng, embedder.rs:556-560)."""
    from annembed_tpu.estimators.quality import quality_estimate
    q = quality_estimate(g, y, nbng=50, radius_k_compat=125)
    return {f"{prefix}no_match": int(q.nb_without_match),
            f"{prefix}mean_matched": q.mean_nb_matched,
            f"{prefix}compat_no_match": int(q.compat["nb_without_match"]),
            f"{prefix}compat_mean_matched": q.compat["mean_nb_matched"]}


def main() -> None:
    from annembed_tpu.utils.cache import enable_persistent_cache
    from annembed_tpu.utils.profiling import (card_name_and_power_limit,
                                              require_gpu)
    enable_persistent_cache()
    device = require_gpu()
    card = card_name_and_power_limit()
    _note(f"device: {device}; card: {card}")

    import jax.numpy as jnp
    from annembed_tpu.io.synthetic import (synthetic_blobs,
                                           synthetic_clustered_manifold)
    from annembed_tpu.knn.api import sampled_exact_recall

    x = jnp.asarray(synthetic_blobs(N, D, seed=42), jnp.float32)
    t0 = time.perf_counter()
    run_once(x)
    _note(f"warm-up pass (compiles included): "
          f"{time.perf_counter() - t0:.3f} s")
    y, g, t = run_once(x)
    _note(f"timed pass: {t}")

    y_host = np.asarray(y)
    if not np.isfinite(y_host).all():
        raise RuntimeError("non-finite embedding")
    rec = {"metric": "mnist70k_e2e_wall_s", "value": t["total"],
           "unit": "s", "vs_baseline": BASELINE_WALL_S / t["total"],
           "stages_s": t, "device": device, "card": card,
           "recall": sampled_exact_recall(
               x, g, sample_ids=np.linspace(0, N - 1, 2000).astype(np.int32))}
    rec.update(_conservation("", g, y))
    # conservation fixture: the same pipeline on a low-intrinsic-dim
    # manifold at the same shapes, which a 2-d embedding can conserve
    xm = jnp.asarray(synthetic_clustered_manifold(N, D), jnp.float32)
    ym, gm, _ = run_once(xm)
    rec.update(_conservation("manifold_", gm, ym))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
