"""CPU A/B: sequential vs parallel (stacked) repulsion kicks at the
bench point.

`dense_parallel_kicks=True` computes every kick's coeff from the
post-attraction snapshot and sums the deltas (one stacked
(n_neg, d, n) program) instead of the reference's sequential chain
(embedder.rs:1244-1299).  At the kernel-count-bound bench point the
sequential chain IS the optimize wall, so the flag is a direct wall
lever — admissible iff final conservation is unchanged.  Runs the
exact bench pipeline (same graph, same init) both ways and prints one
JSON row each (honest nbng=50 + compat radius_k=125, same as
bench.py's tail).

Usage: JAX_PLATFORMS=cpu python tools/ab_parallel_kicks.py [n]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp

from bench import synthetic_mnist, KNBN, DIM, NB_GRAD_BATCH
from annembed_tpu.knn.brute import knn_graph_brute
from annembed_tpu.graph.kgraph import KGraph
from annembed_tpu.graph.proba import to_proba_edges
from annembed_tpu.optim.dense import run_dense_optimization
from annembed_tpu.optim.embedder import set_data_box
from annembed_tpu.spectral.diffmaps import DiffusionMaps
from annembed_tpu.params import EmbedderParams, DiffusionParams
from annembed_tpu.estimators.quality import quality_estimate

n = int(sys.argv[1]) if len(sys.argv) > 1 else 70_000
x = jnp.asarray(synthetic_mnist(n=n)).astype(jnp.float32)
idx, dist = knn_graph_brute(x, KNBN, block_rows=2048,
                            dtype="bfloat16")
g = KGraph(indices=idx, dists=dist)
npar = to_proba_edges(g)
dm = DiffusionMaps(params=DiffusionParams(
    asked_dim=DIM, alfa=0.5, beta=-0.1, t=5.0, gnbn=12))
init = set_data_box(dm.embed_from_kgraph(g), 10.0)
init.block_until_ready()

for par in (False, True):
    params = EmbedderParams(asked_dim=DIM, nb_grad_batch=NB_GRAD_BATCH,
                            n_sub_schedule=((15, 15), (10, 30), (5, 60)),
                            dense_parallel_kicks=par)
    t0 = time.perf_counter()
    y, info = run_dense_optimization(init, g, npar, params, n_sub=15)
    y.block_until_ready()
    t_opt = time.perf_counter() - t0
    q = quality_estimate(g, y, nbng=50, radius_k_compat=125)
    print(json.dumps({
        "parallel_kicks": bool(par), "cpu_opt_s": round(t_opt, 2),
        "sweeps": info["sweeps"],
        "no_match": int(q.nb_without_match),
        "mean_matched": round(q.mean_nb_matched, 3),
        "median_ratio": round(q.median_ratio, 3),
        "compat_no_match": int(q.compat["nb_without_match"]),
        "compat_mean_matched": round(q.compat["mean_nb_matched"], 3),
    }), flush=True)
