"""CPU A/B: does lowering the dmap-init rSVD iteration count change
final conservation at the bench point?

The bench dmap_init phase is 0.29 s of the 1.22 s e2e; its suspected
floor is the subspace iteration's SpMM+QR chain (5 iterations,
reference graphlaplace.rs:115).  The init only SEEDS the CE optimizer,
so a cheaper init is admissible iff the final conservation is
unchanged.  This runs the exact bench pipeline on the CPU backend for
svd_n_iter in {5, 3, 2, 1} and prints one JSON row each (honest
nbng=50 estimator + compat radius, same as bench.py's tail).

Usage: JAX_PLATFORMS=cpu python tools/ab_dmap_iters.py [n]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
# quality A/B on the CPU backend (set before first use)
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
params = EmbedderParams(asked_dim=DIM, nb_grad_batch=NB_GRAD_BATCH,
                        n_sub_schedule=((15, 15), (10, 30), (5, 60)))

for it in (5, 3, 2, 1):
    t0 = time.perf_counter()
    dm = DiffusionMaps(params=DiffusionParams(
        asked_dim=DIM, alfa=0.5, beta=-0.1, t=5.0, gnbn=12,
        svd_n_iter=it))
    init = set_data_box(dm.embed_from_kgraph(g), 10.0)
    init.block_until_ready()
    t_init = time.perf_counter() - t0
    y, _ = run_dense_optimization(init, g, npar, params, n_sub=15)
    y.block_until_ready()
    q = quality_estimate(g, y, nbng=50, radius_k_compat=125)
    print(json.dumps({
        "svd_n_iter": it, "cpu_init_s": round(t_init, 2),
        "no_match": int(q.nb_without_match),
        "mean_matched": round(q.mean_nb_matched, 3),
        "median_ratio": round(q.median_ratio, 3),
        "compat_no_match": int(q.compat["nb_without_match"]),
        "compat_mean_matched": round(q.compat["mean_nb_matched"], 3),
    }), flush=True)
