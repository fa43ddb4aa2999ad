"""CPU A/B: trimmed coarse->fine schedule tails at the bench point.

The adopted schedule ((15,15),(10,30),(5,60)) executes 765 sweeps; the
round-3 granularity study probed 1740 (flat), 1140 and 570 but not the
765 -> ~700 window.  Trimming the FINE tail (fewest batches, most
sweeps each) is the cheapest wall lever left in the optimize phase —
admissible iff the honest+compat conservation stays at the adopted
point's level (same graph, same init, exact bench pipeline).

Usage: JAX_PLATFORMS=cpu python tools/ab_schedule_tail.py [n]
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np  # noqa: F401

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
dm = DiffusionMaps(params=DiffusionParams(asked_dim=DIM, alfa=0.5,
                                          beta=-0.1, t=5.0, gnbn=12,
                                          svd_n_iter=2))
init = set_data_box(dm.embed_from_kgraph(g), 10.0)
init.block_until_ready()

SCHEDULES = [
    ("adopted_765", ((15, 15), (10, 30), (5, 60))),
    ("tail4_705", ((15, 15), (10, 30), (4, 60))),
    ("tail3_645", ((15, 15), (10, 30), (3, 60))),
    ("mid8_645", ((15, 15), (8, 30), (4, 60))),
]
for tag, sched in SCHEDULES:
    p = EmbedderParams(asked_dim=DIM, nb_grad_batch=sum(b for b, _ in sched),
                       n_sub_schedule=sched)
    y, info = run_dense_optimization(init, g, npar, p, n_sub=sched[0][1])
    y.block_until_ready()
    q = quality_estimate(g, y, nbng=50, radius_k_compat=125)
    print(json.dumps({
        "schedule": tag, "sweeps": int(info["sweeps"]),
        "no_match": int(q.nb_without_match),
        "mean_matched": round(q.mean_nb_matched, 3),
        "median_ratio": round(q.median_ratio, 3),
        "compat_no_match": int(q.compat["nb_without_match"]),
        "compat_mean_matched": round(q.compat["mean_nb_matched"], 3),
    }), flush=True)
