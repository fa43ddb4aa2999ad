#!/usr/bin/env python
"""Conservation A/B for the stale-gather lever (dense_gather_reuse).

Same structured-manifold fixture as bench.py's conservation row
(synthetic_clustered_manifold — data a 2-d embedding CAN represent, so
conservation differences are the optimizer's, not the data's), same
graph + init + schedule for every arm; only dense_gather_reuse varies.
Emits one JSON line per arm: mean_nb_matched / no_match / median_ratio
+ optimize wall.  CPU-runnable (JAX_PLATFORMS=cpu) at --n 20000; the
decision row for the 11M recipe is the GPU wall in
tools/sweep_ablation.py — THIS tool decides quality only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=784)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--reuse", default="1,2,4,6",
                    help="arms as S or S:after_frac, comma-separated "
                         "(e.g. '1,4,4:0.5,8:0.5')")
    ap.add_argument("--nbng", type=int, default=50)
    args = ap.parse_args()

    from annembed_tpu.io.synthetic import synthetic_clustered_manifold
    from annembed_tpu.knn.brute import knn_graph_brute
    from annembed_tpu.graph.kgraph import KGraph
    from annembed_tpu.graph.proba import to_proba_edges
    from annembed_tpu.spectral.diffmaps import DiffusionMaps
    from annembed_tpu.optim.dense import run_dense_optimization
    from annembed_tpu.optim.embedder import set_data_box
    from annembed_tpu.estimators.quality import quality_estimate
    from annembed_tpu.params import EmbedderParams, DiffusionParams

    x = jnp.asarray(synthetic_clustered_manifold(args.n, args.d),
                    jnp.float32)
    idx, dist = knn_graph_brute(x, k=args.k)
    g = KGraph(indices=idx, dists=dist)
    npar = to_proba_edges(g)
    dm = DiffusionMaps(params=DiffusionParams(asked_dim=2, alfa=0.5,
                                              beta=-0.1, t=5.0, gnbn=12))
    y0 = set_data_box(dm.embed_from_kgraph(g), 10.0)
    print(json.dumps({"bench": "ab_gather_reuse", "n": args.n,
                      "d": args.d, "k": args.k}), flush=True)
    for arm in args.reuse.split(","):
        s, _, after = arm.partition(":")
        s, after = int(s), float(after or 0.0)
        p = EmbedderParams(grad_factor=5, hubness_weighting=True,
                           optimizer="dense", dense_gather_reuse=s,
                           dense_gather_reuse_after=after)
        t0 = time.perf_counter()
        y, info = run_dense_optimization(y0, g, npar, p)
        np.asarray(y)
        wall = time.perf_counter() - t0
        q = quality_estimate(g, y, nbng=args.nbng)
        print(json.dumps({
            "gather_reuse": s, "after": after,
            "optimize_wall_s": round(wall, 2),
            "sweeps": info["sweeps"],
            "no_match": int(q.nb_without_match),
            "no_match_frac": round(q.nb_without_match / args.n, 4),
            "mean_nb_matched": round(q.mean_nb_matched, 4),
            "median_ratio": round(q.median_ratio, 4)}), flush=True)


if __name__ == "__main__":
    main()
