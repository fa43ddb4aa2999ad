"""Reproducible clustering-at-scale benchmark (PERF.md "Clustering at
scale" table).  Host-side only (forces the CPU jax backend): generates
a 1-D locality graph — the kNN-like topology where components merge
locally — and times the full HDBSCAN* chain.

    python tools/cluster_bench.py [--n 1000000] [--k 8] [--mcs 50]

Prints one JSON line, e.g.
    {"n": 1000000, "k": 8, "hdbscan_s": 3.6, "glosh_s": 0.2,
     "clusters": 8405, "noise": 0.0463, "native": true}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def locality_graph(n: int, k: int, seed: int = 0):
    """1-D locality kNN graph: node i's neighbours are the k other ids
    in a (k+1)-wide window around i, shifted inward at the boundaries —
    every row holds k DISTINCT non-self ids for any k (the old
    clip-based fixup left self-loops at the top edge and duplicates at
    the bottom, and silently built k-1 columns for odd k)."""
    from annembed_tpu.graph.kgraph import KGraph
    if k < 1 or k >= n:
        raise SystemExit(f"--k must be in [1, n) (got k={k}, n={n})")
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.random(n).astype(np.float64)) * (n / 1000.0)
    half = k // 2
    # window of k+1 consecutive ids containing i (shifted inward at
    # the boundaries), minus i itself -> k distinct non-self ids/row
    rows = np.arange(n)
    lo = np.clip(rows - half, 0, n - 1 - k)
    win = lo[:, None] + np.arange(k + 1)[None, :]      # (n, k+1)
    notself = win != rows[:, None]
    assert notself.sum(1).min() == k, "window must contain i exactly once"
    idx = win[notself].reshape(n, k)
    d = np.abs(xs[idx] - xs[:, None]).astype(np.float32)
    order = np.argsort(d, axis=1)
    return KGraph(indices=np.take_along_axis(idx, order, 1).astype(np.int32),
                  dists=np.take_along_axis(d, order, 1))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--mcs", type=int, default=50)
    ap.add_argument("--min-samples", type=int, default=5)
    args = ap.parse_args()

    from annembed_tpu.estimators.hdbscan import (hdbscan, outlier_scores,
                                                 _native_mst_lib)
    g = locality_graph(args.n, args.k)
    t0 = time.perf_counter()
    res = hdbscan(g, min_cluster_size=args.mcs,
                  min_samples=args.min_samples)
    t1 = time.perf_counter()
    scores = outlier_scores(res.condensed, args.n)
    t2 = time.perf_counter()
    print(json.dumps({
        "n": args.n, "k": args.k, "mcs": args.mcs,
        "hdbscan_s": round(t1 - t0, 2),
        "glosh_s": round(t2 - t1, 2),
        "clusters": len(res.selected),
        "noise": round(float((res.labels == -1).mean()), 4),
        "mean_outlier_score": round(float(scores.mean()), 4),
        "native": _native_mst_lib() is not None,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
