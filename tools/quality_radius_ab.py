#!/usr/bin/env python
"""A/B: certified grid radius search vs exact brute (aim: the 11M
quality phase at identical numbers in a fraction of the brute wall).

Shapes mirror the 11M quality phase: a 2-d embedded-like cloud
(anisotropic Gaussian mixture, the shape a real embedding takes),
m sampled queries, k_search = radius_k_compat + 1 = 251.

  * n = --ab-n (default 2M): BOTH paths run; assert equal distances
    at the radius columns, record both walls.
  * n = --big-n (default 11M): grid path only (the brute wall at 11M
    is the measured ~40 min this lever deletes), wall + fallback rate
    recorded.

Emits one JSON line per row.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def cloud(n, seed=5):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 6, (24, 2)).astype(np.float32)
    sd = rng.uniform(0.3, 1.8, (24, 1)).astype(np.float32)
    z = rng.integers(0, 24, n)
    return (c[z] + sd[z] * rng.standard_normal((n, 2), dtype=np.float32))


def emit(row):
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab-n", type=int, default=2_000_000)
    ap.add_argument("--big-n", type=int, default=11_000_000)
    ap.add_argument("--m", type=int, default=200_000)
    ap.add_argument("--k", type=int, default=251,
                    help="k_search (radius_k_compat + 1)")
    ap.add_argument("--brute-m", type=int, default=50_000,
                    help="queries for the brute identity check (a "
                         "subset of --m; the full-m brute is the long "
                         "program that faulted a worker on 2026-08-20)")
    args = ap.parse_args()

    import jax
    from annembed_tpu.knn.brute import knn_search_brute
    from annembed_tpu.knn.radius import grid_radius_search

    emit({"bench": "quality_radius_ab", "backend": jax.default_backend(),
          "m": args.m, "k": args.k})

    for n, do_brute in ((args.ab_n, True), (args.big_n, False)):
        if n <= 0:
            continue
        y = cloud(n)
        rng = np.random.default_rng(11)
        q_ids = np.sort(rng.choice(n, size=min(args.m, n),
                                   replace=False)).astype(np.int32)
        t0 = time.perf_counter()
        sd_g, n_fb = grid_radius_search(y, q_ids, args.k)
        jax.block_until_ready(sd_g)
        w_grid = time.perf_counter() - t0
        emit({"n": n, "path": "grid", "wall_s": round(w_grid, 2),
              "fallback_queries": n_fb})
        if do_brute:
            import jax.numpy as jnp
            m2 = min(args.brute_m, len(q_ids))
            yj = jnp.asarray(y)
            t0 = time.perf_counter()
            _, sd_b = knn_search_brute(yj[jnp.asarray(q_ids[:m2])], yj,
                                       k=args.k)
            jax.block_until_ready(sd_b)
            w_brute = time.perf_counter() - t0
            sg = np.asarray(sd_g)[:m2]
            eq = bool(np.array_equal(sg, np.asarray(sd_b)))
            emit({"n": n, "path": "brute", "wall_s": round(w_brute, 2),
                  "brute_m": m2, "identical_to_grid": eq,
                  "speedup_per_query": round(
                      (w_brute / m2) / max(w_grid / len(q_ids), 1e-12),
                      1)})
            if not eq:
                diff = np.abs(sg - np.asarray(sd_b))
                emit({"n": n, "mismatch_max": float(diff.max()),
                      "mismatch_rows": int((diff.max(1) > 0).sum())})


if __name__ == "__main__":
    main()
