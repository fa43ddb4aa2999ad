#!/usr/bin/env python
"""GPU timing of the fused top-1 kernel (ops/top1.py) against XLA's
plain ``knn_search_brute(k=1)`` at the Higgs projection width (default
2,000,000 queries x 440,000 corpus rows x 28), alone and end to end
through ``build_projection``; needs a GPU.

Every time is a host wall around work that ends in
``block_until_ready``, after one warm-up call of the same shape.
Prints one JSON line per measurement and the card's name and power
limit first:

    python tools/top1_bench.py [--nq 2000000] [--m 440000]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def timed(fn, *args, reps: int = 3):
    """(first call incl. compile, best of ``reps`` warm calls) in s."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def bench_top1(nq: int, m: int) -> None:
    import jax.numpy as jnp
    from annembed_tpu.io.synthetic import synthetic_higgs
    from annembed_tpu.knn import hierarchy
    from annembed_tpu.knn.brute import knn_search_brute
    from annembed_tpu.ops.top1 import top1_l2

    data = jnp.asarray(synthetic_higgs(nq + m, seed=7))
    corpus, queries = data[:m], data[m:]
    first, best = timed(top1_l2, queries, corpus)
    emit(what="top1_kernel", nq=nq, m=m, d=28, first_s=first, best_s=best)
    fn = lambda q, c: knn_search_brute(q, c, k=1)
    first, best = timed(fn, queries, corpus, reps=2)
    emit(what="top1_xla_knn_search_brute", nq=nq, m=m, d=28,
         first_s=first, best_s=best)
    ki, _ = top1_l2(queries, corpus)
    ref_i, _ = knn_search_brute(queries, corpus, k=1)
    emit(what="top1_agreement",
         index_agreement=float(jnp.mean(ki == ref_i[:, 0])))

    # end to end through build_projection: n = nq rows, sample ~ m
    x = data[:nq]
    frac = m / nq
    walls = {}
    for label, use_kernel in [("kernel", True), ("xla", False),
                              ("kernel", True)]:
        hierarchy.use_top1_kernel = (
            lambda distance, k=use_kernel: k and distance == "DistL2")
        t0 = time.perf_counter()
        proj = hierarchy.build_projection(x, 6, sample_fraction=frac)
        proj.proj_dist.block_until_ready()
        proj.large_graph.dists.block_until_ready()
        walls.setdefault(label, []).append(time.perf_counter() - t0)
    emit(what="build_projection", n=nq, m=int(proj.nb_small),
         walls_s=walls, note="first kernel wall includes graph-build "
         "compiles")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nq", type=int, default=2_000_000)
    ap.add_argument("--m", type=int, default=440_000)
    args = ap.parse_args()
    from annembed_tpu.utils.cache import enable_persistent_cache
    from annembed_tpu.utils.profiling import (card_name_and_power_limit,
                                              require_gpu)
    enable_persistent_cache()
    emit(device=require_gpu(), card=card_name_and_power_limit())
    bench_top1(args.nq, args.m)


if __name__ == "__main__":
    main()
