#!/usr/bin/env python
"""Higgs 11M x 28 benchmark driver (reference examples/higgs.rs).

Reference flow: CSV (optionally subsampled) -> z-score rescale ->
HNSW (max_conn=12, ef_c=400, level_scale=0.75, blocked insert) ->
hierarchical embed (batch=40, grad_factor=5, scale_rho=0.75,
hubness_weighting=true) -> quality.  Reference wall: ~2 h.

This flow: native CSV load -> IVF kNN graph (+ rho-sampled NN-descent)
-> hierarchical two-level embedding -> quality; graph
checkpoint/resume replaces the HnswIo dump (higgs.rs:397-474): pass
--graph-cache to save/load the (n, k) kNN arrays with np.savez.
Large-phase defaults are the round-3 tuned operating point
(batch=60, n_sub=120 — PERF.md "hierarchical large-phase tuning";
the reference's own point is batch=40, higgs.rs:204-242, reachable
via --batch 40 --n-sub 60).

Falls back to synthetic 28-dim data with --synthetic N when no CSV is
available (zero-egress container).

--json emits ONE machine-readable line with phase timings, build-graph
recall@k vs exact (sampled queries, chunked exact search over the full
corpus) and the neighborhood-conservation summary — the reproducible
form of the PERF.md 11M table:

  python examples/higgs.py --synthetic 11000000 --quality --json
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


import argparse
import json
import logging
import time

import numpy as np

logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                    format="%(asctime)s %(name)s: %(message)s")


def parse_schedule(spec, batch=None, n_sub=None):
    """'30x60,30x120' -> ((30, 60), (30, 120)); None/''/'none' -> None.

    'auto' resolves to the tuned coarse->fine recipe ((40,60),(20,120))
    when batch/n_sub sit at the harness defaults (60/120), else flat —
    so explicit operating-point flags are never silently reshaped."""
    if spec == "auto":
        return (((40, 60), (20, 120))
                if (batch, n_sub) == (60, 120) else None)
    if not spec or spec == "none":
        return None
    return tuple(tuple(int(v) for v in part.split("x"))
                 for part in spec.split(","))


def build_graph_recall(x, g, sample: int = 2000, seed: int = 11) -> float:
    """recall@k of the build graph vs exact, on `sample` random rows
    (exact side = chunked brute search over the FULL corpus)."""
    from annembed_tpu.knn.api import sampled_exact_recall
    return sampled_exact_recall(x, g, sample=sample, seed=seed)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", default=None, help="HIGGS.csv path")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic 28-dim rows instead")
    ap.add_argument("--manifold", action="store_true",
                    help="with --synthetic: use the intrinsic-dim-2 "
                         "clustered manifold (io/synthetic.py) instead "
                         "of the 8-d-latent blobs.  The 8-d latent "
                         "CANNOT be conserved by a 2-d embedding "
                         "(information-theoretic ceiling, PERF.md "
                         "scale study); the manifold CAN — the "
                         "conservable control at reference scale")
    ap.add_argument("--sampling", type=float, default=1.0)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--nbng", type=int, default=6)
    ap.add_argument("--fraction", type=float, default=0.04,
                    help="hierarchical subsample fraction (~HNSW layer>=1)")
    ap.add_argument("--graph-cache", default=None)
    ap.add_argument("--embed-cache", default=None,
                    help="npy path: eager embedding checkpoint after "
                         "the optimize phase; an existing file resumes "
                         "straight into quality")
    ap.add_argument("--data-cache", default=None,
                    help="npy path: save/load the prepared (z-scored) "
                         "matrix so retries skip the ~min-scale "
                         "synthetic generation at 11M")
    ap.add_argument("--svd-n-iter", type=int, default=5,
                    help="dmap spectral subspace iterations (reference "
                         "5, graphlaplace.rs:115; ~40 s/iter at 6.6M)")
    ap.add_argument("--dmap", action="store_true",
                    help="diffusion-maps variant (dim=5, alfa=1, beta=0, "
                         "gnbn=8; higgs.rs:488-502)")
    ap.add_argument("--quality", action="store_true")
    ap.add_argument("--quality-nbng", type=int, default=100,
                    help="embedded neighbourhood size (reference Higgs "
                         "table uses 100, README.md:148-160)")
    ap.add_argument("--quality-radius-compat", type=int, default=250,
                    help="also report conservation at this radius_k "
                         "(reference adjacency-radius emulation, "
                         "~2.5x nbng; 0 = off) from the same exact "
                         "embedded search")
    ap.add_argument("--quality-fraction", type=float, default=0.0,
                    help="query-node subsample for the quality estimate; "
                         "0 = auto (min(1, 200k/n))")
    ap.add_argument("--recall-sample", type=int, default=2000,
                    help="rows for the build-graph recall check "
                         "(0 = skip)")
    ap.add_argument("--batch", type=int, default=60,
                    help="large-phase gradient batches (reference point "
                         "is 40, higgs.rs:204-242; 60 is the tuned "
                         "operating point — see PERF.md large-phase "
                         "study: no-match 0.190 -> 0.150 at 100k/nbng=100)")
    ap.add_argument("--n-sub", type=int, default=120,
                    help="dense-optimizer sub-sweeps per batch (60 = "
                         "round-2 default; 120 tuned with --batch 60)")
    ap.add_argument("--n-blocks", type=int, default=1,
                    help="node-block sub-sweeps (dense_n_blocks): cut "
                         "the per-batch gather volume by running each "
                         "sub-sweep on 1/B of the nodes at B x the "
                         "sync granularity")
    ap.add_argument("--schedule", default="auto",
                    help="n_sub schedule as 'NBxS,NBxS,...' phases "
                         "summing to --batch (coarse->fine beat flat "
                         "60x120 on every quality metric at 2/3 the "
                         "sweeps — PERF.md granularity study). "
                         "'auto' (default) = 40x60,20x120 when "
                         "--batch/--n-sub are at their defaults, else "
                         "flat; 'none' = flat n_sub")
    ap.add_argument("--nprobe", type=int, default=24,
                    help="IVF cells probed per query (24 x rho=0.5 x "
                         "4 rounds = tuned 11M point: recall@6 0.9803 "
                         "in 643 s, beats nprobe=16 x rho=1.0 x 3 on "
                         "both axes — PERF.md tuning table)")
    ap.add_argument("--refine-rounds", type=int, default=4)
    ap.add_argument("--rho", type=float, default=0.5,
                    help="NN-descent candidate sampling fraction")
    ap.add_argument("--optimizer", default="dense",
                    choices=["dense", "sampling"],
                    help="CE optimizer: 'dense' (flagship closed-form "
                         "multiplicity sweeps) or 'sampling' (the "
                         "reference-exact per-sample dynamics, "
                         "optim/ce.py) — the same-data oracle that "
                         "splits data-artefact from optimizer dynamics "
                         "in the conservation gap")
    ap.add_argument("--no-exclusion", action="store_true",
                    help="skip the negative-sample neighbour-rejection "
                         "test (dense_neighbor_exclusion=False): an "
                         "O(k/n) repulsion surplus — negligible at "
                         "millions of nodes, saves the sweep's biggest "
                         "elementwise op (bench.py ships it; the "
                         "library default stays reference-exact)")
    ap.add_argument("--parallel-kicks", action="store_true",
                    help="stacked repulsion kicks (dense_parallel_kicks)"
                         ": one (n_neg, d, n) program instead of n_neg "
                         "dependent chains; quality-neutral on CPU A/B")
    ap.add_argument("--gather-reuse", type=int, default=1,
                    help="reuse one neighbour gather for S consecutive "
                         "sweeps (dense_gather_reuse): amortizes the "
                         "gather that is 65%% of the 11M sweep; "
                         "neighbour positions <= S-1 sweeps stale "
                         "(within the reference's Hogwild envelope)")
    ap.add_argument("--gather-reuse-after", type=float, default=0.0,
                    help="fraction of the batch schedule run exact "
                         "before stale reuse activates "
                         "(dense_gather_reuse_after)")
    ap.add_argument("--packed-gather", action="store_true",
                    help="pack the (2, n) coordinates into complex64 "
                         "for the neighbour gather (bit-exact; halves "
                         "gathered element count — the gather is 65% "
                         "of the 11M sweep, PERF.md round-5 ablation)")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable result line")
    ap.add_argument("--out", default="higgs_embedded.csv")
    args = ap.parse_args()

    import annembed_tpu as at
    from annembed_tpu.params import EmbedderParams, KnnParams

    import os

    if args.data_cache and os.path.exists(args.data_cache):
        x = np.load(args.data_cache)
        if args.synthetic and x.shape[0] != args.synthetic:
            raise SystemExit(
                f"--data-cache {args.data_cache} holds {x.shape[0]} rows "
                f"but --synthetic asked for {args.synthetic}: stale cache "
                "from another run — delete it or change the path")
    else:
        if args.synthetic and args.manifold:
            from annembed_tpu.io.synthetic import (
                synthetic_clustered_manifold)
            x = synthetic_clustered_manifold(
                args.synthetic, d=28, seed=7,
                n_clusters=32).astype(np.float32)
        elif args.synthetic:
            from annembed_tpu.io.synthetic import synthetic_higgs
            x = synthetic_higgs(args.synthetic)
        else:
            from annembed_tpu.io.csv_io import get_toembed_from_csv
            x = get_toembed_from_csv(args.csv, subsample=args.sampling)
            x = x[:, 1:]  # first column is the label (higgs.rs:77-155)
        # z-score rescale (higgs.rs:158-176)
        x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-12)
        x = x.astype(np.float32)
        if args.data_cache:
            np.save(args.data_cache, x)
    n = x.shape[0]
    print(f"data: {x.shape}", file=sys.stderr, flush=True)

    qfrac = args.quality_fraction or min(1.0, 200_000 / max(n, 1))

    t0 = time.perf_counter()
    if args.dmap:
        # tuned build knobs (bf16 join panels, nprobe, rho-sampled
        # NN-descent) — the default KnnParams build at 6.6M is ~4x
        # slower and blew the round-4 harness timeout
        kp = KnnParams(knbn=8, nprobe=args.nprobe, dtype="bfloat16",
                       refine_rounds=args.refine_rounds,
                       nndescent_rho=args.rho)
        y, info = at.dmap_embed(x, dim=5, alfa=1.0, beta=0.0, nbng=8,
                                knn_params=kp,
                                svd_n_iter=args.svd_n_iter)
        g = None
    else:
        # bf16 IVF join panels: identical recall (exact L2 rerank in the
        # join), ~1.2x faster at 11M; rho-sampled NN-descent rounds
        kp = KnnParams(knbn=args.nbng, nprobe=args.nprobe,
                       dtype="bfloat16", refine_rounds=args.refine_rounds,
                       nndescent_rho=args.rho)
        y, info = at.embed(
            x, dim=args.dim, batch=args.batch, nbng=args.nbng, layer=1,
            hierarchy_fraction=args.fraction, scale=0.75,
            knn_params=kp, with_quality=args.quality,
            quality_nbng=args.quality_nbng, quality_fraction=qfrac,
            quality_radius_compat=args.quality_radius_compat,
            # eager: dump right after construction like the reference's
            # HnswIo (higgs.rs:466-474) — a crash in the hour-long
            # optimize must not lose the graph build
            graph_cache=args.graph_cache, graph_cache_eager=True,
            embed_cache=args.embed_cache, return_graph=True,
            params=EmbedderParams(grad_factor=5, hubness_weighting=True,
                                  optimizer=args.optimizer,
                                  n_sub=args.n_sub,
                                  dense_n_blocks=args.n_blocks,
                                  dense_neighbor_exclusion=(
                                      not args.no_exclusion),
                                  dense_parallel_kicks=args.parallel_kicks,
                                  dense_packed_gather=args.packed_gather,
                                  dense_gather_reuse=args.gather_reuse,
                                  dense_gather_reuse_after=(
                                      args.gather_reuse_after),
                                  n_sub_schedule=parse_schedule(
                                      args.schedule, args.batch,
                                      args.n_sub)))
        g = info.pop("kgraph", None)
    wall = time.perf_counter() - t0

    recall = None
    if g is not None and args.recall_sample > 0:
        recall = build_graph_recall(x, g, sample=args.recall_sample)

    rec = {"n": n, "wall_s": round(wall, 1),
           **({"manifold": True} if args.manifold else {}),
           **{k: (round(v, 2) if isinstance(v, float) else v)
              for k, v in info.items()
              if isinstance(v, (int, float, dict))}}
    if recall is not None:
        rec[f"recall@{args.nbng}"] = round(recall, 4)
        rec["recall_sample"] = args.recall_sample
    if args.quality:
        rec["quality_fraction"] = round(qfrac, 4)
        rec["quality_nbng"] = args.quality_nbng
    out_line = json.dumps(rec, default=float)
    print(out_line, flush=True)
    if args.out and args.out.lower() != "none":
        # at 11M rows this savetxt is minutes of single-threaded
        # formatting — pass --out none for benchmark-only runs
        from annembed_tpu.io.csv_io import write_csv_array2
        write_csv_array2(args.out, y)


if __name__ == "__main__":
    main()
