#!/usr/bin/env python
"""TDA export driver (reference examples/toripser.rs).

Reference flow (toripser.rs:150-221): load MNIST-fashion IDX train
images -> HNSW (max_conn=48, ef_c=400, keeping pruned) ->
ToRipserer::extract_projection_to_ripserer(knbn=20, layer=1,
"fashionproj.ripser") -> extract_neighbourhood(first image, 1000,
"fashionlocal.bson").  The outputs feed Julia/toripserer.jl
(Ripserer.jl persistence homology).

This flow: the same two dumps from annembed_tpu.io.ripser (sparse
triplets of the projected small graph + lower-triangular BSON "limat"
of the 1000-point neighbourhood of the first image); synthetic
fallback when IDX files are absent.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def load_data(data_dir: str | None, n_synth: int):
    if data_dir and Path(data_dir).exists():
        from annembed_tpu.io.mnist_io import load_mnist_train_data
        return load_mnist_train_data(data_dir)[0]
    rng = np.random.default_rng(3)
    # torus-ish synthetic manifold so the persistence dumps are not
    # featureless noise
    theta = rng.uniform(0, 2 * np.pi, (n_synth, 2))
    base = np.stack([(2 + np.cos(theta[:, 0])) * np.cos(theta[:, 1]),
                     (2 + np.cos(theta[:, 0])) * np.sin(theta[:, 1]),
                     np.sin(theta[:, 0])], axis=1).astype(np.float32)
    lift = rng.normal(size=(3, 784)).astype(np.float32)
    return base @ lift + 0.05 * rng.normal(
        size=(n_synth, 784)).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--synthetic", type=int, default=20000)
    ap.add_argument("--knbn", type=int, default=20,
                    help="projected-graph neighbours (toripser.rs:202)")
    ap.add_argument("--nbpoints", type=int, default=1000,
                    help="local neighbourhood size (toripser.rs:219)")
    ap.add_argument("--proj-out", default="fashionproj.ripser")
    ap.add_argument("--local-out", default="fashionlocal.bson")
    args = ap.parse_args()

    from annembed_tpu.io.ripser import (extract_projection_to_ripserer,
                                        extract_neighbourhood,
                                        read_bson_limat)

    x = np.asarray(load_data(args.data_dir, args.synthetic), np.float32)
    print(f"data: {x.shape}")

    t0 = time.perf_counter()
    quants = extract_projection_to_ripserer(x, args.knbn, args.proj_out)
    t_proj = time.perf_counter() - t0
    print(f"projection dump -> {args.proj_out} in {t_proj:.1f}s; "
          f"projection distance quantiles: {quants}")

    t0 = time.perf_counter()
    nb = extract_neighbourhood(x, x[0], args.nbpoints, args.local_out)
    t_local = time.perf_counter() - t0
    vals = read_bson_limat(args.local_out)
    print(f"neighbourhood dump -> {args.local_out} "
          f"({nb} points, {len(vals)} lower-tri entries) in {t_local:.1f}s")
    print(json.dumps({"proj_file": args.proj_out,
                      "local_file": args.local_out,
                      "nb_local": int(nb),
                      "limat_entries": int(len(vals)),
                      "proj_quantiles": {k: float(v)
                                         for k, v in quants.items()}
                      if isinstance(quants, dict) else str(quants)}))


if __name__ == "__main__":
    main()
