#!/usr/bin/env python
"""Carre-du-Champ driver on MNIST digits/fashion
(reference examples/mnistcdc.rs).

Reference flow (mnistcdc.rs:25-161): load train+test IDX images ->
HNSW -> CarreDuChamp -> for a few chosen points per label: CdC
spectrum, distance from the point to its kernel mean, first/last
neighbour distances -> pairwise point-vs-CdC (Bures bound) distance
correlation -> 20k-sample label-pair contingency tables of point and
CdC distances (mnistcdc.rs:165-271), dumped lower-triangular
(``dump_lows``, mnistcdc.rs:274-283).

This flow: brute/IVF kNN graph, batched CdC via the sparse kernel
entries, and the batched Bures bound (psd_dist_pairs) that never
materializes the (784, 784) covariances.  Falls back to synthetic
10-class labeled data when the IDX files are absent.
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
        from annembed_tpu.io.mnist_io import load_mnist_full
        return load_mnist_full(data_dir)
    # synthetic 10-class manifold: class centers on an 8-d latent,
    # lifted to 784 dims (labels matter here — the driver's output is
    # label contingency)
    rng = np.random.default_rng(11)
    labels = rng.integers(0, 10, n_synth)
    centers = rng.normal(size=(10, 8)).astype(np.float32) * 5.0
    latent = centers[labels] + rng.normal(size=(n_synth, 8)).astype(
        np.float32)
    lift = rng.normal(size=(8, 784)).astype(np.float32)
    x = latent @ lift + 0.5 * rng.normal(size=(n_synth, 784)).astype(
        np.float32)
    return x.astype(np.float32), labels.astype(np.int64)


def choose_points(labels: np.ndarray, per_label: int = 2) -> list:
    """A few point indices per label (mnistcdc.rs ``choose_points``)."""
    out = []
    for lab in np.unique(labels):
        idx = np.flatnonzero(labels == lab)[:per_label]
        out.extend((int(lab), int(i)) for i in idx)
    return out


def dump_lows(mat: np.ndarray, title: str) -> None:
    """Lower-triangular print (mnistcdc.rs:274-283)."""
    print(f"\n{title}")
    for i in range(mat.shape[0]):
        print(" ".join(f"{mat[i, j]:.3e}" for j in range(i + 1)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--synthetic", type=int, default=20000)
    ap.add_argument("--nb-sample", type=int, default=20000,
                    help="contingency sample pairs (mnistcdc.rs:160)")
    ap.add_argument("--knbn", type=int, default=12)
    args = ap.parse_args()

    import jax.numpy as jnp
    from annembed_tpu.knn.api import build_kgraph
    from annembed_tpu.estimators.cdc import (CarreDuChamp, CdcMat,
                                             psd_dist_upper_bound)

    x, labels = load_data(args.data_dir, args.synthetic)
    n = x.shape[0]
    print(f"data: {x.shape}")

    t0 = time.perf_counter()
    g = build_kgraph(x, args.knbn)
    cdc = CarreDuChamp(x, kgraph=g)
    print(f"graph+kernel built in {time.perf_counter() - t0:.1f}s")

    # --- per-point diagnostics (mnistcdc.rs:100-126) -------------------
    points = choose_points(labels)
    pts = np.array([p for _, p in points], np.int32)
    t0 = time.perf_counter()
    means, covs = cdc.get_cdc_batch(jnp.asarray(pts))
    means, covs = np.asarray(means), np.asarray(covs)
    for (lab, p), mean, cov in zip(points, means, covs):
        spec = CdcMat(mat=jnp.asarray(cov)).get_spectrum()
        dist_to_mean = float(np.linalg.norm(mean - x[p]))
        first, last = float(g.dists[p, 0]), float(g.dists[p, -1])
        print(f"label {lab} point {p}: spectrum rank {len(spec)} "
              f"top {float(spec[0]):.3e}; dist to mean {dist_to_mean:.3e} "
              f"first nbr {first:.3e} last {last:.3e}")
    print(f"cdc work: {time.perf_counter() - t0:.1f}s")

    # --- pairwise point vs CdC distance correlation (rs:130-158) -------
    m = len(points)
    ii, jj = np.triu_indices(m, k=1)
    p_dist = np.linalg.norm(x[pts[ii]] - x[pts[jj]], axis=1)
    cdc_dist = np.asarray(cdc.psd_dist_pairs(pts[ii], pts[jj]))
    # sanity: batched Bures == per-pair CdcMat bound on the first pair
    d0 = psd_dist_upper_bound(CdcMat(mat=jnp.asarray(covs[ii[0]])),
                              CdcMat(mat=jnp.asarray(covs[jj[0]])))
    assert abs(d0 - cdc_dist[0]) <= 1e-2 * max(1.0, abs(d0)), (d0,
                                                               cdc_dist[0])
    corr = float(np.corrcoef(p_dist, cdc_dist)[0, 1])
    print(f"correlation between dists: {corr:.3e}")

    # --- contingency tables (mnistcdc.rs:165-271) -----------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    nb = args.nb_sample
    si = rng.integers(0, n, nb)
    sj = rng.integers(0, n, nb)
    li, lj = labels[si], labels[sj]
    key_a, key_b = np.maximum(li, lj), np.minimum(li, lj)
    pd = np.linalg.norm(x[si] - x[sj], axis=1)
    cd = np.empty(nb, np.float32)
    chunk = 256
    for s in range(0, nb, chunk):
        e = min(s + chunk, nb)
        cd[s:e] = np.asarray(cdc.psd_dist_pairs(si[s:e], sj[s:e]))
    nlab = int(labels.max()) + 1
    means_p = np.zeros((nlab, nlab)); std_p = np.zeros((nlab, nlab))
    means_c = np.zeros((nlab, nlab)); std_c = np.zeros((nlab, nlab))
    counts_c = np.zeros((nlab, nlab), np.int64)
    for a in range(nlab):
        for b in range(a + 1):
            sel = (key_a == a) & (key_b == b)
            counts_c[a, b] = int(sel.sum())
            if sel.any():
                means_p[a, b] = pd[sel].mean(); std_p[a, b] = pd[sel].std()
                means_c[a, b] = cd[sel].mean(); std_c[a, b] = cd[sel].std()
    print(f"contingency estimation nb samples = {nb}, "
          f"time {time.perf_counter() - t0:.1f}s")
    dump_lows(means_p, "point distances means:")
    dump_lows(std_p, "point distances stddev:")
    dump_lows(means_c, "cdc point distances means:")
    dump_lows(std_c, "cdc point distances stddev:")
    # between-label mean over CELLS THAT DREW SAMPLES only: at small
    # --nb-sample some label pairs get zero draws and their 0.0
    # placeholder would bias the contrast
    li, lj = np.tril_indices(nlab, -1)
    seen = counts_c[li, lj] > 0
    between = (float(means_c[li, lj][seen].mean()) if seen.any()
               else float("nan"))
    print(json.dumps({"corr": corr, "nb_sample": nb,
                      "within_mean": float(np.mean(np.diag(means_c))),
                      "between_mean": between}))


if __name__ == "__main__":
    main()
