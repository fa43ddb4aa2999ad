#!/usr/bin/env python
"""Smoke test: the embedding pipeline on one GPU, checked against the
repo's plain references at the sizes its users run.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: embed(n_devices=4) only

Phases, in order (any failure exits non-zero; without a GPU nothing
runs):

  device        the first JAX device is a GPU; its kind and count, and
                the card's name and power limit from nvidia-smi.
  embed_70k     one-step ``embed`` of the 70,000 x 784 clustered
                manifold (knbn 6, 30 batches, quality at nbng 50):
                recall@6 of the graph >= 0.99 against exact f32 search
                at Precision.HIGHEST on 2,000 rows; finite embedding;
                compat conservation >= 5.0 of 6 matched.
  hierarchical  ``embed(layer=1, hierarchy_fraction=0.05)`` of the
                1,650,000 x 28 Higgs-shaped cloud (IVF + NN-descent,
                top-1 projection, two-stage optimizer): finite
                embedding; the projection agrees with exact top-1
                search on a row sample.
  spectral      ``dmap_embed`` of the 70k data is finite; the
                randomized-SVD basis of its Laplacian has
                max|Q^T Q - I| <= 1e-4 and singular values within
                1e-3 relative of the same call at Precision.HIGHEST.
  top1          the fused top-1 kernel (ops/top1.py, Pallas through
                Triton, IEEE float32 products) against
                ``knn_search_brute(k=1)`` at Precision.HIGHEST, 200,000
                queries x 440,000 corpus rows x 28 features: index
                agreement >= 0.999, distances to rtol 1e-4, and every
                differing choice within 1e-4 of the exact minimum.

``--four`` runs only the hierarchical embed on four cards and the
one-card runs it is compared with: the four-card graph must equal the
one-card graph; the mean conservation of the four-card runs (seeds 0
and 1) must lie within the one-card runs' seed spread (max - min over
seeds 0, 1 and 2) of their mean; collective time is read from a
profiler trace of the four-card embed.

Each phase prints one ``phase <name>: {json}`` line; the last line of
stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def report(name: str, rec: dict) -> None:
    print(f"phase {name}: {json.dumps(rec, default=float)}", flush=True)


def phase_device() -> dict:
    from annembed_tpu.utils.profiling import (card_name_and_power_limit,
                                              require_gpu)
    device = require_gpu()
    print(f"device: kind={device['kind']} count={device['count']}",
          flush=True)
    print(card_name_and_power_limit(), flush=True)
    return device


def manifold_70k(n: int = 70_000, d: int = 784) -> np.ndarray:
    from annembed_tpu.io.synthetic import synthetic_clustered_manifold
    return synthetic_clustered_manifold(n, d, seed=7).astype(np.float32)


def higgs_like(n: int) -> np.ndarray:
    """Synthetic Higgs-shaped rows, z-scored as examples/higgs.py does."""
    from annembed_tpu.io.synthetic import synthetic_higgs
    x = synthetic_higgs(n, seed=7)
    return ((x - x.mean(0)) / np.maximum(x.std(0), 1e-12)).astype(
        np.float32)


def phase_embed(x: np.ndarray, recall_rows: int = 2000,
                min_compat: float = 5.0) -> dict:
    import annembed_tpu
    from annembed_tpu.knn.api import sampled_exact_recall
    t0 = time.perf_counter()
    y, info = annembed_tpu.embed(
        x, dim=2, nbng=6, batch=30, with_quality=True, quality_nbng=50,
        quality_radius_compat=125, return_graph=True)
    wall = time.perf_counter() - t0
    recall = sampled_exact_recall(x, info["kgraph"], sample=recall_rows)
    q = info["quality"]
    rec = {"wall_s": wall, "recall@6": recall,
           "compat_mean_matched": q["compat_mean_nb_matched"],
           "mean_matched": q["mean_nb_matched"],
           "no_match": q["nb_without_match"]}
    report("embed_70k", rec)
    check(np.isfinite(y).all(), "embedding not finite")
    check(recall >= 0.99, f"recall@6 {recall} < 0.99")
    check(q["compat_mean_nb_matched"] >= min_compat,
          f"compat mean_matched {q['compat_mean_nb_matched']} "
          f"< {min_compat}")
    return rec


def _exact_top1(queries, corpus):
    import jax
    from annembed_tpu.knn.brute import knn_search_brute
    with jax.default_matmul_precision("highest"):
        i, d = knn_search_brute(queries, corpus, k=1)
    return np.asarray(i)[:, 0], np.asarray(d)[:, 0]


def phase_hierarchical(x: np.ndarray, check_rows: int = 20_000) -> dict:
    import annembed_tpu
    from annembed_tpu.io.checkpoint import load_projection
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "projection.npz")
        t0 = time.perf_counter()
        y, info = annembed_tpu.embed(
            x, dim=2, nbng=6, layer=1, hierarchy_fraction=0.05,
            graph_cache=cache, graph_cache_eager=True)
        wall = time.perf_counter() - t0
        proj = load_projection(cache, expect_n=x.shape[0])
    sample_ids = np.asarray(proj.sample_ids)
    rng = np.random.default_rng(3)
    rows = np.sort(rng.choice(x.shape[0], min(check_rows, x.shape[0]),
                              replace=False))
    ref_i, ref_d = _exact_top1(x[rows], x[sample_ids])
    got_i = np.asarray(proj.proj_small_idx)[rows]
    got_d = np.asarray(proj.proj_dist)[rows]
    sampled = np.isin(rows, sample_ids)
    agree = float((got_i[~sampled] == ref_i[~sampled]).mean())
    dist_err = float(np.max(np.abs(got_d[~sampled] - ref_d[~sampled])
                            / np.maximum(ref_d[~sampled], 1e-30)))
    rec = {"wall_s": wall, "n": x.shape[0], "n_sampled": len(sample_ids),
           "graph_build_s": info["graph_build_time"],
           "proj_index_agreement": agree, "proj_dist_max_rel_err": dist_err}
    report("hierarchical", rec)
    check(np.isfinite(y).all(), "hierarchical embedding not finite")
    check(agree >= 0.999, f"projection index agreement {agree} < 0.999")
    check(dist_err <= 1e-4, f"projection distance rel err {dist_err}")
    return rec


def _laplacian_svd(x: np.ndarray, nbng: int = 16, dim: int = 2):
    """Randomized SVD of the diffusion-maps Laplacian that
    ``dmap_embed(x, dim, nbng=nbng)`` decomposes, built the same way."""
    import jax
    from annembed_tpu.knn.api import build_kgraph
    from annembed_tpu.params import DiffusionParams
    from annembed_tpu.spectral.diffmaps import DiffusionMaps
    g = build_kgraph(x, nbng)
    dm = DiffusionMaps(params=DiffusionParams(asked_dim=dim, alfa=1.0,
                                              beta=0.0, t=5.0, gnbn=nbng))
    lap = dm.laplacian_from_kgraph(g)
    res = lap.do_svd(dim + 15, n_iter=dm.params.svd_n_iter)
    with jax.default_matmul_precision("highest"):
        ref = lap.do_svd(dim + 15, n_iter=dm.params.svd_n_iter)
    return res, ref


def phase_spectral(x: np.ndarray) -> dict:
    import annembed_tpu
    y, _ = annembed_tpu.dmap_embed(x, dim=2)
    res, ref = _laplacian_svd(x)
    u = np.asarray(res.u, np.float64)
    orth = float(np.abs(u.T @ u - np.eye(u.shape[1])).max())
    s, s_ref = np.asarray(res.s), np.asarray(ref.s)
    s_rel = float(np.max(np.abs(s - s_ref) / np.maximum(np.abs(s_ref),
                                                         1e-30)))
    rec = {"orthogonality_max": orth, "singular_values_max_rel": s_rel,
           "s_top": s[:4].tolist()}
    report("spectral", rec)
    check(np.isfinite(y).all(), "dmap embedding not finite")
    check(orth <= 1e-4, f"max|Q^T Q - I| = {orth} > 1e-4")
    check(s_rel <= 1e-3, f"singular values off by {s_rel} relative")
    return rec


def phase_top1(nq: int = 200_000, m: int = 440_000) -> dict:
    from annembed_tpu.ops.top1 import top1_l2
    data = higgs_like(nq + m)
    corpus, queries = data[:m], data[m:]
    t0 = time.perf_counter()
    got_i, got_d = top1_l2(queries, corpus)
    got_i, got_d = np.asarray(got_i), np.asarray(got_d)
    kernel_s = time.perf_counter() - t0
    ref_i, ref_d = _exact_top1(queries, corpus)
    agree = float((got_i == ref_i).mean())
    diff = got_i != ref_i
    # exact distance of the kernel's choice where it differs
    alt = np.sqrt(((queries[diff].astype(np.float64)
                    - corpus[got_i[diff]]) ** 2).sum(1))
    alt_rel = float(np.max(np.abs(alt - ref_d[diff])
                           / np.maximum(ref_d[diff], 1e-30))) \
        if diff.any() else 0.0
    dist_rel = float(np.max(np.abs(got_d - ref_d)
                            / np.maximum(ref_d, 1e-30)))
    rec = {"nq": nq, "m": m, "d": data.shape[1],
           "precision": "float32 IEEE (Precision.HIGHEST)",
           "first_call_s_incl_compile": kernel_s, "index_agreement": agree,
           "n_differ": int(diff.sum()), "differ_max_rel": alt_rel,
           "dist_max_rel": dist_rel}
    report("top1", rec)
    check(agree >= 0.999, f"top-1 index agreement {agree} < 0.999")
    check(alt_rel <= 1e-4, f"differing choices off by {alt_rel}")
    check(dist_rel <= 1e-4, f"top-1 distances off by {dist_rel}")
    return rec


def collective_seconds(trace_dir: str) -> dict:
    """Per-device time in collective kernels (NCCL and XLA collectives)
    of the profiler trace under ``trace_dir``: per GPU plane, the
    largest per-line sum of matching event durations, and the names of
    the matching events that took longest."""
    import glob
    import re
    from jax.profiler import ProfileData
    pat = re.compile(r"nccl|all-gather|all-reduce|reduce-scatter|"
                     r"all-to-all|collective-permute", re.I)
    out = {}
    for f in glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                    "*.xplane.pb")):
        for plane in ProfileData.from_file(f).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            best, by_name = 0.0, {}
            for line in plane.lines:
                s = 0
                for ev in line.events:
                    if pat.search(ev.name):
                        s += ev.duration_ns
                        by_name[ev.name] = (by_name.get(ev.name, 0)
                                            + ev.duration_ns)
                best = max(best, s * 1e-9)
            top = sorted(by_name, key=by_name.get, reverse=True)[:3]
            out[plane.name] = {"seconds": best, "top_events": top}
    return out


def four_cards(x: np.ndarray, n_devices: int = 4) -> dict:
    """Hierarchical embed on ``n_devices`` cards against one card."""
    import jax
    import annembed_tpu
    from annembed_tpu.io.checkpoint import load_projection
    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, have {len(jax.devices())}")
    # sampled quality: both sides then take the same exact radius
    # search (the full-fraction estimator is exact on one card but an
    # IVF rebuild under a mesh)
    kw = dict(dim=2, nbng=6, layer=1, hierarchy_fraction=0.05,
              with_quality=True, quality_nbng=50, quality_fraction=0.05)

    def matched(info):
        return info["quality"]["mean_nb_matched"]

    with tempfile.TemporaryDirectory() as tmp:
        one, sharded = (os.path.join(tmp, f) for f in ("1.npz", "4.npz"))
        t0 = time.perf_counter()
        y1, i1 = annembed_tpu.embed(x, graph_cache=one,
                                    graph_cache_eager=True, **kw)
        wall_1 = time.perf_counter() - t0
        # seed spread: seeds 1 and 2 reload seed 0's projection, so
        # only the optimizer's random stream differs
        q1 = [matched(i1)] + [
            matched(annembed_tpu.embed(x, graph_cache=one, seed=s,
                                       **kw)[1]) for s in (1, 2)]
        trace_dir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        with jax.profiler.trace(trace_dir):
            y4, i4 = annembed_tpu.embed(x, graph_cache=sharded,
                                        graph_cache_eager=True,
                                        n_devices=n_devices, **kw)
        wall_4 = time.perf_counter() - t0
        coll = collective_seconds(trace_dir)
        q4 = [matched(i4), matched(annembed_tpu.embed(
            x, graph_cache=sharded, seed=1, n_devices=n_devices,
            **kw)[1])]
        p1, p4 = load_projection(one), load_projection(sharded)
    # fraction of identical entries (1-D) or identical rows (2-D)
    same = {name: float(np.mean(np.all(
        np.asarray(a).reshape(len(a), -1) == np.asarray(b).reshape(
            len(b), -1), axis=1)))
        for name, a, b in [
            ("sample_ids", p1.sample_ids, p4.sample_ids),
            ("small_graph", p1.small_graph.indices, p4.small_graph.indices),
            ("large_graph", p1.large_graph.indices, p4.large_graph.indices),
            ("projection", p1.proj_small_idx, p4.proj_small_idx)]}
    spread = max(q1) - min(q1)
    gap = float(np.mean(q4) - np.mean(q1))
    rec = {"n": x.shape[0], "n_devices": n_devices,
           "identical_fraction": same, "mean_matched_1card_seeds": q1,
           "mean_matched_4card_seeds": q4, "spread_1card": spread,
           "mean_gap_4card_minus_1card": gap,
           "wall_1card_s": wall_1, "wall_4card_s_traced": wall_4,
           "collective_s_per_device": coll}
    report("four_cards", rec)
    check(np.isfinite(y1).all() and np.isfinite(y4).all(),
          "embedding not finite")
    check(all(v == 1.0 for v in same.values()),
          "four-card graph differs from the one-card graph")
    check(abs(gap) <= spread,
          f"four-card conservation {q4} is {gap:+.5f} from the one-card "
          f"mean, outside the one-card seed spread {spread:.5f} ({q1})")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only embed(n_devices=4) against one card")
    args = ap.parse_args()

    from annembed_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    device = phase_device()

    if args.four:
        phases = [("four_cards", lambda: four_cards(higgs_like(1_650_000)))]
    else:
        x70 = manifold_70k()
        phases = [
            ("embed_70k", lambda: phase_embed(x70)),
            ("hierarchical",
             lambda: phase_hierarchical(higgs_like(1_650_000))),
            ("spectral", lambda: phase_spectral(x70)),
            ("top1", phase_top1),
        ]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name} took {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
