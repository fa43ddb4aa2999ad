#!/usr/bin/env python
"""Where a sharded k-NN graph build first departs from the one-device
build; needs four GPUs.

Builds the large graph of the hierarchical Higgs-shaped embed stage by
stage, once on one device and once row-sharded over the ``data`` mesh,
each stage from the same input:

  ivf        the IVF local join (``knn_graph_ivf`` against
             ``sharded_knn_graph_ivf``) on the z-scored cloud;
  nndescent  the NN-descent rounds (``nndescent_refine`` against
             ``sharded_nndescent_refine``), both started from the
             one-device IVF graph.

For each stage it prints the fraction of rows whose neighbour ids (in
order) and whose distances are identical.  Where the ids of a row
differ, it recomputes both lists' distances in float64 on the host:
if the sorted lists agree to a few float32 ulps, the rows differ only
by which of two nearly tied candidates was kept.

    python tools/sharded_graph_diff.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: the Higgs row of the reference's README, as ``chip_smoke.py`` runs it
N_ROWS = 1_650_000
N_DEVICES = 4


def emit(**rec) -> None:
    print(json.dumps(rec, default=float), flush=True)


def compare(stage: str, x: np.ndarray, one, sharded, walls,
            sample: int = 5000) -> None:
    i1, d1 = (np.asarray(a) for a in one)
    i4, d4 = (np.asarray(a) for a in sharded)
    same_ids = np.all(i1 == i4, axis=1)
    same_d = np.all(d1 == d4, axis=1)
    differ = np.flatnonzero(~same_ids)
    rec = {"stage": stage, "rows": len(i1), "k": i1.shape[1],
           "ids_identical": float(same_ids.mean()),
           "dists_identical": float(same_d.mean()),
           "dists_identical_where_ids_identical":
               float(same_d[same_ids].mean()) if same_ids.any() else None,
           "rows_ids_differ": int(len(differ)), "wall_s": walls}
    if len(differ):
        rows = differ[:sample]
        q = x[rows].astype(np.float64)[:, None, :]
        e1 = np.sort(np.sqrt(((q - x[i1[rows]]) ** 2).sum(-1)), axis=1)
        e4 = np.sort(np.sqrt(((q - x[i4[rows]]) ** 2).sum(-1)), axis=1)
        rel = np.max(np.abs(e1 - e4) / np.maximum(e1, 1e-30), axis=1)
        same_set = np.array([set(a) == set(b)
                             for a, b in zip(i1[rows], i4[rows])])
        # first column where the two id lists part
        first = np.argmax(i1[rows] != i4[rows], axis=1)
        rec.update({
            "differ_same_set_fraction": float(same_set.mean()),
            "differ_first_column_hist": np.bincount(
                first, minlength=i1.shape[1]).tolist(),
            "differ_exact_sorted_rel_gap_quantiles": {
                f"q{q_:g}": float(np.quantile(rel, q_))
                for q_ in (0.5, 0.9, 0.99, 1.0)},
            "differ_sum_exact_dist_one_minus_sharded": float(
                (e1.sum(1) - e4.sum(1)).sum())})
    emit(**rec)


def main() -> int:
    from annembed_tpu.utils.cache import enable_persistent_cache
    from annembed_tpu.utils.profiling import (card_name_and_power_limit,
                                              require_gpu)
    enable_persistent_cache()
    emit(device=require_gpu(), card=card_name_and_power_limit())
    import jax
    from annembed_tpu.io.synthetic import synthetic_higgs
    from annembed_tpu.knn.ivf import knn_graph_ivf
    from annembed_tpu.knn.nndescent import nndescent_refine
    from annembed_tpu.parallel.sharded import make_mesh
    from annembed_tpu.parallel.sharded_knn import (sharded_knn_graph_ivf,
                                                   sharded_nndescent_refine)
    from annembed_tpu.params import KnnParams

    if len(jax.devices()) < N_DEVICES:
        raise SystemExit(f"need {N_DEVICES} devices, have "
                         f"{len(jax.devices())}")
    x = synthetic_higgs(N_ROWS, seed=7)
    x = ((x - x.mean(0)) / np.maximum(x.std(0), 1e-12)).astype(np.float32)
    mesh = make_mesh(N_DEVICES)
    p = KnnParams(knbn=6)
    kb = max(p.knbn + 1, int(round(p.knbn * p.build_k_factor)))

    def timed(fn, *a, **kw):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a, **kw))
        return out, time.perf_counter() - t0

    ivf_kw = dict(nlist=p.nlist, nprobe=p.nprobe, dtype=p.dtype,
                  quantizer=p.quantizer, layout=p.ivf_layout)
    one, w1 = timed(knn_graph_ivf, x, kb, **ivf_kw)
    sh, w4 = timed(sharded_knn_graph_ivf, x, kb, mesh, **ivf_kw)
    compare("ivf", x, one, sh, {"one": w1, "sharded": w4})
    nnd_kw = dict(n_rounds=p.refine_rounds, dtype=p.dtype,
                  rho=p.nndescent_rho)
    r1, w1 = timed(nndescent_refine, x, *one, **nnd_kw)
    r4, w4 = timed(sharded_nndescent_refine, x, *one, mesh, **nnd_kw)
    compare("nndescent", x, r1, r4, {"one": w1, "sharded": w4})
    return 0


if __name__ == "__main__":
    sys.exit(main())
