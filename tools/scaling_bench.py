#!/usr/bin/env python
"""Weak-scaling microbench on the virtual CPU mesh.

The virtual mesh (``--xla_force_host_platform_device_count``) needs no
accelerator.  Virtual devices share
the host's cores — ABSOLUTE throughput is meaningless — but WEAK
scaling (fixed rows per device) still measures exactly what multi-chip
would stress: partitioning overhead, collective count/volume per step,
and whether per-device work stays constant as devices grow.  A flat
wall per sweep / per joined row as devices double = the program scales;
a growing one = collective or padding overhead.

Phases measured (the two dominant 11M phases):
  * sharded dense optimizer sweeps (sweeps/s, fixed 8192 rows/device)
  * sharded IVF+NN-descent graph build (rows/s, fixed 8192 rows/device)

Each device count runs in a fresh subprocess (the device count must be
fixed before jax initializes).  Emits a table + one JSON line per
count.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROWS_PER_DEV = 8192
CHILD = r"""
import json, os, time
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp

ndev = int(os.environ["_SCALE_NDEV"])
rows = int(os.environ["_SCALE_ROWS"])
assert len(jax.devices()) >= ndev, (ndev, jax.devices())

import dataclasses
from annembed_tpu.parallel.sharded import make_mesh, sharded_dense_optimize
from annembed_tpu.parallel.sharded_knn import sharded_build_kgraph
from annembed_tpu.knn.brute import knn_graph_brute
from annembed_tpu.graph.kgraph import KGraph
from annembed_tpu.graph.proba import to_proba_edges
from annembed_tpu.params import EmbedderParams, KnnParams

n = rows * ndev
d, k, dim = 32, 8, 2
rng = np.random.default_rng(0)
x = rng.normal(size=(n, d)).astype(np.float32)
mesh = make_mesh(ndev)

# --- graph build (IVF path forced: brute_force_limit below n) ---
kp = KnnParams(knbn=k, brute_force_limit=1024, nlist=max(16, ndev * 8),
               nprobe=8, refine_rounds=1, nndescent_rho=0.5)
t0 = time.perf_counter()
g = sharded_build_kgraph(x, k, mesh, params=kp)
g.dists.block_until_ready()
build_cold = time.perf_counter() - t0
t0 = time.perf_counter()
g = sharded_build_kgraph(x, k, mesh, params=kp)
g.dists.block_until_ready()
build_warm = time.perf_counter() - t0

# --- dense optimizer sweeps ---
npar = to_proba_edges(g)
y0 = jnp.asarray(rng.uniform(-5, 5, size=(n, dim)).astype(np.float32))
SWEEPS = 24
p = dataclasses.replace(EmbedderParams(), nb_grad_batch=2, n_sub=SWEEPS // 2,
                        n_sub_schedule=None)
t0 = time.perf_counter()
y = sharded_dense_optimize(y0, g, npar, p, mesh)
y.block_until_ready()
opt_cold = time.perf_counter() - t0
t0 = time.perf_counter()
y = sharded_dense_optimize(y0, g, npar, p, mesh)
y.block_until_ready()
opt_warm = time.perf_counter() - t0

print(json.dumps({
    "n_devices": ndev, "n": n, "rows_per_dev": rows,
    "build_warm_s": round(build_warm, 3),
    "build_rows_per_s": round(n / build_warm, 1),
    "opt_warm_s": round(opt_warm, 3),
    "sweeps": SWEEPS,
    "sweeps_per_s": round(SWEEPS / opt_warm, 2),
    "ms_per_sweep": round(1e3 * opt_warm / SWEEPS, 2),
    "build_cold_s": round(build_cold, 2), "opt_cold_s": round(opt_cold, 2),
}))
"""


def main():
    counts = [int(c) for c in (sys.argv[1:] or ["1", "2", "4", "8"])]
    out = []
    for ndev in counts:
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            f" --xla_force_host_platform_device_count={ndev}"
                            ).strip()
        env["_SCALE_NDEV"] = str(ndev)
        env["_SCALE_ROWS"] = str(ROWS_PER_DEV)
        env["JAX_PLATFORMS"] = "cpu"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CHILD], env=env,
                              capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))
        if proc.returncode != 0:
            print(proc.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"child ndev={ndev} failed rc={proc.returncode}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["child_wall_s"] = round(time.perf_counter() - t0, 1)
        out.append(rec)
        print(json.dumps(rec), flush=True)

    # On a shared-core host (this container exposes ONE core) the total
    # compute capacity is constant, so ideal weak scaling shows CONSTANT
    # total throughput (row-sweeps/s, build rows/s) as devices double —
    # any drop is partitioning/collective overhead, the thing multi-chip
    # would pay for real.  eff = throughput / 1-device throughput.
    base = out[0]
    base_rs = base["n"] * base["sweeps"] / base["opt_warm_s"]
    print(f"\n{'ndev':>4} {'n':>8} {'row-sweeps/s':>13} {'eff_opt':>8} "
          f"{'build rows/s':>13} {'eff_build':>9}")
    for r in out:
        rs = r["n"] * r["sweeps"] / r["opt_warm_s"]
        eff_o = rs / base_rs
        eff_b = r["build_rows_per_s"] / base["build_rows_per_s"]
        print(f"{r['n_devices']:>4} {r['n']:>8} {rs:>13.0f} "
              f"{eff_o:>8.2f} {r['build_rows_per_s']:>13} {eff_b:>9.2f}")

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "scaling_r5.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {path}")


if __name__ == "__main__":
    main()
