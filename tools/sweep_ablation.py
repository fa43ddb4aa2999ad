#!/usr/bin/env python
"""Per-sweep component ablation at the 11M Higgs operating shape.

The 11M large-phase optimize wall is ~0.28 s/sweep (PERF.md round-4
table) and the roofline notes blame "the gather floor" — but no
measurement has DECOMPOSED a sweep into its parts at the real shape.
This tool times, on the device, at (n, k, d) = (11M, 6, 2):

  * the transposed attraction sweep alone (one kg=3 column group):
    the (kg, n) neighbour gather + closed-form closure
  * the rolled repulsion alone (n_neg=5): sequential kicks,
    parallel (stacked) kicks, exclusion on/off
  * the neighbour-rejection mask alone
  * full _dense_segment sweeps under lax.scan with each shippable
    flag combination (baseline / exclusion off / parallel kicks /
    both) — the numbers that decide the 11M recipe flags.

Each timing: one warm execution, then median of 3 steady reps,
block_until_ready.  Emits one JSON line per row; artifact written by
the caller redirect.
"""

import argparse
import functools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def emit(row):
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=11_000_000)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--n-neg", type=int, default=5,
                    help="kicks per sweep (n_sub=60 phase value)")
    ap.add_argument("--sweeps", type=int, default=24,
                    help="scan steps per full-sweep timing (24 = LCM "
                         "of the gather_reuse block sizes 4/8/12, so "
                         "every reuse row amortizes exactly)")
    args = ap.parse_args()

    from annembed_tpu.optim import dense as D

    n, k, n_neg = args.n, args.k, args.n_neg
    kg = k // 2                     # n_groups = 2 production default
    rng = np.random.default_rng(0)

    emit({"bench": "sweep_ablation", "n": n, "k": k, "kg": kg,
          "n_neg": n_neg, "backend": jax.default_backend()})

    yT = jnp.asarray(rng.normal(0, 2, (2, n)), jnp.float32)
    idxT = jnp.asarray(rng.integers(0, n, (kg, n)), jnp.int32)
    idxT_full = jnp.asarray(rng.integers(0, n, (k, n)), jnp.int32)
    wT = jnp.asarray(rng.uniform(0.05, 0.4, (kg, n)), jnp.float32)
    mT = jnp.asarray(rng.uniform(0.5, 3.0, (kg, n)), jnp.float32)
    w_revT = jnp.asarray(
        rng.uniform(0, 0.4, (kg, n)) * (rng.random((kg, n)) < 0.5),
        jnp.float32)
    m_revT = w_revT * 10.0
    scale_iT = jnp.asarray(rng.uniform(0.1, 0.3, (1, n)), jnp.float32)
    scale_jT = jnp.asarray(rng.uniform(0.1, 0.3, (kg, n)), jnp.float32)
    gamma = jnp.float32(1.0)

    # --- attraction alone (one column group) ---
    # NB: every big array is an EXPLICIT jit argument — a closed-over
    # device array would be baked into the program as a constant.
    att = jax.jit(lambda y, ix, w, m, wr, mr, si, sj:
                  D._attraction_sweep_sfT(y, ix, w, m, wr, mr, si, sj,
                                          gamma, 1.0))
    emit({"op": "attraction_sfT_1group",
          "wall_s": timed(att, yT, idxT, wT, mT, w_revT, m_revT,
                          scale_iT, scale_jT)})

    # attraction minus the gather: neighbour block replaced by a roll
    # (same math, contiguous read) — isolates the gather's share
    def att_nogather(y, wT, w_revT, mT, m_revT, scale_iT, scale_jT):
        yj = jnp.stack([jnp.roll(y, -(i + 1) * 13, axis=1)
                        for i in range(kg)], axis=1)      # (d, kg, n)
        diff = yj - y[:, None, :]
        d2 = jnp.sum(jnp.square(diff), 0)
        a_f = D._clipped_alpha(d2 / jnp.square(scale_iT), scale_iT, wT,
                               gamma, 1.0)
        a_r = D._clipped_alpha(d2 / jnp.square(scale_jT), scale_jT,
                               w_revT, gamma, 1.0)
        f = jnp.exp(mT * jnp.log(jnp.clip(1.0 - 2.0 * a_f, 1e-3, 1.05))
                    + m_revT * jnp.log(jnp.clip(1.0 - 2.0 * a_r, 1e-3,
                                                1.05)))
        f = jnp.maximum(f, 1e-3)
        c = jnp.where(w_revT > 0.0, 0.5, 1.0)
        return jnp.sum(diff * (c * (1.0 - f))[None], axis=1)

    emit({"op": "attraction_roll_nogather",
          "wall_s": timed(jax.jit(att_nogather), yT, wT, w_revT, mT,
                          m_revT, scale_iT, scale_jT)})

    # --- the gather itself, pair vs packed-complex64 (bit-exact) ---
    # round-5 ablation: the (d, kg, n) neighbour gather is ~65% of the
    # 11M sweep (0.185 of 0.285 s); packing d=2 into one c64 lane
    # halves the gathered element count (dense_packed_gather knob,
    # off-until-measured) — these rows decide it.
    gather_pair = jax.jit(lambda y, ix: y[:, ix])
    emit({"op": "gather_pair_f32",
          "wall_s": timed(gather_pair, yT, idxT)})
    yz = jax.jit(lambda y: jax.lax.complex(y[0], y[1]))(yT)  # (n,) c64
    gather_packed = jax.jit(lambda z, ix: z[ix])
    emit({"op": "gather_packed_c64",
          "wall_s": timed(gather_packed, yz, idxT)})
    att_packed = jax.jit(lambda y, z, ix, w, m, wr, mr, si, sj:
                         D._attraction_sweep_sfT(y, ix, w, m, wr, mr,
                                                 si, sj, gamma, 1.0,
                                                 yzT=z))
    emit({"op": "attraction_sfT_packed",
          "wall_s": timed(att_packed, yT, yz, idxT, wT, mT, w_revT,
                          m_revT, scale_iT, scale_jT)})

    # --- repulsion alone ---
    for pk in (False, True):
        for excl in (True, False):
            rep = jax.jit(functools.partial(
                D._repulsion_sweep_rolledT, gamma=gamma, b=1.0,
                n_neg=n_neg, neighbor_exclusion=excl,
                parallel_kicks=pk))
            emit({"op": "repulsion_rolledT", "parallel_kicks": pk,
                  "exclusion": excl,
                  "wall_s": timed(rep, yT, jnp.int32(37), idxT_full,
                                  scale_iT)})

    # rejection mask alone
    pos = jnp.arange(n, dtype=jnp.int32)
    shifts = (jnp.int32(37) + (n // n_neg)
              * jnp.arange(n_neg, dtype=jnp.int32)) % n
    rej = jax.jit(functools.partial(D._neighbor_rejection,
                                    n=n, n_neg=n_neg))
    emit({"op": "neighbor_rejection_mask",
          "wall_s": timed(rej, pos, idxT_full, shifts)})

    # --- full sweeps under scan: the shippable flag matrix ---
    y0 = yT.T
    key = jax.random.PRNGKey(0)
    for label, kw in (
        ("baseline", {}),
        ("exclusion_off", {"neighbor_exclusion": False}),
        ("parallel_kicks", {"parallel_kicks": True}),
        ("both", {"neighbor_exclusion": False, "parallel_kicks": True}),
        ("packed_gather", {"packed_gather": True}),
        # stale-gather lever: one neighbour gather per S sweeps (the
        # gather is 65% of the sweep; predicted s/sweep ~ 0.185/S+0.10)
        ("gather_reuse_4", {"gather_reuse": 4}),
        ("gather_reuse_8", {"gather_reuse": 8}),
        ("gather_reuse_12", {"gather_reuse": 12}),
        ("gather_reuse_8_excl_off", {"gather_reuse": 8,
                                     "neighbor_exclusion": False}),
    ):
        def run(y0=y0, kw=kw):
            return D._dense_segment(
                y0, idxT_full.T, jnp.tile(wT, (2, 1)).T[:, :k],
                jnp.tile(mT, (2, 1)).T[:, :k],
                jnp.tile(w_revT, (2, 1)).T[:, :k],
                jnp.tile(m_revT, (2, 1)).T[:, :k],
                scale_iT[0], key, None,
                grad_step_init=2.0, b=1.0, n_sub=60, n_neg=n_neg,
                nb_grad_batch=60, n_groups=2, scatter_free=True,
                step0=jnp.int32(0), seg_steps=args.sweeps,
                rot0=jnp.int32(0), **kw)
        w = timed(run, reps=2)
        emit({"op": "full_sweep_scan", "config": label,
              "sweeps": args.sweeps, "wall_s": w,
              "s_per_sweep": w / args.sweeps})


if __name__ == "__main__":
    main()
