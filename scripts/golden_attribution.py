#!/usr/bin/env python
"""Attribution of the FULL-scale golden T2 residual (round 4).

GOLDEN_T2_FULL.json (4032 walkers x 2e6 steps, moment x60, decay to
~0.32) resolves a systematic oracle-framework difference: rms 2.2x the
paired-noise envelope, oracle decaying FASTER long-term and SLOWER
before the first echo.  This script pins down the cause with two
independent experiments:

1. **Framework side converged** — the scan engine runs the identical
   Threefry streams under FIELD_EXPANSION and FIELD_EXACT.  Trajectories
   are field-independent, so with common streams the two curves differ
   ONLY by the chunked-expansion field error: measured rms 3.5e-4
   (final -4.8e-5) — 30x below the observed residual.  Our field model
   is not the cause.

2. **Oracle octree error is the cause** — ref_t2_oracle re-run under
   the SAME walker streams as the committed coarse runs at three
   field-accuracy rungs (round 5): GOLDEN_MAX_PRODUCT=5e-7 and 2.5e-7
   (4x/8x tighter leaf criterion than the reference's compiled 2e-6,
   SimulationBox.cpp:86 / octree.cpp:267; the 10x build of round 4 was
   not feasible on this box's single CPU — build cost is superlinear:
   0.5 s at 2e-6, 52 s at 5e-7, 9.4 min at 2.5e-7), plus the EXACT
   endpoint: GOLDEN_EXACT_FIELD=1 evaluates the brute-force masked
   dipole sum over all MNPs (the max_product -> 0 limit of the octree,
   GPU convention cuda_sim.cu:107-114) on a stride-4 walker subset
   (GOLDEN_WALKER_STRIDE keeps each walker's stream and source water,
   so the strided pair is zero-noise too).  The oracle's curve moves
   monotonically toward the framework as its field improves, and the
   exact endpoint lands on it.

Physics: the octree caches B at leaf sub-octant centers (octree.cpp:
274-297).  The cached value UNDERSTATES the true static field spread
(smoothing -> less inhomogeneous dephasing before the first echo, so
the coarse oracle sits HIGH early), while walkers crossing leaf
boundaries see artificial field jumps (un-refocusable random phase ->
extra long-term decay, so the coarse oracle sits LOW late).  Both signs
match GOLDEN_T2_FULL_curves.npz.  At the round-3 reduced scale
(moment x20, 0.5 ms) this effect is ~36x smaller in accumulated
variance — exactly why GOLDEN_T2.json sat at 0.30x H0 while the
production-scale arm resolves it.

Usage:
  python scripts/golden_attribution.py            # needs a GPU + oracle CSVs
  python scripts/golden_attribution.py --skip-framework
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import golden_paired as gp  # noqa: E402


def same_stream_field_error(seed: int = 6000, rng_seed: int = 4242):
    """Experiment 1: scan engine, identical Threefry streams, expansion
    vs exact field.  Returns (rms, final_diff, max_abs)."""
    import jax.numpy as jnp

    from mri_nanoparticle_simulation_tpu import rng
    from mri_nanoparticle_simulation_tpu.engine import \
        reference_engine as re
    from mri_nanoparticle_simulation_tpu.params import (FIELD_EXACT,
                                                        FIELD_EXPANSION)

    args = argparse.Namespace(steps=gp.STEPS, tcp=gp.TCP,
                              mscale=gp.MSCALE, fw_reps=1, reflect=None,
                              kick="aswritten", gradient=0.0)
    base_p = gp.framework_params(args)
    d = gp.dump_dir(os.path.join(gp.GOLDEN, "work"), seed)
    curves = {}
    for mode in (FIELD_EXPANSION, FIELD_EXACT):
        p = base_p.replace(field_mode=mode).validate()
        scene = gp.load_scene(d, p)
        scene.mnps[:, 4] *= gp.MSCALE
        mnp_pos = jnp.asarray(scene.mnps[:, :3], jnp.float32)
        mnp_M = jnp.asarray(scene.mnps[:, 4], jnp.float32)
        k = rng.key_from_seed(rng_seed)
        key = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
        st = re.init_state(scene.waters, p, jnp.float32)
        sprint = re.make_sprint_fn(p, jnp.float32)
        outs = []
        t0 = time.time()
        for _ in range(gp.STEPS // p.sprint_steps):
            st, wins = sprint(mnp_pos, mnp_M, key, st, 0)
            outs.append(np.asarray(wins[:, 0]))
        curves[mode] = np.concatenate(outs) / gp.N_WATER
        print(f"[fw] {mode}: {time.time() - t0:.0f}s", file=sys.stderr,
              flush=True)
    diff = curves[FIELD_EXPANSION] - curves[FIELD_EXACT]
    return (float(np.sqrt(np.mean(diff ** 2))), float(diff[-1]),
            float(np.abs(diff).max()))


def _curve(path: str, n_walkers: int):
    return np.loadtxt(path, delimiter=",")[:, 1] / n_walkers


def _delta(a, b):
    n = min(len(a), len(b))
    d = a[:n] - b[:n]
    return {"rms": float(np.sqrt(np.mean(d ** 2))),
            "final": float(d[n - 1]),
            "max_abs": float(np.abs(d).max()),
            # the residual's attributed time signature (same windows as
            # tests/test_golden_full.py): pre-first-echo and 1.5-2 ms
            "early250_mean": float(d[:250].mean()),
            "late500_mean": float(d[-500:].mean())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-framework", action="store_true")
    ap.add_argument("--tights", nargs="*", default=["5e-7", "2.5e-7"],
                    help="GOLDEN_MAX_PRODUCT values with committed "
                         "paired_tight<t>_<seed>.csv runs")
    ap.add_argument("--seeds", type=int, nargs="*",
                    default=[6000, 6001, 6002, 6003])
    ap.add_argument("--out", default="GOLDEN_T2_FULL_ATTRIBUTION.json")
    args = ap.parse_args()
    work = os.path.join(gp.GOLDEN, "work")

    report = {"residual_under_attribution": {
        "source": "GOLDEN_T2_FULL.json",
        "rms_diff": 0.0108, "final_diff": -0.020,
        "rms_ratio_vs_h0": 2.24}}

    if args.skip_framework:
        # keep a previously measured experiment-1 block if present
        if os.path.exists(args.out):
            with open(args.out) as f:
                prev = json.load(f)
            if "framework_field_error_same_streams" in prev:
                report["framework_field_error_same_streams"] = \
                    prev["framework_field_error_same_streams"]
    else:
        rms, fin, mx = same_stream_field_error()
        report["framework_field_error_same_streams"] = {
            "design": "scan engine, IDENTICAL Threefry streams "
                      "(trajectories are field-independent) -> curve "
                      "difference isolates the chunked-expansion field "
                      "error with zero walker noise",
            "rms": rms, "final_diff": fin, "max_abs": mx,
            "verdict": "framework field model contributes "
                       f"{rms:.1e} rms — negligible vs the residual"}

    # Experiment 2 (the decisive one): the oracle's
    # own curve as its field improves, under the SAME walker streams as
    # the committed coarse runs.  Trajectories are field-independent,
    # so every delta below has ZERO walker noise.  Three field-accuracy
    # rungs: GOLDEN_MAX_PRODUCT 5e-7 and 2.5e-7 (4x / 8x tighter leaf
    # criterion than the compiled 2e-6, octree.cpp:267 /
    # SimulationBox.cpp:86) at the full 4032 walkers, plus the exact
    # brute-force endpoint (GOLDEN_EXACT_FIELD=1 — the max_product->0
    # limit) on a strict stride-4 walker subset (GOLDEN_WALKER_STRIDE,
    # same per-walker streams) paired against its own strided coarse
    # partner.
    fwz = np.load("GOLDEN_T2_FULL_curves.npz")
    per_seed = {}
    for s in args.seeds:
        cp = os.path.join(work, f"paired_{s}.csv")
        if not os.path.exists(cp):
            continue
        co = _curve(cp, gp.N_WATER)
        fw = fwz["framework"][s - gp.SCENE_SEED0]
        entry = {"coarse_minus_fw": _delta(co, fw)}
        for t in args.tights:
            tp = os.path.join(work, f"paired_tight{t}_{s}.csv")
            if not os.path.exists(tp):
                continue
            to = _curve(tp, gp.N_WATER)
            entry[f"tight{t}_minus_coarse"] = _delta(to, co)
            entry[f"tight{t}_minus_fw"] = _delta(to, fw)
        xp = os.path.join(work, f"paired_exact-str4_{s}.csv")
        cs = os.path.join(work, f"paired_coarse-str4_{s}.csv")
        if os.path.exists(xp) and os.path.exists(cs):
            ex = _curve(xp, 1008)
            c4 = _curve(cs, 1008)
            entry["exact_minus_coarse_str4"] = _delta(ex, c4)
            # subset representativeness: how far the stride-4 coarse
            # curve sits from the full-4032 coarse curve (walker-subset
            # noise of a CURVE; the zero-noise DELTA above is far more
            # stable than this, but report the bound honestly)
            entry["coarse_str4_minus_coarse_full"] = _delta(c4, co)
        if len(entry) > 1:
            per_seed[str(s)] = entry

    # Monotonicity + closure: does the oracle move toward the framework
    # as its octree tightens, and does the exact endpoint land on it?
    concl = {}
    s0 = per_seed.get("6000", {})
    if "tight5e-7_minus_coarse" in s0:
        seq = [("coarse", s0["coarse_minus_fw"]["rms"])]
        for t in args.tights:
            k = f"tight{t}_minus_fw"
            if k in s0:
                seq.append((f"max_product={t}", s0[k]["rms"]))
        concl["oracle_minus_fw_rms_by_field_accuracy_seed6000"] = seq
        concl["monotone_toward_framework"] = all(
            seq[i][1] > seq[i + 1][1] for i in range(len(seq) - 1))
    endpoint = {}
    for sid, e in per_seed.items():
        if "exact_minus_coarse_str4" not in e:
            continue
        ex, cf = e["exact_minus_coarse_str4"], e["coarse_minus_fw"]
        endpoint[sid] = {
            # the LATE WINDOW (1.5-2 ms mean, the residual's dominant
            # attributed signature) is the calibrated comparison — the
            # final POINT carries ~0.02 walker noise on the residual
            # side and is reported only as a diagnostic
            "explained_fraction_of_residual_late_window":
                ex["late500_mean"] / -cf["late500_mean"]
                if cf["late500_mean"] else None,
            "explained_fraction_of_residual_final":
                ex["final"] / -cf["final"] if cf["final"] else None,
            "rms_exact_minus_coarse": ex["rms"],
            "rms_residual": cf["rms"],
        }
    if endpoint:
        endpoint["note"] = (
            "exact_minus_coarse (zero-noise) vs -(coarse_minus_fw): "
            "1.0 = the reference octree's field error accounts for the "
            "entire residual")
        concl["exact_endpoint"] = endpoint
    report["oracle_octree_tightening"] = {
        "design": "graduated GOLDEN_MAX_PRODUCT {5e-7, 2.5e-7} re-runs "
                  "at 4032 walkers + exact brute-force endpoint "
                  "(GOLDEN_EXACT_FIELD=1, stride-4 walker subset with "
                  "its own strided coarse partner), ALL under the same "
                  "per-walker streams as the committed coarse runs -> "
                  "every delta is zero-walker-noise",
        "per_seed": per_seed,
        "conclusion": concl}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
