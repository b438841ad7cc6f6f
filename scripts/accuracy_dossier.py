"""Generate the full-length accuracy dossier (ACCURACY.md data).

Runs the four certification arms, each over
the FULL 4e7-step time axis (the non-negotiable part — phase drift is
what is being certified):

  A. precision drift: scan engine, f32 trajectories, f32-Kahan phase vs
     f64 phase on BITWISE-IDENTICAL trajectories (phase never feeds back
     into positions) — isolates accumulation error exactly.
  B. production engine vs scan engine: the chunk kernel vs the scan
     engine, f32, same scene and the same Threefry streams — the two
     engines integrate the same trajectories, so the curves agree to f32
     summation order.
  C. (retired) a second in-kernel RNG against Threefry; the engines now
     draw from Threefry only, so this arm no longer runs.  Its recorded
     numbers stay in ACCURACY_DATA.json as history.
  D. field backends: expansion vs grid vs exact in the scan engine on
     the same threefry streams — near-identical trajectories, so
     differences measure the field-model error directly, plus the
     direct expansion-vs-grid cross check.  The exact brute-force
     oracle is HBM-bound at [W, N] per step and the grid engine pays
     per-step gathers, so this arm runs 1/10 of the axis (a full-axis
     grid run is ~5000 s for no additional information).

Writes dossier JSON to ACCURACY_DATA.json, incrementally after each arm
(a killed run keeps its finished arms); ACCURACY.md is the human
summary (maintained by hand from these numbers).

Run on a GPU:  python -u scripts/accuracy_dossier.py [--quick]
(--quick cuts the time axis 10x for a smoke run.)
"""

import argparse
import json
import sys
import time

import numpy as np


def _write(results, out):
    """Write after every arm: a killed run keeps its finished arms."""
    with open(out, "w") as f:
        json.dump(results, f, indent=1)


def stats_vs(a, b, w):
    """Curve-difference stats, normalized per walker."""
    a = np.asarray(a, np.float64) / w
    b = np.asarray(b, np.float64) / w
    d = a - b
    return {
        "rms": float(np.sqrt((d ** 2).mean())),
        "max": float(np.abs(d).max()),
        "rms_signal": float(np.sqrt((a ** 2).mean())),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="ACCURACY_DATA.json")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from mri_nanoparticle_simulation_tpu.engine import (pallas_engine,
                                                        reference_engine)
    from mri_nanoparticle_simulation_tpu.params import Params
    from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
    from mri_nanoparticle_simulation_tpu.utils.cache import \
        enable_compile_cache
    enable_compile_cache()
    np.asarray(jnp.zeros(16))  # warm the backend

    totaltime = 4.0 if args.quick else 40.0
    results = {"totaltime_ms": totaltime, "config": {}}

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    # ---- arm A: Kahan f32 vs f64 phase, identical trajectories ----------
    # 4032 walkers: small populations underutilize the VPU ~10x in the
    # scan engine, and more walkers = tighter statistics anyway
    pA = Params(num_water=4032, totaltime=totaltime, chunk_steps=1000,
                near_k=5, sprint_steps=20000, scan_unroll=16).validate()
    scA = BacteriaBox(pA, seed=42).populate()
    t0 = time.time()
    _, c32, s32, st32 = reference_engine.run_simulation(
        scA, pA, seed=7, dtype=jnp.float32)
    log(f"A1 scan f32-Kahan done in {time.time()-t0:.0f}s")
    t0 = time.time()
    _, c64, s64, st64 = reference_engine.run_simulation(
        scA, pA, seed=7, dtype=jnp.float32, phase_dtype=jnp.float64)
    log(f"A2 scan f64-phase done in {time.time()-t0:.0f}s")
    assert np.array_equal(np.asarray(st32.pos), np.asarray(st64.pos)), \
        "trajectories must be bitwise identical"
    results["A_kahan_vs_f64_phase"] = {
        **stats_vs(c32, c64, pA.num_water),
        "max_phase_err_rad": float(np.abs(
            np.asarray(st32.phase, np.float64)
            - np.asarray(st64.phase)).max()),
        "walkers": pA.num_water,
    }
    log("A:", results["A_kahan_vs_f64_phase"])
    _write(results, args.out)

    # ---- arm B: production chunk kernel vs scan engine -----------------
    # x64 off again: the kernel is f32-only, and weak-typed python
    # floats would otherwise promote its planes to f64 inside the trace
    jax.config.update("jax_enable_x64", False)
    pB = Params(num_water=4032, totaltime=totaltime, chunk_steps=4000,
                near_k=5, sprint_steps=20000, cube_candidates=16).validate()
    scB = BacteriaBox(pB, seed=42).populate()
    t0 = time.time()
    _, c_tf, _, _ = pallas_engine.run_simulation(scB, pB, seed=7)
    log(f"B1 kernel done in {time.time()-t0:.0f}s")
    t0 = time.time()
    pB_scan = pB.replace(chunk_steps=1000, scan_unroll=16)
    _, c_scan, _, _ = reference_engine.run_simulation(
        scB, pB_scan, seed=7, dtype=jnp.float32)
    log(f"B2 scan done in {time.time()-t0:.0f}s")
    results["B2_pallas_tf_vs_scan_tf_same_streams"] = \
        stats_vs(c_tf, c_scan, pB.num_water)
    log("B (same streams):", results["B2_pallas_tf_vs_scan_tf_same_streams"])
    _write(results, args.out)

    # ---- arm D: field backends vs the exact oracle (1/10 axis) ----------
    pD = Params(num_water=512, totaltime=totaltime, chunk_steps=1000,
                near_k=5, sprint_steps=20000, scan_unroll=16).validate()
    scD = BacteriaBox(pD, seed=42).populate()
    d_steps = pD.t // 10
    t0 = time.time()
    _, c_exp, _, _ = reference_engine.run_simulation(
        scD, pD, seed=7, dtype=jnp.float32, max_steps=d_steps)
    log(f"D1 expansion done in {time.time()-t0:.0f}s")
    t0 = time.time()
    _, c_grid, _, _ = reference_engine.run_simulation(
        scD, pD.replace(field_mode="grid", grid_n=96), seed=7,
        dtype=jnp.float32, max_steps=d_steps)
    log(f"D2 grid done in {time.time()-t0:.0f}s")
    t0 = time.time()
    _, c_exact, _, _ = reference_engine.run_simulation(
        scD, pD.replace(field_mode="exact"), seed=7, dtype=jnp.float32,
        max_steps=d_steps)
    log(f"D3 exact done in {time.time()-t0:.0f}s")
    results["D_expansion_vs_exact"] = stats_vs(c_exp, c_exact, pD.num_water)
    results["D_grid_vs_exact"] = stats_vs(c_grid, c_exact, pD.num_water)
    results["D_expansion_vs_grid"] = stats_vs(c_exp, c_grid, pD.num_water)
    results["D_steps"] = d_steps
    log("D exp vs exact:", results["D_expansion_vs_exact"])
    log("D grid vs exact:", results["D_grid_vs_exact"])
    log("D exp vs grid:", results["D_expansion_vs_grid"])
    _write(results, args.out)

    _write(results, args.out)
    log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
