#!/usr/bin/env python
"""Golden T2 arm: reference physics end-to-end vs this framework.

The oracle (golden/ref_t2_oracle) runs the AS-WRITTEN reference device
loop (cuda_sim.cu:688-746, 772-804, 814-838, 996-1023) on the CPU using
the reference's own compiled scene + octree; this script runs the
framework's production engine on the same *statistical* experiment
(matched num_cells / cell_r / moment / taus / kick / CP schedule,
independent seeds) and tests the two T2 ensembles for equivalence.

The comparison is STATISTICAL by construction: the two sides use
different RNGs (mt19937 vs Threefry) and different scenes per
trial — exactly like comparing two independent batches of reference
runs.  The metric is the normalized magnetization curve
m(t) = sum cos(phi) / W; we report:

  * per-arm trial means and standard errors over the time axis;
  * the time-RMS of the mean-curve difference;
  * that RMS normalized by its own sampling expectation (from the
    combined per-time stderr): ~1 means indistinguishable at this
    ensemble size;
  * the max |z| over time points.

Reduced config (defaults): 1024 walkers x 500k steps (0.5 ms),
pfreq=1000, tcp=125k (4 Carr-Purcell echoes), moment x20 so the curve
decays deeply within the window.  One oracle trial is ~3 min on this
1-core box; use --oracle-trials/--skip-oracle to manage budget.
Oracle CSVs are cached in --work-dir and reused.

Usage:
  python scripts/golden_t2.py --work-dir /tmp/golden_t2 --trials 8
  python scripts/golden_t2.py --work-dir /tmp/golden_t2 --skip-oracle \
      --out GOLDEN_T2.json        # framework arm + report only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden")

# reduced-config knobs shared by both arms.  MSCALE x20 makes the
# 0.5 ms window decay as deeply as the production 40 ms run (B scales
# linearly with the moment; at x6 the curve only lost 4%, giving the
# equivalence test no power)
N_WATER = 1024
STEPS = 500_000
PFREQ = 1000
TCP = 125_000
MSCALE = 20.0


def oracle_csv(work_dir: str, trial: int, d_scale: float = 1.0,
               cell_r: float = 0.0,
               reflect: tuple[float, float] | None = None) -> str:
    tag = "" if d_scale == 1.0 else f"_d{d_scale:g}"
    if cell_r:
        tag += f"_r{cell_r:g}"
    if reflect:
        tag += f"_p{reflect[0]:g}-{reflect[1]:g}"
    return os.path.join(work_dir, f"oracle{tag}_{trial}.csv")


def run_oracle_trials(work_dir: str, n_trials: int,
                      d_scale: float = 1.0, cell_r: float = 0.0,
                      reflect: tuple[float, float] | None = None):
    exe = os.path.join(GOLDEN, "build", "ref_t2_oracle")
    if not os.path.exists(exe):
        subprocess.run(["bash", os.path.join(GOLDEN, "build.sh")],
                       check=True, capture_output=True)
    for t in range(n_trials):
        path = oracle_csv(work_dir, t, d_scale, cell_r, reflect)
        if os.path.exists(path):
            continue
        print(f"[oracle] trial {t} (d_scale={d_scale:g}"
              + (f", cell_r={cell_r:g}" if cell_r else "")
              + (f", reflect={reflect}" if reflect else "") + ") ...",
              file=sys.stderr, flush=True)
        cmd = [exe, str(5000 + t), str(900 + t), path, str(N_WATER),
               str(STEPS), str(PFREQ), str(TCP), str(MSCALE),
               str(d_scale)]
        if cell_r or reflect:
            # 0 = "compiled default" so the reflect args stay reachable
            cmd.append(str(cell_r))
        if reflect:
            cmd += [str(reflect[0]), str(reflect[1])]
        subprocess.run(cmd, check=True, capture_output=True)


def load_oracle(work_dir: str, d_scale: float = 1.0,
                cell_r: float = 0.0,
                reflect: tuple[float, float] | None = None):
    curves = []
    t = 0
    while os.path.exists(oracle_csv(work_dir, t, d_scale, cell_r, reflect)):
        d = np.loadtxt(oracle_csv(work_dir, t, d_scale, cell_r, reflect),
                       delimiter=",")
        curves.append(d[:, 1] / N_WATER)
        t += 1
    if not curves:
        raise SystemExit("no oracle CSVs found; run without --skip-oracle")
    return np.asarray(curves), np.loadtxt(
        oracle_csv(work_dir, 0, d_scale, cell_r, reflect),
        delimiter=",")[:, 0]


def run_framework_trials(n_trials: int, d_scale: float = 1.0,
                         cell_r: float = 0.0,
                         reflect: tuple[float, float] | None = None):
    """Production engine (the chunk kernel; needs a GPU), matched
    params: as-written kick + cube direction + per-window CP schedule —
    the reference-physics compatibility mode."""
    from mri_nanoparticle_simulation_tpu import params as P
    from mri_nanoparticle_simulation_tpu.parallel import ensemble
    p = P.DEFAULT.replace(
        num_water=N_WATER,
        totaltime=STEPS * P.DEFAULT.tau,         # 0.5 ms
        sprint_steps=STEPS,
        chunk_steps=4000,
        print_interval=PFREQ * P.DEFAULT.tau,
        taucp=TCP * P.DEFAULT.tau,
        mmoment=P.DEFAULT.mmoment * MSCALE,
        near_k=10,
        # membrane bounce probabilities: static trace-time constants —
        # every trial in the arm shares them, so no launch scalar needed
        reflect_io=reflect[0] if reflect else 0.0,
        reflect_oi=reflect[1] if reflect else 0.0,
    ).validate()
    _, cos, _, _ = ensemble.run_ensemble(
        p, n_trials=n_trials, base_seed=7000, run_seed=8000,
        engine="pallas",
        d_scales=None if d_scale == 1.0 else [d_scale] * n_trials,
        # fixed geometry + runtime residency radius: the launch-scalar
        # semantics inverse.fit_cell_radius_crn rides (the oracle
        # overrides its kernel-side radius the same way)
        run_cell_rs=None if not cell_r else [cell_r] * n_trials)
    return np.asarray(cos)[:, :] / N_WATER


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--work-dir", default="/tmp/golden_t2")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--skip-oracle", action="store_true",
                    help="reuse cached oracle CSVs only")
    ap.add_argument("--out", default=None,
                    help="report path; default GOLDEN_T2.json, or "
                         "GOLDEN_T2_dD.json for --d-scale != 1 so the "
                         "d=1 baseline is never silently overwritten")
    ap.add_argument("--cell-r", type=float, default=0.0,
                    help="runtime residency radius (um) applied to BOTH "
                         "arms on geometry built at the default radius: "
                         "the oracle shadows its static-const cell_r "
                         "after the scene build, the framework rides "
                         "its cell_r launch scalar (run_cell_rs) — the "
                         "reference-physics equivalence arm for the "
                         "cell-size axis")
    ap.add_argument("--d-scale", type=float, default=1.0,
                    help="diffusion scale applied to BOTH arms: the "
                         "oracle scales the reference's derived stdevs "
                         "by sqrt(d), the framework rides its d_scale "
                         "launch scalar — the reference-physics "
                         "equivalence arm for the runtime D axis")
    ap.add_argument("--reflect", default=None, metavar="RIO,ROI",
                    help="membrane bounce probabilities applied to BOTH "
                         "arms (cell_reflect, cuda_sim.cu:502-509 — the "
                         "reference ships reflectIO=reflectOI=0, "
                         "parameters.h:116-117, so this branch has never "
                         "had a reference-physics measurement): the "
                         "oracle overrides its ParameterStruct copy, the "
                         "framework sets params.reflect_io/oi — the "
                         "equivalence arm for the permeability physics. "
                         "Asymmetric values (e.g. 0.9,0.3) shift the "
                         "intracellular occupancy, so a swapped or "
                         "mis-gated branch shows as a curve shift")
    args = ap.parse_args()
    reflect = None
    if args.reflect:
        rio, roi = (float(v) for v in args.reflect.split(","))
        if not (0 <= rio <= 1 and 0 <= roi <= 1):
            raise SystemExit("--reflect values must be in [0, 1]")
        reflect = (rio, roi)
    if args.out is None:
        # tags combine (like the oracle CSV names) so a mixed-axis run
        # never overwrites a single-axis baseline
        tag = "" if args.d_scale == 1.0 else f"_d{args.d_scale:g}"
        if args.cell_r:
            tag += f"_r{args.cell_r:g}"
        if reflect:
            tag += f"_p{reflect[0]:g}-{reflect[1]:g}"
        args.out = f"GOLDEN_T2{tag}.json"
    os.makedirs(args.work_dir, exist_ok=True)

    if not args.skip_oracle:
        run_oracle_trials(args.work_dir, args.trials, args.d_scale,
                          args.cell_r, reflect)
    oracle, times = load_oracle(args.work_dir, args.d_scale, args.cell_r,
                                reflect)
    print(f"[framework] {args.trials} trials ...", file=sys.stderr)
    ours = run_framework_trials(args.trials, args.d_scale, args.cell_r,
                                reflect)
    n = min(oracle.shape[1], ours.shape[1])
    oracle, ours = oracle[:, :n], ours[:, :n]

    mo, so = oracle.mean(0), oracle.std(0, ddof=1) / np.sqrt(len(oracle))
    mu, su = ours.mean(0), ours.std(0, ddof=1) / np.sqrt(len(ours))
    diff = mo - mu
    se = np.sqrt(so ** 2 + su ** 2)
    z = diff / np.maximum(se, 1e-12)
    rms = float(np.sqrt(np.mean(diff ** 2)))
    # expected RMS under H0 (difference is pure sampling noise):
    # E[diff_t^2] = se_t^2, so E[RMS^2] = mean(se^2)
    rms_expected = float(np.sqrt(np.mean(se ** 2)))
    report = {
        "config": {"n_water": N_WATER, "steps": STEPS, "pfreq": PFREQ,
                   "tcp": TCP, "moment_scale": MSCALE,
                   "d_scale": args.d_scale,
                   "cell_r_run": args.cell_r or None,
                   "reflect_io_oi": list(reflect) if reflect else None,
                   "oracle_trials": int(len(oracle)),
                   "framework_trials": int(len(ours))},
        "oracle_final_mean": float(mo[-1]),
        "framework_final_mean": float(mu[-1]),
        "oracle_final_stderr": float(so[-1]),
        "framework_final_stderr": float(su[-1]),
        "rms_diff": rms,
        "rms_expected_under_h0": rms_expected,
        "rms_ratio": float(rms / rms_expected),
        "max_abs_z": float(np.abs(z).max()),
        "mean_abs_z": float(np.abs(z).mean()),
        "curve_decay_span": float(1.0 - min(mo.min(), mu.min())),
        "times_ms": [float(times[0]), float(times[n - 1])],
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
