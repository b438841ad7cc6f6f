#!/usr/bin/env python
"""Golden echo-axis arm: the (taucp) reconstruction vs reference physics.

The framework's decomposition record claims that ONE simulation at a
base Carr-Purcell spacing reconstructs the curve at ANY aligned echo
spacing exactly (engine/decompose.curves_at_plane: flips are +-1
bookkeeping on window prefix sums).  This arm tests that claim against
the reference's own physics end-to-end:

  * oracle arm: golden/ref_t2_oracle (the as-written device loop,
    cuda_sim.cu:688-746, 772-804, 814-838, 996-1023, on the reference's
    compiled scene + octree + xoroshiro128+) run DIRECTLY at tcp2 —
    reference physics at the target echo spacing;
  * framework arm: production-engine decomposition runs at the BASE
    tcp (125k, the GOLDEN_T2 schedule), each reconstructed at tcp2 in
    closed form — the target spacing is never simulated on our side.

Statistical comparison identical to scripts/golden_t2.py (independent
seeds and scenes per trial; the metric is the normalized curve
m(t) = sum cos(phi)/W; RMS of the mean-curve difference normalized by
its sampling expectation under H0, and max |z|).

Usage:
  python scripts/golden_echo.py --work-dir /tmp/golden_echo --trials 8
  python scripts/golden_echo.py --skip-oracle --out GOLDEN_ECHO.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import golden_t2 as G  # noqa: E402  (shared reduced-config knobs)

TCP2 = 50_000          # target echo spacing: 10 echoes in 500k steps,
                       # aligned to pfreq=1000 (the reconstruction's
                       # output-interval requirement); the base run
                       # keeps G.TCP = 125k — a DIFFERENT schedule


def oracle_csv(work_dir: str, trial: int) -> str:
    return os.path.join(work_dir, f"oracle_tcp{TCP2}_{trial}.csv")


def run_oracle_trials(work_dir: str, n_trials: int) -> None:
    exe = os.path.join(G.GOLDEN, "build", "ref_t2_oracle")
    if not os.path.exists(exe):
        subprocess.run(["bash", os.path.join(G.GOLDEN, "build.sh")],
                       check=True, capture_output=True)
    for t in range(n_trials):
        path = oracle_csv(work_dir, t)
        if os.path.exists(path):
            continue
        print(f"[oracle] trial {t} (tcp={TCP2}) ...", file=sys.stderr,
              flush=True)
        subprocess.run(
            [exe, str(5000 + t), str(900 + t), path, str(G.N_WATER),
             str(G.STEPS), str(G.PFREQ), str(TCP2), str(G.MSCALE), "1.0"],
            check=True, capture_output=True)


def load_oracle(work_dir: str):
    curves, t = [], 0
    while os.path.exists(oracle_csv(work_dir, t)):
        d = np.loadtxt(oracle_csv(work_dir, t), delimiter=",")
        curves.append(d[:, 1] / G.N_WATER)
        t += 1
    if not curves:
        raise SystemExit("no oracle CSVs found; run without --skip-oracle")
    return np.asarray(curves), np.loadtxt(
        oracle_csv(work_dir, 0), delimiter=",")[:, 0]


def run_framework_trials(n_trials: int):
    """Decomposition runs at the BASE schedule (G.TCP), reconstructed at
    TCP2 — the echo axis from records that never simulated it."""
    from mri_nanoparticle_simulation_tpu import params as P
    from mri_nanoparticle_simulation_tpu.engine import decompose as dec
    from mri_nanoparticle_simulation_tpu.engine.pallas_engine import \
        choose_engine
    from mri_nanoparticle_simulation_tpu.scene import BacteriaBox

    engine = choose_engine(anywhere=True)
    import jax
    print(f"[framework] {engine} engine on {jax.devices()[0].platform}",
          file=sys.stderr)
    p = P.DEFAULT.replace(
        num_water=G.N_WATER,
        totaltime=G.STEPS * P.DEFAULT.tau,
        sprint_steps=G.STEPS,
        chunk_steps=4000,
        print_interval=G.PFREQ * P.DEFAULT.tau,
        taucp=G.TCP * P.DEFAULT.tau,          # BASE schedule
        mmoment=P.DEFAULT.mmoment * G.MSCALE,
        near_k=10,
    ).validate()
    taucp2 = TCP2 * P.DEFAULT.tau
    curves = []
    for t in range(n_trials):
        print(f"[framework] decomposition trial {t} ...", file=sys.stderr,
              flush=True)
        sc = BacteriaBox(p, seed=7000 + t).populate()
        rec = dec.run_decomposition(
            sc, p, seed=8000 + t, engine=engine)
        curves.append(dec.curves_at_plane(rec.A, rec.B, [1.0], [taucp2],
                                          p)[0, 0])
    return np.asarray(curves)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--work-dir", default="/tmp/golden_echo")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--out", default="GOLDEN_ECHO.json")
    args = ap.parse_args()
    os.makedirs(args.work_dir, exist_ok=True)

    if not args.skip_oracle:
        run_oracle_trials(args.work_dir, args.trials)
    oracle, times = load_oracle(args.work_dir)
    ours = run_framework_trials(args.trials)
    n = min(oracle.shape[1], ours.shape[1])
    oracle, ours = oracle[:, :n], ours[:, :n]

    mo, so = oracle.mean(0), oracle.std(0, ddof=1) / np.sqrt(len(oracle))
    mu, su = ours.mean(0), ours.std(0, ddof=1) / np.sqrt(len(ours))
    diff = mo - mu
    se = np.sqrt(so ** 2 + su ** 2)
    z = diff / np.maximum(se, 1e-12)
    rms = float(np.sqrt(np.mean(diff ** 2)))
    rms_expected = float(np.sqrt(np.mean(se ** 2)))
    report = {
        "config": {"n_water": G.N_WATER, "steps": G.STEPS,
                   "pfreq": G.PFREQ, "base_tcp": G.TCP,
                   "reconstructed_tcp": TCP2, "moment_scale": G.MSCALE,
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
