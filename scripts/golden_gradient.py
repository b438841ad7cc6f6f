#!/usr/bin/env python
"""DWI / gradient golden arm: reference physics vs
this framework under a constant background gradient, PLUS the analytic
Carr-Purcell anchor — three independent values of the same number.

Design (all at steps=500k, mscale=20, tcp=125k, Gz=3e-5 T/um):

  * **Paired arm stats**: scripts/golden_paired.py --gradient 3e-05
    produces GOLDEN_T2_G.json (oracle = ref_t2_oracle with the gz
    argument — the phase-kick line cuda_sim.cu:637 plus z*Gz; framework
    = production Pallas engine with params.b0_gradient).
  * **Zero-noise R2 shift, oracle side**: the gz kick consumes NO extra
    RNG draws, so the gradient and no-gradient oracle runs of the same
    (scene_seed, rng_seed) share IDENTICAL trajectories — their curve
    ratio at the echo rows isolates the gradient-induced decay with
    zero walker noise.  The no-gradient partners are the dispersion
    arm's base-spacing CSVs (same config).
  * **Zero-noise R2 shift, framework side**: same argument with common
    Threefry streams (fw_gradient.npz vs fw_gradient0.npz, identical
    run seeds).
  * **Analytic anchor**: analysis.carr_purcell_r2 — the CPMG closed
    form gamma^2 G^2 D_eff taucp^2 / 3 with the engine's per-axis
    D_eff (validated against the engines in tests/test_gradient.py).

The R2 shift is fitted from the ECHO rows (0.25 / 0.5 ms — flips at
each 0.125 ms, echoes where static dephasing refocuses; between echoes
the curve legitimately oscillates).  Agreement of all three puts the
DWI axis on two-independent-implementations + closed-form footing.

Usage (after the oracle CSVs exist):
  python scripts/golden_gradient.py --out GOLDEN_T2_G.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import golden_paired as gp  # noqa: E402

GZ = 3e-05
STEPS = 500_000
TCP = 125_000
MSCALE = 20.0
ECHO_ROWS = (249, 499)        # 0.25 ms, 0.5 ms (pfreq=1000, tau=1e-6 ms)


def echo_r2_shift(g_curve, g0_curve) -> float:
    """R2 shift from the last echo row of a zero-noise pair:
    ln(M_g0 / M_g) / t  [1/ms]."""
    r = ECHO_ROWS[-1]
    t_ms = (r + 1) * 1e-3
    return float(math.log(g0_curve[r] / g_curve[r]) / t_ms)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", default="GOLDEN_T2_G.json")
    args = ap.parse_args()
    work = os.path.join(gp.GOLDEN, "work")
    seeds = [gp.SCENE_SEED0 + i for i in range(args.seeds)]

    # analytic anchor via the framework's own design tool
    from mri_nanoparticle_simulation_tpu import analysis
    pa = argparse.Namespace(steps=STEPS, tcp=TCP, mscale=MSCALE,
                            reflect=None, kick="aswritten", gradient=GZ)
    p = gp.framework_params(pa)
    r2_cp = analysis.carr_purcell_r2(p)

    oracle_shifts, fw_shifts = [], []
    for s in seeds:
        gp_csv = os.path.join(
            work, f"paired_s{STEPS}_m{MSCALE:g}_t{TCP}_g{GZ:g}_{s}.csv")
        g0_csv = os.path.join(
            work, f"paired_s{STEPS}_m{MSCALE:g}_t{TCP}_{s}.csv")
        if not (os.path.exists(gp_csv) and os.path.exists(g0_csv)):
            print(f"[skip] seed {s}: missing oracle pair", file=sys.stderr)
            continue
        g = np.loadtxt(gp_csv, delimiter=",")[:, 1] / gp.N_WATER
        g0 = np.loadtxt(g0_csv, delimiter=",")[:, 1] / gp.N_WATER
        oracle_shifts.append(echo_r2_shift(g, g0))
    zg = np.load(os.path.join(work, "fw_gradient.npz"))
    z0 = np.load(os.path.join(work, "fw_gradient0.npz"))
    cached = [int(v) for v in zg["seeds"]]
    for s in seeds:
        i = cached.index(s)
        fw_shifts.append(echo_r2_shift(zg["curves"][i], z0["curves"][i]))

    anchor = {
        "design": "gradient vs no-gradient runs share IDENTICAL "
                  "trajectories on each arm (the gz kick consumes no "
                  "RNG draws; framework pairs share Threefry streams) "
                  "-> per-seed R2 shift from the 0.5 ms echo row is "
                  "zero-walker-noise on BOTH arms",
        "gz_T_per_um": GZ,
        "r2_carr_purcell_closed_form_per_ms": r2_cp,
        "r2_shift_oracle_per_ms": oracle_shifts,
        "r2_shift_framework_per_ms": fw_shifts,
        "oracle_vs_closed_form_ratio":
            [v / r2_cp for v in oracle_shifts],
        "framework_vs_closed_form_ratio":
            [v / r2_cp for v in fw_shifts],
    }
    rep = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            rep = json.load(f)
    rep["dwi_anchor"] = anchor
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(anchor, indent=1))


if __name__ == "__main__":
    main()
