#!/usr/bin/env python
"""Paired dispersion-plane golden arm.

The flagship one-record claim: ONE decomposition run at a base
Carr-Purcell spacing reconstructs the T2 curve at EVERY aligned echo
spacing in closed form (engine/decompose.reconstruct_curves — flips are
+-1 bookkeeping on window prefix sums, cuda_sim.cu:833-838,1015-1020
semantics).  GOLDEN_ECHO.json validated ONE reconstructed spacing
against independent scenes; this arm validates the whole CPMG
dispersion axis on PAIRED reference-built scenes:

  * oracle arm: golden/ref_t2_oracle run DIRECTLY at each echo spacing
    (tcp in 50k/125k/250k steps) — reference physics simulated at the
    target spacing, on the reference's own compiled scene;
  * framework arm: ONE production-engine decomposition record per scene
    at the BASE spacing (125k); every spacing (including the base — a
    self-check) reconstructed from that single record.  The 50k and
    250k curves are never simulated on our side.

Paired statistics per spacing (identical scenes on both arms, walker
noise only), plus the fitted R2(taucp) dispersion table both arms —
the product the reference would need one recompile-and-rerun per grid
point to build (README.md:13,16).

Usage:
  python scripts/golden_dispersion.py --seeds 3            # runs oracles
  python scripts/golden_dispersion.py --seeds 3 --skip-oracle
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import golden_paired as gp  # noqa: E402

STEPS = 500_000
MSCALE = 20.0
BASE_TCP = 125_000
TCPS = (50_000, 125_000, 250_000)
FW_SEED0 = 8700


def arm_args(tcp: int) -> argparse.Namespace:
    return argparse.Namespace(steps=STEPS, tcp=tcp, mscale=MSCALE,
                              reflect=None, kick="aswritten", gradient=0.0)


def run_framework_records(scenes, p, n_reps: int):
    """One decomposition record per (scene, rep) at BASE_TCP; curves at
    every spacing reconstructed from it.  Returns [S, n_tcps, n_win]."""
    from mri_nanoparticle_simulation_tpu.engine import decompose as dec
    from mri_nanoparticle_simulation_tpu.engine.pallas_engine import \
        choose_engine
    from mri_nanoparticle_simulation_tpu.params import DEFAULT

    engine = choose_engine(anywhere=True)
    import jax
    print(f"[framework] {engine} engine on {jax.devices()[0].platform}",
          file=sys.stderr)
    taucps = [t * DEFAULT.tau for t in TCPS]
    out = []
    for si, scene in enumerate(scenes):
        reps = []
        for k in range(n_reps):
            rec = dec.run_decomposition(
                scene, p, seed=FW_SEED0 + 1000 * si + k, engine=engine)
            reps.append(dec.curves_at_plane(rec.A, rec.B, [1.0], taucps,
                                            p)[0])
        out.append(np.mean(reps, axis=0))
        print(f"[framework] scene {si}: one record -> {len(TCPS)} "
              f"spacings", file=sys.stderr, flush=True)
    return np.asarray(out)


def fit_r2(times_ms, curve) -> float:
    from mri_nanoparticle_simulation_tpu import analysis

    return 1.0 / analysis.fit_t2(times_ms, curve, floor=0.05).t2_ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--work-dir", default=os.path.join(gp.GOLDEN, "work"))
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--fw-reps", type=int, default=2)
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--fw-cache", default=None,
                    help="npz caching the per-scene reconstruction "
                         "curves (run the device arm early, assemble "
                         "later)")
    ap.add_argument("--out", default="GOLDEN_DISPERSION.json")
    args = ap.parse_args()

    seeds = [gp.SCENE_SEED0 + i for i in range(args.seeds)]
    base = arm_args(BASE_TCP)
    p = gp.framework_params(base)
    # the framework record carries the base CP schedule; reconstruction
    # re-derives every other spacing from the SAME record
    oracle = {}                      # tcp -> [S, n_win]
    scenes = []
    for s in seeds:
        d = gp.run_scene_dump(args.work_dir, s)
        scene = gp.load_scene(d, p)
        scene.mnps[:, 4] *= MSCALE   # same linear scaling as the oracle
        scenes.append(scene)
    oracle_idx = {}                  # tcp -> seed indices present, so a
    for tcp in TCPS:                 # missing MIDDLE seed cannot pair a
        a = arm_args(tcp)            # framework row with the wrong scene
        curves, idx = [], []
        for si, s in enumerate(seeds):
            if not args.skip_oracle:
                gp.run_oracle(args.work_dir, s, a)
            path = gp.oracle_csv(args.work_dir, s, gp.tag_of(a))
            if not os.path.exists(path):
                print(f"[skip] no oracle CSV for tcp={tcp} seed {s}",
                      file=sys.stderr)
                continue
            curves.append(np.loadtxt(path, delimiter=",")[:, 1]
                          / gp.N_WATER)
            idx.append(si)
        if curves:
            oracle[tcp] = np.asarray(curves)
            oracle_idx[tcp] = idx
    if not oracle:
        raise SystemExit("no oracle CSVs available")

    if args.fw_cache and os.path.exists(args.fw_cache):
        z = np.load(args.fw_cache)
        assert list(z["seeds"]) == list(seeds), "fw cache seed mismatch"
        ours = z["curves"]                                   # [S, T, W]
        print(f"[framework] cached records from {args.fw_cache}",
              file=sys.stderr)
    else:
        ours = run_framework_records(scenes, p, args.fw_reps)
        if args.fw_cache:
            np.savez(args.fw_cache, curves=ours,
                     seeds=np.asarray(seeds))
    times = np.loadtxt(
        gp.oracle_csv(args.work_dir, seeds[0],
                      gp.tag_of(arm_args(sorted(oracle)[0]))),
        delimiter=",")[:, 0]

    per_tcp = {}
    for ti, tcp in enumerate(TCPS):
        if tcp not in oracle:
            continue
        oc = oracle[tcp]
        S = oc.shape[0]
        fw = ours[oracle_idx[tcp], ti]
        n = min(oc.shape[1], fw.shape[1])
        oc, fw = oc[:, :n], fw[:, :n]
        d = oc - fw
        mean_d = d.mean(0)
        se = (d.std(0, ddof=1) / np.sqrt(S)) if S > 1 \
            else np.full(n, np.inf)
        z = mean_d / np.maximum(se, 1e-12)
        r2_o = [fit_r2(times[:n], c) for c in oc]
        r2_f = [fit_r2(times[:n], c) for c in fw]
        dr2 = np.asarray(r2_o) - np.asarray(r2_f)
        per_tcp[str(tcp)] = {
            "paired_scenes": int(S),
            "reconstructed": tcp != BASE_TCP,
            "oracle_final_mean": float(oc.mean(0)[-1]),
            "framework_final_mean": float(fw.mean(0)[-1]),
            "rms_diff": float(np.sqrt(np.mean(mean_d ** 2))),
            "rms_expected_under_h0":
                float(np.sqrt(np.mean(se ** 2))) if S > 1 else None,
            "rms_ratio": float(np.sqrt(np.mean(mean_d ** 2))
                               / np.sqrt(np.mean(se ** 2)))
                if S > 1 else None,
            # same statistic and name as golden_paired.py: paired
            # per-point t = mean_d/se, S-1 dof; needs
            # >= 3 paired scenes for a stable se estimate
            "max_abs_t_paired": float(np.abs(z).max()) if S > 2 else None,
            "r2_oracle_per_ms": [float(v) for v in r2_o],
            "r2_framework_per_ms": [float(v) for v in r2_f],
            "r2_mean_diff": float(dr2.mean()),
            "r2_diff_se": float(dr2.std(ddof=1) / np.sqrt(S))
                if S > 1 else None,
        }

    # Reconstruction-specific error: any physics/field-model bias
    # between the arms (the octree-error residual attributed in
    # GOLDEN_T2_FULL_ATTRIBUTION.json) is SHARED by every spacing,
    # since the oracle bias does not depend on the CP schedule's
    # bookkeeping; what the one-record reconstruction itself adds shows
    # up as spacing-to-spacing VARIATION of the R2 difference.
    summary = {}
    if len(per_tcp) >= 2:
        dr2s = {t: v["r2_mean_diff"] for t, v in per_tcp.items()}
        vals = np.asarray(list(dr2s.values()))
        ses = np.asarray([v["r2_diff_se"] or np.nan
                          for v in per_tcp.values()], np.float64)
        summary = {
            "r2_diff_by_spacing_per_ms": dr2s,
            "r2_diff_spread_per_ms": float(vals.max() - vals.min()),
            "r2_diff_spread_se_per_ms":
                float(np.sqrt(np.nansum(ses ** 2))),
            "note": "shared offset = arm physics bias (oracle octree "
                    "error, see GOLDEN_T2_FULL_ATTRIBUTION); wider "
                    "spacings refocus less of that bias, so the "
                    "spread is an UPPER bound on reconstruction-"
                    "specific error",
        }

    report = {
        "config": {"n_water": gp.N_WATER, "steps": STEPS,
                   "pfreq": gp.PFREQ, "base_tcp": BASE_TCP,
                   "spacings": list(TCPS), "moment_scale": MSCALE,
                   "fw_reps_per_scene": args.fw_reps},
        "reconstruction_consistency": summary,
        "design": "paired reference-built scenes; framework simulates "
                  "ONLY the base spacing (one decomposition record per "
                  "scene/rep); every spacing incl. base reconstructed "
                  "in closed form from that record; oracle simulates "
                  "each spacing directly",
        "per_tcp": per_tcp,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
