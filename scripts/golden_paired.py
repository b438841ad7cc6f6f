#!/usr/bin/env python
"""Paired-scene golden T2 arm: reference physics vs this framework on
IDENTICAL geometry.

The unpaired golden arms (scripts/golden_t2.py) compare independent
scene ensembles, so their H0 envelope carries scene-to-scene variance —
at deep decay that variance dominates and the required oracle trial
count explodes.  This harness removes it exactly:

  * golden/ref_scene_dump and golden/ref_t2_oracle build the SAME scene
    from the same <scene_seed> (both construct ``XORShift<> gen(seed);
    BacteriaBox box(&gen); box.populateSimulation()`` — the reference's
    own compiled C++, BacteriaBox.cpp:49-121 / SimulationBox.cpp:77-97);
  * the framework arm runs its production Pallas engine ON THE DUMPED
    SCENE (cells = dumped cells, MNPs incl. periodic images, the exact
    Morton-sorted initial waters), so the per-seed curve difference
    contains only (a) walker-RNG noise and (b) any physics/field/
    precision mismatch — which is the thing under test;
  * statistics are paired: d_s(t) = oracle_s(t) - framework_s(t),
    se(t) = std_s(d_s(t)) / sqrt(P).  Scene variance cancels in d_s.

This is the production-scale deep-decay instrument:
default config 4032 walkers (parameters.h:46) x 2e6 steps (2 ms) with
moment x60, tcp=250k -> 8 Carr-Purcell flips and a curve decaying below
0.3 — thousands of accumulated radians through the f32/Kahan path, the
regime the reduced arms never reached.

The moment scale multiplies the oracle's queried B (linear in M,
octree.cpp:206-210) and the framework's scene.mnps[:, 4] — the same
linear scaling on both sides, no octree/expansion rebuild semantics
change.

Usage:
  python scripts/golden_paired.py --work-dir /root/repo/golden/work \
      --seeds 8 --out GOLDEN_T2_FULL.json
  python scripts/golden_paired.py --skip-oracle ...   # reuse cached CSVs
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

# production-scale defaults: every reference default
# (4032 walkers, 270 cells, tau 1e-6 ms) with the time axis moment-scaled
# to the 40 ms run's decay depth in 2 ms of simulated time
N_WATER = 4032
STEPS = 2_000_000
PFREQ = 1000
TCP = 250_000
MSCALE = 60.0
SCENE_SEED0 = 6000
ORACLE_RNG0 = 9100
FW_RUN0 = 8100


def tag_of(args) -> str:
    t = ""
    if args.steps != STEPS or args.mscale != MSCALE or args.tcp != TCP:
        t += f"_s{args.steps}_m{args.mscale:g}_t{args.tcp}"
    if args.reflect:
        t += f"_p{args.reflect[0]:g}-{args.reflect[1]:g}"
    if args.kick != "aswritten":
        t += f"_{args.kick}"
    if args.gradient:
        t += f"_g{args.gradient:g}"
    return t


def dump_dir(work: str, seed: int) -> str:
    return os.path.join(work, f"scene_{seed}")


def ensure_tools():
    exe = os.path.join(GOLDEN, "build", "ref_t2_oracle")
    if not os.path.exists(exe):
        subprocess.run(["bash", os.path.join(GOLDEN, "build.sh")],
                       check=True, capture_output=True)


def run_scene_dump(work: str, seed: int) -> str:
    d = dump_dir(work, seed)
    if not os.path.exists(os.path.join(d, "scene_waters.csv")):
        ensure_tools()
        os.makedirs(d, exist_ok=True)
        # probe_n=2 / near_per=0: the probes are parity diagnostics we
        # don't need here; keep the dump cheap
        subprocess.run([os.path.join(GOLDEN, "build", "ref_scene_dump"),
                        str(seed), d, "2", "0"],
                       check=True, capture_output=True)
    return d


def oracle_csv(work: str, seed: int, tag: str) -> str:
    return os.path.join(work, f"paired{tag}_{seed}.csv")


def run_oracle(work: str, seed: int, args) -> str:
    path = oracle_csv(work, seed, tag_of(args))
    if os.path.exists(path):
        return path
    ensure_tools()
    cmd = [os.path.join(GOLDEN, "build", "ref_t2_oracle"),
           str(seed), str(ORACLE_RNG0 + seed), path, str(N_WATER),
           str(args.steps), str(PFREQ), str(args.tcp),
           str(args.mscale), "1.0"]
    extra = list(args.reflect) if args.reflect else None
    if extra or args.kick != "aswritten" or args.gradient:
        cmd.append("0")                      # cell_r_run: compiled default
        cmd += [str(v) for v in (extra or [0.0, 0.0])]
    if args.kick != "aswritten" or args.gradient:
        cmd.append({"aswritten": "0", "intended": "1"}[args.kick])
    if args.gradient:
        cmd.append(str(args.gradient))
    print(f"[oracle] seed {seed} ...", file=sys.stderr, flush=True)
    subprocess.run(cmd, check=True, capture_output=True)
    return path


def framework_params(args):
    from mri_nanoparticle_simulation_tpu import params as P
    kick = {"aswritten": P.KICK_AS_WRITTEN,
            "intended": P.KICK_INTENDED}[args.kick]
    direction = {"aswritten": P.DIRECTION_CUBE,
                 "intended": P.DIRECTION_SPHERE}[args.kick]
    return P.DEFAULT.replace(
        num_water=N_WATER,
        totaltime=args.steps * P.DEFAULT.tau,
        sprint_steps=min(args.steps, 500_000),
        chunk_steps=4000,
        print_interval=PFREQ * P.DEFAULT.tau,
        taucp=args.tcp * P.DEFAULT.tau,
        near_k=10,
        kick_mode=kick,
        direction_mode=direction,
        b0_gradient=(0.0, 0.0, float(args.gradient or 0.0)),
        reflect_io=args.reflect[0] if args.reflect else 0.0,
        reflect_oi=args.reflect[1] if args.reflect else 0.0,
    ).validate()


def load_scene(d: str, p):
    """Framework Scene from the reference's own dumped geometry.  The
    lookup table is rebuilt with the framework's builder — candidate
    semantics stay the framework's, geometry stays the reference's."""
    from mri_nanoparticle_simulation_tpu.scene import box as box_mod
    from mri_nanoparticle_simulation_tpu.scene import lookup as lookup_mod

    mnps = np.loadtxt(os.path.join(d, "scene_mnps.csv"),
                      delimiter=",", skiprows=1)
    cells = np.loadtxt(os.path.join(d, "scene_cells.csv"),
                       delimiter=",", skiprows=1)
    waters = np.loadtxt(os.path.join(d, "scene_waters.csv"),
                        delimiter=",", skiprows=1)
    assert waters.shape == (p.num_water, 3), waters.shape
    assert cells.shape == (p.num_cells, 3), cells.shape
    lookup = lookup_mod.build_lookup_table(cells, p)
    return box_mod.Scene(params=p, cells=cells, mnps=mnps, waters=waters,
                         lookup_table=lookup, num_intra_mnps=p.num_cells)


def run_framework_cached(scenes, p, args, seeds):
    """run_framework with an optional npz cache (--fw-cache): the
    framework (device) arm is independent of the oracle CSVs, so it can
    run EARLY while the oracle queue churns, and the
    assembly later just loads the curves.  The cache stores the seed
    list; a mismatch falls through to a fresh run."""
    path = getattr(args, "fw_cache", None)
    if path and os.path.exists(path):
        z = np.load(path)
        cached = [int(v) for v in z["seeds"]]
        if all(s in cached for s in seeds):
            print(f"[framework] cached curves from {path}",
                  file=sys.stderr)
            return z["curves"][[cached.index(s) for s in seeds]]
        print(f"[framework] cache seed mismatch, re-running",
              file=sys.stderr)
    curves = run_framework(scenes, p, args)
    if path:
        np.savez(path, curves=curves, seeds=np.asarray(seeds))
    return curves


def run_framework(scenes, p, args):
    """One compiled sprint across all seeds: MNP tables padded to a
    common length with zero-moment entries far outside the box (never
    near-K candidates, never residents — walkers in these configs stay
    in the central sub-cube, >10 um from any face)."""
    import jax.numpy as jnp
    from mri_nanoparticle_simulation_tpu import rng
    from mri_nanoparticle_simulation_tpu.engine import pallas_engine
    from mri_nanoparticle_simulation_tpu.engine.reference_engine import \
        init_state

    n_pad = max(s.mnps.shape[0] for s in scenes)
    sprint = pallas_engine.make_sprint_fn(p, N_WATER, jnp.float32)
    curves = []
    for si, scene in enumerate(scenes):
        mnps = scene.mnps
        pos = np.full((n_pad, 3), 1e6, np.float64)
        M = np.zeros(n_pad, np.float64)
        pos[: len(mnps)] = mnps[:, :3]
        M[: len(mnps)] = mnps[:, 4] * args.mscale
        mnp_pos = jnp.asarray(pos, jnp.float32)
        mnp_M = jnp.asarray(M, jnp.float32)
        reps = []
        for k in range(args.fw_reps):
            kk = rng.key_from_seed(FW_RUN0 + 1000 * si + k)
            key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
            ps = pallas_engine.to_planes(
                init_state(scene.waters, p, jnp.float32), p)
            outs = []
            for _ in range(args.steps // p.sprint_steps):
                ps, wins = sprint(mnp_pos, mnp_M, key_arr, ps, 0)
                outs.append(np.asarray(wins[:, 0]))
            reps.append(np.concatenate(outs) / N_WATER)
        curves.append(np.mean(reps, axis=0))
        print(f"[framework] seed {si} done", file=sys.stderr, flush=True)
    return np.asarray(curves)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--work-dir", default=os.path.join(GOLDEN, "work"))
    ap.add_argument("--seeds", type=int, default=8,
                    help="number of paired scenes (scene_seed = 6000+i)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--tcp", type=int, default=TCP)
    ap.add_argument("--mscale", type=float, default=MSCALE)
    ap.add_argument("--fw-reps", type=int, default=2,
                    help="framework RNG replicates per scene (averaged; "
                         "halves the framework-side walker noise)")
    ap.add_argument("--reflect", default=None, metavar="RIO,ROI",
                    help="membrane bounce probabilities on BOTH arms "
                         "(cell_reflect, cuda_sim.cu:502-509)")
    ap.add_argument("--kick", default="aswritten",
                    choices=["aswritten", "intended"],
                    help="physics mode on BOTH arms: 'intended' selects "
                         "the corrected quirks together — sign(u-1/2) "
                         "Cauchy kick (quirk 1, cuda_sim.cu:625-640) AND "
                         "uniform-on-sphere directions (quirk 4, "
                         "cuda_sim.cu:562-583)")
    ap.add_argument("--gradient", type=float, default=0.0,
                    help="constant background Gz (T/um) on BOTH arms "
                         "(the DWI axis; adds z * Gz * 2pi*g*tau*1e-3 "
                         "to the per-step phase kick)")
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--fw-cache", default=None,
                    help="npz path caching the framework-arm curves "
                         "(run the device arm early, assemble later)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.reflect:
        rio, roi = (float(v) for v in args.reflect.split(","))
        if not (0 <= rio <= 1 and 0 <= roi <= 1):
            raise SystemExit("--reflect values must be in [0, 1]")
        args.reflect = (rio, roi)
    tag = tag_of(args)
    if args.out is None:
        args.out = f"GOLDEN_T2_FULL{tag}.json"
    os.makedirs(args.work_dir, exist_ok=True)

    seeds = [SCENE_SEED0 + i for i in range(args.seeds)]
    p = framework_params(args)
    oracle, scenes, present = [], [], []
    for s in seeds:
        d = run_scene_dump(args.work_dir, s)
        if not args.skip_oracle:
            run_oracle(args.work_dir, s, args)
        path = oracle_csv(args.work_dir, s, tag)
        if not os.path.exists(path):
            print(f"[skip] no oracle CSV for seed {s}", file=sys.stderr)
            continue
        rows = np.loadtxt(path, delimiter=",")
        oracle.append(rows[:, 1] / N_WATER)
        scenes.append(load_scene(d, p))
        present.append(s)
    if not oracle:
        raise SystemExit("no oracle CSVs available")
    times = np.loadtxt(oracle_csv(args.work_dir, present[0], tag),
                       delimiter=",")[:, 0]
    oracle = np.asarray(oracle)

    ours = run_framework_cached(scenes, p, args, present)
    n = min(oracle.shape[1], ours.shape[1])
    oracle, ours, times = oracle[:, :n], ours[:, :n], times[:n]

    d = oracle - ours                       # [P, n] paired differences
    P_ = len(d)
    mean_d = d.mean(0)
    se = d.std(0, ddof=1) / np.sqrt(P_) if P_ > 1 else np.full(n, np.inf)
    z = mean_d / np.maximum(se, 1e-12)
    rms = float(np.sqrt(np.mean(mean_d ** 2)))
    rms_expected = float(np.sqrt(np.mean(se ** 2)))
    mo = oracle.mean(0)
    report = {
        "config": {"n_water": N_WATER, "steps": args.steps, "pfreq": PFREQ,
                   "tcp": args.tcp, "moment_scale": args.mscale,
                   "cp_flips": args.steps // args.tcp,
                   "kick": args.kick,
                   "gradient_z": args.gradient or None,
                   "reflect_io_oi": list(args.reflect) if args.reflect
                   else None,
                   "paired_scenes": P_, "fw_reps_per_scene": args.fw_reps},
        "design": "paired: identical reference-built scenes on both arms; "
                  "se from per-scene curve differences (scene variance "
                  "cancels exactly)",
        "oracle_final_mean": float(mo[-1]),
        "framework_final_mean": float(ours.mean(0)[-1]),
        "final_diff": float(mean_d[-1]),
        "final_se": float(se[-1]),
        "rms_diff": rms,
        "rms_expected_under_h0": rms_expected,
        "rms_ratio": float(rms / rms_expected),
        # ONE statistic, one name: the paired
        # per-point t — mean_d(t) / se(t), se from the P scene-pair
        # differences (P-1 dof).  With few pairs the per-point se
        # estimate is itself noisy (t_{P-1} is heavy-tailed), so the
        # pointwise MAX over thousands of correlated points is NOT a
        # calibrated significance level — rms_ratio and final_diff /
        # final_se are the calibrated summaries; the max and quartile
        # values are reported for curve-shape diagnosis only, and
        # ACCURACY.md quotes this same statistic at named times.
        "stat_definition": "t_paired(t) = mean_d(t) / se(t); se(t) = "
                           "std over scene-pair diffs / sqrt(P), P-1 "
                           "dof (heavy-tailed for small P: max over "
                           "the curve is diagnostic, not calibrated)",
        "max_abs_t_paired": float(np.abs(z).max()),
        "mean_abs_t_paired": float(np.abs(z).mean()),
        "t_paired_at_quarters": {
            f"{times[i]:.3f}ms": float(z[i])
            for i in (n // 4, n // 2, 3 * n // 4, n - 1)},
        "curve_min": float(min(mo.min(), ours.mean(0).min())),
        "curve_decay_span": float(1.0 - min(mo.min(), ours.mean(0).min())),
        "times_ms": [float(times[0]), float(times[n - 1])],
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    np.savez(os.path.splitext(args.out)[0] + "_curves.npz",
             times=times, oracle=oracle, framework=ours)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
