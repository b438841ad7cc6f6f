"""Production-scale deep-decay golden T2 regression.

``golden/testdata/`` commits, for two scene seeds, the reference's own
compiled-C++ scene dumps (``ref_scene_dump``: BacteriaBox.cpp:49-121 /
SimulationBox.cpp:77-97 geometry) and the reference-physics oracle T2
curves (``ref_t2_oracle``: the cuda_sim.cu:688-804 walker loop on the
host) at the PRODUCTION configuration — 4032 walkers (parameters.h:46),
2e6 steps, tcp=250k -> 8 Carr-Purcell flips (cuda_sim.cu:1015-1020),
moment x60 so the curve decays to ~0.34 (thousands of accumulated
radians through the f32/Kahan path).  This test re-runs the framework's
production Pallas engine on the SAME scenes and gates the paired curve
difference at the walker-noise scale, pinning the headline claim of
GOLDEN_T2_FULL.json as a repeatable regression on the card.  The
framework arm runs in f32 with Kahan phase folds (the engine's own
precision); the gates below are walker-noise scales, far above f32
rounding.

Runs only under ``MRI_GPU_TESTS=1`` on an NVIDIA GPU (one device run per
seed plus one compile); the full-statistics instrument is
scripts/golden_paired.py.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "golden", "testdata")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import golden_paired as gp  # noqa: E402

pytestmark = pytest.mark.gpu

SEEDS = (6000, 6001)

# Per-seed noise scale: the oracle and framework arms draw independent
# walker RNG, so at the deep end var(cos phi) ~ 1/2 per walker per arm
# -> sd of the per-point difference ~ sqrt(2 * 0.5 / 4032) ~ 0.0157 for
# 1 framework rep.  Measured per-seed rms_diff (GOLDEN_T2_FULL_curves,
# 4-rep framework means): 0.0098 / 0.0180 for seeds 6000 / 6001.  The
# gates are ~2x measured — a regression that
# doubles the residual fails:
RMS_GATE = 0.025          # per seed; 2x the larger measured rms
FINAL_GATE = 0.060        # per seed; final POINT carries ~0.022 1-rep
#                           noise on top of the -0.009..-0.043 measured
#                           systematic, so the sharp statistics are the
#                           WINDOWED means below, not the final point
# Time-signature gates (the attributed residual's known shape,
# GOLDEN_T2_FULL_ATTRIBUTION.json: reference-octree smoothing -> oracle
# HIGH pre-first-echo; leaf-jump phase noise -> oracle LOW at depth).
# Windowed means average ~250-500 points, so their 1-rep noise is
# ~0.01; measured early in [-0.003, +0.009], late in [-0.025, -0.009].
# A SIGN FLIP of the residual (late-window mean going positive) or a
# >2x growth fails on the cross-seed mean.
EARLY_WINDOW = 250        # pre-first-echo: t < 0.25 ms (tcp = 250k)
LATE_WINDOW = 500         # 1.5-2.0 ms
EARLY_ABS_GATE = 0.020    # per seed
LATE_RANGE = (-0.055, +0.010)       # per seed
LATE_MEAN_RANGE = (-0.040, 0.000)   # cross-seed mean (noise ~0.007)
# vs the tightened-octree oracle (committed
# golden/testdata/paired_tight2.5e-7_6000.csv): measured rms 0.0061 /
# late -0.0040 with 4 framework reps; ~2x headroom + 1-rep noise
TIGHT_RMS_GATE = 0.015
TIGHT_LATE_ABS_GATE = 0.014


def _args():
    import argparse

    return argparse.Namespace(steps=gp.STEPS, tcp=gp.TCP,
                              mscale=gp.MSCALE, fw_reps=1, reflect=None,
                              kick="aswritten", gradient=0.0)


def check_parity(log=lambda *a: None):
    """Run the framework arm on both committed scenes and assert every
    gate above; returns the per-seed statistics (also passed to
    ``log``).  chip_smoke.py calls this on the card."""
    args = _args()
    p = gp.framework_params(args)
    diffs, finals, stats = [], [], {}
    for seed in SEEDS:
        d = os.path.join(TESTDATA, f"scene_{seed}")
        rows = np.loadtxt(os.path.join(TESTDATA, f"paired_{seed}.csv"),
                          delimiter=",")
        oracle = rows[:, 1] / gp.N_WATER
        scene = gp.load_scene(d, p)
        ours = gp.run_framework([scene], p, args)[0]
        n = min(len(oracle), len(ours))
        assert n == gp.STEPS // gp.PFREQ
        diff = oracle[:n] - ours[:n]
        rms = float(np.sqrt(np.mean(diff**2)))
        diffs.append(diff)
        finals.append(float(diff[-1]))
        # the attributed residual's time signature, per seed
        early = float(diff[:EARLY_WINDOW].mean())
        late = float(diff[-LATE_WINDOW:].mean())
        st = dict(rms=rms, final=float(diff[-1]), early=early, late=late,
                  oracle_end=float(oracle[n - 1]),
                  ours_end=float(ours[n - 1]))
        # apples-to-apples parity: against the TIGHTENED-octree
        # oracle (GOLDEN_MAX_PRODUCT=2.5e-7 — 8x tighter leaf
        # criterion, attribution round 5) the residual collapses to
        # the walker-noise floor; gate ~2x the measured 0.0061 rms
        # / -0.0040 late-window (same reference physics, better
        # field: the curve the reference WOULD produce without its
        # documented 6.8e-2 field error)
        tight_csv = os.path.join(
            TESTDATA, f"paired_tight2.5e-7_{seed}.csv")
        if os.path.exists(tight_csv):
            to = np.loadtxt(tight_csv, delimiter=",")[:, 1] / gp.N_WATER
            td = to[:n] - ours[:n]
            st["tight_rms"] = float(np.sqrt(np.mean(td ** 2)))
            st["tight_late"] = float(td[-LATE_WINDOW:].mean())
        stats[seed] = st
        log(seed, st)
        # the deep-decay regime is actually reached
        assert st["oracle_end"] < 0.45
        assert st["ours_end"] < 0.45
        assert rms < RMS_GATE, (seed, rms)
        assert abs(diff[-1]) < FINAL_GATE, (seed, diff[-1])
        assert abs(early) < EARLY_ABS_GATE, (seed, early)
        assert LATE_RANGE[0] < late < LATE_RANGE[1], (seed, late)
        if "tight_rms" in st:
            assert st["tight_rms"] < TIGHT_RMS_GATE, (seed, st)
            assert abs(st["tight_late"]) < TIGHT_LATE_ABS_GATE, (seed, st)
    # cross-seed means: a sign flip or >2x growth of the attributed
    # residual fails here even when single-seed noise hides it
    assert abs(np.mean(finals)) < FINAL_GATE
    late_mean = float(np.mean([d[-LATE_WINDOW:].mean() for d in diffs]))
    log("cross-seed late-window mean", late_mean)
    assert LATE_MEAN_RANGE[0] < late_mean < LATE_MEAN_RANGE[1], late_mean
    return stats


class TestGoldenFullScale:
    def test_paired_deep_decay_parity(self):
        check_parity()
