"""Quickstart: scene -> simulation -> T2 fit -> CSV + plot.

The pipeline the reference ran as `make clean && make && ./gpu_sim.out`
(README.md:13, ~14 GPU-minutes per configuration), as a few lines of
library code.  CLI equivalent:

    mri-t2-sim --totaltime 1.0 --out quickstart.csv
    mri-t2-fit quickstart.csv --taucp 5.5
    mri-t2-plot quickstart.csv --num-water 4032 --out quickstart.png

Runs the production chunk kernel on a GPU; elsewhere it shrinks the run
and uses the scan engine (same physics and random stream, the
cross-validation suite's reference).
"""

import jax

from mri_nanoparticle_simulation_tpu.analysis import fit_t2, sample_at_echoes
from mri_nanoparticle_simulation_tpu.engine.pallas_engine import \
    choose_engine
from mri_nanoparticle_simulation_tpu.engine.sim import SimulationRunner
from mri_nanoparticle_simulation_tpu.params import Params

ENGINE = choose_engine(anywhere=True)
print(f"{ENGINE} engine on {jax.devices()[0].platform}")

# Every parameters.h knob is a runtime field (params.py cites each
# reference line).  The defaults ARE the reference configuration:
# 4032 walkers, 270 cells, 30 um box, tau = 1 ns, 40 ms total.
if ENGINE == "pallas":
    # 4 ms (1/10 of the reference run); totaltime=40, taucp=5.5 is the
    # full reference run.  taucp shrinks with the run so echoes exist
    # to fit.
    params = Params(totaltime=4.0, taucp=0.5, sprint_steps=100_000,
                    chunk_steps=4000, near_k=6)
    runner = SimulationRunner(params, scene_seed=42, seed=0)
else:
    params = Params(num_water=256, num_cells=32, bound=15.0,
                    water_start_bound=10.0, border=4.0, hash_dim=10,
                    totaltime=0.04, taucp=0.005, sprint_steps=10_000,
                    chunk_steps=1000, near_k=6,
                    mmoment=3.5e-15)   # boosted so the short run decays
    runner = SimulationRunner(params, scene_seed=42, seed=0,
                              engine="scan")

# One call: compiles the sprint (cached across runs), streams the
# reference-schema CSV (time_ms, sum_cos_phi), returns the curve.
times_ms, sum_cos, sum_sin, stats = runner.run(
    csv_path="quickstart.csv", quadrature=True)
print(f"{stats['steps']:.0f} steps x {runner.params.num_water} walkers, "
      f"{stats['escapes']} chunk escapes, "
      f"{stats['coverage_violations']} coverage violations "
      f"({stats['wall_s']:.1f}s wall)")

# Fit T2 on the spin-echo envelope (rows at t = 2k*taucp, where the
# Carr-Purcell train refocuses static dephasing).
te, me = sample_at_echoes(times_ms, sum_cos, runner.params.taucp)
fit = fit_t2(te, me)
print(f"T2 = {fit.t2_ms:.3g} ms  (A = {fit.amplitude:.4g}, "
      f"R^2 = {fit.r_squared:.5f}, {fit.n_used} echoes)")

# Optional figure (PNG; fixed colorblind-validated palette)
try:
    from mri_nanoparticle_simulation_tpu.plotting import plot_curves
    plot_curves(["quickstart.csv"], "quickstart.png",
                num_water=runner.params.num_water,
                title="T2 decay (quickstart)")
    print("wrote quickstart.csv and quickstart.png")
except Exception as e:   # matplotlib backend quirks shouldn't kill a demo
    print(f"wrote quickstart.csv (plot skipped: {e})")
