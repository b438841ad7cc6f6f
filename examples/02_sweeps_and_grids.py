"""Parameter sweeps and cross-product grids as ONE compiled program.

The reference explores a parameter axis by editing parameters.h,
`make clean && make`, and a ~14-minute GPU job PER VALUE (README.md:13).
Here mmoment / taucp / cell_r / D are *launch scalars* of the compiled
sprint, so a whole sweep — or the cross product of several axes — runs
as trials of one device computation sharing one compile.

CLI equivalents:

    mri-t2-sim --sweep D --sweep-values 0.25,0.5,1 --paired \
        --fit-t2 d_dispersion.csv --out dsweep.csv
    mri-t2-sim --sweep-grid "D=0.25,0.5,1;taucp=2.5,5.5,11" --paired \
        --fit-t2 surface.csv --out grid.csv

This demo shrinks the problem to run anywhere.
"""

import jax
import numpy as np

from mri_nanoparticle_simulation_tpu.analysis import fit_t2, sample_at_echoes
from mri_nanoparticle_simulation_tpu.parallel import (run_parameter_grid,
                                                      run_parameter_sweep)
from mri_nanoparticle_simulation_tpu.engine.pallas_engine import \
    choose_engine
from mri_nanoparticle_simulation_tpu.params import Params

params = Params(num_water=256, num_cells=32, bound=15.0,
                water_start_bound=10.0, border=4.0, hash_dim=10,
                totaltime=0.04, taucp=0.005, sprint_steps=10_000,
                chunk_steps=1000, near_k=6, mmoment=3.5e-15)
engine = choose_engine(anywhere=True)
print(f"{engine} engine on {jax.devices()[0].platform}")
# at reference scale: params = Params(sprint_steps=2_000_000,
#     chunk_steps=4000, near_k=6) and engine="pallas"

# --- 1. one-knob sweep with common random numbers --------------------
# paired=True gives every D value the same scene and the same RNG
# stream, so the CONTRAST between curves is the knob's effect alone —
# Monte-Carlo noise cancels in differences.
times, cos = run_parameter_sweep(params, "D", [0.25, 0.5, 1.0],
                                 engine=engine, paired=True)
print("sweep curves:", cos.shape)           # [3 values, 1 trial, n]
for d, curve in zip((0.25, 0.5, 1.0), cos[:, 0]):
    te, me = sample_at_echoes(times, curve, params.taucp)
    f = fit_t2(te, me)
    print(f"  D scale {d:4.2f}: T2 = {f.t2_ms:6.3f} ms "
          f"(R^2 = {f.r_squared:.4f})")
# at reference scale R2 rises monotonically with D (diffusion-limited
# dephasing) — at this demo size expect visible Monte-Carlo noise on top
# of the trend

# --- 2. cross-product grid: the motional-narrowing surface -----------
axes = {"D": [0.5, 1.0], "taucp": [0.005, 0.01]}
times, curves = run_parameter_grid(params, axes, engine=engine,
                                   paired=True)
print("grid curves:", curves.shape)         # [2 D, 2 taucp, 1 trial, n]
r2 = np.full((2, 2), np.nan)
for i, d in enumerate(axes["D"]):
    for j, tc in enumerate(axes["taucp"]):
        te, me = sample_at_echoes(times, curves[i, j, 0], tc)
        try:
            r2[i, j] = 1.0 / fit_t2(te, me).t2_ms
        except ValueError:
            pass      # honest nan for unfittable grid points
print("R2(D, taucp) [/ms]:")
print(np.array_str(r2, precision=4))

# --- 3. error bars from replicate trials ------------------------------
# n_trials_each > 1 averages independent trials per value and the CLI's
# --fit-t2 writes a t2_stderr_ms column from the cross-trial scatter;
# here: 3 trials of the SAME grid point differ only by seed.
times, cos = run_parameter_sweep(params, "D", [1.0],
                                 n_trials_each=3, engine=engine)
t2s = []
for k in range(3):
    te, me = sample_at_echoes(times, cos[0, k], params.taucp)
    t2s.append(fit_t2(te, me).t2_ms)
print(f"3 trials at D=1: T2 = {np.mean(t2s):.3f} "
      f"+- {np.std(t2s, ddof=1):.3f} ms")
