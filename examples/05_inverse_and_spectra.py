"""Inverse relaxometry + T2 spectra: from a measured decay back to the
physical parameters that produced it.

The reference answers every inverse question by recompile-and-re-run
sweeps (README.md:13); here each axis has a principled estimator:

  * moment        — exact closed form from ONE decomposition record
                    (phase = s*A + B), or reverse-mode AD through the
                    whole simulation;
  * diffusion (D) — CRN golden-section on the d_scale launch scalar
                    (trajectories BEND with D; no closed form exists);
  * cell radius   — CRN golden-section on the cell_r launch scalar on a
                    FIXED scene (same centers, unknown cell size);
  * (moment, D)   — BOTH unknown at once: Nelder-Mead on (log s, log d)
                    with common random numbers, one compiled program for
                    the whole 2D fit;
  * T2 spectrum   — multi-exponential decomposition of a heterogeneous
                    decay (regularized NNLS, Whittall-MacKay).

CLI equivalents:

    mri-t2-invert --axis joint --method crn --true-scale 1.5
    mri-t2-invert --axis cell_r --method crn --true-scale 0.7
    mri-t2-fit mixed.csv --spectrum --out-table spectrum.csv
    mri-t2-plot spectrum.csv --spectrum --out spectrum.png

Every fit below shares the target's RNG seed, so the CRN losses are
deterministic surfaces whose minima sit exactly at the hidden truth —
the recoveries are exact up to search resolution, not Monte-Carlo luck.
On real measured data the residual Monte-Carlo noise floor applies
(tests/test_inverse.py pins the cross-seed case too).
"""

import jax
import numpy as np

from mri_nanoparticle_simulation_tpu import analysis, inverse
from mri_nanoparticle_simulation_tpu.engine.pallas_engine import \
    choose_engine
from mri_nanoparticle_simulation_tpu.params import small_test_params
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox

ENGINE = choose_engine(anywhere=True)
print(f"{ENGINE} engine on {jax.devices()[0].platform}")

# A small configuration with a strong dephasing signal (mmoment ~1400x
# the reference default scaled to the short window).
params = small_test_params(num_water=128, mmoment=5e-14)
scene = BacteriaBox(params, seed=1).populate()
curve = inverse.make_engine_curve_fn(params, scene, seed=2, engine=ENGINE)

# --- 1. Joint (moment, D) recovery: the measured-data problem --------
hidden = (1.6, 0.5)
target = np.asarray(curve(hidden[1], m_scale=hidden[0]))
fit = inverse.fit_joint_crn(target, params, scene, seed=2,
                            m_bracket=(0.25, 4.0), d_bracket=(0.1, 1.0),
                            max_evals=70, engine=ENGINE)
print(f"joint fit: moment scale {fit.m_scale:.4f} (true {hidden[0]}), "
      f"d_scale {fit.d_scale:.4f} (true {hidden[1]}), "
      f"{len(fit.loss_history)} evaluations of ONE compiled program")
assert abs(fit.m_scale - hidden[0]) / hidden[0] < 0.05
assert abs(fit.d_scale - hidden[1]) / hidden[1] < 0.05

# --- 2. Cell-size recovery on a fixed scene ---------------------------
# Unknown cell radius, known centers: the cell_r launch scalar moves
# residency, the field mask, membrane events and kick gating together.
target_r = np.asarray(curve(cell_r=0.7))
fit_r = inverse.fit_cell_radius_crn(target_r, params, scene, seed=2,
                                    bracket=(0.4, 1.0), iters=18,
                                    engine=ENGINE)
print(f"cell-radius fit: {fit_r.scale:.4f} um (true 0.7)")
assert abs(fit_r.scale - 0.7) < 0.02

# --- 3. Diffusion-weighted MRI: gradient + ADC recovery ----------------
# A constant background gradient (mri-t2-sim --gradient) encodes the
# diffusion coefficient in the CPMG decay (Carr & Purcell 1954); the
# closed form analysis.carr_purcell_r2 designs the gradient, and the
# CRN d_scale fit recovers the hidden ADC from the curve alone.
p_dwi = small_test_params(num_water=128, num_cells=4, totaltime=0.01,
                          sprint_steps=1000, taucp=0.001, mmoment=0.0,
                          phase_k=0.0, D_cell=1.0, D_extra=1.0)
gz = analysis.design_gradient_for_r2(p_dwi, 200.0, D=1.0)
p_dwi = p_dwi.replace(b0_gradient=(0.0, 0.0, gz)).validate()
sc_dwi = BacteriaBox(p_dwi, seed=5).populate()
dwi = np.asarray(inverse.make_engine_curve_fn(
    p_dwi, sc_dwi, seed=7, engine=ENGINE)(0.55))   # hidden ADC scale
fit_d = inverse.fit_diffusion_scale_crn(dwi, p_dwi, sc_dwi, seed=7,
                                        bracket=(0.2, 1.0), iters=16,
                                        engine=ENGINE)
print(f"DWI ADC fit: d_scale {fit_d.scale:.4f} (true 0.55); designed "
      f"R2 = {analysis.carr_purcell_r2(p_dwi, D=1.0):.0f}/ms")
assert abs(fit_d.scale - 0.55) / 0.55 < 0.05

# --- 4. T2 spectrum of a heterogeneous decay --------------------------
# Two compartments (e.g. two cell densities / D environments): the mono
# fit averages them away; the spectrum resolves both.
t = np.linspace(0.05, 60.0, 400)
mixed = 0.4 * np.exp(-t / 3.0) + 0.6 * np.exp(-t / 25.0)
spec = analysis.fit_t2_spectrum(t, mixed, n_t2=96)
mono = analysis.fit_t2(t, mixed)
comps = ", ".join(f"T2={t2:.3g} ms (A={a:.2f})" for t2, a in spec.peaks)
print(f"spectrum: {comps}; mono-exponential fit collapses to "
      f"T2={mono.t2_ms:.3g} ms")
assert len(spec.peaks) == 2

print("inverse + spectrum example OK")
