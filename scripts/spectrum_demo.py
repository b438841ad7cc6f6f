#!/usr/bin/env python
"""Two-compartment voxel demo: the T2 spectrum resolves what the mono
fit averages away — measured with full simulations, not synthetics.

Physics: a voxel containing two diffusion environments (e.g. restricted
vs free water) decays as the SUM of two exponentials whose T2s the
dispersion grid already measured (R2 rises with D in this
diffusion-limited regime: T2 ~42 ms at d_scale 0.25 vs ~19 ms at 1.0,
taucp 2.5 — PLAN item 21).  This script:

  1. runs the paired D sweep (0.25, 1) through ONE compiled program
     (the d_scale launch scalar) at the requested scale;
  2. fits each compartment's echo envelope (ground truth);
  3. mixes the curves 50/50 (a voxel with both environments);
  4. fits the mixture mono-exponentially (collapses to a weighted
     middle) and with the regularized-NNLS spectrum
     (analysis.fit_t2_spectrum), which must resolve both components.

Writes SPECTRUM_DEMO.json (+ optional --plot PNG of the spectrum).

Full reference scale (one GPU):
  python scripts/spectrum_demo.py --out SPECTRUM_DEMO.json
Reduced CPU smoke (seconds):
  JAX_PLATFORMS=cpu python scripts/spectrum_demo.py --reduced
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="SPECTRUM_DEMO.json")
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="also render the mixture spectrum")
    ap.add_argument("--reduced", action="store_true",
                    help="small CPU configuration (smoke/test scale); "
                         "default is the full 4032 x 4e7 reference run")
    ap.add_argument("--taucp", type=float, default=2.5,
                    help="echo spacing (ms); 2.5 gives 8 echoes in the "
                         "40 ms reference window with a 2.3x T2 split")
    args = ap.parse_args()

    import jax

    from mri_nanoparticle_simulation_tpu.engine.pallas_engine import \
        choose_engine
    engine = choose_engine(anywhere=True)
    print(f"{engine} engine on {jax.devices()[0].platform}",
          file=sys.stderr)
    from mri_nanoparticle_simulation_tpu import analysis as an
    from mri_nanoparticle_simulation_tpu import params as P
    from mri_nanoparticle_simulation_tpu.parallel import ensemble

    if args.reduced:
        p = P.small_test_params(num_water=256, mmoment=5e-14,
                                totaltime=0.004, sprint_steps=1000,
                                taucp=0.0002)   # 10 echoes in the window
        taucp = 0.0002
    else:
        p = P.DEFAULT.replace(taucp=args.taucp,
                              sprint_steps=2_000_000, chunk_steps=4000)
        taucp = args.taucp
    p = p.validate()
    d_vals = [0.25, 1.0]
    times, cos = ensemble.run_parameter_sweep(
        p, "D", d_vals, n_trials_each=1, paired=True,
        engine=engine)
    curves = np.asarray(cos)[:, 0, :] / p.num_water   # [2, n]

    def envelope(y):
        return an.sample_at_echoes(times, y, taucp)

    f_slow = an.fit_t2(*envelope(curves[0]))
    f_fast = an.fit_t2(*envelope(curves[1]))
    mix = 0.5 * (curves[0] + curves[1])
    te, me = envelope(mix)
    mono = an.fit_t2(te, me)
    spec = an.fit_t2_spectrum(te, me, n_t2=64)

    report = {
        "config": {"num_water": p.num_water, "steps": p.t,
                   "taucp_ms": taucp, "d_scales": d_vals,
                   "n_echoes": int(len(te)), "reduced": args.reduced,
                   "engine": engine,
                   "device": jax.devices()[0].platform},
        "compartment_t2_ms": {"d0.25": f_slow.t2_ms, "d1": f_fast.t2_ms},
        "mixture_mono_t2_ms": mono.t2_ms,
        "mixture_mono_r_squared": mono.r_squared,
        "spectrum_peaks": [{"t2_ms": t2, "amplitude": a}
                           for t2, a in spec.peaks],
        "spectrum_lambda": spec.lambda_reg,
        "spectrum_chi2_ratio": spec.chi2_ratio,
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))

    if args.plot:
        import tempfile

        from mri_nanoparticle_simulation_tpu import plotting
        with tempfile.NamedTemporaryFile("w", suffix=".csv",
                                         delete=False) as f:
            f.write("t2_ms,weight\n")
            for t2, wv in zip(spec.t2_grid_ms, spec.weights):
                f.write(f"{t2:.10g},{wv:.10g}\n")
            tmp = f.name
        plotting.plot_spectrum(
            [tmp], args.plot,
            title=f"two-compartment voxel: T2 spectrum "
                  f"(true {f_slow.t2_ms:.1f} / {f_fast.t2_ms:.1f} ms)")
        os.unlink(tmp)
        print(f"spectrum plot: {args.plot}", file=sys.stderr)


if __name__ == "__main__":
    main()
