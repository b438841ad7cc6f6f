"""The phase-decomposition record: one run, a whole analysis campaign.

Walker trajectories never depend on the dipole moment, and a
Carr-Purcell pulse only negates accumulated phase — so ONE simulation
that records per-walker (A, B) phase components per output window is a
complete basis for the entire (moment scale x echo spacing) plane,
closed-form inverse fits of measured curves, and Monte-Carlo error bars
by walker bootstrap (engine/decompose.py).  The reference's route to
any ONE of these points is a recompile plus a ~14-minute GPU job.

CLI equivalents:

    mri-t2-sim --moment-scales 0.5,1,2 --echo-taucps 2.5,5.5 \
        --dump-record basis.npz --fit-r2 dispersion.csv --out plane.csv
    mri-t2-fit --record basis.npz --bootstrap 200
    mri-t2-invert --record basis.npz --target measured.csv
    # long records: disk-backed + crash-safe (re-run the same command
    # after a process death; it resumes from the checkpoint)
    mri-t2-sim --moment-scales 1 --record-dir basis/ \
        --checkpoint ck.npz --checkpoint-every 8 ...
    # dense sweeps too big even for disk records: stream the plane
    # (O(taucps x walkers) memory) — durable with the same flag
    mri-t2-sim --moment-scales 0.5,1,2 --echo-taucps 2.5,5.5 \
        --stream-plane --checkpoint snap.npz ...
    # production speed: the plane folded ON DEVICE (no record crosses
    # to the host), error bars
    # from the on-device spin-echo capture
    mri-t2-sim --moment-scales 0.5,1,2 --echo-taucps 2.5,5.5 \
        --plane-device --dump-echoes echoes.npz ...
    mri-t2-fit --echoes echoes.npz --bootstrap 200
"""

import jax
import numpy as np

from mri_nanoparticle_simulation_tpu.engine import decompose as dec
from mri_nanoparticle_simulation_tpu.engine.pallas_engine import \
    choose_engine
from mri_nanoparticle_simulation_tpu.params import Params
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox

params = Params(num_water=256, num_cells=32, bound=15.0,
                water_start_bound=10.0, border=4.0, hash_dim=10,
                totaltime=0.04, taucp=0.005, sprint_steps=10_000,
                chunk_steps=1000, near_k=6, mmoment=3.5e-15)
engine = choose_engine(anywhere=True)
print(f"{engine} engine on {jax.devices()[0].platform}")
scene = BacteriaBox(params, seed=42).populate()

# --- 1. one forward run records the (A, B) basis ----------------------
rec = dec.run_decomposition(scene, params, seed=0, engine=engine)
print(f"record: A/B {rec.A.shape} "
      f"({rec.stats['coverage_violations']} coverage violations)")

# --- 2. the whole (moment x taucp) plane, closed form -----------------
scales = [0.5, 1.0, 2.0]
taucps = [0.005, 0.01]
plane = dec.curves_at_plane(rec.A, rec.B, scales, taucps, params)
print("plane curves:", plane.shape)        # [3 scales, 2 taucps, n]
print("final magnetization m(t_end):")
for si, s in enumerate(scales):
    row = "  ".join(f"{plane[si, ti, -1]:+.4f}"
                    for ti in range(len(taucps)))
    print(f"  scale {s:3.1f}:  {row}")
# stronger moments dephase faster: m(t_end) falls along the scale axis

# --- 3. Monte-Carlo error bars from the SAME record -------------------
# resample walker columns (the sampling unit) -> the full sampling
# distribution of T2, no re-simulation
b = dec.bootstrap_t2(rec.A, rec.B, params, n_boot=100, seed=1)
print(f"T2 = {b.fit.t2_ms:.3g} ms, 95% CI [{b.t2_lo_ms:.3g}, "
      f"{b.t2_hi_ms:.3g}] ({b.n_ok}/100 resamples)")

# --- 4. fit a 'measured' curve in closed form -------------------------
# synthesize a measurement at a hidden moment scale, then recover it
# from the record alone (inverse.fit_moment_scale_decomposed is the
# mri-t2-invert --record path)
from mri_nanoparticle_simulation_tpu.inverse import \
    fit_moment_scale_decomposed
hidden = 1.6
measured = np.mean(np.cos(hidden * np.asarray(rec.A)
                          + np.asarray(rec.B)), axis=1)
fit = fit_moment_scale_decomposed(measured, rec.A, rec.B,
                                  mmoment=params.mmoment)
print(f"hidden scale {hidden} -> recovered {fit.scale:.4f} "
      f"(moment {fit.mmoment:.3e})")

# --- 5. arbitrary refocusing schedules the engines never simulated ----
# a variable-spacing echo train, reconstructed exactly from the same
# record (pulses only negate phase)
dA, dB = dec.window_increments(rec.A, rec.B, params)
train = dec.reconstruct_at_schedule(dA, dB, [1.0],
                                    schedules=[[5, 9, 17, 33]])
print("variable-spacing train m(t_end):", f"{train[0, 0, -1]:+.4f}")

# --- 6. production form: plane + error bars fully on device -----------
# the same plane and the same bootstrap inputs with NO record anywhere:
# per-sprint record planes fold into carried Kahan sums on the device
# (only KB curve blocks drain) and the per-walker spin-echo rows are
# gathered in the same pass
_, dev_plane, _, echoes = dec.run_plane_on_device(
    scene, params, scales, taucps, seed=0, engine=engine,
    echo_pairs=[(1.0, params.taucp)])
print("on-device plane matches the record reconstruction:",
      bool(np.allclose(dev_plane[..., 0], plane, atol=1e-4)))
b_dev = dec.bootstrap_from_echoes(echoes[0].times_ms, echoes[0].cos,
                                  n_boot=100, seed=1)
print(f"on-device echoes: T2 = {b_dev.fit.t2_ms:.3g} ms, 95% CI "
      f"[{b_dev.t2_lo_ms:.3g}, {b_dev.t2_hi_ms:.3g}]")

# --- 7. durable on-disk record (crash-safe) ---------------------------
# the same run streamed into a disk store with checkpoints: host RAM
# stays one sprint block; killing the process and re-running resumes
# from the checkpoint bitwise (tests/test_record_store.py proves it
# with injected faults)
res = dec.run_decomposition_durable(
    scene, params, "basis_store", seed=0, scene_seed=42, engine=engine,
    checkpoint_path="basis_ck.npz", checkpoint_every_sprints=2)
same = np.array_equal(np.asarray(res.A), np.asarray(rec.A))
print(f"durable store bitwise-equal to the in-RAM record: {same}")
