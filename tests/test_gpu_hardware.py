"""Tests of the compiled chunk kernel on the card.

Everything here runs ONLY under ``MRI_GPU_TESTS=1`` on an NVIDIA GPU
(the ``gpu`` marker; conftest skips it elsewhere), in one process:

    MRI_GPU_TESTS=1 python -m pytest tests/ -m gpu -p no:xdist

Interpret-mode equivalence is good, but it is not the Triton compiler,
and these are the paths users actually run — checkpoint/resume round
trips, kernel ensembles, the sweep/ensemble CLI, the grid oracle
backend, the big-scene path with a live far table, the runtime coverage
sentinel, and the AOT warm-start cache.  Configs are kept small so each
compile stays short; physics assertions mirror the CPU suite's.  Kernel
and scan engine draw the same Threefry streams but contract to FMA in
their own order, so their positions are compared at 1e-4 µm (f32
rounding over a few thousand steps) and window sums at 0.05 of the
walker count.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu import rng
from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
from mri_nanoparticle_simulation_tpu.engine import reference_engine as re
from mri_nanoparticle_simulation_tpu.engine import sim
from mri_nanoparticle_simulation_tpu.engine.sim import SimulationRunner
from mri_nanoparticle_simulation_tpu.fields import expansion
from mri_nanoparticle_simulation_tpu.io import writer as wr
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def p():
    return P.small_test_params(num_water=128, totaltime=0.002,
                               sprint_steps=500)


class TestCheckpointResumeHardware:
    def test_pallas_resume_matches_uninterrupted(self, p, tmp_path):
        """Checkpoint at sprint 2 of 4 under the production engine,
        resume in a fresh runner: final walker state must be bitwise
        identical (the counter-based Threefry stream is keyed by (seed,
        step, walker), so a resume replays the exact stream)."""
        ckpt = str(tmp_path / "hw.npz")
        full = SimulationRunner(p, scene_seed=3, seed=4, engine="pallas")
        _, cos_full, _, _ = full.run()

        first = SimulationRunner(p, scene_seed=3, seed=4, engine="pallas")
        first.run(max_steps=2 * p.sprint_steps, checkpoint_path=ckpt)

        second = SimulationRunner(p, scene_seed=3, seed=4, engine="pallas")
        second.resume(ckpt)
        _, cos_rest, _, _ = second.run()

        np.testing.assert_array_equal(np.asarray(second.state.pos),
                                      np.asarray(full.state.pos))
        np.testing.assert_array_equal(np.asarray(second.state.phase),
                                      np.asarray(full.state.phase))
        n_rest = len(cos_rest)
        np.testing.assert_allclose(cos_full[-n_rest:], cos_rest,
                                   atol=1e-4)


class TestEnsembleHardware:
    def test_pallas_ensemble_matches_scan(self, p):
        """run_ensemble on the production pallas engine vs the scan
        engine under the shared Threefry streams: identical trials."""
        from mri_nanoparticle_simulation_tpu.parallel import ensemble
        _, cos_p, _, st_p = ensemble.run_ensemble(
            p, n_trials=2, base_seed=0, run_seed=50, engine="pallas",
            rng_impl="threefry")
        _, cos_s, _, st_s = ensemble.run_ensemble(
            p, n_trials=2, base_seed=0, run_seed=50, engine="scan")
        np.testing.assert_allclose(np.asarray(st_p.pos),
                                   np.asarray(st_s.pos), atol=1e-4)
        np.testing.assert_allclose(cos_p, cos_s, atol=0.05)

    def test_ensemble_cli_smoke(self, p, tmp_path):
        """--ensemble through main() end-to-end on the chip."""
        out = str(tmp_path / "ens.csv")
        rc = sim.main(["--num-water", "128", "--num-cells", "12",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "1000", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--ensemble", "2", "--out", out])
        assert rc == 0
        t, c = wr.read_t2_csv(out)   # CLI default pfreq=1000 -> 2 rows
        assert len(t) == 2 and np.isfinite(c).all()


class TestSweepCliHardware:
    def test_sweep_cli_smoke(self, p, tmp_path):
        """--sweep mmoment through main(): one compiled program, one CSV
        per value, finite physics in each."""
        import os
        out = str(tmp_path / "sw.csv")
        rc = sim.main(["--num-water", "128", "--num-cells", "12",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "1000", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--sweep", "mmoment",
                       "--sweep-values", "0,3.5e-16", "--out", out])
        assert rc == 0
        stem = str(tmp_path / "sw")
        paths = [f"{stem}_mmoment=0.csv", f"{stem}_mmoment=3.5e-16.csv"]
        assert all(os.path.exists(q) for q in paths)
        _, c0 = wr.read_t2_csv(paths[0])
        _, c1 = wr.read_t2_csv(paths[1])
        # mmoment=0: no dipole field, phase stays at the kick-only value
        assert np.abs(c1 - 128.0).max() >= np.abs(c0 - 128.0).max()


class TestGridOracleHardware:
    def test_grid_backend_curve_matches_exact(self, p):
        """The FIELD_GRID oracle (the reference octree's direct
        analogue) vs the exact brute-force field, both on the chip."""
        pv = p.replace(num_water=64, mmoment=3.5e-15)
        sc = BacteriaBox(pv, seed=5).populate()
        _, ce, _, ste = re.run_simulation(
            sc, pv.replace(field_mode=P.FIELD_EXACT), seed=3)
        _, cg, _, stg = re.run_simulation(
            sc, pv.replace(field_mode=P.FIELD_GRID, grid_n=64), seed=3)
        d = np.abs(np.mod(np.asarray(ste.pos), pv.bound)
                   - np.asarray(stg.pos))
        d = np.minimum(d, pv.bound - d)
        np.testing.assert_allclose(d, 0.0, atol=1e-4)
        err = np.abs(np.asarray(ce) - np.asarray(cg)) / pv.num_water
        assert np.sqrt((err ** 2).mean()) < 2e-3


class TestBigScenePathHardware:
    def test_fused_recand_with_live_far_table(self):
        """The big-scene path (XLA rebuild feeding the kernel) on the card
        with a NON-trivial far table (the production big-scene
        configuration; test_pallas.py's on-card test pins the far table
        to zero via an exact partition).  Tolerance = the far-table
        truncation bound measured in tests/test_fields.py::TestFarTable."""
        pv = P.small_test_params(num_water=128, totaltime=0.001,
                                 sprint_steps=500, mmoment=3.5e-15,
                                 cube_hash_dim=4, cube_candidates=48,
                                 far_table_order=5)
        sc = BacteriaBox(pv, seed=3).populate()
        need = expansion.validate_cube_candidates(sc.mnps[:, :3], pv)
        assert need <= pv.cube_candidates
        mp = jnp.asarray(np.asarray(sc.mnps[:, :3], np.float32))
        mM = jnp.asarray(np.asarray(sc.mnps[:, 4], np.float32))
        cache = expansion.build_cache(mp, mM, pv)
        assert cache.far_coeffs is not None
        sprint = pe.make_sprint_fn(pv, 128)
        kk = rng.key_from_seed(9)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps = pe.to_planes(re.init_state(sc.waters, pv), pv)
        outs = []
        for _ in range(pv.t // pv.sprint_steps):
            ps, wins = sprint(mp, mM, key_arr, ps, 0, cache)
            outs.append(wins)
        wins = np.asarray(jnp.concatenate(outs, axis=0))
        st = pe.from_planes(ps, 128)
        _, c2, _, st2 = re.run_simulation(sc, pv, seed=9)
        np.testing.assert_allclose(np.asarray(st.pos),
                                   np.asarray(st2.pos), atol=1e-3)
        np.testing.assert_allclose(wins[:, 0], c2, atol=0.1)


class TestCoverageSentinelHardware:
    """The runtime residency counter (reference DEBUG_TREE asserts,
    octree.cpp:39-41) through the compiled kernel — both kernel
    modes."""

    def _dense(self, near_k):
        return P.small_test_params(near_k=near_k, chunk_steps=200,
                                   num_cells=20, cell_r=0.9, bound=8.0,
                                   water_start_bound=7.0,
                                   totaltime=0.001, sprint_steps=1000,
                                   taucp=0.0002)

    def test_undersized_k_counts_violations(self):
        p = self._dense(near_k=1)
        sc = BacteriaBox(p, seed=2).populate()
        assert expansion.validate_near_k(sc.mnps[:, :3], p) > 1
        _, _, _, st = pe.run_simulation(sc, p, seed=3)
        assert int(np.asarray(st.coverage)) > 0

    def test_validated_k_counts_zero(self):
        p = self._dense(near_k=1)
        sc = BacteriaBox(p, seed=2).populate()
        need = expansion.validate_near_k(sc.mnps[:, :3], p)
        _, _, _, st = pe.run_simulation(sc, p.replace(near_k=need),
                                        seed=3)
        assert int(np.asarray(st.coverage)) == 0


class TestAotWarmStartHardware:
    def test_aot_roundtrip_bitwise(self, p, tmp_path, monkeypatch):
        """serialize -> fresh deserialize -> identical windows, and the
        executable cache round-trips through disk on the real backend."""
        from mri_nanoparticle_simulation_tpu.engine import aot
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        sc = BacteriaBox(p, seed=3).populate()
        mp = jnp.asarray(np.asarray(sc.mnps[:, :3], np.float32))
        mM = jnp.asarray(np.asarray(sc.mnps[:, 4], np.float32))
        kk = rng.key_from_seed(5)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps0 = pe.to_planes(re.init_state(sc.waters, p), p)

        base = pe.make_sprint_fn(p, p.num_water)
        saved = aot.compile_and_save(
            base.inner, p, p.num_water,
            (mp, mM, key_arr, ps0, 0), jnp.float32, "threefry")
        assert saved is not None, "backend refused serialization"
        loaded = aot.load_sprint(p, p.num_water, int(mp.shape[0]),
                                 jnp.float32, "threefry")
        assert loaded is not None

        _, w_jit = base(mp, mM, key_arr, ps0, 0)
        _, w_aot = loaded(mp, mM, key_arr, ps0, 0)
        np.testing.assert_array_equal(np.asarray(w_jit),
                                      np.asarray(w_aot))


class TestResilienceHardware:
    def test_recovery_bitwise_on_chip(self, p, tmp_path):
        """Two injected faults under the production engine on the real
        chip: the recovered CSV must be bitwise-identical to an
        uninterrupted run (counter RNG resumes the exact sequence)."""
        from mri_nanoparticle_simulation_tpu.engine import resilience

        def mk():
            return SimulationRunner(p, scene_seed=3, seed=4,
                                    engine="pallas", rng_impl="threefry")

        base_csv = str(tmp_path / "base.csv")
        mk().run(csv_path=base_csv, progress=False)
        rec_csv = str(tmp_path / "rec.csv")
        inj = resilience.FaultInjector({1: 1, 3: 1})
        _, _, _, stats = resilience.run_resilient(
            mk, csv_path=rec_csv, checkpoint_path=str(tmp_path / "c.npz"),
            checkpoint_every_sprints=1, drain_depth=1, max_retries=2,
            fault_hook=inj, progress=False)
        assert stats["recovery_attempts"] == 2
        assert open(rec_csv).read() == open(base_csv).read()


class TestMultiBlockHardware:
    """Populations of many kernel programs (one per BLOCK_WALKERS
    walkers) on the card: the per-program coverage and window-sum
    outputs are written by every program and added up by XLA."""

    def test_two_blocks_in_kernel_rebuild(self):
        """8192 walkers (256 programs), global-selection rebuild: windows
        must equal the scan engine's under shared Threefry streams."""
        p = P.small_test_params(num_water=8192, num_cells=12,
                                totaltime=0.0005, sprint_steps=500,
                                chunk_steps=500, taucp=0.0002)
        sc = BacteriaBox(p, seed=7).populate()
        _, cos_p, _, st_p = pe.run_simulation(sc, p, seed=11)
        _, cos_s, _, st_s = re.run_simulation(sc, p, seed=11)
        np.testing.assert_allclose(np.asarray(st_p.pos),
                                   np.asarray(st_s.pos), atol=1e-4)
        np.testing.assert_allclose(cos_p, cos_s, atol=0.05)
        assert int(np.asarray(st_p.coverage)) == \
            int(np.asarray(st_s.coverage))

    def test_two_blocks_big_scene_path(self, monkeypatch):
        """Same population through the cube-candidate rebuild (the
        big-scene path, forced by declaring every scene large)."""
        p = P.small_test_params(num_water=8192, num_cells=12,
                                totaltime=0.0005, sprint_steps=500,
                                chunk_steps=500, taucp=0.0002)
        sc = BacteriaBox(p, seed=7).populate()
        monkeypatch.setattr(expansion, "uses_large_path", lambda w, n: True)
        _, cos_p, _, st_p = pe.run_simulation(sc, p, seed=11)
        _, cos_s, _, st_s = re.run_simulation(sc, p, seed=11)
        np.testing.assert_allclose(np.asarray(st_p.pos),
                                   np.asarray(st_s.pos), atol=1e-4)
        np.testing.assert_allclose(cos_p, cos_s, atol=0.05)

    def test_full_height_block_with_reflection(self):
        """4096 walkers with membrane reflection enabled: the reflect
        branch's boolean crossing logic and selects must compile and
        match the scan engine under shared Threefry streams."""
        p = P.small_test_params(num_water=4096, num_cells=12,
                                totaltime=0.0005, sprint_steps=500,
                                chunk_steps=500, taucp=0.0002)
        p = p.with_permeability().validate()
        assert p.reflect_io > 0
        sc = BacteriaBox(p, seed=7).populate()
        _, cos_p, _, st_p = pe.run_simulation(sc, p, seed=11)
        _, cos_s, _, st_s = re.run_simulation(sc, p, seed=11)
        np.testing.assert_allclose(np.asarray(st_p.pos),
                                   np.asarray(st_s.pos), atol=1e-4)
        np.testing.assert_allclose(cos_p, cos_s, atol=0.05)


class TestSceneFamiliesHardware:
    def test_fcc_scene_through_pallas(self, p):
        """FCC lattice scene family end-to-end on the production
        engine: full step count, clean coverage sentinel."""
        from mri_nanoparticle_simulation_tpu.scene import FCCLatticeBox
        sc = FCCLatticeBox(p, seed=1).populate()
        r = SimulationRunner(p, seed=2, engine="pallas", scene=sc)
        _, cos, _, stats = r.run(progress=False)
        assert stats["steps"] == p.t
        assert stats["coverage_violations"] == 0
        assert np.all(np.abs(cos) <= p.num_water)


class TestDecomposeHardware:
    def test_decompose_kernel_reconstructs_on_chip(self):
        """The decompose variant of the production kernel (8 state
        planes, per-walker window output) through the Triton
        compiler: its (A, B) record must reconstruct a direct
        scaled-moment Pallas run's curve in closed form."""
        from mri_nanoparticle_simulation_tpu.engine import decompose as dec
        from mri_nanoparticle_simulation_tpu.params import small_test_params
        pp = small_test_params(num_water=128, mmoment=2e-14,
                               avoid_intracellular_throw=False)
        sc = BacteriaBox(pp, seed=3).populate()
        rec = dec.run_decomposition(sc, pp, seed=5, engine="pallas")
        assert rec.stats["coverage_violations"] == 0

        mnps = sc.mnps.copy()
        mnps[:, 4] *= 1.6

        class _Scaled:
            waters = sc.waters
        _Scaled.mnps = mnps
        _, cos_d, _, _ = pe.run_simulation(_Scaled(), pp, seed=5)
        rec_curve = np.mean(np.cos(1.6 * rec.A + rec.B), axis=-1)
        np.testing.assert_allclose(rec_curve, cos_d / 128, atol=5e-5)


class TestEchoPlaneHardware:
    def test_taucp_reconstruction_on_chip(self):
        """The echo axis from the SAME on-chip decomposition record:
        curves_at_plane at a different taucp must match a direct Pallas
        run at that taucp (trajectories are taucp-invariant, so the
        comparison is f32 rounding on identical RNG streams)."""
        from mri_nanoparticle_simulation_tpu.engine import decompose as dec
        from mri_nanoparticle_simulation_tpu.params import small_test_params
        pp = small_test_params(num_water=128, mmoment=2e-14,
                               avoid_intracellular_throw=False)
        sc = BacteriaBox(pp, seed=3).populate()
        rec = dec.run_decomposition(sc, pp, seed=5, engine="pallas")
        plane = dec.curves_at_plane(rec.A, rec.B, [1.0], [0.001], pp)
        pt = pp.replace(taucp=0.001).validate()
        _, cos_d, _, _ = pe.run_simulation(sc, pt, seed=5)
        np.testing.assert_allclose(plane[0, 0], cos_d / 128, atol=5e-5)


class TestUncertaintyHardware:
    def test_bootstrap_and_schedule_from_chip_record(self):
        """The new uncertainty + schedule surfaces against a record the
        REAL production kernel produced on the card: the walker
        bootstrap yields a finite, deterministic CI around the point
        fit, and an arbitrary pulse train reconstructs with its periodic
        special case matching the taucp-grid path bitwise."""
        from mri_nanoparticle_simulation_tpu.engine import decompose as dec
        from mri_nanoparticle_simulation_tpu.params import small_test_params
        pp = small_test_params(num_water=256, num_cells=12,
                               totaltime=0.02, sprint_steps=2000,
                               taucp=0.001, mmoment=2e-14,
                               avoid_intracellular_throw=False)
        sc = BacteriaBox(pp, seed=3).populate()
        rec = dec.run_decomposition(sc, pp, seed=5, engine="pallas",
                                    )
        b = dec.bootstrap_t2(rec.A, rec.B, pp, n_boot=32, seed=1)
        assert b.t2_lo_ms < b.t2_hi_ms
        assert b.t2_stderr_ms > 0 and b.n_ok == 32
        med = float(np.median(b.t2_samples))
        assert b.t2_lo_ms < med < b.t2_hi_ms
        assert abs(b.fit.t2_ms - med) < 4 * b.t2_stderr_ms
        b2 = dec.bootstrap_t2(rec.A, rec.B, pp, n_boot=32, seed=1)
        np.testing.assert_array_equal(b.t2_samples, b2.t2_samples)

        dA, dB = dec.window_increments(rec.A, rec.B, pp)
        n = dA.shape[0]
        period = pp.replace(taucp=0.002).validate().tcp // pp.pfreq
        sched = list(range(period, n + 1, period))
        via_grid = dec.reconstruct_curves(dA, dB, [1.0], [0.002], pp)
        via_sched = dec.reconstruct_at_schedule(dA, dB, [1.0], [sched])
        np.testing.assert_allclose(via_sched, via_grid, rtol=0,
                                   atol=1e-12)


class TestStreamingPlaneHardware:
    def test_streamed_consumer_matches_chip_record(self):
        """StreamingPlane as the run_decomposition consumer against the
        REAL production kernel's drains: the incrementally-reconstructed
        plane (and in-stream echo capture) must match the record-based
        batch reconstruction of an identical chip run."""
        from mri_nanoparticle_simulation_tpu.engine import decompose as dec
        from mri_nanoparticle_simulation_tpu.params import small_test_params
        pp = small_test_params(num_water=128, totaltime=0.004,
                               sprint_steps=1000, mmoment=2e-14,
                               avoid_intracellular_throw=False)
        sc = BacteriaBox(pp, seed=3).populate()
        scales, taucps = [0.5, 1.0], [pp.taucp, 0.001]
        plane = dec.StreamingPlane(pp, pp.t // pp.pfreq, scales, taucps,
                                   quadrature=True,
                                   echo_pairs=[(1.0, 0.001)])
        res = dec.run_decomposition(sc, pp, seed=5, engine="pallas",
                                    consumer=plane)
        assert res.A.shape[0] == 0      # nothing materialized
        rec = dec.run_decomposition(sc, pp, seed=5, engine="pallas")
        batch = dec.curves_at_plane(rec.A, rec.B, scales, taucps, pp,
                                    quadrature=True)
        np.testing.assert_allclose(plane.result(), batch, rtol=0,
                                   atol=1e-12)
        te_s, mat_s = plane.echo_matrix()
        te_b, mat_b = dec.echo_cos_matrix(rec.A, rec.B, pp, taucp=0.001)
        np.testing.assert_array_equal(te_s, te_b)
        np.testing.assert_allclose(mat_s, mat_b, rtol=0, atol=1e-12)


class TestMomentScalesCliHardware:
    def test_moment_scales_cli_smoke(self, tmp_path):
        """--moment-scales end-to-end on the chip: ONE decomposition run
        of the production kernel, one reference-schema CSV per scale."""
        out = str(tmp_path / "dec.csv")
        rc = sim.main(["--num-water", "128", "--num-cells", "8",
                       "--totaltime", "0.002", "--sprint-steps", "500",
                       "--chunk-steps", "100", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--mmoment", "3.5e-13", "--out", out,
                       "--moment-scales", "1,2"])
        assert rc == 0
        d1 = np.loadtxt(str(tmp_path / "dec_mscale=1.csv"), delimiter=",")
        d2 = np.loadtxt(str(tmp_path / "dec_mscale=2.csv"), delimiter=",")
        assert d1.shape == (2, 2) and d2.shape == (2, 2)
        assert np.all(np.abs(d1[:, 1]) <= 128.0 + 1e-4)
        # the doubled moment dephases measurably faster (pre-echo window:
        # the CP flip at step 1000 refocuses most of window 2's phase)
        assert d2[0, 1] < d1[0, 1]


class TestInverseHardware:
    def test_moment_recovery_on_chip(self):
        """Inverse relaxometry through the real compiler: reverse-mode
        AD over the full simulation (every diffusion step, field eval,
        kick and CP flip) must recover a hidden moment scale on the
        chip, the whole Adam loop one jitted lax.scan with
        jax.checkpoint-ed sprints."""
        from mri_nanoparticle_simulation_tpu import inverse as inv
        from mri_nanoparticle_simulation_tpu.params import small_test_params
        pp = small_test_params(num_water=64, mmoment=2e-14)
        sc = BacteriaBox(pp, seed=1).populate()
        target = np.asarray(inv.make_curve_fn(pp, sc, seed=2)(1.4))
        fit = inv.fit_moment_scale(target, pp, sc, seed=2, iters=60)
        assert abs(fit.scale - 1.4) / 1.4 < 0.03
        assert fit.loss < fit.loss_history[0] * 1e-2


class TestDiffusionAxisHardware:
    """The d_scale launch scalar in the compiled kernel: the
    runtime D axis on the production kernel, end to end."""

    def test_d_sweep_matches_static_scaled_params(self, p):
        """--sweep D semantics on-chip: each swept value's Pallas curve
        equals a statically-compiled run with D_cell/D_extra scaled
        (0.25 is a power of four, so sqrt(d_scale) and the stdev fold
        are exact in f32)."""
        from mri_nanoparticle_simulation_tpu.parallel import ensemble
        vals = [1.0, 0.25]
        _, curves = ensemble.run_parameter_sweep(
            p, "D", vals, n_trials_each=1, engine="pallas",
            rng_impl="threefry")
        for i, v in enumerate(vals):
            pv = p.replace(D_cell=p.D_cell * v,
                           D_extra=p.D_extra * v).validate()
            sc = BacteriaBox(p, seed=i).populate()
            _, c2, _, _ = pe.run_simulation(sc, pv, seed=1000 + i)
            np.testing.assert_allclose(curves[i, 0], c2, atol=1e-3)

    def test_crn_adc_fit_on_chip(self):
        """Production-path ADC recovery: golden-section over the launch
        scalar, every evaluation a full Pallas forward run through the
        real compiler with common random numbers (ONE compiled program
        for the whole fit)."""
        from mri_nanoparticle_simulation_tpu import inverse as inv
        pp = P.small_test_params(num_water=64, mmoment=5e-14)
        sc = BacteriaBox(pp, seed=1).populate()
        target = np.asarray(inv.make_engine_curve_fn(
            pp, sc, seed=2, engine="pallas")(0.6))
        fit = inv.fit_diffusion_scale_crn(
            target, pp, sc, seed=2, bracket=(0.2, 1.0), iters=16,
            engine="pallas")
        assert abs(fit.scale - 0.6) / 0.6 < 0.02
        assert fit.loss < 1e-6


class TestGridAotHardware:
    def test_grid_repeat_bitwise_with_ensemble_aot(self, p, tmp_path,
                                                   monkeypatch):
        """--sweep-grid semantics under the real compiler, twice with a
        fresh AOT cache: run 1 compiles + serializes the ensemble
        program, run 2 deserializes it — curves must be bitwise
        identical across the two paths."""
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        from mri_nanoparticle_simulation_tpu.parallel import ensemble
        axes = {"D": [1.0, 0.25], "taucp": [0.001, 0.002]}
        _, c1 = ensemble.run_parameter_grid(
            p, axes, engine="pallas", rng_impl="threefry", paired=True)
        _, c2 = ensemble.run_parameter_grid(
            p, axes, engine="pallas", rng_impl="threefry", paired=True)
        assert c1.shape == (2, 2, 1, 20)
        np.testing.assert_array_equal(c1, c2)


class TestCustomSceneHardware:
    def test_scene_file_geometry_through_pallas(self, tmp_path):
        """A user-provided geometry (scene.CustomBox — the --scene-file
        path) through the real compiler, with a checkpoint round trip
        whose scene-content fingerprint must hold."""
        from mri_nanoparticle_simulation_tpu.io import checkpoint as ck
        from mri_nanoparticle_simulation_tpu.scene import CustomBox
        pp = P.small_test_params(num_water=128, totaltime=0.002,
                                 sprint_steps=500, num_cells=3,
                                 near_k=3)
        centers = np.array([[2.0, 2.0, 2.0], [5.0, 5.0, 5.0],
                            [2.0, 5.5, 3.0]])
        sc = CustomBox(pp, centers, seed=1).populate()
        ckpt = str(tmp_path / "c.npz")
        r1 = SimulationRunner(pp, scene_seed=1, seed=2, engine="pallas",
                              scene=sc)
        _, cos, _, _ = r1.run(checkpoint_path=ckpt)
        assert np.isfinite(cos).all()
        # resume with a shifted geometry must be refused on content
        sc_b = CustomBox(pp, centers + 0.25, seed=1).populate()
        r2 = SimulationRunner(pp, scene_seed=1, seed=2, engine="pallas",
                              scene=sc_b)
        with pytest.raises(ValueError, match="different scene"):
            r2.resume(ckpt)


class TestDurableRecordHardware:
    def test_record_store_crash_resume_on_chip(self, tmp_path):
        """The disk-backed decomposition record (io/record.py) on the
        REAL production kernel: a mid-run fault, then a resume from the
        checkpoint (trimming the committed record overhang), must end
        bitwise-identical to an uninterrupted durable run — the
        long-record production workflow, on the card."""
        from mri_nanoparticle_simulation_tpu.engine import decompose as dec
        from mri_nanoparticle_simulation_tpu.engine.resilience import \
            FaultInjector
        from mri_nanoparticle_simulation_tpu.io import record as record_mod
        pp = P.small_test_params(num_water=128, mmoment=2e-14,
                                 avoid_intracellular_throw=False,
                                 sprint_steps=500, totaltime=0.003)
        sc = BacteriaBox(pp, seed=3).populate()
        plain = dec.run_decomposition_durable(
            sc, pp, str(tmp_path / "plain"), seed=5, engine="pallas")
        d = str(tmp_path / "rec")
        ck = str(tmp_path / "ck.npz")
        hook = FaultInjector({4: 1})
        with pytest.raises(RuntimeError, match="injected fault"):
            dec.run_decomposition_durable(
                sc, pp, d, seed=5, engine="pallas", checkpoint_path=ck,
                checkpoint_every_sprints=2, fault_hook=hook)
        assert not record_mod.RecordStore.open(d).complete
        res = dec.run_decomposition_durable(
            sc, pp, d, seed=5, engine="pallas", checkpoint_path=ck,
            checkpoint_every_sprints=2)
        np.testing.assert_array_equal(np.asarray(res.A),
                                      np.asarray(plain.A))
        np.testing.assert_array_equal(np.asarray(res.B),
                                      np.asarray(plain.B))
        assert res.stats == plain.stats

    def test_streaming_snapshot_resume_on_chip(self, tmp_path):
        """Durable --stream-plane (walker + plane state in one atomic
        snapshot) on the real kernel: crash, resume with a fresh plane,
        bitwise-equal curves."""
        from mri_nanoparticle_simulation_tpu.engine import decompose as dec
        from mri_nanoparticle_simulation_tpu.engine.resilience import \
            FaultInjector
        pp = P.small_test_params(num_water=128, mmoment=2e-14,
                                 avoid_intracellular_throw=False,
                                 sprint_steps=500, totaltime=0.003)
        sc = BacteriaBox(pp, seed=3).populate()

        def plane():
            return dec.StreamingPlane(pp, pp.t // pp.pfreq, [0.5, 1.0],
                                      quadrature=True)
        ref = plane()
        dec.run_streaming_durable(sc, pp, ref,
                                  str(tmp_path / "ref.npz"), seed=5,
                                  engine="pallas")
        snap = str(tmp_path / "snap.npz")
        broken = plane()
        with pytest.raises(RuntimeError, match="injected fault"):
            dec.run_streaming_durable(
                sc, pp, broken, snap, seed=5, engine="pallas",
                snapshot_every_sprints=2,
                fault_hook=FaultInjector({4: 1}))
        resumed = plane()
        dec.run_streaming_durable(sc, pp, resumed, snap, seed=5,
                                  engine="pallas", snapshot_every_sprints=2)
        np.testing.assert_array_equal(resumed.result(), ref.result())


class TestDevicePlaneHardware:
    def test_plane_on_device_matches_host(self):
        """run_plane_on_device through the compiled kernel: the
        on-device f32+Kahan plane must match the float64 host
        StreamingPlane fed by the same engine's drained record."""
        from mri_nanoparticle_simulation_tpu.engine import decompose as dec
        pp = P.small_test_params(num_water=128, mmoment=2e-14,
                                 avoid_intracellular_throw=False)
        sc = BacteriaBox(pp, seed=3).populate()
        taucps = [pp.taucp, 0.001]
        scales = [0.5, 1.0, 2.0]
        pairs = [(1.0, pp.taucp)]
        plane = dec.StreamingPlane(pp, pp.t // pp.pfreq, scales, taucps,
                                   quadrature=True, echo_pairs=pairs)
        dec.run_decomposition(sc, pp, seed=5, engine="pallas",
                              consumer=plane)
        _, dev, stats, echoes = dec.run_plane_on_device(
            sc, pp, scales, taucps, seed=5, engine="pallas",
            echo_pairs=pairs)
        np.testing.assert_allclose(dev, plane.result(), atol=1e-4)
        assert stats["coverage_violations"] == 0
        # the on-device echo capture matches the host one and feeds
        # the walker bootstrap — production-speed error bars, no record
        te_h, mat_h = plane.echo_matrix(0)
        np.testing.assert_allclose(echoes[0].cos, mat_h, atol=1e-4)


class TestNewInverseAxesHardware:
    def test_joint_crn_fit_on_chip(self):
        """Joint (moment, D) Nelder-Mead through the compiled kernel:
        the moment rides the traced mnp_M array and D the launch scalar,
        so EVERY probe of the 2D CRN surface reuses one compiled
        program."""
        from mri_nanoparticle_simulation_tpu import inverse as inv
        pp = P.small_test_params(num_water=64, mmoment=5e-14)
        sc = BacteriaBox(pp, seed=1).populate()
        target = np.asarray(inv.make_engine_curve_fn(
            pp, sc, seed=2, engine="pallas")(0.5, m_scale=1.6))
        fit = inv.fit_joint_crn(target, pp, sc, seed=2,
                                m_bracket=(0.25, 4.0),
                                d_bracket=(0.1, 1.0), max_evals=60,
                                engine="pallas")
        assert abs(fit.m_scale - 1.6) / 1.6 < 0.05
        assert abs(fit.d_scale - 0.5) / 0.5 < 0.05
        assert fit.loss < 1e-6

    def test_cell_radius_crn_fit_on_chip(self):
        """Cell-size recovery on the production kernel: the cell_r
        launch scalar varies the residency radius on a fixed scene."""
        from mri_nanoparticle_simulation_tpu import inverse as inv
        pp = P.small_test_params(num_water=64, mmoment=5e-14)
        sc = BacteriaBox(pp, seed=1).populate()
        worst = expansion.validate_near_k(sc.mnps[:, :3],
                                          pp.replace(cell_r=1.0))
        if worst > pp.near_k:
            pp = pp.replace(near_k=worst)
        target = np.asarray(inv.make_engine_curve_fn(
            pp, sc, seed=2, engine="pallas")(cell_r=0.7))
        fit = inv.fit_cell_radius_crn(target, pp, sc, seed=2,
                                      bracket=(0.4, 1.0), iters=14,
                                      engine="pallas")
        assert abs(fit.scale - 0.7) / 0.7 < 0.02
        assert fit.loss < 1e-6

    def test_run_cell_rs_ensemble_on_chip(self, p):
        """run_cell_rs (fixed geometry, runtime residency radius — the
        golden cell_r arm's framework side) through the production
        ensemble path: identity at the params radius, real effect at an
        override."""
        from mri_nanoparticle_simulation_tpu.parallel import ensemble
        pp = p.replace(mmoment=5e-14)
        _, cos0, _, _ = ensemble.run_ensemble(
            pp, n_trials=2, base_seed=3, run_seed=9, engine="pallas")
        _, cos1, _, _ = ensemble.run_ensemble(
            pp, n_trials=2, base_seed=3, run_seed=9, engine="pallas",
            run_cell_rs=[pp.cell_r, pp.cell_r])
        np.testing.assert_array_equal(cos0, cos1)
        _, cos2, _, _ = ensemble.run_ensemble(
            pp, n_trials=2, base_seed=3, run_seed=9, engine="pallas",
            run_cell_rs=[0.8, 0.8])
        assert np.abs(cos2 - cos0).max() > 1e-3


class TestGradientHardware:
    def test_carr_purcell_analytic_on_chip(self):
        """The background-gradient CPMG attenuation against the
        Carr-Purcell closed form, through the compiled kernel — an
        analytic physics anchor executed at production speed on the
        card."""
        D = 1.0
        # 2048 walkers: the 512-walker/5-echo estimator's sampling
        # scatter is ~7-10% (one RNG stream measured 14.6%);
        # 4x walkers halves it, and the 15% gate sits near 2 sigma
        pp = P.small_test_params(
            num_water=2048, num_cells=4, totaltime=0.02,
            sprint_steps=2000, taucp=0.002, mmoment=0.0,
            phase_k=0.0, D_cell=D, D_extra=D)
        from mri_nanoparticle_simulation_tpu import analysis as an
        r2_target = 100.0
        gz = an.design_gradient_for_r2(pp, r2_target, D=D)
        pp = pp.replace(b0_gradient=(0.0, 0.0, gz)).validate()
        sc = BacteriaBox(pp, seed=5).populate()
        runner = SimulationRunner(pp, scene_seed=5, seed=7,
                                  engine="pallas", scene=sc)
        times, cos, _, stats = runner.run()
        assert stats["escapes"] == 0
        te, me = an.sample_at_echoes(times, np.asarray(cos), pp.taucp)
        fit = an.fit_t2(te, me / pp.num_water, floor=0.0)
        r2_fit = 1.0 / fit.t2_ms
        assert abs(r2_fit - r2_target) / r2_target < 0.15
