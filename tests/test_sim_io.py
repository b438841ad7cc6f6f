"""Orchestrator, CSV streaming, checkpoint/resume."""

import numpy as np
import pytest

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu.engine import sim
from mri_nanoparticle_simulation_tpu.engine.sim import SimulationRunner
from mri_nanoparticle_simulation_tpu.io import checkpoint as ck
from mri_nanoparticle_simulation_tpu.io import writer as wr


@pytest.fixture(scope="module")
def p():
    return P.small_test_params(num_water=64, totaltime=0.002,
                               sprint_steps=500)


class TestRunner:
    def test_full_run_csv(self, p, tmp_path):
        path = str(tmp_path / "t2.csv")
        r = SimulationRunner(p, scene_seed=1, seed=2, engine="scan")
        times, cos, sin, stats = r.run(csv_path=path)
        assert stats["steps"] == p.t
        assert len(times) == p.t // p.pfreq
        t2, c2 = wr.read_t2_csv(path)
        np.testing.assert_allclose(t2, times, rtol=1e-12)
        np.testing.assert_allclose(c2, cos, rtol=1e-6)

    def test_quadrature_column(self, p, tmp_path):
        path = str(tmp_path / "t2q.csv")
        r = SimulationRunner(p, scene_seed=1, seed=2, engine="scan")
        _, cos, sin, _ = r.run(csv_path=path, quadrature=True)
        t2, c2, s2 = wr.read_t2_csv(path)
        np.testing.assert_allclose(s2, sin, rtol=1e-6)

    def test_resume_matches_uninterrupted(self, p, tmp_path):
        """checkpoint at sprint 2 of 4, resume in a fresh runner -> final
        state identical to the uninterrupted run (counter-based RNG)."""
        ckpt = str(tmp_path / "state.npz")
        full = SimulationRunner(p, scene_seed=3, seed=4, engine="scan")
        _, cos_full, _, _ = full.run()

        first = SimulationRunner(p, scene_seed=3, seed=4, engine="scan")
        first.run(max_steps=2 * p.sprint_steps,
                  checkpoint_path=ckpt)

        second = SimulationRunner(p, scene_seed=3, seed=4, engine="scan")
        second.resume(ckpt)
        _, cos_rest, _, _ = second.run()

        np.testing.assert_array_equal(np.asarray(second.state.pos),
                                      np.asarray(full.state.pos))
        np.testing.assert_array_equal(np.asarray(second.state.phase),
                                      np.asarray(full.state.phase))
        n_rest = len(cos_rest)
        np.testing.assert_allclose(cos_full[-n_rest:], cos_rest, atol=1e-4)

    def test_resume_rejects_wrong_params(self, p, tmp_path):
        ckpt = str(tmp_path / "state2.npz")
        r = SimulationRunner(p, scene_seed=3, seed=4, engine="scan")
        r.run(max_steps=p.sprint_steps, checkpoint_path=ckpt)
        p2 = p.replace(mmoment=1e-18)
        r2 = SimulationRunner(p2, scene_seed=3, seed=4, engine="scan")
        with pytest.raises(ValueError, match="different parameters"):
            r2.resume(ckpt)

    def test_coverage_guard(self):
        """A dense scene with tiny K must be rejected up front."""
        p = P.small_test_params(num_water=16, num_cells=40, bound=7.0,
                                water_start_bound=5.0, near_k=1,
                                chunk_steps=1000, print_interval=0.001,
                                totaltime=0.002, sprint_steps=1000,
                                taucp=0.001)
        with pytest.raises(ValueError, match="near_k"):
            SimulationRunner(p, engine="scan")


class TestCheckpointFormat:
    def test_roundtrip(self, p, tmp_path):
        from mri_nanoparticle_simulation_tpu.engine.reference_engine import \
            init_state
        from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
        sc = BacteriaBox(p, seed=9).populate()
        st = init_state(sc.waters, p)
        path = str(tmp_path / "c.npz")
        ck.save_checkpoint(path, st, p, seed=1, scene_seed=9)
        st2, seed, scene_seed = ck.load_checkpoint(path, p)
        assert (seed, scene_seed) == (1, 9)
        np.testing.assert_array_equal(np.asarray(st.pos),
                                      np.asarray(st2.pos))


class TestFilename:
    def test_reference_convention(self):
        name = P.DEFAULT.output_filename(1700000000)
        assert name == ("tau=1000ps_T-e=11largedipole_border=6um_"
                        "impermeablemultitrial1700000000.csv")


class TestResumeCsv:
    def test_resume_appends_not_truncates(self, p, tmp_path):
        """A resumed run must append to the existing CSV, not wipe the
        rows streamed before the crash."""
        csv = str(tmp_path / "t2r.csv")
        ckpt = str(tmp_path / "s.npz")
        first = SimulationRunner(p, scene_seed=3, seed=4, engine="scan")
        first.run(max_steps=2 * p.sprint_steps, csv_path=csv,
                  checkpoint_path=ckpt)
        rows_before = len(open(csv).readlines())
        second = SimulationRunner(p, scene_seed=3, seed=4, engine="scan")
        second.resume(ckpt)
        second.run(csv_path=csv)
        rows = open(csv).readlines()
        assert len(rows) == p.t // p.pfreq
        assert len(rows) > rows_before
        # times strictly increasing across the seam
        ts = [float(r.split(",")[0]) for r in rows]
        assert all(b > a for a, b in zip(ts, ts[1:]))


class TestRunnerMesh:
    def test_runner_sharded_pallas_matches_unsharded(self, tmp_path):
        """SimulationRunner(mesh=...) runs the production engine sharded;
        results equal the single-device runner (threefry mode)."""
        import jax
        from mri_nanoparticle_simulation_tpu.engine import pallas_engine
        from mri_nanoparticle_simulation_tpu.parallel import sharding
        p = P.small_test_params(num_water=64, totaltime=0.001,
                                sprint_steps=500, mmoment=3.5e-15)
        mesh = sharding.make_walker_mesh(jax.devices("cpu"))
        r1 = sim.SimulationRunner(p, scene_seed=5, seed=3, engine="pallas",
                                  rng_impl=pallas_engine.RNG_THREEFRY,
                                  interpret=True, mesh=mesh)
        t1, c1, s1, _ = r1.run(progress=False)
        r2 = sim.SimulationRunner(p, scene_seed=5, seed=3, engine="pallas",
                                  rng_impl=pallas_engine.RNG_THREEFRY,
                                  interpret=True)
        t2, c2, s2, _ = r2.run(progress=False)
        np.testing.assert_allclose(c1, c2, atol=1e-3)
        np.testing.assert_array_equal(np.asarray(r1.state.pos),
                                      np.asarray(r2.state.pos))

    def test_runner_sharded_scan(self):
        import jax
        from mri_nanoparticle_simulation_tpu.parallel import sharding
        p = P.small_test_params(num_water=64, totaltime=0.001,
                                sprint_steps=500)
        mesh = sharding.make_walker_mesh(jax.devices("cpu"))
        r1 = sim.SimulationRunner(p, scene_seed=5, seed=3, engine="scan",
                                  mesh=mesh)
        _, c1, _, _ = r1.run(progress=False)
        r2 = sim.SimulationRunner(p, scene_seed=5, seed=3, engine="scan")
        _, c2, _, _ = r2.run(progress=False)
        np.testing.assert_allclose(c1, c2, atol=1e-3)


class TestRunnerGridBackend:
    def test_grid_field_mode_runs(self):
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500, mmoment=3.5e-15,
                                field_mode=P.FIELD_GRID, grid_n=32)
        r = sim.SimulationRunner(p, scene_seed=5, seed=3, engine="scan")
        times, c, s, stats = r.run(progress=False)
        assert len(c) == p.t // p.pfreq
        assert np.all(np.abs(c) <= p.num_water)

    def test_grid_mode_rejects_pallas(self):
        p = P.small_test_params(field_mode=P.FIELD_GRID)
        with pytest.raises(ValueError, match="scan-engine backend"):
            sim.SimulationRunner(p, engine="pallas", interpret=True)


class TestCliEnsemble:
    def test_ensemble_flag_writes_mean_curve(self, tmp_path):
        """--ensemble N: the reference's 'multitrial' workflow
        (T2_GPU_sim.cu:45, PBS resubmission) as one device computation."""
        out = str(tmp_path / "ens.csv")
        rc = sim.main(["--num-water", "32", "--num-cells", "8",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--engine", "scan", "--ensemble", "4",
                       "--out", out, "--quadrature"])
        assert rc == 0
        d = np.loadtxt(out, delimiter=",")
        assert d.shape == (2, 3)
        assert np.all(np.abs(d[:, 1]) <= 32.0 + 1e-5)

    def test_ensemble_walker_shards_matches_plain(self, tmp_path):
        """--walker-shards N: the 2D (trials x walkers) mesh writes the
        same ensemble curve as the trial-parallel run (same seeds,
        bitwise per walker; the mean differs only by summation order)."""
        args = ["--num-water", "32", "--num-cells", "8",
                "--totaltime", "0.002", "--sprint-steps", "1000",
                "--chunk-steps", "100", "--near-k", "6",
                "--taucp", "0.001", "--hash-dim", "8",
                "--engine", "scan", "--ensemble", "2"]
        o1 = str(tmp_path / "e1.csv")
        o2 = str(tmp_path / "e2.csv")
        assert sim.main(args + ["--out", o1]) == 0
        assert sim.main(args + ["--walker-shards", "4",
                                "--out", o2]) == 0
        d1 = np.loadtxt(o1, delimiter=",")
        d2 = np.loadtxt(o2, delimiter=",")
        np.testing.assert_allclose(d2, d1, atol=1e-3)

    def test_walker_shards_requires_ensemble_or_sweep(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(["--walker-shards", "4",
                      "--out", str(tmp_path / "x.csv")])


class TestCliSweep:
    def test_sweep_flag_writes_per_value_curves(self, tmp_path):
        """--sweep taucp: one compiled program, one CSV per value with
        the reference's cos-only schema; later windows diverge because
        the earlier echo flips phase at different times."""
        out = str(tmp_path / "sweep.csv")
        rc = sim.main(["--num-water", "32", "--num-cells", "8",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--engine", "scan",
                       "--sweep", "taucp",
                       "--sweep-values", "0.001,0.002",
                       "--out", out])
        assert rc == 0
        d1 = np.loadtxt(str(tmp_path / "sweep_taucp=0.001.csv"),
                        delimiter=",")
        d2 = np.loadtxt(str(tmp_path / "sweep_taucp=0.002.csv"),
                        delimiter=",")
        assert d1.shape == (2, 2) and d2.shape == (2, 2)
        # reference cos-only schema: time_ms, sum_cos within [-W, W]
        np.testing.assert_allclose(d1[:, 0], [0.001, 0.002], atol=1e-9)
        assert np.all(np.abs(d1[:, 1]) <= 32.0 + 1e-5)
        assert np.all(np.abs(d2[:, 1]) <= 32.0 + 1e-5)

    def test_sweep_requires_values(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(["--sweep", "taucp",
                      "--out", str(tmp_path / "x.csv")])

    def test_sweep_d_writes_per_value_curves(self, tmp_path):
        """--sweep D: the global diffusion scale rides the engines'
        d_scale launch scalar; one CSV per value."""
        out = str(tmp_path / "dsweep.csv")
        rc = sim.main(["--num-water", "32", "--num-cells", "8",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--engine", "scan",
                       "--sweep", "D",
                       "--sweep-values", "1,0.25",
                       "--out", out])
        assert rc == 0
        d1 = np.loadtxt(str(tmp_path / "dsweep_D=1.csv"), delimiter=",")
        d2 = np.loadtxt(str(tmp_path / "dsweep_D=0.25.csv"),
                        delimiter=",")
        assert d1.shape == (2, 2) and d2.shape == (2, 2)
        assert np.all(np.abs(d1[:, 1]) <= 32.0 + 1e-5)
        assert np.all(np.abs(d2[:, 1]) <= 32.0 + 1e-5)

    def test_sweep_d_rejects_nonpositive(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(["--sweep", "D", "--sweep-values", "1,-0.5",
                      "--out", str(tmp_path / "x.csv")])

    def test_paired_sweep_identical_values_identical_csvs(self, tmp_path):
        """--paired: common random numbers across sweep values.  In a
        paired taucp sweep the first output window ends before either
        value's phases have been flipped, so the two CSVs must share
        that row's sum bitwise (same scene, same draws)."""
        out = str(tmp_path / "p.csv")
        rc = sim.main(["--num-water", "32", "--num-cells", "8",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--engine", "scan", "--paired",
                       "--sweep", "taucp",
                       "--sweep-values", "0.001,0.002",
                       "--out", out])
        assert rc == 0
        d1 = np.loadtxt(str(tmp_path / "p_taucp=0.001.csv"),
                        delimiter=",")
        d2 = np.loadtxt(str(tmp_path / "p_taucp=0.002.csv"),
                        delimiter=",")
        # window 1 (t=0.001 ms) ends exactly AT the first echo of
        # taucp=0.001 and before any echo of taucp=0.002; phases only
        # FLIP after the window sum, so paired trials share it bitwise
        assert d1[0, 1] == d2[0, 1]

    def test_paired_requires_sweep(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(["--paired", "--out", str(tmp_path / "x.csv")])

    def test_fit_t2_writes_dispersion_table(self, tmp_path):
        """--fit-t2 with --sweep: one table row per swept value (this
        2-window test curve has too few echoes to fit, so the rows
        carry the documented nan sentinel — the real fit is pinned by
        tests/test_analysis.py on synthetic decays)."""
        out = str(tmp_path / "s.csv")
        table = str(tmp_path / "disp.csv")
        rc = sim.main(["--num-water", "32", "--num-cells", "8",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--engine", "scan",
                       "--sweep", "D", "--sweep-values", "1,0.25",
                       "--fit-t2", table, "--out", out])
        assert rc == 0
        lines = open(table).read().strip().splitlines()
        assert lines[0] == "D,r2_per_ms,t2_ms,r_squared,n_echoes,t2_stderr_ms"
        assert len(lines) == 3
        assert lines[1].startswith("1,") and lines[2].startswith("0.25,")

    def test_fit_t2_cross_trial_stderr(self, tmp_path):
        """With --trials-per-value >= 2 the table's t2_stderr_ms is the
        cross-trial scatter of per-trial fits — a real (finite, positive)
        Monte-Carlo error bar on the mean-curve T2."""
        out = str(tmp_path / "s.csv")
        table = str(tmp_path / "disp.csv")
        rc = sim.main(["--num-water", "64", "--num-cells", "64",
                       "--totaltime", "0.01", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "8",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--mmoment", "1e-13",
                       "--engine", "scan", "--rng", "threefry",
                       "--sweep", "D", "--sweep-values", "1",
                       "--trials-per-value", "2",
                       "--fit-t2", table, "--out", out])
        assert rc == 0
        lines = open(table).read().strip().splitlines()
        assert lines[0].endswith(",t2_stderr_ms")
        row = lines[1].split(",")
        t2, se = float(row[2]), float(row[5])
        assert np.isfinite(t2) and t2 > 0
        assert np.isfinite(se) and se > 0

    def test_sweep_quadrature_csvs(self, tmp_path):
        """--sweep composes with --quadrature: per-point CSVs carry the
        real sum-sin column (previously rejected as cos-only)."""
        out = str(tmp_path / "q.csv")
        table = str(tmp_path / "qt.csv")
        rc = sim.main(["--num-water", "32", "--num-cells", "8",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--engine", "scan", "--quadrature",
                       "--sweep", "D", "--sweep-values", "1,0.25",
                       "--fit-t2", table, "--out", out])
        assert rc == 0
        for d in ("1", "0.25"):
            rows = np.loadtxt(str(tmp_path / f"q_D={d}.csv"),
                              delimiter=",")
            assert rows.shape == (2, 3)          # time, cos, sin
            assert np.any(rows[:, 2] != 0.0)     # real quadrature data
        # the cos column matches the cos-only run bitwise
        rc = sim.main(["--num-water", "32", "--num-cells", "8",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--engine", "scan",
                       "--sweep", "D", "--sweep-values", "1,0.25",
                       "--out", str(tmp_path / "c.csv")])
        assert rc == 0
        for d in ("1", "0.25"):
            q = np.loadtxt(str(tmp_path / f"q_D={d}.csv"), delimiter=",")
            c = np.loadtxt(str(tmp_path / f"c_D={d}.csv"), delimiter=",")
            np.testing.assert_array_equal(q[:, :2], c)

    def test_fit_t2_requires_sweep(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(["--fit-t2", str(tmp_path / "t.csv"),
                      "--out", str(tmp_path / "x.csv")])

    def test_sweep_grid_writes_every_combination(self, tmp_path):
        """--sweep-grid: the (D x taucp) cross product from ONE
        compiled program — one CSV per grid point plus the dispersion
        table with one knob column per axis."""
        out = str(tmp_path / "g.csv")
        table = str(tmp_path / "gt.csv")
        rc = sim.main(["--num-water", "32", "--num-cells", "8",
                       "--totaltime", "0.002", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "6",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--engine", "scan",
                       "--sweep-grid", "D=1,0.25;taucp=0.001,0.002",
                       "--fit-t2", table, "--out", out])
        assert rc == 0
        for d in ("1", "0.25"):
            for tc in ("0.001", "0.002"):
                path = str(tmp_path / f"g_D={d}_taucp={tc}.csv")
                rows = np.loadtxt(path, delimiter=",")
                assert rows.shape == (2, 2)
        lines = open(table).read().strip().splitlines()
        assert lines[0] == "D,taucp,r2_per_ms,t2_ms,r_squared,n_echoes,t2_stderr_ms"
        assert len(lines) == 5

    def test_sweep_grid_rejects_bad_spec(self, tmp_path):
        out = str(tmp_path / "x.csv")
        with pytest.raises(SystemExit):
            sim.main(["--sweep-grid", "bogus", "--out", out])
        with pytest.raises(SystemExit):
            sim.main(["--sweep-grid", "num_water=8,16", "--out", out])
        with pytest.raises(SystemExit):
            sim.main(["--sweep-grid", "D=1", "--sweep", "taucp",
                      "--sweep-values", "0.001", "--out", out])


class TestCliMomentScales:
    # mmoment is boosted 1e4x so the 2-window curve visibly dephases
    # (at the reference moment the per-step phases round to cos = 1.0f
    # over a 2000-step test run and every curve is exactly num_water)
    ARGS = ["--num-water", "32", "--num-cells", "8",
            "--totaltime", "0.002", "--sprint-steps", "1000",
            "--chunk-steps", "100", "--near-k", "6",
            "--taucp", "0.001", "--hash-dim", "8",
            "--mmoment", "3.5e-13",
            "--engine", "scan", "--rng", "threefry"]

    def test_dump_record_reconstructs_csvs(self, tmp_path):
        """--dump-record: the saved (A, B) basis reconstructs the CSVs
        the run itself wrote (closed-form, offline)."""
        from mri_nanoparticle_simulation_tpu.engine.decompose import \
            curves_at_scales
        out = str(tmp_path / "rec.csv")
        rec = str(tmp_path / "record.npz")
        rc = sim.main(self.ARGS + ["--moment-scales", "1,2",
                                   "--dump-record", rec, "--out", out])
        assert rc == 0
        with np.load(rec) as z:
            assert z["A"].shape == z["B"].shape == (2, 32)
            curves = curves_at_scales(z["A"], z["B"], [1.0, 2.0])
        for si, sc in enumerate(("1", "2")):
            d = np.loadtxt(str(tmp_path / f"rec_mscale={sc}.csv"),
                           delimiter=",")
            np.testing.assert_allclose(curves[si] * 32, d[:, 1],
                                       atol=1e-3)

    def test_record_reconstructs_offline_without_params(self, tmp_path):
        """decompose.reconstruct_record: the npz alone (knob fields
        included) reconstructs the echo plane — no original Params
        object, no simulator."""
        from mri_nanoparticle_simulation_tpu.engine.decompose import \
            reconstruct_record
        out = str(tmp_path / "r.csv")
        rec = str(tmp_path / "record.npz")
        rc = sim.main(self.ARGS + ["--moment-scales", "1,2",
                                   "--echo-taucps", "0.001,0.002",
                                   "--dump-record", rec, "--out", out])
        assert rc == 0
        plane = reconstruct_record(rec, [1.0, 2.0], [0.001, 0.002])
        for si, sc in enumerate(("1", "2")):
            for ti, tc in enumerate(("0.001", "0.002")):
                d = np.loadtxt(
                    str(tmp_path / f"r_mscale={sc}_taucp={tc}.csv"),
                    delimiter=",")
                np.testing.assert_allclose(
                    np.asarray(plane[si, ti]) * 32, d[:, 1],
                    atol=1e-3)

    def test_dump_record_requires_decomposition(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(["--dump-record", str(tmp_path / "r.npz"),
                      "--out", str(tmp_path / "x.csv")])

    def test_stream_plane_matches_batch_csvs(self, tmp_path):
        """--stream-plane: the incremental reconstruction writes the
        same (moment x taucp)-plane CSVs as the record-based path up to
        f64 summation-order rounding."""
        batch = str(tmp_path / "b.csv")
        rc = sim.main(self.ARGS + ["--moment-scales", "1,2",
                                   "--echo-taucps", "0.001,0.002",
                                   "--out", batch])
        assert rc == 0
        streamed = str(tmp_path / "s.csv")
        rc = sim.main(self.ARGS + ["--moment-scales", "1,2",
                                   "--echo-taucps", "0.001,0.002",
                                   "--stream-plane", "--out", streamed])
        assert rc == 0
        for sc in ("1", "2"):
            for tc in ("0.001", "0.002"):
                db = np.loadtxt(
                    str(tmp_path / f"b_mscale={sc}_taucp={tc}.csv"),
                    delimiter=",")
                ds = np.loadtxt(
                    str(tmp_path / f"s_mscale={sc}_taucp={tc}.csv"),
                    delimiter=",")
                np.testing.assert_allclose(ds, db, rtol=0, atol=1e-9)

    def test_stream_plane_guards(self, tmp_path):
        out = str(tmp_path / "x.csv")
        with pytest.raises(SystemExit):   # needs decomposition mode
            sim.main(self.ARGS + ["--stream-plane", "--out", out])
        with pytest.raises(SystemExit):   # no record exists to dump
            sim.main(self.ARGS + ["--moment-scales", "1",
                                  "--stream-plane", "--dump-record",
                                  str(tmp_path / "r.npz"), "--out", out])

    def test_moment_scales_reconstructs_direct_run(self, tmp_path):
        """--moment-scales: ONE decomposition run reconstructs the curve
        at each scale; at s=1 it must match a direct run of the same
        seed/scene up to the split-vs-joint Kahan rounding."""
        direct = str(tmp_path / "direct.csv")
        rc = sim.main(self.ARGS + ["--out", direct])
        assert rc == 0
        out = str(tmp_path / "dec.csv")
        rc = sim.main(self.ARGS + ["--moment-scales", "1,2.5",
                                   "--out", out])
        assert rc == 0
        d_direct = np.loadtxt(direct, delimiter=",")
        d1 = np.loadtxt(str(tmp_path / "dec_mscale=1.csv"), delimiter=",")
        d25 = np.loadtxt(str(tmp_path / "dec_mscale=2.5.csv"),
                         delimiter=",")
        assert d1.shape == (2, 2) and d25.shape == (2, 2)
        np.testing.assert_allclose(d1[:, 0], d_direct[:, 0], atol=1e-12)
        np.testing.assert_allclose(d1[:, 1], d_direct[:, 1],
                                   rtol=0, atol=1e-3)
        # a larger moment dephases faster: later-window |sum cos| drops
        assert not np.allclose(d25[:, 1], d1[:, 1])

    def test_echo_taucps_reconstructs_direct_run(self, tmp_path):
        """--echo-taucps: the taucp axis from the SAME run; each grid
        point must match a direct simulation at that taucp (trajectories
        are taucp-invariant under common random numbers)."""
        direct = str(tmp_path / "direct.csv")
        # argparse takes the last --taucp: direct run at 0.002
        rc = sim.main(self.ARGS + ["--taucp", "0.002", "--out", direct])
        assert rc == 0
        out = str(tmp_path / "plane.csv")
        rc = sim.main(self.ARGS + ["--moment-scales", "1",
                                   "--echo-taucps", "0.002,0.001",
                                   "--out", out])
        assert rc == 0
        d_direct = np.loadtxt(direct, delimiter=",")
        d5 = np.loadtxt(str(tmp_path / "plane_mscale=1_taucp=0.002.csv"),
                        delimiter=",")
        d10 = np.loadtxt(str(tmp_path / "plane_mscale=1_taucp=0.001.csv"),
                         delimiter=",")
        assert d5.shape == (2, 2) and d10.shape == (2, 2)
        # the base run used taucp=0.001 (ARGS); the reconstructed
        # taucp=0.002 curve must match the direct taucp=0.002 run
        np.testing.assert_allclose(d5[:, 0], d_direct[:, 0], atol=1e-12)
        np.testing.assert_allclose(d5[:, 1], d_direct[:, 1],
                                   rtol=0, atol=1e-3)

    def test_echo_taucps_alone_defaults_scale_one(self, tmp_path):
        """--echo-taucps without --moment-scales implies mscale=1."""
        out = str(tmp_path / "e.csv")
        rc = sim.main(self.ARGS + ["--echo-taucps", "0.001", "--out", out])
        assert rc == 0
        assert (tmp_path / "e_mscale=1_taucp=0.001.csv").exists()

    def test_echo_taucps_rejects_misaligned(self, tmp_path):
        """Misaligned echo spacings fail fast at argument validation."""
        with pytest.raises(ValueError, match="align"):
            sim.main(self.ARGS + ["--echo-taucps", "0.0015",
                                  "--out", str(tmp_path / "x.csv")])

    def test_fit_r2_dispersion_table(self, tmp_path):
        """--fit-r2 writes the CPMG dispersion table R2(taucp) from the
        reconstructed plane: fittable grid points get positive R2 rows,
        points with too few echoes get honest nan rows.  (The monotone
        dispersion physics is pinned at statistical power in
        test_analysis.TestCpmgDispersion.)"""
        out = str(tmp_path / "p.csv")
        r2csv = str(tmp_path / "r2.csv")
        rc = sim.main(["--num-water", "64", "--num-cells", "64",
                       "--totaltime", "0.01", "--sprint-steps", "1000",
                       "--chunk-steps", "100", "--near-k", "8",
                       "--taucp", "0.001", "--hash-dim", "8",
                       "--mmoment", "1e-13",
                       "--engine", "scan", "--rng", "threefry",
                       "--echo-taucps", "0.001,0.005",
                       "--fit-r2", r2csv, "--out", out])
        assert rc == 0
        rows = open(r2csv).read().splitlines()
        assert rows[0] == "mscale,taucp_ms,r2_per_ms,t2_ms,r_squared,n_echoes,t2_stderr_ms"
        assert len(rows) == 3  # header + 2 taucps at mscale=1
        vals = [row.split(",") for row in rows[1:]]
        assert [v[1] for v in vals] == ["0.001", "0.005"]
        # taucp=0.005 has only one echo (t=0.01) in a 0.01 ms run
        assert vals[1][2] == "nan" and vals[1][5] == "0"
        r2_1 = float(vals[0][2])
        assert np.isfinite(r2_1) and r2_1 > 0
        assert int(vals[0][5]) == 5  # echoes at 2k*0.001 in (0, 0.01]

    def test_fit_r2_requires_echo_taucps(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(self.ARGS + ["--fit-r2", str(tmp_path / "r.csv"),
                                  "--out", str(tmp_path / "x.csv")])

    def test_moment_scales_rejects_sweep_and_shard(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(self.ARGS + ["--moment-scales", "1,2", "--sweep",
                                  "taucp", "--sweep-values", "0.001",
                                  "--out", str(tmp_path / "x.csv")])
        with pytest.raises(SystemExit):
            sim.main(self.ARGS + ["--moment-scales", "1,2",
                                  "--shard-walkers",
                                  "--out", str(tmp_path / "x.csv")])


class TestValidationGuards:
    def test_taucp_below_pfreq_rejected(self):
        """tcp < pfreq (including tcp == 0, which would reach the
        kernels' `end_step % tcp` as an unsigned mod-by-zero) fails fast
        at Params.validate."""
        with pytest.raises(ValueError, match="at least one output"):
            P.small_test_params(taucp=0.0)
        with pytest.raises(ValueError, match="at least one output"):
            P.small_test_params(taucp=0.00005)  # tcp=50 < pfreq=100

    def test_runtime_taucp_zero_rejected(self):
        """The same floor applies to swept runtime taucps."""
        from mri_nanoparticle_simulation_tpu.parallel import ensemble
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        with pytest.raises(ValueError, match="at least one output"):
            ensemble.run_ensemble(p, n_trials=2, base_seed=0, run_seed=1,
                                  taucps=[0.0, 0.0001])

    def test_pallas_runner_skips_cube_machinery_for_smem_scenes(
            self, monkeypatch):
        """A scene below the large-path size must not pay for (or be
        rejected by) the cube-candidate machinery the field-model
        rebuild will never consult; above it the runner builds the
        scene cache once, on the padded walker count the kernel sees."""
        from mri_nanoparticle_simulation_tpu.engine import pallas_engine
        from mri_nanoparticle_simulation_tpu.fields import expansion
        p = P.small_test_params(num_water=64, totaltime=0.001,
                                sprint_steps=500)
        seen = []
        monkeypatch.setattr(expansion, "uses_large_path",
                            lambda w, n: seen.append(w) or False)

        def boom(*a, **k):
            raise AssertionError("cube machinery touched")

        monkeypatch.setattr(expansion, "build_cache", boom)
        monkeypatch.setattr(expansion, "validate_cube_candidates", boom)
        r = sim.SimulationRunner(p, scene_seed=5, seed=3, engine="pallas",
                                 interpret=True)
        assert r._cache is None
        assert seen[0] == pallas_engine.pad_count(p.num_water)

        monkeypatch.setattr(expansion, "uses_large_path", lambda w, n: True)
        monkeypatch.setattr(expansion, "validate_cube_candidates",
                            lambda *a, **k: 0)
        monkeypatch.setattr(expansion, "build_cache",
                            lambda *a, **k: "scene cache")
        r = sim.SimulationRunner(p, scene_seed=5, seed=3, engine="pallas",
                                 interpret=True)
        assert r._cache == "scene cache"

    def test_cli_checkpoint_with_ensemble_rejected(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(["--num-water", "32", "--totaltime", "0.002",
                      "--engine", "scan", "--ensemble", "2",
                      "--checkpoint", str(tmp_path / "ck.npz"),
                      "--out", str(tmp_path / "x.csv")])


class TestCliFieldDump:
    def test_dump_field_writes_lattice(self, tmp_path):
        """--dump-field: the reference's DEBUG_FIELD product
        (octree.cpp:435-449) as a runtime flag."""
        out = str(tmp_path / "field.csv")
        rc = sim.main(["--num-water", "16", "--num-cells", "4",
                      "--totaltime", "0.002", "--taucp", "0.001",
                      "--hash-dim", "8", "--dump-field", out,
                      "--dump-field-n", "8"])
        assert rc == 0
        d = np.loadtxt(out, delimiter=",")
        assert d.shape == (8 ** 3, 4)
        assert np.isfinite(d).all()


class TestCliRngFlag:
    def test_rng_threefry_selects_validation_path(self, tmp_path):
        """--rng threefry on the pallas engine must reproduce the scan
        engine's curve (shared counter streams) — the CLI's
        bit-reproducible validation mode."""
        out1 = str(tmp_path / "a.csv")
        out2 = str(tmp_path / "b.csv")
        common = ["--num-water", "32", "--num-cells", "8",
                  "--totaltime", "0.002", "--sprint-steps", "1000",
                  "--chunk-steps", "100", "--near-k", "6",
                  "--taucp", "0.001", "--hash-dim", "8"]
        # interpret-mode pallas isn't CLI-reachable; compare scan runs
        # under both flag spellings to pin the plumbing
        assert sim.main(common + ["--engine", "scan", "--out", out1]) == 0
        assert sim.main(common + ["--engine", "scan", "--rng", "threefry",
                                  "--out", out2]) == 0
        d1 = np.loadtxt(out1, delimiter=",")
        d2 = np.loadtxt(out2, delimiter=",")
        np.testing.assert_array_equal(d1, d2)

    def test_rng_hardware_refused(self, tmp_path):
        """The retired 'hardware' generator is no longer a choice."""
        out = tmp_path / "h.csv"
        with pytest.raises(SystemExit):
            sim.main(["--num-water", "32", "--num-cells", "8",
                      "--totaltime", "0.002", "--engine", "scan",
                      "--rng", "hardware", "--out", str(out)])
        assert not out.exists()


class TestCheckpointIdentity:
    """Round-3 hardening: the RNG implementation and engine are part of
    the random sequence's identity."""

    def test_rng_impl_mismatch_rejected(self, p, tmp_path):
        """A checkpoint written under another generator (the retired
        'hardware' stream) must not resume under Threefry, and no
        engine can be built for that generator any more."""
        from mri_nanoparticle_simulation_tpu.engine.reference_engine import \
            init_state
        from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
        sc = BacteriaBox(p, seed=9).populate()
        st = init_state(sc.waters, p)
        path = str(tmp_path / "c.npz")
        ck.save_checkpoint(path, st, p, seed=1, scene_seed=9,
                           engine="pallas", rng_impl="hardware")
        with pytest.raises(ValueError, match="rng_impl"):
            ck.load_checkpoint(path, p, engine="pallas",
                               rng_impl="threefry")
        with pytest.raises(ValueError, match="Threefry"):
            SimulationRunner(p, scene_seed=9, seed=1, engine="pallas",
                             rng_impl="hardware", interpret=True)
        ck.save_checkpoint(path, st, p, seed=1, scene_seed=9,
                           engine="pallas", rng_impl="threefry")
        with pytest.raises(ValueError, match="engine"):
            ck.load_checkpoint(path, p, engine="scan",
                               rng_impl="threefry")
        # matching identity loads fine
        ck.load_checkpoint(path, p, engine="pallas", rng_impl="threefry")
        # legacy checkpoints (no identity recorded) still load
        ck.save_checkpoint(path, st, p, seed=1, scene_seed=9)
        ck.load_checkpoint(path, p, engine="pallas", rng_impl="threefry")

    def test_runner_resume_rejects_other_engine(self, p, tmp_path):
        ckpt = str(tmp_path / "e.npz")
        r = SimulationRunner(p, scene_seed=3, seed=4, engine="scan")
        r.run(max_steps=p.sprint_steps, checkpoint_path=ckpt)
        r2 = SimulationRunner(p, scene_seed=3, seed=4, engine="pallas",
                              rng_impl="threefry", interpret=True)
        with pytest.raises(ValueError, match="engine"):
            r2.resume(ckpt)


class TestDrainDepth:
    def test_drain_depth_one_matches_default(self, p, tmp_path):
        """Per-sprint durability must not change the physics/output."""
        a = SimulationRunner(p, scene_seed=5, seed=6, engine="scan")
        _, cos_a, _, _ = a.run(drain_depth=1)
        b = SimulationRunner(p, scene_seed=5, seed=6, engine="scan")
        _, cos_b, _, _ = b.run()
        np.testing.assert_array_equal(cos_a, cos_b)

    def test_rejects_zero(self, p):
        r = SimulationRunner(p, scene_seed=5, seed=6, engine="scan")
        with pytest.raises(ValueError, match="drain_depth"):
            r.run(drain_depth=0)


class TestSweepKnobValidation:
    def test_derived_property_rejected(self, tmp_path):
        """--sweep tcp names a derived read-only property; it must fail
        with the argparse error, not a raw TypeError in replace()."""
        with pytest.raises(SystemExit):
            sim.main(["--num-water", "32", "--num-cells", "8",
                      "--totaltime", "0.002", "--sprint-steps", "1000",
                      "--chunk-steps", "100", "--near-k", "6",
                      "--taucp", "0.001", "--hash-dim", "8",
                      "--sweep", "tcp", "--sweep-values", "500,1000",
                      "--out", str(tmp_path / "x.csv")])


class TestAotWarmStart:
    """engine/aot.py: the executable cache is an accelerator, never a
    correctness dependency — every miss/corruption must fall back."""

    def test_key_stability_and_source_sensitivity(self):
        from mri_nanoparticle_simulation_tpu.engine import aot
        import jax.numpy as jnp
        p = P.small_test_params(num_water=64)
        k1 = aot._cache_key(p, 64, 100, jnp.float32, "threefry")
        k2 = aot._cache_key(p, 64, 100, jnp.float32, "threefry")
        assert k1 == k2
        assert k1 != aot._cache_key(p, 64, 100, jnp.float64, "threefry")
        assert k1 != aot._cache_key(p, 128, 100, jnp.float32, "threefry")
        assert k1 != aot._cache_key(p.replace(near_k=p.near_k + 1), 64,
                                    100, jnp.float32, "threefry")

    def test_missing_and_corrupt_entries_fall_back(self, tmp_path,
                                                   monkeypatch):
        from mri_nanoparticle_simulation_tpu.engine import aot
        import jax.numpy as jnp
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        p = P.small_test_params(num_water=64)
        assert aot.load_sprint(p, 64, 100, jnp.float32, "threefry") is None
        key = aot._cache_key(p, 64, 100, jnp.float32, "threefry")
        import os
        os.makedirs(os.path.dirname(aot._path(key)), exist_ok=True)
        assert aot._path(key).startswith(str(tmp_path))
        with open(aot._path(key), "wb") as f:
            f.write(b"not a pickle")
        assert aot.load_sprint(p, 64, 100, jnp.float32, "threefry") is None

    def test_ensemble_key_sensitivity(self):
        from mri_nanoparticle_simulation_tpu.engine import aot
        import jax.numpy as jnp
        p = P.small_test_params(num_water=64)
        k1 = aot._ensemble_key(p, 2, 100, jnp.float32, "threefry")
        assert k1 == aot._ensemble_key(p, 2, 100, jnp.float32, "threefry")
        assert k1 != aot._ensemble_key(p, 3, 100, jnp.float32, "threefry")
        assert k1 != aot._ensemble_key(p, 2, 101, jnp.float32, "threefry")
        assert k1 != aot._ensemble_key(p, 2, 100, jnp.float64, "threefry")
        # ensemble keys never collide with single-run keys
        assert k1 != aot._cache_key(p, 64, 100, jnp.float32, "threefry")

    def test_ensemble_aot_miss_falls_back(self, tmp_path, monkeypatch):
        """On backends whose executables can't serialize (CPU), the
        ensemble hook must silently keep the jit path."""
        from mri_nanoparticle_simulation_tpu.engine import aot
        import jax.numpy as jnp
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        p = P.small_test_params(num_water=64)
        assert aot.load_ensemble_sprint(p, 2, 100, jnp.float32,
                                        "threefry") is None

    def test_wrapper_rejects_every_runtime_override(self):
        """The AOT guard's checklist must cover EVERY sprint override
        (an uncovered kwarg would surface as a raw TypeError or a
        silent mis-binding instead of the clean rejection)."""
        import inspect

        from mri_nanoparticle_simulation_tpu.engine import aot
        sprint = aot._wrap_compiled(lambda *a, **k: "ran")
        assert sprint(1, 2, 3, 4, 0) == "ran"
        for kw in ("cache", "tcp", "cell_r", "d_scale", "reflect"):
            with pytest.raises(ValueError, match="plain production"):
                sprint(1, 2, 3, 4, 0, **{kw: 1.0})
        # the wrapper's signature must track the real sprint's
        # overrides exactly (pallas_engine.make_sprint_fn's guarded())
        wrap = inspect.signature(sprint).parameters
        assert set(wrap) == {"mnp_pos", "mnp_M", "key_arr", "ps",
                             "lane_offset", "cache", "tcp", "cell_r",
                             "d_scale", "reflect"}

    def test_roundtrip_on_multi_device_host(self, p, tmp_path,
                                            monkeypatch, request):
        """A single-device sprint saved and loaded again on a host with
        several devices (the 8 virtual CPU devices here) must run on one
        device and reproduce the jit path bitwise."""
        import jax
        import jax.numpy as jnp

        from mri_nanoparticle_simulation_tpu import rng
        from mri_nanoparticle_simulation_tpu.engine import aot
        from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
        from mri_nanoparticle_simulation_tpu.engine import reference_engine
        from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
        assert len(jax.devices()) > 1
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        # an XLA:CPU executable that came out of the persistent compile
        # cache (enabled by earlier CLI tests in this process) does not
        # serialize again; compile afresh so the round trip is real
        was = jax.config.jax_enable_compilation_cache
        jax.config.update("jax_enable_compilation_cache", False)
        request.addfinalizer(lambda: jax.config.update(
            "jax_enable_compilation_cache", was))
        sc = BacteriaBox(p, seed=3).populate()
        mp = jnp.asarray(np.asarray(sc.mnps[:, :3], np.float32))
        mM = jnp.asarray(np.asarray(sc.mnps[:, 4], np.float32))
        kk = rng.key_from_seed(5)
        key = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps0 = pe.to_planes(reference_engine.init_state(sc.waters, p), p)
        base = pe.make_sprint_fn(p, p.num_water, interpret=True)
        args = (mp, mM, key, ps0, 0)
        if aot.compile_and_save(base.inner, p, p.num_water, args,
                                jnp.float32, "threefry") is None:
            pytest.skip("this jax build cannot serialize executables")
        loaded = aot.load_sprint(p, p.num_water, int(mp.shape[0]),
                                 jnp.float32, "threefry")
        assert loaded is not None
        _, w_jit = base(*args)
        _, w_aot = loaded(*args)
        np.testing.assert_array_equal(np.asarray(w_jit), np.asarray(w_aot))

    def test_runner_falls_back_on_cpu(self, p):
        """On backends whose executables can't be serialized (CPU),
        SimulationRunner must still run via the jit path."""
        r = SimulationRunner(p, scene_seed=1, seed=2, engine="pallas",
                             rng_impl="threefry", interpret=True)
        _, cos, _, stats = r.run()
        assert stats["steps"] == p.t
        assert np.isfinite(cos).all()


class TestShardWalkersCli:
    def test_sharded_csv_matches_unsharded(self, tmp_path):
        """--shard-walkers over the 8-device virtual mesh must reproduce
        the single-device CSV exactly (threefry streams are lane-keyed,
        so sharding has no physical footprint)."""
        base = ["--num-water", "64", "--num-cells", "12",
                "--totaltime", "0.002", "--sprint-steps", "1000",
                "--chunk-steps", "1000", "--near-k", "6",
                "--taucp", "0.001", "--hash-dim", "8",
                "--engine", "scan"]
        a = str(tmp_path / "plain.csv")
        b = str(tmp_path / "sharded.csv")
        assert sim.main(base + ["--out", a]) == 0
        assert sim.main(base + ["--shard-walkers", "--out", b]) == 0
        ta, ca = wr.read_t2_csv(a)
        tb, cb = wr.read_t2_csv(b)
        np.testing.assert_array_equal(ca, cb)

    def test_rejected_with_ensemble(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(["--shard-walkers", "--ensemble", "2",
                      "--out", str(tmp_path / "x.csv")])


class TestDumpStatsCli:
    def test_dump_stats_flag(self, tmp_path):
        from mri_nanoparticle_simulation_tpu.engine import sim
        path = str(tmp_path / "stats.csv")
        assert sim.main(["--num-water", "32", "--num-cells", "6",
                         "--dump-stats", path,
                         "--scene-family", "fcc"]) == 0
        text = open(path).read()
        assert "Number of MNPs, 6" in text
        assert "Number of Waters, 32" in text
        assert "Number of Cells, 6" in text


class TestCliPlaneDevice:
    ARGS = ["--num-water", "32", "--num-cells", "8",
            "--totaltime", "0.002", "--sprint-steps", "1000",
            "--chunk-steps", "100", "--near-k", "6",
            "--taucp", "0.001", "--hash-dim", "8",
            "--mmoment", "3.5e-13",
            "--engine", "scan", "--rng", "threefry"]

    def test_plane_device_matches_stream(self, tmp_path):
        """--plane-device (record never leaves the device, f32+Kahan
        carries) writes the same plane CSVs as the f64 host
        --stream-plane path to f32 rounding."""
        a = str(tmp_path / "host.csv")
        b = str(tmp_path / "dev.csv")
        common = self.ARGS + ["--moment-scales", "1,2",
                              "--echo-taucps", "0.001,0.002"]
        assert sim.main(common + ["--stream-plane", "--out", a]) == 0
        assert sim.main(common + ["--plane-device", "--out", b]) == 0
        for s in ("1", "2"):
            for t in ("0.001", "0.002"):
                h = np.loadtxt(str(tmp_path / f"host_mscale={s}_taucp={t}.csv"),
                               delimiter=",")
                d = np.loadtxt(str(tmp_path / f"dev_mscale={s}_taucp={t}.csv"),
                               delimiter=",")
                np.testing.assert_allclose(d, h, atol=32 * 1e-4)

    def test_plane_device_shard_walkers(self, tmp_path):
        """--plane-device --shard-walkers: sharded sprints + sharded
        plane folding write the same CSVs as the single-device plane
        run up to the f32 mean-of-means grouping."""
        a = str(tmp_path / "one.csv")
        b = str(tmp_path / "sh.csv")
        common = self.ARGS + ["--moment-scales", "1,2"]
        assert sim.main(common + ["--plane-device", "--out", a]) == 0
        assert sim.main(common + ["--plane-device", "--shard-walkers",
                                  "--out", b]) == 0
        for s in ("1", "2"):
            one = np.loadtxt(str(tmp_path / f"one_mscale={s}.csv"),
                             delimiter=",")
            sh = np.loadtxt(str(tmp_path / f"sh_mscale={s}.csv"),
                            delimiter=",")
            np.testing.assert_allclose(sh, one, atol=32 * 1e-4)

    def test_dump_echoes(self, tmp_path, capsys):
        """--dump-echoes captures the per-walker spin-echo matrices on
        device for every grid point with an echo inside the run (taucp
        0.002 has none at totaltime 0.002 and is skipped with a note)
        and mri-t2-fit --echoes consumes the npz."""
        from mri_nanoparticle_simulation_tpu.engine import decompose as dec
        npz = str(tmp_path / "echoes.npz")
        assert sim.main(self.ARGS + ["--moment-scales", "1,2",
                                     "--echo-taucps", "0.001,0.002",
                                     "--plane-device",
                                     "--dump-echoes", npz,
                                     "--out", str(tmp_path / "d.csv")]) == 0
        err = capsys.readouterr().err
        assert "skipping mscale=1 taucp=0.002" in err
        echoes = dec.load_echoes(npz)
        assert [(e.scale, e.taucp_ms) for e in echoes] == \
            [(1.0, 0.001), (2.0, 0.001)]
        for e in echoes:
            assert e.cos.shape == (e.times_ms.size, 32)
            assert np.all(np.abs(e.cos) <= 1.0)
        # one echo inside this tiny run: the fit CLI reports the nan
        # sentinel rather than crashing
        from mri_nanoparticle_simulation_tpu import analysis as an
        assert an.main(["--echoes", npz, "--bootstrap", "8"]) == 0
        assert "unfittable" in capsys.readouterr().out

    def test_plane_device_validation(self, tmp_path):
        with pytest.raises(SystemExit):
            sim.main(["--plane-device",
                      "--out", str(tmp_path / "x.csv")])
        with pytest.raises(SystemExit):
            # --dump-echoes needs --plane-device
            sim.main(self.ARGS + ["--moment-scales", "1",
                                  "--dump-echoes", str(tmp_path / "e.npz"),
                                  "--out", str(tmp_path / "x.csv")])
        with pytest.raises(SystemExit):
            sim.main(self.ARGS + ["--moment-scales", "1",
                                  "--plane-device", "--stream-plane",
                                  "--out", str(tmp_path / "x.csv")])
        with pytest.raises(SystemExit):
            sim.main(self.ARGS + ["--moment-scales", "1",
                                  "--plane-device", "--checkpoint",
                                  str(tmp_path / "c.npz"),
                                  "--out", str(tmp_path / "x.csv")])


class TestCompileCacheDir:
    """utils/cache.py: JAX_COMPILATION_CACHE_DIR wins and is left to JAX;
    otherwise the fixed <checkout>/.jax_cache."""

    def _recorded_updates(self, monkeypatch):
        import jax
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda name, val: calls.append((name, val)))
        return calls

    def test_env_var_honoured(self, tmp_path, monkeypatch):
        from mri_nanoparticle_simulation_tpu.utils import cache as cm
        d = str(tmp_path / "jc")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
        calls = self._recorded_updates(monkeypatch)
        assert cm.enable_compile_cache() == d
        assert cm._default_dir() == d
        import os
        assert os.path.isdir(d)
        # JAX reads the variable itself: no other directory set in code
        assert not any(n == "jax_compilation_cache_dir" for n, _ in calls)

    def test_default_is_fixed_checkout_path(self, monkeypatch):
        import os

        from mri_nanoparticle_simulation_tpu.utils import cache as cm
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        calls = self._recorded_updates(monkeypatch)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        want = os.path.join(repo, ".jax_cache")
        assert cm._default_dir() == want
        assert cm.enable_compile_cache() == want
        assert ("jax_compilation_cache_dir", want) in calls
