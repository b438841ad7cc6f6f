"""Multi-chip sharding and ensembles on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu.engine import reference_engine as re
from mri_nanoparticle_simulation_tpu.parallel import ensemble, sharding
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox


@pytest.fixture(scope="module")
def small():
    p = P.small_test_params(num_water=64, totaltime=0.001, sprint_steps=500)
    sc = BacteriaBox(p, seed=5).populate()
    return p, sc


class TestWalkerSharding:
    def test_sharded_matches_single_device(self, small):
        """Counter-based RNG makes sharding exact: per-walker trajectories
        are bitwise identical to the single-chip run; only the summation
        order of the magnetization reduction differs."""
        p, sc = small
        mesh = sharding.make_walker_mesh(jax.devices("cpu"))
        assert mesh.shape[sharding.WALKER_AXIS] == 8
        t1, c1, s1, st1 = sharding.run_simulation_sharded(sc, p, mesh=mesh,
                                                          seed=3)
        t2, c2, s2, st2 = re.run_simulation(sc, p, seed=3)
        np.testing.assert_array_equal(np.asarray(st1.pos),
                                      np.asarray(st2.pos))
        np.testing.assert_array_equal(np.asarray(st1.phase),
                                      np.asarray(st2.phase))
        np.testing.assert_allclose(c1, c2, atol=1e-3)
        assert int(st1.escapes) == int(st2.escapes)

    def test_uneven_shard_rejected(self, small):
        p, _ = small
        mesh = sharding.make_walker_mesh(jax.devices("cpu")[:3])
        with pytest.raises(ValueError, match="divide evenly"):
            sharding.make_sharded_sprint_fn(p, mesh)


class TestEnsemble:
    def test_trials_independent(self):
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        times, cos, sin, state = ensemble.run_ensemble(
            p, n_trials=4, base_seed=0, run_seed=50)
        assert cos.shape == (4, 5)
        # different scenes/streams -> different final states per trial
        pos = np.asarray(state.pos)
        assert not np.array_equal(pos[0], pos[1])

    def test_mmoment_sweep(self):
        """A trial with mmoment=0 has no dipole field: with the default
        as-written kick and waters outside cells, its curve is exactly W."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        _, cos, _, _ = ensemble.run_ensemble(
            p, n_trials=2, base_seed=0, run_seed=50,
            mmoments=[0.0, p.mmoment * 4])
        np.testing.assert_allclose(cos[0], 32.0, atol=1e-4)
        assert np.abs(cos[1] - 32.0).max() > np.abs(cos[0] - 32.0).max()

    def test_padding_dipoles_inert(self):
        """Trial MNP padding must not alter physics: a 1-trial ensemble
        equals the plain single-scene run."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        _, cos, _, st_e = ensemble.run_ensemble(
            p, n_trials=2, base_seed=7, run_seed=99)
        sc = BacteriaBox(p, seed=7).populate()
        _, c2, _, st_s = re.run_simulation(sc, p, seed=99)
        # ensemble pads the MNP table; trajectories must be unchanged
        np.testing.assert_array_equal(np.asarray(st_e.pos)[0],
                                      np.asarray(st_s.pos))
        np.testing.assert_allclose(cos[0], c2, atol=1e-4)


class TestSweep:
    def test_cell_r_sweep(self):
        """cell_r rides the engines' launch scalars: the sweep shares one
        compile; geometry responds per trial (scenes are rebuilt with each
        trial's radius) and every value's curve equals a statically-built
        engine run on the matching scene/seed."""
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200, num_cells=4)
        vals = [0.4, 0.8]
        times, curves = ensemble.run_parameter_sweep(
            p, "cell_r", vals, n_trials_each=1)
        assert curves.shape == (2, 1, 2)
        for i, v in enumerate(vals):
            pv = p.replace(cell_r=v).validate()
            sc = BacteriaBox(pv, seed=i).populate()
            _, c2, _, _ = re.run_simulation(sc, pv, seed=1000 + i)
            np.testing.assert_allclose(curves[i, 0], c2, atol=1e-4)

    def test_mmoment_sweep_shares_compile(self):
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        times, curves = ensemble.run_parameter_sweep(
            p, "mmoment", [0.0, p.mmoment], n_trials_each=2)
        assert curves.shape == (2, 2, 2)
        np.testing.assert_allclose(curves[0], 16.0, atol=1e-4)

    def test_taucp_sweep_shared_compile(self):
        """taucp sweeps share one compiled program (runtime tcp scalar);
        each value's curve equals a statically-built run, and the swept
        values genuinely flip at different echo times."""
        p = P.small_test_params(num_water=32, totaltime=0.001,
                                sprint_steps=500)
        vals = [0.0005, 0.0003]
        times, curves = ensemble.run_parameter_sweep(
            p, "taucp", vals, n_trials_each=1)
        for i, v in enumerate(vals):
            pv = p.replace(taucp=v).validate()
            sc = BacteriaBox(p, seed=i).populate()  # taucp: same geometry
            _, c2, _, _ = re.run_simulation(sc, pv, seed=1000 + i)
            np.testing.assert_allclose(curves[i, 0], c2, atol=1e-4)

    def test_taucp_sweep_builds_one_program(self, monkeypatch):
        """The shared path must construct exactly one sprint program for
        the whole sweep (the reference re-ran nvcc per value)."""
        calls = []
        orig = ensemble.reference_engine.make_sprint_fn
        monkeypatch.setattr(
            ensemble.reference_engine, "make_sprint_fn",
            lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        ensemble.run_parameter_sweep(p, "taucp", [0.0001, 0.0002],
                                     n_trials_each=1)
        assert len(calls) == 1

    def test_taucp_sweep_pallas_engine(self):
        """The production engine's launch-scalar path through ensembles."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        vals = [0.0005, 0.0001]
        _, curves = ensemble.run_parameter_sweep(
            p, "taucp", vals, n_trials_each=1, engine="pallas",
            interpret=True)
        from mri_nanoparticle_simulation_tpu.engine import pallas_engine
        for i, v in enumerate(vals):
            pv = p.replace(taucp=v).validate()
            sc = BacteriaBox(p, seed=i).populate()
            _, c2, _, _ = pallas_engine.run_simulation(
                sc, pv, seed=1000 + i, interpret=True)
            np.testing.assert_allclose(curves[i, 0], c2, atol=1e-4)

    def test_d_sweep_shared_compile(self):
        """The global diffusion scale D rides the engines' d_scale launch
        scalar: one compiled program for the sweep, each value's curve
        matching a statically-built run with D_cell/D_extra scaled.
        0.25 is a power of four, so sqrt(d_scale) and the stdev products
        are exact in f32 and the trajectories coincide."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        vals = [1.0, 0.25]
        times, curves = ensemble.run_parameter_sweep(
            p, "D", vals, n_trials_each=1)
        for i, v in enumerate(vals):
            pv = p.replace(D_cell=p.D_cell * v,
                           D_extra=p.D_extra * v).validate()
            sc = BacteriaBox(p, seed=i).populate()  # D: same geometry
            _, c2, _, _ = re.run_simulation(sc, pv, seed=1000 + i)
            np.testing.assert_allclose(curves[i, 0], c2, atol=1e-4)

    def test_d_sweep_pallas_engine(self):
        """The production kernel's d_scale launch scalar through the
        ensemble layer."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        vals = [1.0, 0.25]
        _, curves = ensemble.run_parameter_sweep(
            p, "D", vals, n_trials_each=1, engine="pallas",
            interpret=True)
        from mri_nanoparticle_simulation_tpu.engine import pallas_engine
        for i, v in enumerate(vals):
            pv = p.replace(D_cell=p.D_cell * v,
                           D_extra=p.D_extra * v).validate()
            sc = BacteriaBox(p, seed=i).populate()
            _, c2, _, _ = pallas_engine.run_simulation(
                sc, pv, seed=1000 + i, interpret=True)
            np.testing.assert_allclose(curves[i, 0], c2, atol=1e-4)

    def test_paired_sweep_shares_scene_and_stream(self):
        """paired=True: trial k of every value gets scene seed
        base_seed+k and run seed run_seed+k.  Two identical sweep
        values must then produce BITWISE-identical curves (same scene,
        same draws, same knob) — while the default independent sweep
        gives them different scenes and streams."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        _, paired = ensemble.run_parameter_sweep(
            p, "D", [0.5, 0.5], n_trials_each=1, paired=True)
        np.testing.assert_array_equal(paired[0], paired[1])
        _, indep = ensemble.run_parameter_sweep(
            p, "D", [0.5, 0.5], n_trials_each=1)
        assert not np.array_equal(indep[0], indep[1])

    def test_paired_sweep_matches_static_oracle(self):
        """Every paired trial still equals a statically-built run on
        the SHARED scene seed (seed pairing changes which scene each
        trial sees, not the physics)."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        vals = [1.0, 0.25]
        _, curves = ensemble.run_parameter_sweep(
            p, "D", vals, n_trials_each=1, paired=True, base_seed=7,
            run_seed=1000)
        sc = BacteriaBox(p, seed=7).populate()  # shared by BOTH values
        for i, v in enumerate(vals):
            pv = p.replace(D_cell=p.D_cell * v,
                           D_extra=p.D_extra * v).validate()
            _, c2, _, _ = re.run_simulation(sc, pv, seed=1000)
            np.testing.assert_allclose(curves[i, 0], c2, atol=1e-4)

    def test_parameter_grid_matches_singles(self):
        """run_parameter_grid: every (D, taucp) combination runs as a
        trial of ONE program; each grid point equals a statically-built
        run on its trial's scene/seed."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        axes = {"D": [1.0, 0.25], "taucp": [0.0005, 0.0003]}
        times, curves = ensemble.run_parameter_grid(p, axes)
        assert curves.shape == (2, 2, 1, 5)
        import itertools
        for ci, (d, tc) in enumerate(itertools.product(*axes.values())):
            pv = p.scale_D(d).replace(taucp=tc).validate()
            sc = BacteriaBox(p, seed=ci).populate()
            _, c2, _, _ = re.run_simulation(sc, pv, seed=1000 + ci)
            di, ti = ci // 2, ci % 2
            np.testing.assert_allclose(curves[di, ti, 0], c2, atol=1e-4)

    def test_parameter_grid_geometry_axis(self):
        """cell_r in a grid rebuilds each trial's scene with its radius
        while D rides the launch scalar — the combination must equal
        statically-built runs point by point."""
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200, num_cells=4)
        axes = {"cell_r": [0.4, 0.8], "D": [1.0, 0.25]}
        _, curves = ensemble.run_parameter_grid(p, axes)
        import itertools
        for ci, (cr, d) in enumerate(itertools.product(*axes.values())):
            pv = p.replace(cell_r=cr).scale_D(d).validate()
            sc = BacteriaBox(p.replace(cell_r=cr).validate(),
                             seed=ci).populate()
            _, c2, _, _ = re.run_simulation(sc, pv, seed=1000 + ci)
            np.testing.assert_allclose(curves[ci // 2, ci % 2, 0], c2,
                                       atol=1e-4)

    def test_parameter_grid_paired_shares_scene(self):
        """paired grid: every grid point's trial k shares scene seed
        base_seed+k — two grid points with identical knob values give
        bitwise-identical curves."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        _, curves = ensemble.run_parameter_grid(
            p, {"D": [0.5, 0.5]}, paired=True)
        np.testing.assert_array_equal(curves[0], curves[1])

    def test_parameter_grid_rejects_compile_knobs(self):
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        with pytest.raises(ValueError, match="launch-scalar"):
            ensemble.run_parameter_grid(p, {"num_water": [8, 16]})
        with pytest.raises(ValueError, match="at least one"):
            ensemble.run_parameter_grid(p, {})

    def test_paired_sweep_builds_each_scene_once(self):
        """Repeated (seed, geometry) across values share ONE scene
        object and one coverage validation (paired sweeps would
        otherwise rebuild and re-validate per value)."""
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        _, _, _, scenes = ensemble.build_trial_scenes(
            p, 4, scene_seeds=[0, 1, 0, 1])
        assert scenes[0] is scenes[2]
        assert scenes[1] is scenes[3]
        assert scenes[0] is not scenes[1]

    def test_seed_override_length_validated(self):
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        with pytest.raises(ValueError, match="scene_seeds"):
            ensemble.run_ensemble(p, n_trials=2, scene_seeds=[1])
        with pytest.raises(ValueError, match="run_seeds"):
            ensemble.run_ensemble(p, n_trials=2, run_seeds=[1, 2, 3])

    def test_invalid_d_scale_rejected(self):
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        with pytest.raises(ValueError, match="d_scales must be > 0"):
            ensemble.run_ensemble(p, n_trials=2, base_seed=0, run_seed=1,
                                  d_scales=[1.0, -1.0])

    def test_invalid_runtime_taucp_rejected(self):
        """A swept taucp that misaligns with pfreq fails fast at the host
        boundary, exactly like the static Params.validate check."""
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        with pytest.raises(ValueError, match="taucp must align"):
            ensemble.run_ensemble(p, n_trials=2, base_seed=0, run_seed=1,
                                  taucps=[0.0001, 0.00013])


class TestPallasSharding:
    def test_pallas_sharded_matches_single_device(self, small):
        """The production engine sharded over 8 devices (per-shard plane
        packing, shard_map + psum): bitwise-identical walker physics to
        the single-device Pallas run (global Threefry lanes)."""
        p, sc = small
        mesh = sharding.make_walker_mesh(jax.devices("cpu"))
        t1, c1, s1, st1 = sharding.run_simulation_sharded_pallas(
            sc, p, mesh=mesh, seed=3, interpret=True)
        from mri_nanoparticle_simulation_tpu.engine import pallas_engine
        t2, c2, s2, st2 = pallas_engine.run_simulation(
            sc, p, seed=3, interpret=True)
        np.testing.assert_array_equal(np.asarray(st1.pos),
                                      np.asarray(st2.pos))
        np.testing.assert_array_equal(np.asarray(st1.phase),
                                      np.asarray(st2.phase))
        np.testing.assert_allclose(c1, c2, atol=1e-3)
        assert int(st1.escapes) == int(st2.escapes)

    def test_pallas_sharded_matches_scan_engine(self, small):
        """Cross-engine: sharded Pallas and the scan engine share Threefry
        streams, so curves agree to f32 summation tolerance."""
        p, sc = small
        mesh = sharding.make_walker_mesh(jax.devices("cpu"))
        _, c1, _, st1 = sharding.run_simulation_sharded_pallas(
            sc, p, mesh=mesh, seed=3, interpret=True)
        _, c2, _, st2 = re.run_simulation(sc, p, seed=3)
        np.testing.assert_allclose(np.asarray(st1.pos),
                                   np.asarray(st2.pos), atol=1e-5)
        np.testing.assert_allclose(c1, c2, atol=1e-2)


class TestEnsemblePallas:
    def test_pallas_ensemble_matches_single_runs(self):
        """Production-engine ensembles (lax.scan over trials inside each
        shard): every trial bitwise-equal to its standalone run."""
        from mri_nanoparticle_simulation_tpu.engine import pallas_engine
        from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500, mmoment=3.5e-15)
        _, cos, _, st = ensemble.run_ensemble(
            p, n_trials=2, base_seed=7, run_seed=99, engine="pallas",
            interpret=True)
        for i in range(2):
            sc = BacteriaBox(p, seed=7 + i).populate()
            _, c1, _, st1 = pallas_engine.run_simulation(
                sc, p, seed=99 + i, interpret=True)
            np.testing.assert_array_equal(np.asarray(st.pos)[i],
                                          np.asarray(st1.pos))
            np.testing.assert_allclose(cos[i], c1, atol=1e-4)


class TestEnsemble2D:
    """Trials x walker-sharding on one 2D mesh (the pod layout):
    per-walker physics must stay bitwise vs the plain trial-parallel
    run; curves agree to summation order."""

    def test_scan_2d_matches_1d(self):
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        _, cos1, sin1, st1 = ensemble.run_ensemble(
            p, n_trials=2, base_seed=0, run_seed=50)
        _, cos2, sin2, st2 = ensemble.run_ensemble(
            p, n_trials=2, base_seed=0, run_seed=50, walker_shards=4)
        np.testing.assert_allclose(cos2, cos1, atol=1e-3)
        np.testing.assert_allclose(sin2, sin1, atol=1e-3)
        np.testing.assert_array_equal(np.asarray(st2.pos),
                                      np.asarray(st1.pos))
        np.testing.assert_array_equal(np.asarray(st2.phase),
                                      np.asarray(st1.phase))

    def test_pallas_2d_matches_1d(self):
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        _, cos1, _, st1 = ensemble.run_ensemble(
            p, n_trials=2, base_seed=0, run_seed=50, engine="pallas",
            rng_impl="threefry", interpret=True)
        _, cos2, _, st2 = ensemble.run_ensemble(
            p, n_trials=2, base_seed=0, run_seed=50, engine="pallas",
            rng_impl="threefry", interpret=True, walker_shards=4)
        np.testing.assert_allclose(cos2, cos1, atol=1e-3)
        np.testing.assert_array_equal(np.asarray(st2.pos),
                                      np.asarray(st1.pos))

    def test_2d_sweep_axes_ride_along(self):
        """The launch-scalar sweep axes work on the 2D mesh too."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        _, cos1, _, _ = ensemble.run_ensemble(
            p, n_trials=2, base_seed=0, run_seed=50,
            d_scales=[1.0, 0.25])
        _, cos2, _, _ = ensemble.run_ensemble(
            p, n_trials=2, base_seed=0, run_seed=50,
            d_scales=[1.0, 0.25], walker_shards=2)
        np.testing.assert_allclose(cos2, cos1, atol=1e-3)

    def test_caller_mesh_walker_axis_must_match(self):
        """A caller-provided 2D mesh whose walker axis disagrees with
        walker_shards would silently misassign walkers to RNG lanes on
        the pallas path — it must be rejected at the boundary."""
        from jax.sharding import Mesh
        p = P.small_test_params(num_water=32, totaltime=0.0002,
                                sprint_steps=200)
        devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
        mesh = Mesh(devs, (ensemble.TRIAL_AXIS, sharding.WALKER_AXIS))
        with pytest.raises(ValueError, match="must equal walker_shards"):
            ensemble.run_ensemble(p, n_trials=2, walker_shards=2,
                                  mesh=mesh)

    def test_invalid_walker_shards_rejected(self):
        p = P.small_test_params(num_water=30, totaltime=0.0002,
                                sprint_steps=200)
        with pytest.raises(ValueError, match="divide evenly"):
            ensemble.run_ensemble(p, n_trials=2, walker_shards=4)
        p2 = P.small_test_params(num_water=32, totaltime=0.0002,
                                 sprint_steps=200)
        with pytest.raises(ValueError, match="device count"):
            ensemble.run_ensemble(p2, n_trials=2, walker_shards=3)


class TestEnsemblePadding:
    """Round-3 behavior: when we pick the mesh it
    is right-sized, so indivisible trial counts no longer burn up to
    n_dev-1 whole padded simulations."""

    def test_indivisible_trials_rightsize_no_padding(self):
        """3 trials on 8 devices: a 3-device mesh, zero padding, no
        warning, and exactly n_trials results."""
        import warnings
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            _, cos, _, st = ensemble.run_ensemble(p, n_trials=3,
                                                  base_seed=0, run_seed=50)
        assert not any("padding" in str(x.message) for x in w)
        assert cos.shape[0] == 3
        assert np.asarray(st.pos).shape[0] == 3

    def test_trial_mesh_minimal_padding(self):
        import jax
        n_dev = len(jax.devices())
        assert n_dev == 8  # conftest forces the 8-device CPU mesh
        mesh, padded = ensemble._trial_mesh(2, None)
        assert mesh.shape[ensemble.TRIAL_AXIS] == 2 and padded == 2
        mesh, padded = ensemble._trial_mesh(7, None)
        assert mesh.shape[ensemble.TRIAL_AXIS] == 7 and padded == 7
        # 9 trials: optimal wall is 2 rounds; 5 devices x 2 rounds pads
        # just 1 trial (the old full-width mesh padded 7)
        import warnings
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mesh, padded = ensemble._trial_mesh(9, None)
        assert mesh.shape[ensemble.TRIAL_AXIS] == 5 and padded == 10
        assert any("padding" in str(x.message) for x in w)

    def test_explicit_mesh_warns_and_pads(self):
        """A caller-provided mesh is honored as-is: indivisible trials
        pad up to its size with a warning."""
        import warnings

        import jax
        from jax.sharding import Mesh
        mesh = Mesh(np.asarray(jax.devices()), (ensemble.TRIAL_AXIS,))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            m2, padded = ensemble._trial_mesh(3, mesh)
        assert m2 is mesh and padded == 8
        assert any("does not divide" in str(x.message) for x in w)

    def test_divisible_trials_do_not_warn(self):
        import warnings
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ensemble.run_ensemble(p, n_trials=8, base_seed=0, run_seed=50)
        assert not any("does not divide" in str(x.message) for x in w)

    def test_swept_cell_rs_validated(self):
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        with pytest.raises(ValueError, match="cell_r"):
            ensemble.run_ensemble(p, n_trials=2, base_seed=0, run_seed=50,
                                  cell_rs=[0.5, 0.0])


class TestDynScalarGuards:
    """Concrete tcp/cell_r overrides entering the engines must be
    rejected at the door (ADVICE r2: unsigned end_step % 0)."""

    def test_scan_engine_rejects_tcp_zero(self):
        p = P.small_test_params(num_water=16, totaltime=0.0005,
                                sprint_steps=500)
        sc = BacteriaBox(p, seed=0).populate()
        fn = re.make_sprint_fn(p)
        st = re.init_state(sc.waters, p)
        import jax.numpy as jnp
        key = jnp.asarray([1, 2], dtype=jnp.uint32)
        mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mm = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        with pytest.raises(ValueError, match="tcp"):
            fn(mp, mm, key, st, 0, tcp=0)

    def test_grid_mode_rejects_cell_r_override(self):
        from mri_nanoparticle_simulation_tpu.fields import grid as grid_mod
        p = P.small_test_params(num_water=16, totaltime=0.0005,
                                sprint_steps=500, field_mode="grid")
        sc = BacteriaBox(p, seed=0).populate()
        import jax.numpy as jnp
        mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mm = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        fg = grid_mod.build_grid(mp, mm, p, grid_n=8, max_residents=8)
        fn = re.make_sprint_fn(p, field_grid=fg)
        st = re.init_state(sc.waters, p)
        key = jnp.asarray([1, 2], dtype=jnp.uint32)
        with pytest.raises(ValueError, match="grid"):
            fn(mp, mm, key, st, 0, cell_r=0.7)


class TestShardedBigScene:
    def test_sharded_fused_recand_matches_single_device(self, monkeypatch):
        """Big-scene path under shard_map: the far-table cache replicates
        over the mesh and every shard runs the XLA field-model rebuild
        feeding the kernel — bitwise-identical walker physics to the
        single-device run (global Threefry lanes)."""
        from mri_nanoparticle_simulation_tpu import rng as rng_mod
        from mri_nanoparticle_simulation_tpu.engine import (
            pallas_engine, reference_engine)
        from mri_nanoparticle_simulation_tpu.fields import expansion
        p = P.small_test_params(num_water=256, totaltime=0.0005,
                                sprint_steps=500, mmoment=3.5e-15,
                                cube_hash_dim=8, far_table_order=3)
        sc = BacteriaBox(p, seed=3).populate()
        mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        cache = expansion.build_cache(mp, mM, p)
        mesh = sharding.make_walker_mesh(jax.devices("cpu"))
        t1, c1, s1, st1 = sharding.run_simulation_sharded_pallas(
            sc, p, mesh=mesh, seed=3, interpret=True, cache=cache)

        # single-device fused run with the same cache
        sprint = pallas_engine.make_sprint_fn(p, 256, interpret=True)
        kk = rng_mod.key_from_seed(3)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps = pallas_engine.to_planes(
            reference_engine.init_state(sc.waters, p), p)
        outs = []
        for _ in range(p.t // p.sprint_steps):
            ps, wins = sprint(mp, mM, key_arr, ps, 0, cache)
            outs.append(wins)
        wins = np.asarray(jnp.concatenate(outs, axis=0))
        st2 = pallas_engine.from_planes(ps, 256)
        np.testing.assert_array_equal(np.asarray(st1.pos),
                                      np.asarray(st2.pos))
        np.testing.assert_array_equal(np.asarray(st1.phase),
                                      np.asarray(st2.phase))
        np.testing.assert_allclose(c1, wins[:, 0], atol=1e-3)


class TestRunCellRs:
    """run_ensemble(run_cell_rs=...): the runtime residency radius on
    FIXED geometry — the fit_cell_radius_crn / golden cell_r arm
    semantics, distinct from cell_rs (which rebuilds each scene)."""

    def test_identity_at_params_radius(self):
        """run_cell_rs at the params radius is the plain ensemble,
        bitwise (the launch scalar bakes to the same value)."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500)
        _, cos0, _, st0 = ensemble.run_ensemble(
            p, n_trials=2, base_seed=3, run_seed=9)
        _, cos1, _, st1 = ensemble.run_ensemble(
            p, n_trials=2, base_seed=3, run_seed=9,
            run_cell_rs=[p.cell_r, p.cell_r])
        np.testing.assert_array_equal(cos0, cos1)
        np.testing.assert_array_equal(np.asarray(st0.pos),
                                      np.asarray(st1.pos))

    def test_fixed_geometry_runtime_radius(self):
        """The scene keeps the params geometry; the trial runs at the
        override radius — equal to a single-scene run with the engine's
        cell_r override (NOT to a scene rebuilt at that radius)."""
        p = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500, mmoment=5e-14)
        from mri_nanoparticle_simulation_tpu import inverse as inv
        v = 0.8
        _, cos, _, _ = ensemble.run_ensemble(
            p, n_trials=1, base_seed=3, run_seed=9, run_cell_rs=[v])
        sc = BacteriaBox(p, seed=3).populate()      # params geometry
        c2 = inv.make_engine_curve_fn(p, sc, seed=9,
                                      engine="scan")(cell_r=v)
        np.testing.assert_allclose(cos[0] / p.num_water, c2, atol=1e-5)
        # and it genuinely differs from the params-radius run
        _, cos0, _, _ = ensemble.run_ensemble(
            p, n_trials=1, base_seed=3, run_seed=9)
        assert np.abs(cos0[0] - cos[0]).max() > 1e-3

    def test_mutually_exclusive_with_cell_rs(self):
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        with pytest.raises(ValueError, match="one, not both"):
            ensemble.run_ensemble(p, n_trials=1, run_cell_rs=[0.5],
                                  cell_rs=[0.5])

    def test_coverage_checked_at_run_radius(self):
        """A run radius whose reach overflows near_k must raise — the
        scenes were built (and would pass) at the smaller params radius."""
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200, num_cells=48,
                                near_k=3)
        with pytest.raises(ValueError, match="near_k"):
            ensemble.run_ensemble(p, n_trials=1, base_seed=1,
                                  run_cell_rs=[2.5])

    def test_validated_like_cell_rs(self):
        p = P.small_test_params(num_water=16, totaltime=0.0002,
                                sprint_steps=200)
        with pytest.raises(ValueError):
            ensemble.run_ensemble(p, n_trials=2, run_cell_rs=[0.5])
        with pytest.raises(ValueError):
            ensemble.run_ensemble(p, n_trials=1, run_cell_rs=[0.0])


class TestPermeabilitySweep:
    """The P axis: per-trial permeability riding the engines' reflect
    launch scalars through Params.reflect_pair (parameters.h:116-117
    formulas) — one compiled program across membrane physics."""

    @staticmethod
    def _base():
        # D x100 so 500 steps produce many membrane crossings (default
        # D moves a walker ~0.05 um — no reflection events to compare)
        b = P.small_test_params(num_water=32, totaltime=0.0005,
                                sprint_steps=500, water_start_bound=7.9,
                                avoid_intracellular_throw=False,
                                near_k=12)   # covers the x100 D travel
        return b.replace(D_cell=b.D_cell * 100, D_extra=b.D_extra * 100)

    @staticmethod
    def _p_vals(p):
        import math
        bound = 1.0 / (math.sqrt(p.tau / (6.0 * p.D_cell)) * 4.0)
        return [bound * 0.2, bound * 0.8]

    def test_p_sweep_matches_static_params(self):
        p = self._base()
        vals = self._p_vals(p)
        _, curves = ensemble.run_parameter_sweep(p, "P", vals,
                                                 n_trials_each=1)
        for i, v in enumerate(vals):
            pv = p.with_permeability(v)
            sc = BacteriaBox(p, seed=i).populate()  # P: same geometry
            _, c2, _, _ = re.run_simulation(sc, pv, seed=1000 + i)
            np.testing.assert_allclose(curves[i, 0], c2, atol=1e-4)
        # the two P values really produce different membrane physics
        assert not np.allclose(curves[0, 0], curves[1, 0], rtol=0,
                               atol=1e-7)

    def test_p_sweep_pallas_engine(self):
        p = self._base()
        vals = self._p_vals(p)
        _, curves = ensemble.run_parameter_sweep(
            p, "P", vals, n_trials_each=1, engine="pallas",
            interpret=True)
        from mri_nanoparticle_simulation_tpu.engine import pallas_engine
        for i, v in enumerate(vals):
            pv = p.with_permeability(v)
            sc = BacteriaBox(p, seed=i).populate()
            _, c2, _, _ = pallas_engine.run_simulation(
                sc, pv, seed=1000 + i, interpret=True)
            np.testing.assert_allclose(curves[i, 0], c2, atol=1e-4)

    def test_invalid_p_rejected(self):
        p = self._base().with_permeability()
        with pytest.raises(ValueError, match="permeability"):
            ensemble.run_ensemble(p, n_trials=1, permeabilities=[-1.0])
        bound = self._p_vals(p)[1] / 0.8
        with pytest.raises(ValueError, match="validity bound"):
            ensemble.run_ensemble(p, n_trials=1,
                                  permeabilities=[bound * 1.5])

    def test_reflection_off_params_guarded(self):
        """run_ensemble demands reflection traced in; the sweep helpers
        promote automatically."""
        p = self._base()        # reflect_io = reflect_oi = 0
        with pytest.raises(ValueError, match="with_permeability"):
            ensemble.run_ensemble(p, n_trials=1,
                                  permeabilities=self._p_vals(p)[:1])
