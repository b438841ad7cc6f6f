"""Chunk-kernel cross-validation against the scan engine.

Run in Pallas' interpreter on CPU with the shared Threefry streams: the
two engines consume identical random numbers and execute the same
arithmetic, so trajectories agree to within compiler-level FMA/association
differences (a few ULPs over thousands of steps) — the strongest practical
equivalence for a rewritten kernel.  The compiled kernel on the card is
exercised by the gpu-marked tests (TestOnGpu, tests/test_gpu_hardware.py)
and chip_smoke.py; TestTritonLowering checks here that every kernel
variant lowers through the Triton route for CUDA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mri_nanoparticle_simulation_tpu import params as P
from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
from mri_nanoparticle_simulation_tpu.engine import reference_engine as re
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox


def both(p, seed_scene=3, seed=1):
    sc = BacteriaBox(p, seed=seed_scene).populate()
    r = re.run_simulation(sc, p, seed=seed, dtype=jnp.float32)
    q = pe.run_simulation(sc, p, seed=seed, dtype=jnp.float32,
                          interpret=True)
    return r, q


class TestEngineEquivalence:
    def test_chunk_equals_pfreq(self):
        p = P.small_test_params(chunk_steps=100, print_interval=0.0001,
                                num_water=64, totaltime=0.001,
                                sprint_steps=500)
        (_, c1, s1, st1), (_, c2, s2, st2) = both(p)
        np.testing.assert_allclose(np.asarray(st1.pos),
                                   np.asarray(st2.pos), atol=5e-6)
        np.testing.assert_allclose(c1, c2, atol=1e-3)

    def test_chunk_spans_windows(self):
        """chunk = 2 x pfreq: the production regime (chunk-major scan vs
        multi-window kernel)."""
        p = P.small_test_params(chunk_steps=200, print_interval=0.0001,
                                num_water=64, totaltime=0.0008,
                                sprint_steps=400)
        (_, c1, s1, st1), (_, c2, s2, st2) = both(p)
        np.testing.assert_allclose(np.asarray(st1.pos),
                                   np.asarray(st2.pos), atol=5e-6)
        np.testing.assert_allclose(c1, c2, atol=1e-3)
        assert int(st1.step) == int(st2.step) == p.t

    def test_with_reflection(self):
        p = P.small_test_params(chunk_steps=100, print_interval=0.0001,
                                num_water=32, totaltime=0.0004,
                                sprint_steps=400, water_start_bound=7.9,
                                avoid_intracellular_throw=False,
                                ).with_permeability()
        (_, c1, _, st1), (_, c2, _, st2) = both(p)
        np.testing.assert_allclose(np.asarray(st1.pos),
                                   np.asarray(st2.pos), atol=5e-6)
        np.testing.assert_allclose(c1, c2, atol=1e-3)

    def test_intended_kick(self):
        p = P.small_test_params(chunk_steps=100, print_interval=0.0001,
                                num_water=32, totaltime=0.0004,
                                sprint_steps=400, water_start_bound=7.9,
                                avoid_intracellular_throw=False,
                                kick_mode=P.KICK_INTENDED)
        (_, c1, _, st1), (_, c2, _, st2) = both(p)
        np.testing.assert_array_equal(np.asarray(st1.pos),
                                      np.asarray(st2.pos))
        np.testing.assert_allclose(c1, c2, atol=1e-3)

    def test_nonmultiple_walker_padding(self):
        """num_water not a multiple of 128: dummy lanes must not leak into
        the magnetization."""
        p = P.small_test_params(chunk_steps=100, print_interval=0.0001,
                                num_water=50, totaltime=0.0002,
                                sprint_steps=200)
        (_, c1, _, st1), (_, c2, _, st2) = both(p)
        np.testing.assert_allclose(np.asarray(st1.pos),
                                   np.asarray(st2.pos), atol=5e-6)
        np.testing.assert_allclose(c1, c2, atol=1e-3)
        assert abs(c2[0]) <= 50.0 + 1e-6


class TestPlaneRoundtrip:
    def test_to_from_planes(self):
        p = P.small_test_params(num_water=50)
        sc = BacteriaBox(p, seed=1).populate()
        st = re.init_state(sc.waters, p)
        ps = pe.to_planes(st, p)
        st2 = pe.from_planes(ps, 50)
        np.testing.assert_array_equal(np.asarray(st.pos),
                                      np.asarray(st2.pos))
        np.testing.assert_array_equal(np.asarray(st.in_cell),
                                      np.asarray(st2.in_cell))


@pytest.mark.gpu
class TestOnGpu:
    def test_compiled_kernel_matches_scan(self):
        """Triton-compiled kernel vs scan engine on the card.  Same
        Threefry streams; XLA and Triton both contract to FMA in their
        own order, so positions agree to f32 rounding (1e-4 µm) and
        window sums to 0.05 of 64 walkers."""
        p = P.small_test_params(chunk_steps=100, print_interval=0.0001,
                                num_water=64, totaltime=0.0005,
                                sprint_steps=500)
        sc = BacteriaBox(p, seed=3).populate()
        _, c1, _, st1 = re.run_simulation(sc, p, seed=1, dtype=jnp.float32)
        _, c2, _, st2 = pe.run_simulation(sc, p, seed=1, dtype=jnp.float32,
                                          interpret=False)
        np.testing.assert_allclose(np.asarray(st1.pos),
                                   np.asarray(st2.pos), atol=1e-4)
        np.testing.assert_allclose(c1, c2, atol=0.05)

    def test_big_scene_path_on_gpu(self):
        """The big-scene path (XLA field-model rebuild feeding the
        kernel) on the card: forced with an all-candidates cache (exact
        partition — far table identically zero), it must match the scan
        engine like every other path."""
        from mri_nanoparticle_simulation_tpu import rng
        from mri_nanoparticle_simulation_tpu.fields import expansion
        p = P.small_test_params(num_water=128, totaltime=0.001,
                                sprint_steps=500, mmoment=3.5e-15,
                                cube_hash_dim=8, far_table_order=3)
        sc = BacteriaBox(p, seed=3).populate()
        mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        assert sc.mnps.shape[0] <= p.cube_candidates
        cache = expansion.build_cache(mp, mM, p)
        sprint = pe.make_sprint_fn(p, 128)
        kk = rng.key_from_seed(9)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps = pe.to_planes(re.init_state(sc.waters, p), p)
        outs = []
        for _ in range(p.t // p.sprint_steps):
            ps, wins = sprint(mp, mM, key_arr, ps, 0, cache)
            outs.append(wins)
        wins = np.asarray(jnp.concatenate(outs, axis=0))
        st = pe.from_planes(ps, 128)
        _, c2, _, st2 = re.run_simulation(sc, p, seed=9)
        np.testing.assert_allclose(np.asarray(st.pos),
                                   np.asarray(st2.pos), atol=1e-4)
        np.testing.assert_allclose(wins[:, 0], c2, atol=0.05)

    def test_runtime_sweep_scalars_on_gpu(self):
        """The sweep launch scalars through the compiled kernel (the CP
        flip is a scalar mod by a launch scalar; cell_r² rides as a bit
        pattern): a runtime-override run must be bitwise-equal to the
        statically-compiled engine."""
        from mri_nanoparticle_simulation_tpu import rng
        p = P.small_test_params(num_water=256, totaltime=0.001,
                                sprint_steps=500)
        pv = p.replace(taucp=0.0003, cell_r=0.4).validate()
        sc = BacteriaBox(pv, seed=3).populate()
        _, c_s, _, st_s = pe.run_simulation(sc, pv, seed=9)
        sprint = pe.make_sprint_fn(p, sc.waters.shape[0])
        kk = rng.key_from_seed(9)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps = pe.to_planes(re.init_state(sc.waters, pv), pv)
        mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        outs = []
        for _ in range(pv.t // pv.sprint_steps):
            ps, wins = sprint(mp, mM, key_arr, ps, 0,
                              tcp=jnp.uint32(pv.tcp),
                              cell_r=jnp.float32(pv.cell_r))
            outs.append(wins)
        wins = np.asarray(jnp.concatenate(outs, axis=0))
        st_r = pe.from_planes(ps, sc.waters.shape[0])
        np.testing.assert_array_equal(np.asarray(st_r.pos),
                                      np.asarray(st_s.pos))
        np.testing.assert_array_equal(wins[:, 0], np.asarray(c_s))


class TestMultiBlock:
    def test_two_block_grid_matches_scan(self):
        """A population spread over many kernel programs, with the last
        plane only partly filled: physics must match the scan engine
        exactly (per-program lane offsets and the valid mask are the
        risks)."""
        p = P.small_test_params(chunk_steps=100, print_interval=0.0001,
                                num_water=4200, num_cells=12,
                                totaltime=0.0002, sprint_steps=200,
                                taucp=0.0001)
        sc = BacteriaBox(p, seed=3).populate()
        _, c1, _, st1 = re.run_simulation(sc, p, seed=1, dtype=jnp.float32)
        _, c2, _, st2 = pe.run_simulation(sc, p, seed=1, dtype=jnp.float32,
                                          interpret=True)
        assert pe.pad_count(4200) == 4224
        assert pe.pad_count(4200) // pe.BLOCK_WALKERS > 1  # many programs
        np.testing.assert_allclose(np.asarray(st1.pos),
                                   np.asarray(st2.pos), atol=5e-6)
        np.testing.assert_allclose(c1, c2, atol=1e-2)


class TestOddPfreq:
    def test_odd_pfreq_step_count_threefry(self):
        """pfreq=125 (odd): the in-kernel window loop must count every
        step; constant-kick phase counts steps exactly."""
        p = P.Params(num_water=32, num_cells=1, mmoment=0.0,
                     kick_mode=P.KICK_CONSTANT, phase_k=400.0, bound=8.0,
                     cell_r=3.5, water_start_bound=1.0,
                     avoid_intracellular_throw=False, tau=8e-6,
                     totaltime=0.002, taucp=0.001, print_interval=1e-3,
                     sprint_steps=250, chunk_steps=125, near_k=1,
                     hash_dim=4, max_neighbors=4).validate()
        assert p.pfreq % 2 == 1
        sc = BacteriaBox(p, seed=2).populate()
        _, c, _, _ = pe.run_simulation(sc, p, seed=8, interpret=True)
        K = p.phase_k * p.tau
        phase, expect = 0.0, []
        for step in range(p.pfreq, p.t + 1, p.pfreq):
            phase += p.pfreq * K
            expect.append(p.num_water * np.cos(phase))
            if step % p.tcp == 0:
                phase = -phase
        np.testing.assert_allclose(c, expect, rtol=1e-5)


class TestRuntimeSweepScalars:
    """taucp / cell_r as launch scalars (sweep-ergonomics path): a sprint
    compiled from BASE params but fed runtime tcp / cell_r overrides must
    match, bitwise, an engine compiled with those values baked statically
    — proving the scalar plumbing carries the full physics (CP flip
    timing and the containment radius) with zero recompiles."""

    def _scene_and_static(self, pv, engine):
        sc = BacteriaBox(pv, seed=3).populate()
        if engine == "pallas":
            r = pe.run_simulation(sc, pv, seed=9, interpret=True)
        else:
            r = re.run_simulation(sc, pv, seed=9)
        return sc, r

    def test_pallas_runtime_scalars_match_static(self):
        from mri_nanoparticle_simulation_tpu import rng
        p = P.small_test_params(num_water=64, totaltime=0.001,
                                sprint_steps=500)
        pv = p.replace(taucp=0.0003, cell_r=0.4).validate()
        sc, (_, c_s, _, st_s) = self._scene_and_static(pv, "pallas")

        sprint = pe.make_sprint_fn(p, sc.waters.shape[0], interpret=True)
        kk = rng.key_from_seed(9)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps = pe.to_planes(re.init_state(sc.waters, pv), pv)
        mnp_pos = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mnp_M = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        outs = []
        for _ in range(pv.t // pv.sprint_steps):
            ps, wins = sprint(mnp_pos, mnp_M, key_arr, ps, 0,
                              tcp=jnp.uint32(pv.tcp),
                              cell_r=jnp.float32(pv.cell_r))
            outs.append(wins)
        wins = np.asarray(jnp.concatenate(outs, axis=0))
        st_r = pe.from_planes(ps, sc.waters.shape[0])
        np.testing.assert_array_equal(np.asarray(st_r.pos),
                                      np.asarray(st_s.pos))
        np.testing.assert_array_equal(np.asarray(st_r.phase),
                                      np.asarray(st_s.phase))
        np.testing.assert_array_equal(wins[:, 0], c_s)

    def test_scan_runtime_scalars_match_static(self):
        from mri_nanoparticle_simulation_tpu import rng
        p = P.small_test_params(num_water=64, totaltime=0.001,
                                sprint_steps=500)
        pv = p.replace(taucp=0.0003, cell_r=0.4).validate()
        sc, (_, c_s, _, st_s) = self._scene_and_static(pv, "scan")

        sprint = re.make_sprint_fn(p)
        kk = rng.key_from_seed(9)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        st = re.init_state(sc.waters, pv)
        mnp_pos = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mnp_M = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        outs = []
        for _ in range(pv.t // pv.sprint_steps):
            st, wins = sprint(mnp_pos, mnp_M, key_arr, st, 0,
                              tcp=jnp.uint32(pv.tcp),
                              cell_r=jnp.float32(pv.cell_r))
            outs.append(wins)
        wins = np.asarray(jnp.concatenate(outs, axis=0))
        np.testing.assert_array_equal(np.asarray(st.pos),
                                      np.asarray(st_s.pos))
        np.testing.assert_array_equal(np.asarray(st.phase),
                                      np.asarray(st_s.phase))
        np.testing.assert_array_equal(wins[:, 0], c_s)

    def test_default_none_is_bitwise_identical(self):
        """Passing no overrides must reproduce the pre-change program
        exactly (the params values ride the same launch scalars)."""
        p = P.small_test_params(num_water=64, totaltime=0.0005,
                                sprint_steps=500)
        sc = BacteriaBox(p, seed=3).populate()
        _, c1, _, st1 = pe.run_simulation(sc, p, seed=9, interpret=True)
        _, c2, _, st2 = re.run_simulation(sc, p, seed=9)
        np.testing.assert_allclose(np.asarray(st1.pos),
                                   np.asarray(st2.pos), atol=5e-6)
        np.testing.assert_allclose(c1, c2, atol=1e-3)


class TestDiffusionScaleScalar:
    """The d_scale launch scalar in the Pallas kernel: runtime
    diffusion-coefficient scaling (stdev x sqrt(d_scale)), matching the
    scan engine's dyn stdev scale bitwise on shared Threefry streams."""

    def _pallas_sprints(self, p, sc, d_scale=None):
        from mri_nanoparticle_simulation_tpu import rng
        sprint = pe.make_sprint_fn(p, sc.waters.shape[0], interpret=True)
        kk = rng.key_from_seed(9)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps = pe.to_planes(re.init_state(sc.waters, p), p)
        mnp_pos = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mnp_M = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        outs = []
        for _ in range(p.t // p.sprint_steps):
            ps, wins = sprint(mnp_pos, mnp_M, key_arr, ps, 0,
                              d_scale=d_scale)
            outs.append(wins)
        st = pe.from_planes(ps, sc.waters.shape[0])
        return np.asarray(st.pos), np.asarray(
            jnp.concatenate(outs, axis=0))

    def test_identity_override_bitwise(self):
        p = P.small_test_params(num_water=64, totaltime=0.0005,
                                sprint_steps=500)
        sc = BacteriaBox(p, seed=3).populate()
        pos0, w0 = self._pallas_sprints(p, sc)
        pos1, w1 = self._pallas_sprints(p, sc, d_scale=1.0)
        np.testing.assert_array_equal(pos0, pos1)
        np.testing.assert_array_equal(w0, w1)

    def test_matches_scan_engine_scaled(self):
        """d_scale=0.25 through the kernel vs the scan engine's dyn
        scalar: identical Threefry streams, same multiply order ->
        trajectories agree to interpreter-level rounding."""
        from mri_nanoparticle_simulation_tpu import rng
        p = P.small_test_params(num_water=64, totaltime=0.0005,
                                sprint_steps=500)
        sc = BacteriaBox(p, seed=3).populate()
        pos_p, w_p = self._pallas_sprints(p, sc, d_scale=0.25)

        sprint = re.make_sprint_fn(p)
        kk = rng.key_from_seed(9)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        st = re.init_state(sc.waters, p)
        mnp_pos = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mnp_M = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        outs = []
        for _ in range(p.t // p.sprint_steps):
            st, wins = sprint(mnp_pos, mnp_M, key_arr, st, 0,
                              d_scale=0.25)
            outs.append(wins)
        w_s = np.asarray(jnp.concatenate(outs, axis=0))
        np.testing.assert_allclose(pos_p, np.asarray(st.pos), atol=5e-6)
        np.testing.assert_allclose(w_p[:, 0], w_s[:, 0], atol=1e-3)

    def test_nonpositive_rejected(self):
        p = P.small_test_params(num_water=64, totaltime=0.0005,
                                sprint_steps=500)
        sc = BacteriaBox(p, seed=3).populate()
        with pytest.raises(ValueError, match="d_scale"):
            self._pallas_sprints(p, sc, d_scale=-1.0)


class TestBigScenePathFused:
    def test_fused_recand_matches_scan_engine(self):
        """Force the big-scene path (the cube-candidate field-model
        rebuild, expansion.build, feeds the kernel) with a
        far-table cache whose candidate set covers EVERY dipole, so the
        table term is identically zero and the rebuild is an exact
        partition — the engine must then match the scan engine to the
        usual cross-engine tolerance."""
        from mri_nanoparticle_simulation_tpu import rng as rng_mod
        from mri_nanoparticle_simulation_tpu.fields import expansion
        p = P.small_test_params(num_water=128, totaltime=0.001,
                                sprint_steps=500, mmoment=3.5e-15,
                                cube_hash_dim=8, far_table_order=3)
        sc = BacteriaBox(p, seed=3).populate()
        mp = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mM = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        assert sc.mnps.shape[0] <= p.cube_candidates
        cache = expansion.build_cache(mp, mM, p)
        assert cache.far_coeffs is not None
        sprint = pe.make_sprint_fn(p, 128, interpret=True)
        kk = rng_mod.key_from_seed(9)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps = pe.to_planes(re.init_state(sc.waters, p), p)
        outs = []
        for _ in range(p.t // p.sprint_steps):
            ps, wins = sprint(mp, mM, key_arr, ps, 0, cache)
            outs.append(wins)
        wins = np.asarray(jnp.concatenate(outs, axis=0))
        st = pe.from_planes(ps, 128)
        _, c2, _, st2 = re.run_simulation(sc, p, seed=9)
        np.testing.assert_allclose(np.asarray(st.pos),
                                   np.asarray(st2.pos), atol=5e-6)
        np.testing.assert_allclose(wins[:, 0], c2, atol=1e-3)
        assert int(st.step) == int(st2.step) == p.t


class TestReflectScalar:
    """The reflect=(reflect_io, reflect_oi) launch scalars in the Pallas
    kernel (scalars[9]/[10]): runtime membrane bounce probabilities,
    matching the scan engine's dyn scalars on shared Threefry streams."""

    @staticmethod
    def _perm_params():
        # D x100 so 500 steps produce many membrane crossings
        base = P.small_test_params(
            num_water=64, totaltime=0.0005, sprint_steps=500,
            water_start_bound=7.9, avoid_intracellular_throw=False)
        return base.replace(D_cell=base.D_cell * 100,
                            D_extra=base.D_extra * 100).with_permeability()

    def _pallas_sprints(self, p, sc, reflect=None):
        from mri_nanoparticle_simulation_tpu import rng
        sprint = pe.make_sprint_fn(p, sc.waters.shape[0], interpret=True)
        kk = rng.key_from_seed(11)
        key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
        ps = pe.to_planes(re.init_state(sc.waters, p), p)
        mnp_pos = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mnp_M = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        outs = []
        for _ in range(p.t // p.sprint_steps):
            ps, wins = sprint(mnp_pos, mnp_M, key_arr, ps, 0,
                              reflect=reflect)
            outs.append(wins)
        st = pe.from_planes(ps, sc.waters.shape[0])
        return np.asarray(st.pos), np.asarray(
            jnp.concatenate(outs, axis=0))

    def test_identity_override_bitwise(self):
        p = self._perm_params()
        sc = BacteriaBox(p, seed=5).populate()
        pos0, w0 = self._pallas_sprints(p, sc)
        pos1, w1 = self._pallas_sprints(
            p, sc, reflect=(p.reflect_io, p.reflect_oi))
        np.testing.assert_array_equal(pos0, pos1)
        np.testing.assert_array_equal(w0, w1)

    def test_asymmetric_override_matches_static_params(self):
        """(0.9, 0.3) as launch scalars through a kernel compiled with
        different static probabilities == the same values baked in."""
        p = self._perm_params()
        sc = BacteriaBox(p, seed=5).populate()
        pos_dyn, w_dyn = self._pallas_sprints(p, sc, reflect=(0.9, 0.3))
        p_static = p.replace(reflect_io=0.9, reflect_oi=0.3)
        pos_st, w_st = self._pallas_sprints(p_static, sc)
        np.testing.assert_array_equal(pos_dyn, pos_st)
        np.testing.assert_array_equal(w_dyn, w_st)
        # transparent membranes must differ (the scalar is really live)
        pos0, _ = self._pallas_sprints(p, sc, reflect=(0.0, 0.0))
        assert not np.array_equal(pos_dyn, pos0)

    def test_rejected_when_reflection_compiled_out(self):
        p = P.small_test_params(num_water=64, totaltime=0.0005,
                                sprint_steps=500)
        sc = BacteriaBox(p, seed=5).populate()
        with pytest.raises(ValueError, match="reflection enabled"):
            self._pallas_sprints(p, sc, reflect=(0.5, 0.5))


class TestChooseEngine:
    """pallas_engine.choose_engine: the one platform -> engine decision."""

    def test_gpu_picks_the_kernel(self, monkeypatch):
        monkeypatch.setattr(pe, "on_gpu", lambda: True)
        assert pe.choose_engine() == "pallas"
        assert pe.choose_engine("pallas") == "pallas"
        assert pe.choose_engine(anywhere=True) == "pallas"

    def test_kernel_without_gpu_raises(self):
        assert not pe.on_gpu()          # the CPU test platform
        with pytest.raises(RuntimeError, match="GPU"):
            pe.choose_engine("pallas")
        with pytest.raises(RuntimeError, match="GPU"):
            pe.choose_engine()
        # the sprint builder enforces the same rule
        p = P.small_test_params(num_water=64)
        with pytest.raises(RuntimeError, match="GPU"):
            pe.make_sprint_fn(p, 64)

    @pytest.mark.parametrize("kwargs, want", [
        (dict(requested="scan"), "scan"),
        (dict(requested="pallas", interpret=True), "pallas"),
        (dict(interpret=True), "pallas"),
        (dict(anywhere=True), "scan"),
    ])
    def test_allowed_without_gpu(self, kwargs, want):
        assert pe.choose_engine(**kwargs) == want

    def test_explicit_kernel_request_is_not_rerouted(self):
        # anywhere= only applies when no engine was asked for
        with pytest.raises(RuntimeError, match="GPU"):
            pe.choose_engine("pallas", anywhere=True)

    def test_unknown_engine_rejected(self):
        with pytest.raises(ValueError, match="unknown engine"):
            pe.choose_engine("mosaic")

    def test_cli_refuses_kernel_without_gpu(self, tmp_path):
        from mri_nanoparticle_simulation_tpu.engine import sim
        with pytest.raises(SystemExit):
            sim.main(["--num-water", "32", "--num-cells", "8",
                      "--totaltime", "0.002", "--sprint-steps", "1000",
                      "--chunk-steps", "100", "--near-k", "6",
                      "--taucp", "0.001", "--hash-dim", "8",
                      "--out", str(tmp_path / "x.csv")])
        assert not (tmp_path / "x.csv").exists()

    def test_hardware_rng_refused(self):
        with pytest.raises(ValueError, match="Threefry"):
            pe.check_rng_impl("hardware")
        p = P.small_test_params(num_water=64)
        with pytest.raises(ValueError, match="Threefry"):
            pe.make_sprint_fn(p, 64, rng_impl="hardware", interpret=True)


class TestProgramBlocks:
    """Walker padding and the split of walkers over kernel programs."""

    @pytest.mark.parametrize("n", [1, 50, 127, 128, 129, 4032, 4200])
    def test_pad_count(self, n):
        wp = pe.pad_count(n)
        assert n <= wp < n + pe.LANES
        assert wp % pe.LANES == 0 and wp % pe.BLOCK_WALKERS == 0

    def test_block_must_be_warp_multiple_dividing_lanes(self, monkeypatch):
        p = P.small_test_params(num_water=64)
        for bad in (16, 48, 256):
            monkeypatch.setattr(pe, "BLOCK_WALKERS", bad)
            with pytest.raises(ValueError, match="BLOCK_WALKERS"):
                pe.make_chunk_kernel(p, 256, interpret=True)

    def test_program_split_does_not_change_physics(self, monkeypatch):
        """200 walkers (last plane partly filled) as 8 programs of 32 or
        2 programs of 128: programs share nothing, so every output —
        positions, phases and the per-program window sums added up by
        XLA — must be identical."""
        p = P.small_test_params(chunk_steps=100, print_interval=0.0001,
                                num_water=200, totaltime=0.0002,
                                sprint_steps=200)
        sc = BacteriaBox(p, seed=3).populate()
        runs = []
        for bw in (32, 128):
            monkeypatch.setattr(pe, "BLOCK_WALKERS", bw)
            runs.append(pe.run_simulation(sc, p, seed=2, interpret=True))
        (_, c1, s1, st1), (_, c2, s2, st2) = runs
        np.testing.assert_array_equal(np.asarray(st1.pos),
                                      np.asarray(st2.pos))
        np.testing.assert_array_equal(np.asarray(st1.phase),
                                      np.asarray(st2.phase))
        np.testing.assert_allclose(c1, c2, rtol=0, atol=1e-4)
        np.testing.assert_allclose(s1, s2, rtol=0, atol=1e-4)


class TestTritonLowering:
    """Every kernel variant lowers through the Triton route for CUDA —
    the step the card's compiler starts from — without a GPU present
    (jax.export lowers for a platform other than the local one)."""

    @pytest.mark.parametrize("physics", ["default", "reflect_intended"])
    @pytest.mark.parametrize("decompose", [False, True])
    def test_variant_lowers_for_cuda(self, physics, decompose):
        from jax import export
        p = P.small_test_params(num_water=256, near_k=4)
        if physics == "reflect_intended":
            # the 7-word draw: membrane coin + intended-kick uniform
            p = p.with_permeability().replace(kick_mode=P.KICK_INTENDED)
        wp = pe.pad_count(p.num_water)
        kern = pe.make_chunk_kernel(p, wp, decompose=decompose)
        n_state = 8 if decompose else 6
        args = [jax.ShapeDtypeStruct((10,), jnp.uint32),
                jax.ShapeDtypeStruct((n_state, wp), jnp.float32),
                jax.ShapeDtypeStruct((4, p.near_k, wp), jnp.float32),
                jax.ShapeDtypeStruct((10, wp), jnp.float32)]
        exp = export.export(
            jax.jit(kern), platforms=["cuda"],
            disabled_checks=[export.DisabledSafetyCheck.custom_call(
                "__gpu$xla.gpu.triton")])(*args)
        text = exp.mlir_module()
        assert "__gpu$xla.gpu.triton" in text
        assert f"num_warps = {pe.BLOCK_WALKERS // 32}" in text
