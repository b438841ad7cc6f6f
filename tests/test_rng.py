"""Threefry RNG: known-answer vectors and statistical quality.

The reference had no RNG tests (and was irreproducible by construction:
time(NULL) seeds at cuda_sim.cu:912, gpu_random.cu:22).  Counter-based RNG
makes determinism testable.
"""

import jax.numpy as jnp
import numpy as np

from mri_nanoparticle_simulation_tpu import rng


class TestKnownAnswer:
    """Random123 published known-answer tests for threefry2x32 (20 rounds)."""

    def test_kat_zero(self):
        x0, x1 = rng.threefry2x32(
            (jnp.uint32(0), jnp.uint32(0)), jnp.uint32(0), jnp.uint32(0))
        assert (int(x0), int(x1)) == (0x6B200159, 0x99BA4EFE)

    def test_kat_ones(self):
        k = (jnp.uint32(0xFFFFFFFF), jnp.uint32(0xFFFFFFFF))
        x0, x1 = rng.threefry2x32(
            k, jnp.uint32(0xFFFFFFFF), jnp.uint32(0xFFFFFFFF))
        assert (int(x0), int(x1)) == (0x1CB996FC, 0xBB002BE7)

    def test_kat_pi(self):
        k = (jnp.uint32(0x13198A2E), jnp.uint32(0x03707344))
        x0, x1 = rng.threefry2x32(
            k, jnp.uint32(0x243F6A88), jnp.uint32(0x85A308D3))
        assert (int(x0), int(x1)) == (0xC4923A9C, 0x483DF7A0)

    def test_kat_13_rounds(self):
        """Random123 KAT for the reduced-round (13) variant."""
        x0, x1 = rng.threefry2x32(
            (jnp.uint32(0), jnp.uint32(0)), jnp.uint32(0), jnp.uint32(0),
            rounds=12)
        # 13 rounds isn't a multiple of 4; we only support multiples of 4.
        # This test just checks reduced rounds run and differ from 20-round.
        y0, y1 = rng.threefry2x32(
            (jnp.uint32(0), jnp.uint32(0)), jnp.uint32(0), jnp.uint32(0))
        assert (int(x0), int(x1)) != (int(y0), int(y1))


class TestDeterminism:
    def test_same_counter_same_bits(self):
        key = rng.key_from_seed(42)
        lane = jnp.arange(256, dtype=jnp.uint32)
        a = rng.words_for_step(key, 7, lane, 6)
        b = rng.words_for_step(key, 7, lane, 6)
        for wa, wb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(wa), np.asarray(wb))

    def test_distinct_steps_distinct_bits(self):
        key = rng.key_from_seed(42)
        lane = jnp.arange(256, dtype=jnp.uint32)
        a = rng.words_for_step(key, 7, lane, 2)[0]
        b = rng.words_for_step(key, 8, lane, 2)[0]
        assert not np.array_equal(np.asarray(a), np.asarray(b))

    def test_distinct_pairs_distinct_bits(self):
        key = rng.key_from_seed(42)
        lane = jnp.arange(256, dtype=jnp.uint32)
        ws = rng.words_for_step(key, 3, lane, 6)
        flat = np.stack([np.asarray(w) for w in ws])
        # all 6 words per lane mutually distinct with overwhelming probability
        assert len({tuple(flat[:, i]) for i in range(256)}) == 256
        assert all(len(set(flat[:, i])) == 6 for i in range(0, 256, 37))


class TestDistributions:
    def test_uniform_moments(self):
        u = np.asarray(rng.uniforms(rng.key_from_seed(1), 0, (200_000,)))
        assert abs(u.mean() - 0.5) < 0.005
        assert abs(u.var() - 1 / 12) < 0.002
        assert u.min() >= 0.0 and u.max() < 1.0

    def test_uniform_f32_f64_identical_values(self, f64):
        """The f64 oracle and f32 engine must consume identical reals."""
        key = rng.key_from_seed(9)
        lane = jnp.arange(1000, dtype=jnp.uint32)
        bits = rng.words_for_step(key, 0, lane, 1)[0]
        u32 = np.asarray(rng.uniform_from_bits(bits, jnp.float32))
        u64 = np.asarray(rng.uniform_from_bits(bits, jnp.float64))
        np.testing.assert_array_equal(u32.astype(np.float64), u64)

    def test_normal_moments(self):
        key = rng.key_from_seed(5)
        lane = jnp.arange(200_000, dtype=jnp.uint32)
        a, b = rng.words_for_step(key, 0, lane, 2)
        n = np.asarray(rng.normal_from_bits(a, b))
        assert abs(n.mean()) < 0.01
        assert abs(n.std() - 1.0) < 0.01
        # Box-Muller magnitude cap at ~5.77 sigma
        assert np.abs(n).max() < 5.78

    def test_bit_balance(self):
        """Each of the 32 bit positions should be ~50% ones."""
        key = rng.key_from_seed(11)
        lane = jnp.arange(50_000, dtype=jnp.uint32)
        bits = np.asarray(rng.words_for_step(key, 0, lane, 1)[0])
        for pos in range(32):
            frac = ((bits >> pos) & 1).mean()
            assert abs(frac - 0.5) < 0.01, f"bit {pos} biased: {frac}"

    def test_no_step_correlation(self):
        key = rng.key_from_seed(13)
        lane = jnp.arange(20_000, dtype=jnp.uint32)
        u1 = np.asarray(rng.uniform_from_bits(
            rng.words_for_step(key, 0, lane, 1)[0], jnp.float32))
        u2 = np.asarray(rng.uniform_from_bits(
            rng.words_for_step(key, 1, lane, 1)[0], jnp.float32))
        corr = np.corrcoef(u1, u2)[0, 1]
        assert abs(corr) < 0.02
