"""Counter-based random number generation (Threefry-2x32).

Replacement for the reference's RNG layer:

* device RNG: cuRAND XORWOW batches filling 3.9 GB of per-sprint buffers
  (``src/gpu_random.{h,cu}``, ``src/cuda_sim.cu:54-55,929-947,976-977``);
* host RNG: xoroshiro128+ (``src/xorshift.h``).

Both are *stateful* generators, which forces the reference to materialize
every random number in memory before use and makes runs irreproducible
(seeded with ``time(NULL)``, gpu_random.cu:22, cuda_sim.cu:912).  A
counter-based generator is a pure function ``(key, counter) -> bits``: each
(walker, step, word) coordinate deterministically names its random number,
so the hot loop generates values in registers, checkpoint/resume is trivial
(the counter is the step index), and the same stream can be replayed by any
engine (the pure-JAX scan engine, the chunk kernel, or a NumPy oracle) for
bitwise cross-validation.

Everything here is plain ``jax.numpy`` on ``uint32``, so it runs unchanged
inside Pallas kernels, under ``jit``/``vmap``, and on CPU.

The 20-round Threefry-2x32 implemented here matches the Random123
specification (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
SC'11) and is validated against its published known-answer vectors in
``tests/test_rng.py``.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

# Threefry-2x32 rotation schedule (Random123).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # key-schedule parity constant (Skein/Threefish)

Key = Tuple[jnp.ndarray, jnp.ndarray]  # pair of uint32 scalars


def key_from_seed(seed: int) -> Key:
    """Derive a Threefry key from a 64-bit integer seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (jnp.uint32(seed >> 32), jnp.uint32(seed & 0xFFFFFFFF))


def _rotl32(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(key: Key, c0: jnp.ndarray, c1: jnp.ndarray,
                 rounds: int = 20) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Threefry-2x32 block cipher: encrypt counter (c0, c1) under ``key``.

    ``c0``/``c1`` may be arrays (broadcast together); returns two uint32
    arrays of the broadcast shape.  ``rounds=20`` is the standard (and
    jax.random-compatible) strength; 12 (the nearest multiple of 4 to the
    Random123-recommended minimum of 13 — injections happen every 4
    rounds here) is ample for Monte Carlo statistics and faster.
    """
    if rounds % 4 != 0:
        raise ValueError("rounds must be a multiple of 4")
    ks0 = jnp.uint32(key[0])
    ks1 = jnp.uint32(key[1])
    ks2 = ks0 ^ ks1 ^ jnp.uint32(_PARITY)
    ks = (ks0, ks1, ks2)

    x0 = jnp.asarray(c0, jnp.uint32) + ks0
    x1 = jnp.asarray(c1, jnp.uint32) + ks1

    for i in range(rounds):
        x0 = x0 + x1
        x1 = _rotl32(x1, _ROTATIONS[i % 8])
        x1 = x1 ^ x0
        if i % 4 == 3:
            j = i // 4 + 1
            x0 = x0 + ks[j % 3]
            x1 = x1 + ks[(j + 1) % 3] + jnp.uint32(j)
    return x0, x1


def words_for_step(key: Key, step: jnp.ndarray, lane: jnp.ndarray,
                   n_words: int, rounds: int = 20) -> list:
    """Random uint32 words for one timestep.

    Every (step, lane, word) coordinate maps to a unique Threefry counter:
    ``c0 = step``, ``c1 = lane + n_lanes_stride * pair`` where the stride is
    2**27 (supports up to 134M walkers and 32 word-pairs per step — the
    engine uses 3 pairs).  ``lane`` may be any int32 array (e.g. a
    program's walker-index vector inside the chunk kernel); ``step`` is a
    scalar.

    Returns a list of ``n_words`` uint32 arrays shaped like ``lane``.

    This replaces the reference scheme of pre-filling
    ``5 uniform + 1 normal doubles x num_water x sprintSteps`` buffers
    (cuda_sim.cu:929-947): here the words are (re)computed in registers.
    """
    n_pairs = (n_words + 1) // 2
    step = jnp.asarray(step, jnp.uint32)
    lane = jnp.asarray(lane, jnp.uint32)
    out = []
    for pair in range(n_pairs):
        c1 = lane + jnp.uint32(pair << 27)
        w0, w1 = threefry2x32(key, step, c1, rounds=rounds)
        out.append(w0)
        out.append(w1)
    return out[:n_words]


def uniform_from_bits(bits: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """Map uint32 bits to a uniform float in [0, 1).

    Uses the top 24 bits so the resulting value is exactly representable in
    float32 — the float64 CPU oracle and the float32 engines therefore
    consume *identical* real numbers, enabling trajectory-level
    cross-validation.  (The reference drew float64 uniforms from cuRAND;
    24-bit resolution is far below every physical scale here: positions move
    ~2.3e-3 µm/step, so quantizing the direction at 2^-24 is ~1e-10 µm.)
    """
    shifted = bits >> jnp.uint32(8)
    # view the (now < 2^24, hence sign-safe) word as int32 before the float
    # conversion: a signed convert is the one every backend lowers
    as_int = jax.lax.bitcast_convert_type(shifted, jnp.int32)
    return as_int.astype(dtype) * (2.0 ** -24)


def normal_from_bits(bits_a: jnp.ndarray, bits_b: jnp.ndarray,
                     dtype=jnp.float32) -> jnp.ndarray:
    """Standard normal via Box-Muller from two uint32 words.

    ``n = sqrt(-2 ln(1 - u_a)) * cos(2 pi u_b)``.  With 24-bit uniforms the
    magnitude is inherently capped at sqrt(-2 ln 2^-24) ~= 5.77 sigma
    (probability mass < 1e-8) — the same regime cuRAND's normal generator
    covers, and a useful hard bound for the chunked field expansion's travel
    radius (see fields/local_expansion.py).
    """
    u_a = uniform_from_bits(bits_a, dtype)
    u_b = uniform_from_bits(bits_b, dtype)
    # jnp.log(1 - u), NOT log1p(-u): 1-u is exact for 24-bit uniforms, and
    # the chunk kernel uses the same expression, keeping the two engines'
    # streams identical (log1p can round one ulp differently)
    r = jnp.sqrt(dtype(-2.0) * jnp.log(dtype(1.0) - u_a))
    theta = dtype(2.0 * math.pi) * u_b
    return r * jnp.cos(theta)


# ----------------------------------------------------------------------------
# Bulk helpers (scene construction, tests)
# ----------------------------------------------------------------------------

def uniforms(key: Key, counter0: int, shape, dtype=jnp.float32,
             rounds: int = 20) -> jnp.ndarray:
    """A [shape] tensor of uniforms with counters starting at ``counter0``.

    Lays counters out as c0 = counter0 + i for pair i; convenient for bulk
    draws outside the hot loop.
    """
    n = int(math.prod(shape)) if shape else 1
    n_pairs = (n + 1) // 2
    idx = jnp.arange(n_pairs, dtype=jnp.uint32)
    w0, w1 = threefry2x32(key, jnp.uint32(counter0) + idx,
                          jnp.zeros_like(idx), rounds=rounds)
    bits = jnp.stack([w0, w1], axis=-1).reshape(-1)[:n]
    return uniform_from_bits(bits, dtype).reshape(shape)
