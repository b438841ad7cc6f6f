"""Fused chunk kernel for NVIDIA GPUs — the production engine.

The reference ran each sprint as a pipeline: cuRAND XORWOW filled 3.9 GB
of uniform and normal buffers, ``simulateDiffusion`` moved one walker per
thread, ``computePhaseAccumulation`` walked the octree for every (walker,
step), and cuBLAS ``dgemv`` plus ``thrust::reduce`` produced Σcos
(cuda_sim.cu:688-804, 996-1023).  This kernel keeps the reference's own
mapping — one walker per GPU thread — but fuses the whole pipeline into
one launch per chunk: the Threefry words are computed in registers, the
per-walker field model (K nearest dipoles + far Taylor expansion, built
by XLA before each launch, see fields/expansion.py) replaces the octree,
the chunk's steps run in an in-kernel loop, and each program writes its
own window partial sums.

Route: Pallas through Triton (``backend="triton"``).  The work is
elementwise f32 math, integer Threefry and small reductions — no matrix
products — so tensor cores, TMA and ``wgmma`` have nothing to do here.
On the CPU the same kernel runs in Pallas' interpreter (``interpret=True``)
for the tests.

Layout: walker state is stored as ``PlaneState`` planes of shape
[R, 128] (R = W_pad / 128); the kernel sees each plane as its flat
[W_pad] view and gives each program ``BLOCK_WALKERS`` consecutive walkers,
one per thread.  Programs share nothing: each reads its walkers, runs the
chunk, and writes its walkers plus its own [n_win, 2] window sums, which
XLA adds up afterwards.

Every launch draws the same counter-based Threefry-2x32 words as the scan
engine (rng.words_for_step), so the two engines can be compared walker by
walker.  The XLA side (field-model rebuild, window bookkeeping) wraps
the kernel in ``make_sprint_fn`` with the same signature and semantics
as the scan engine's.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.lazyimport import LazyModule

# pallas is touched only at kernel-construction time (utils/lazyimport.py)
pl = LazyModule("jax.experimental.pallas")
plgpu = LazyModule("jax.experimental.pallas.triton")

from .. import rng
from ..fields import dipole, expansion
from ..params import DIRECTION_CUBE, KICK_INTENDED, Params
from .reference_engine import WalkerState, intracellular_kick

ENGINES = ("pallas", "scan")

#: storage width of a PlaneState row; walker counts pad to a multiple
LANES = 128
#: walkers per kernel program, one per thread (so BLOCK_WALKERS // 32
#: warps).  Must be a power of two that divides LANES.  One warp per
#: program was the fastest of 32 / 64 / 128 at the headline size on an
#: H100 (126 programs spread over more SMs than 63 or 32 would).
BLOCK_WALKERS = 32

RNG_THREEFRY = "threefry"


def on_gpu() -> bool:
    """Whether this process's default JAX backend is an NVIDIA GPU."""
    return jax.devices()[0].platform == "gpu"


def choose_engine(requested: str | None = None, *, interpret: bool = False,
                  anywhere: bool = False) -> str:
    """The one decision of which engine runs on this platform.

    ``'scan'`` is honoured on any platform.  Otherwise (``None`` or
    ``'pallas'``) the answer is the chunk kernel, which is compiled for the
    GPU and exists elsewhere only in Pallas' interpreter
    (``interpret=True``, the CPU tests).  With no GPU and no interpreter a
    kernel request raises instead of switching engine; only a caller that
    asks for no engine in particular and passes ``anywhere=True`` (a demo
    that must run on any machine) gets the scan engine there."""
    if requested not in (None,) + ENGINES:
        raise ValueError(f"unknown engine {requested!r}; use one of "
                         f"{ENGINES}")
    if requested == "scan":
        return "scan"
    if interpret or on_gpu():
        return "pallas"
    if anywhere and requested is None:
        return "scan"
    raise RuntimeError(
        f"the pallas engine is compiled for an NVIDIA GPU and this "
        f"process's platform is {jax.devices()[0].platform!r}; run on a "
        f"GPU, ask for engine='scan', or pass interpret=True (tests)")


def check_rng_impl(rng_impl: str) -> str:
    """Both engines draw from one counter-based Threefry stream; any other
    generator name (e.g. a checkpoint's or a script's 'hardware') is
    refused."""
    if rng_impl != RNG_THREEFRY:
        raise ValueError(
            f"unknown rng_impl {rng_impl!r}: the engines draw from the "
            f"counter-based Threefry stream only ({RNG_THREEFRY!r})")
    return rng_impl


class PlaneState(NamedTuple):
    """Walker state as [R, 128] planes (pallas-engine native form)."""
    px: jnp.ndarray
    py: jnp.ndarray
    pz: jnp.ndarray
    in_cell: jnp.ndarray     # f32 0/1 mask
    phase: jnp.ndarray
    phase_comp: jnp.ndarray
    step: jnp.ndarray        # scalar uint32
    escapes: jnp.ndarray     # scalar int32
    coverage: jnp.ndarray    # scalar int32 (see WalkerState.coverage)


def pad_count(num_water: int) -> int:
    """Walker count padded to whole planes, hence to whole kernel
    programs (BLOCK_WALKERS divides LANES)."""
    return -(-num_water // LANES) * LANES


def to_planes(state: WalkerState, params: Params) -> PlaneState:
    """[W]-vector state -> padded [R, 128] planes.  Dummy lanes (beyond
    num_water) start at the box center and simply diffuse; the kernel's
    validity mask excludes them from magnetization sums.

    Host-NumPy inputs (the init_state/checkpoint form) stay NumPy: the
    result is consumed as a jitted-sprint argument (pure transfer)."""
    xp = np if isinstance(state.pos, np.ndarray) else jnp
    w = state.pos.shape[0]
    wp = pad_count(w)
    r = wp // LANES

    def plane(x, fill):
        return xp.concatenate(
            [x, xp.full((wp - w,), fill, x.dtype)]).reshape(r, LANES)

    half = xp.asarray(params.bound / 2, state.pos.dtype)
    if state.phase.ndim == 2:    # decompose run: [W, 2] -> [2, R, 128]
        phase = xp.stack([plane(state.phase[:, 0], 0),
                          plane(state.phase[:, 1], 0)])
        comp = xp.stack([plane(state.phase_comp[:, 0], 0),
                         plane(state.phase_comp[:, 1], 0)])
    else:
        phase = plane(state.phase, 0)
        comp = plane(state.phase_comp, 0)
    return PlaneState(
        px=plane(state.pos[:, 0], half),
        py=plane(state.pos[:, 1], half),
        pz=plane(state.pos[:, 2], half),
        in_cell=plane(state.in_cell.astype(state.pos.dtype), 0),
        phase=phase,
        phase_comp=comp,
        step=state.step,
        escapes=state.escapes,
        coverage=state.coverage,
    )


def from_planes(ps: PlaneState, num_water: int) -> WalkerState:
    def vec(x):
        return x.reshape(-1)[:num_water]
    if ps.phase.ndim == 3:       # decompose run: [2, R, 128] -> [W, 2]
        phase = jnp.stack([vec(ps.phase[0]), vec(ps.phase[1])], axis=-1)
        comp = jnp.stack([vec(ps.phase_comp[0]), vec(ps.phase_comp[1])],
                         axis=-1)
    else:
        phase = vec(ps.phase)
        comp = vec(ps.phase_comp)
    return WalkerState(
        pos=jnp.stack([vec(ps.px), vec(ps.py), vec(ps.pz)], axis=-1),
        in_cell=vec(ps.in_cell) > 0.5,
        phase=phase,
        phase_comp=comp,
        step=ps.step,
        escapes=ps.escapes,
        coverage=ps.coverage,
    )


def _threefry_words(key01, c0_scalar, lane, n_words, rounds):
    """Counter-based words for a vector of walker lanes; bitwise-identical
    to rng.words_for_step."""
    c0 = jnp.full_like(lane, c0_scalar)
    out = []
    for pair in range((n_words + 1) // 2):
        w0, w1 = rng.threefry2x32(key01, c0,
                                  lane + jnp.uint32(pair << 27),
                                  rounds=rounds)
        out += [w0, w1]
    return out[:n_words]


def make_chunk_kernel(params: Params, n_walkers: int, dtype=jnp.float32,
                      interpret: bool = False,
                      decompose: bool = False):
    """Build the pallas_call executing one chunk (chunk_steps timesteps,
    spanning chunk_steps/pfreq output windows) for ``n_walkers`` (padded)
    walkers:

        f(scalars_u32[10],
          state  [6, W]     (px, py, pz, in_cell, phase, comp),
          near   [4, K, W]  (x, y, z, M*FIELD_SCALE),
          taylor [10, W]    (b0, gx, gy, gz, hxx, hyy, hzz, hxy, hxz, hyz))
        -> (state' [6, W], escapes [W], wins [n_prog, n_win, 2])

    scalars = [step0, key_hi, key_lo, lane_offset, num_water, tcp,
    cell_r2_bits, stdev_scale_bits, reflect_io_bits, reflect_oi_bits].
    The chunk anchor IS the input position (positions are wrapped before
    the field-model build), and walker lanes and
    validity are derived in-kernel from (program_id, lane_offset,
    num_water).  tcp (Carr-Purcell interval, steps), cell_r^2, the
    diffusion stdev scale sqrt(d_scale) and the membrane bounce
    probabilities (f32 bit patterns) ride the scalar vector instead of
    being baked into the program, so parameter sweeps over taucp / cell_r
    / D / permeability share ONE compile (the reference recompiled with
    nvcc per value, README.md:13).  The reflect scalars are only read
    (and the coin word only drawn) when the static params enable
    reflection.

    The field model (near list + far Taylor) is built by XLA before each
    launch (expansion.build, which also counts the coverage sentinel).

    **Decomposition mode** (``decompose=True``): trajectories never
    depend on the dipole moment, so each walker's phase is exactly linear
    in a global moment scale — phase = s*A + B with A the dipole-field
    part and B the kick part (see reference_engine.make_sprint_fn).  The
    state grows to 8 rows (A, comp_A, B, comp_B replace phase, comp), and
    the window output becomes the per-walker record
    ``dec [n_win, 2, W]`` (A, B per window) — one production-speed run
    then reconstructs the T2 curve at ANY moment scale
    (engine/decompose.py).
    """
    params.validate()
    if params.chunk_steps % params.pfreq != 0:
        raise ValueError(
            "pallas engine requires chunk_steps to be a multiple of pfreq")
    bw = BLOCK_WALKERS
    if bw < 32 or bw & (bw - 1) or LANES % bw:
        raise ValueError(f"BLOCK_WALKERS={bw} must be a power of two "
                         f"of at least one warp (32) dividing {LANES}")
    if n_walkers % bw:
        raise ValueError(f"n_walkers ({n_walkers}) must be a multiple of "
                         f"{bw}; pad_count guarantees this")
    n_prog = n_walkers // bw
    n_win = params.chunk_steps // params.pfreq
    k = params.near_k
    travel2_f = float(expansion.default_travel_bound(params) ** 2)
    use_reflection = params.reflect_io > 0 or params.reflect_oi > 0
    use_kick_u = params.kick_mode == KICK_INTENDED
    n_words = 7 if (use_reflection or use_kick_u) else 5

    # plain python floats: weak-typed scalars that adopt the walker dtype
    # without becoming traced constants the kernel would have to capture
    in_stdev = float(params.in_stdev)
    out_stdev = float(params.out_stdev)
    phase_per_tesla = float(params.phase_per_tesla)
    two_pi = float(2.0 * np.pi)
    # background-gradient constants (T/µm); only touched when
    # params.use_gradient (static) — the default physics pays nothing
    gx_c, gy_c, gz_c = (float(g) for g in params.b0_gradient)

    def f32(bits):
        return jax.lax.bitcast_convert_type(bits, jnp.float32).astype(dtype)

    def kernel(scalars, state, near, taylor, o_state, o_esc, o_wins):
        pid = pl.program_id(0)
        cols = pl.ds(pid * bw, bw)
        step0 = scalars[0]
        key01 = (scalars[1], scalars[2])
        tcp_u = scalars[5]
        # launch scalars, read once per launch (outside the step loop)
        cell_r2 = f32(scalars[6])
        # stdev scale sqrt(d_scale) (1.0 by default): folded into the
        # stdev constants once, so the runtime D axis costs the step loop
        # nothing (and dstd == 1.0 keeps the default products unchanged)
        dstd = f32(scalars[7])
        in_stdev_d = in_stdev * dstd
        out_stdev_d = out_stdev * dstd
        if use_reflection:
            rio = f32(scalars[8])
            roi = f32(scalars[9])

        idx_u = jax.lax.bitcast_convert_type(
            jax.lax.broadcasted_iota(jnp.int32, (bw,), 0) + pid * bw,
            jnp.uint32)
        valid_v = (idx_u < scalars[4]).astype(dtype)
        lane_v = idx_u + scalars[3]

        def uni(bits):
            return rng.uniform_from_bits(bits, dtype)

        x, y, z = state[0, cols], state[1, cols], state[2, cols]
        phases = tuple(state[4 + i, cols] for i in range(4 if decompose
                                                          else 2))
        nx, ny, nz, nM = ([near[c, j, cols] for j in range(k)]
                          for c in range(4))
        tl = [taylor[i, cols] for i in range(10)]
        anchor_x, anchor_y, anchor_z = x, y, z
        tb0, tgx, tgy, tgz, thxx, thyy, thzz, thxy, thxz, thyz = tl

        def eval_field(px, py, pz):
            """Masked K-near sum + far Taylor (expansion.evaluate, fused).
            Returns (B, squared distance to the nearest near dipole)."""
            b_near = jnp.zeros_like(px)
            min_d2 = jnp.full_like(px, 1e9)
            for j in range(k):
                dx = px - nx[j]
                dy = py - ny[j]
                dz = pz - nz[j]
                dz2 = dz * dz
                d2 = dx * dx + dy * dy + dz2
                # d2 == 0 (walker exactly on a dipole) sends rsqrt to inf
                # and contrib to nan — but d2 = 0 < cell_r2 always lands
                # in the masked (in-cell) arm of the select, so the nan
                # never escapes (cell_r > 0 is enforced by
                # Params.validate)
                rs = jax.lax.rsqrt(d2)
                rs2 = rs * rs
                inv_r5 = rs2 * rs2 * rs
                # 2dz^2 - dx^2 - dy^2 == 3dz^2 - d2; nM is pre-scaled by
                # FIELD_SCALE at pack time
                contrib = nM[j] * (3.0 * dz2 - d2) * inv_r5
                b_near = b_near + jnp.where(d2 > cell_r2, contrib, 0.0)
                min_d2 = jnp.minimum(min_d2, d2)
            # the running-min distance is carried instead of a containment
            # mask: each step derives the bool with ONE compare
            ex = px - anchor_x
            ey = py - anchor_y
            ez = pz - anchor_z
            b_far = (tb0 + tgx * ex + tgy * ey + tgz * ez
                     + 0.5 * (thxx * ex * ex + thyy * ey * ey
                              + thzz * ez * ez)
                     + thxy * ex * ey + thxz * ex * ez + thyz * ey * ez)
            return b_near + b_far, min_d2

        def one_step(carry, u0, u1, u2, nrm, u_coin, u_kick):
            """The physics of one timestep given its random inputs
            (simulateDiffusion body, cuda_sim.cu:708-732, fused with the
            phase kick)."""
            (x, y, z, mind2, bprev, acc, maxd2) = carry
            incell = mind2 < cell_r2
            if params.direction_mode == DIRECTION_CUBE:
                dx = 2.0 * u0 - 1.0
                dy = 2.0 * u1 - 1.0
                dz = 2.0 * u2 - 1.0
                inv_norm = jax.lax.rsqrt(
                    jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-12))
            else:
                cos_t = 2.0 * u0 - 1.0
                sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
                phi = two_pi * u1
                dx = sin_t * jnp.cos(phi)
                dy = sin_t * jnp.sin(phi)
                dz = cos_t
                inv_norm = 1.0
            # exact select (bitwise-equal to the scan engine's jnp.where)
            stdev = jnp.where(incell, in_stdev_d, out_stdev_d)
            mag = nrm * stdev * inv_norm
            x2 = x + dx * mag
            y2 = y + dy * mag
            z2 = z + dz * mag

            b, mind2_new = eval_field(x2, y2, z2)
            in_new = mind2_new < cell_r2

            if use_reflection:
                # boolean crossing logic + selects — value-identical to
                # the scan engine's float blend (its flip factor is
                # exactly 0 or 1)
                flip = ((incell & jnp.logical_not(in_new)
                         & (u_coin < rio))
                        | (jnp.logical_not(incell) & in_new
                           & (u_coin < roi)))
                x2 = jnp.where(flip, x, x2)
                y2 = jnp.where(flip, y, y2)
                z2 = jnp.where(flip, z, z2)
                b = jnp.where(flip, bprev, b)
                in_new = jnp.where(flip, incell, in_new)
                mind2_new = jnp.where(flip, mind2, mind2_new)

            kick = b * phase_per_tesla
            intra = intracellular_kick(params, u_kick, in_new, dtype)
            if params.use_gradient:
                # background-gradient kick at the recorded position;
                # moment-independent -> rides the B column in decompose
                # mode (see reference_engine.step_fn)
                bg_kick = (x2 * gx_c + y2 * gy_c
                           + z2 * gz_c) * phase_per_tesla
                intra = bg_kick if intra is None else intra + bg_kick
            if decompose:
                acc = (acc[0] + kick,
                       acc[1] if intra is None else acc[1] + intra)
            else:
                if intra is not None:
                    kick = kick + intra
                acc = (acc[0] + kick,)

            ddx = x2 - anchor_x
            ddy = y2 - anchor_y
            ddz = z2 - anchor_z
            maxd2 = jnp.maximum(maxd2, ddx * ddx + ddy * ddy + ddz * ddz)
            return (x2, y2, z2, mind2_new, b, acc, maxd2)

        def step_body(win_step0):
            def body(i, c):
                # per-step counter draws: the scan engine's exact stream
                words = _threefry_words(
                    key01, win_step0 + i.astype(jnp.uint32), lane_v,
                    n_words, params.rng_rounds)
                nrm = jnp.sqrt(-2.0 * jnp.log(1.0 - uni(words[3]))) * \
                    jnp.cos(two_pi * uni(words[4]))
                return one_step(
                    c, uni(words[0]), uni(words[1]), uni(words[2]), nrm,
                    uni(words[5]) if n_words > 5 else None,
                    uni(words[6]) if n_words > 6 else None)
            return body

        n_acc = 2 if decompose else 1

        def window(w_idx, carry):
            (x, y, z, mind2, bprev, maxd2), phases = carry
            win_step0 = step0 + (w_idx * params.pfreq).astype(jnp.uint32)
            acc0 = tuple(jnp.zeros_like(x) for _ in range(n_acc))
            x, y, z, mind2, bprev, acc, maxd2 = jax.lax.fori_loop(
                0, params.pfreq, step_body(win_step0),
                (x, y, z, mind2, bprev, acc0, maxd2))

            # Kahan fold (performUpdate, cuda_sim.cu:814-828), one stream
            # per accumulator (phase, or A and B)
            folded = []
            for a in range(n_acc):
                ph, cp = phases[2 * a], phases[2 * a + 1]
                ky = acc[a] - cp
                kt = ph + ky
                cp = (kt - ph) - ky
                folded += [kt, cp]
            phases = tuple(folded)
            if decompose:
                # per-walker (A, B) record for this window — the
                # moment-scale reconstruction basis
                o_wins[w_idx, 0, cols] = phases[0]
                o_wins[w_idx, 1, cols] = phases[2]
            else:
                o_wins[pid, w_idx, 0] = jnp.sum(jnp.cos(phases[0]) * valid_v)
                o_wins[pid, w_idx, 1] = jnp.sum(jnp.sin(phases[0]) * valid_v)

            # Carr-Purcell flip after emission (cuda_sim.cu:1015-1020); in
            # decompose mode the flip negates BOTH components, preserving
            # phase = s*A + B exactly
            end_step = win_step0 + jnp.uint32(params.pfreq)
            flip = ((end_step % tcp_u) == 0).astype(dtype)
            phases = tuple(p - 2.0 * flip * p for p in phases)
            return (x, y, z, mind2, bprev, maxd2), phases

        b_start, mind2_start = eval_field(x, y, z)
        (x, y, z, mind2, _, maxd2), phases = jax.lax.fori_loop(
            0, n_win, window,
            ((x, y, z, mind2_start, b_start, jnp.zeros_like(x)), phases))

        o_state[0, cols] = x
        o_state[1, cols] = y
        o_state[2, cols] = z
        o_state[3, cols] = (mind2 < cell_r2).astype(dtype)
        for i, p in enumerate(phases):
            o_state[4 + i, cols] = p
        o_esc[cols] = jnp.where(maxd2 > travel2_f, 1.0, 0.0) * valid_v

    n_state = 8 if decompose else 6
    if decompose:
        wins_shape = (n_win, 2, n_walkers)
    else:
        wins_shape = (n_prog, n_win, 2)
    return pl.pallas_call(
        kernel,
        grid=(n_prog,),
        out_shape=(
            jax.ShapeDtypeStruct((n_state, n_walkers), dtype),
            jax.ShapeDtypeStruct((n_walkers,), dtype),
            jax.ShapeDtypeStruct(wins_shape, dtype),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=bw // 32,
                                             num_stages=1),
        interpret=interpret,
        name="mri_chunk" + ("_decompose" if decompose else ""),
    )


def make_sprint_fn(params: Params, num_water: int, dtype=jnp.float32,
                   rng_impl: str = RNG_THREEFRY, interpret: bool = False,
                   decompose: bool = False):
    """Jitted sprint with the same contract as
    reference_engine.make_sprint_fn, but running chunks in the kernel.
    Operates on PlaneState.

    sprint(mnp_pos, mnp_M, key_arr, plane_state, lane_offset,
           cache=None, tcp=None, cell_r=None, d_scale=None, reflect=None)
        -> (plane_state', wins [n_windows, 2])

    ``tcp`` (Carr-Purcell interval in steps, uint32), ``cell_r``
    (cell radius, f32 — squared in-flight with scan-engine-identical
    rounding), ``d_scale`` and ``reflect`` (a (reflect_io, reflect_oi)
    pair; requires reflection enabled in the static params) optionally
    override their static params values with *traced* runtime scalars:
    a taucp / cell_r / D / permeability sweep can then reuse ONE
    compiled sprint across all values (the reference rebuilt with nvcc
    per value, README.md:13).  Defaults (None) bake the params values
    into the very same launch scalars — the compiled program is
    identical either way.

    Each chunk is one XLA field-model rebuild (expansion.build: wrap,
    K-nearest selection, far Taylor sums, coverage count) feeding one
    kernel launch; the sprint is a scan over chunks.  Large scenes take
    build()'s cube-candidate path (``cache``, or one built per sprint
    call when none is passed).

    ``decompose=True``: phase-decomposition run (see make_chunk_kernel) —
    the PlaneState carries phase / phase_comp as [2, R, 128] (A, B)
    stacks, and ``wins`` becomes [n_windows, 2, R, 128] per-walker (A, B)
    planes.  Production-speed basis for moment-scale reconstruction
    (engine/decompose.py).

    Needs a GPU unless ``interpret`` (see choose_engine).
    """
    params.validate()
    check_rng_impl(rng_impl)
    choose_engine("pallas", interpret=interpret)
    wp = pad_count(num_water)
    r = wp // LANES
    if params.chunk_steps % params.pfreq == 0:
        chunk_steps = params.chunk_steps
    else:
        raise ValueError("pallas engine: chunk_steps must be a multiple "
                         "of pfreq (e.g. 2000 with pfreq=1000)")
    n_chunks = params.sprint_steps // chunk_steps
    if n_chunks * chunk_steps != params.sprint_steps:
        raise ValueError("sprint_steps must be a multiple of chunk_steps")
    n_win_chunk = chunk_steps // params.pfreq
    bound = dtype(params.bound)
    n_state = 8 if decompose else 6
    kern = make_chunk_kernel(params, wp, dtype, interpret,
                             decompose=decompose)

    def pack_state(ps: PlaneState):
        base = jnp.stack([ps.px, ps.py, ps.pz, ps.in_cell])
        if decompose:     # phase/comp are [2, R, 128] (A, B) stacks
            st = jnp.concatenate([base, ps.phase, ps.phase_comp])
        else:
            st = jnp.concatenate([base, ps.phase[None],
                                  ps.phase_comp[None]])
        return st.reshape(n_state, wp)

    def make_scalars(ps, lane_offset, key_arr, tcp_u, cr2_bits, dstd_bits,
                     rio_bits, roi_bits):
        return jnp.stack(
            [ps.step, key_arr[0], key_arr[1],
             jnp.asarray(lane_offset, jnp.uint32), jnp.uint32(num_water),
             tcp_u, cr2_bits, dstd_bits, rio_bits, roi_bits])

    def dyn_scalars(tcp, cell_r, d_scale, reflect=None):
        """Resolve the runtime-sweepable scalars: defaults come from the
        static params (bitwise-identical program either way), overrides
        are traced values so taucp / cell_r / d_scale / reflect sweeps
        share one compile.

        cell_r is squared HERE as an f32 x f32 product — the same
        rounding as the scan engine's ``cell_r * cell_r`` — so the
        in-cell verdict is bitwise consistent across every path (a
        pre-squared f64 constant differs by 1 ulp for radii like 0.55).
        d_scale square-roots here too (f32, matching the scan engine's
        dyn stdev scale) and rides as the sqrt's bit pattern.
        reflect is a (reflect_io, reflect_oi) pair riding as f32 bit
        patterns; the kernel only reads them when the static params
        enable reflection (guarded upstream)."""
        tcp_u = (jnp.uint32(params.tcp) if tcp is None
                 else jnp.asarray(tcp, jnp.uint32))
        cr = (jnp.float32(params.cell_r) if cell_r is None
              else jnp.asarray(cell_r, jnp.float32))
        dstd = (jnp.float32(1.0) if d_scale is None
                else jnp.sqrt(jnp.asarray(d_scale, jnp.float32)))
        rio = (jnp.float32(params.reflect_io) if reflect is None
               else jnp.asarray(reflect[0], jnp.float32))
        roi = (jnp.float32(params.reflect_oi) if reflect is None
               else jnp.asarray(reflect[1], jnp.float32))
        return (tcp_u, jax.lax.bitcast_convert_type(cr * cr, jnp.uint32),
                cr, jax.lax.bitcast_convert_type(dstd, jnp.uint32),
                jax.lax.bitcast_convert_type(rio, jnp.uint32),
                jax.lax.bitcast_convert_type(roi, jnp.uint32))

    def advance(ps, state_out, o_esc, cov, steps):
        # o_esc: [W] per-walker escape counts, validity-masked in-kernel;
        # cov: the coverage violations counted at the field-model build
        escapes = ps.escapes + jnp.sum(o_esc).astype(jnp.int32)
        coverage = ps.coverage + cov
        st = state_out.reshape(n_state, r, LANES)
        if decompose:
            phase, comp = st[4:6], st[6:8]
        else:
            phase, comp = st[4], st[5]
        return PlaneState(px=st[0], py=st[1], pz=st[2], in_cell=st[3],
                          phase=phase, phase_comp=comp,
                          step=ps.step + jnp.uint32(steps),
                          escapes=escapes, coverage=coverage)

    def chunk_wins(wins):
        # decompose: [n_win, 2, W] per-walker record -> [n_win, 2, R, 128];
        # otherwise the [n_prog, n_win, 2] per-program partial sums
        if decompose:
            return wins.reshape(n_win_chunk, 2, r, LANES)
        return jnp.sum(wins, axis=0)

    def sprint(mnp_pos, mnp_M, key_arr, ps: PlaneState, lane_offset,
               cache=None, tcp=None, cell_r=None, d_scale=None,
               reflect=None):
        (tcp_u, cr2_bits, cr_dyn, dstd_bits, rio_bits,
         roi_bits) = dyn_scalars(tcp, cell_r, d_scale, reflect)
        n_mnp = mnp_pos.shape[0]
        if params.near_k > n_mnp:
            raise ValueError(
                f"near_k={params.near_k} exceeds the number of dipoles "
                f"({n_mnp}); selection would duplicate entries and "
                f"double-count their field")

        def scalars(ps):
            return make_scalars(ps, lane_offset, key_arr, tcp_u, cr2_bits,
                                dstd_bits, rio_bits, roi_bits)

        if cache is None and expansion.uses_large_path(wp, n_mnp):
            # callers that run many sprints should precompute the cache
            # once (it only depends on the scene) and pass it in; the
            # far table is skipped here because this build runs inside
            # the jitted sprint, i.e. once per sprint CALL on device
            cache = expansion.build_cache(mnp_pos, mnp_M, params,
                                          far_table=False)
        # XLA-side coverage sentinel inputs: reach from the runtime
        # cell_r + static travel bound; padded walker lanes (which sit at
        # the box center) are masked out of the violation count
        travel_f = float(expansion.default_travel_bound(params))
        reach_dyn = (cr_dyn.astype(dtype) + dtype(travel_f))
        reach2_dyn = reach_dyn * reach_dyn
        valid_vec = jnp.arange(wp, dtype=jnp.int32) < num_water

        def chunk_body(ps: PlaneState, chunk_idx):
            del chunk_idx  # ps.step already advances chunk by chunk
            # periodic wrap at chunk boundary (see reference_engine notes)
            px = jnp.mod(ps.px + bound, bound)
            py = jnp.mod(ps.py + bound, bound)
            pz = jnp.mod(ps.pz + bound, bound)
            pos = jnp.stack([px.reshape(-1), py.reshape(-1),
                             pz.reshape(-1)], axis=-1)
            nf = expansion.build(pos, mnp_pos, mnp_M, params, cache=cache,
                                 reach2=reach2_dyn)
            cov = jnp.sum((nf.n_reach > params.near_k) & valid_vec,
                          dtype=jnp.int32)
            near = jnp.stack(
                [nf.near_pos[..., 0].T, nf.near_pos[..., 1].T,
                 nf.near_pos[..., 2].T,
                 # fold the unit conversion into the moment (one fewer
                 # multiply per k per step)
                 (nf.near_M * dtype(dipole.FIELD_SCALE)).T])   # [4, K, W]
            taylor = jnp.concatenate(
                [nf.b0[None], nf.grad.T, nf.hess.T])             # [10, W]
            state_in = pack_state(ps._replace(px=px, py=py, pz=pz))
            state_out, o_esc, wins = kern(scalars(ps), state_in, near,
                                          taylor)
            return advance(ps, state_out, o_esc, cov,
                           chunk_steps), chunk_wins(wins)

        ps, wins = jax.lax.scan(chunk_body, ps,
                                jnp.arange(n_chunks, dtype=jnp.uint32))
        return ps, wins.reshape(n_chunks * n_win_chunk, *wins.shape[2:])

    inner = jax.jit(sprint)
    use_reflection = params.reflect_io > 0 or params.reflect_oi > 0

    def guarded(mnp_pos, mnp_M, key_arr, ps, lane_offset,
                cache=None, tcp=None, cell_r=None, d_scale=None,
                reflect=None):
        from .reference_engine import _check_dyn_overrides
        if reflect is not None and not use_reflection:
            # the kernel neither draws the coin word nor reads the
            # reflect scalars when the static params have reflection off
            raise ValueError(
                "reflect overrides need reflection enabled in the static "
                "params (e.g. params.with_permeability()); the engine "
                "was built with reflect_io = reflect_oi = 0")
        _check_dyn_overrides(tcp, cell_r, d_scale, reflect)
        return inner(mnp_pos, mnp_M, key_arr, ps, lane_offset,
                     cache=cache, tcp=tcp, cell_r=cell_r,
                     d_scale=d_scale, reflect=reflect)

    guarded.inner = inner   # AOT warm-start hooks .lower() (engine/aot.py)
    return guarded


def run_simulation(scene, params: Params, seed: int = 0, dtype=jnp.float32,
                   rng_impl: str = RNG_THREEFRY, interpret: bool = False,
                   max_steps: int | None = None):
    """Single-device full run with the kernel engine (mirror of
    reference_engine.run_simulation)."""
    from .reference_engine import init_state

    num_water = scene.waters.shape[0]
    sprint_fn = make_sprint_fn(params, num_water, dtype, rng_impl, interpret)
    mnp_pos = jnp.asarray(scene.mnps[:, :3], dtype)
    mnp_M = jnp.asarray(scene.mnps[:, 4], dtype)
    kk = rng.key_from_seed(seed)
    key_arr = jnp.asarray([np.uint32(kk[0]), np.uint32(kk[1])])
    ps = to_planes(init_state(scene.waters, params, dtype), params)

    total = params.t if max_steps is None else min(params.t, max_steps)
    outs = []
    for _ in range(total // params.sprint_steps):
        ps, wins = sprint_fn(mnp_pos, mnp_M, key_arr, ps, 0)
        outs.append(wins)
    wins = jnp.concatenate(outs, axis=0) if outs else jnp.zeros((0, 2), dtype)
    n = wins.shape[0]
    times = (np.arange(1, n + 1) * params.pfreq) * params.tau
    return times, np.asarray(wins[:, 0]), np.asarray(wins[:, 1]), \
        from_planes(ps, num_water)
