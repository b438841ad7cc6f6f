"""Pure-JAX walker engine: the correctness anchor.

One compiled program advances every walker through a *sprint* of timesteps
(the reference's sprint concept, cuda_sim.cu:974, but with O(num_water)
memory instead of 3.9 GB of materialized trajectories and RNG buffers).
The structure maps the reference's four separate device passes —

    cuRAND batch fill          (cuda_sim.cu:976-977)
    simulateDiffusion          (cuda_sim.cu:688-746)
    computePhaseAccumulation   (cuda_sim.cu:772-804)
    cublasDgemv + performUpdate + thrust::reduce + flipPhases
                               (cuda_sim.cu:996-1023)

— onto one fused ``lax.scan`` hierarchy:

    sprint
      └─ scan over windows (pfreq steps each; one magnetization output per
         window, Carr-Purcell flip when the step count hits a multiple of
         tcp — semantics of cuda_sim.cu:996-1023)
           └─ scan over chunks (chunk_steps each; per-walker field
              expansion rebuilt at each chunk start — see fields/expansion)
                └─ scan over steps: RNG -> displacement -> in/out stdev ->
                   membrane reflection -> field + intracellular kick ->
                   windowed kick accumulation (cuda_sim.cu:708-732, 625-640)

Semantics notes (each a deliberate, documented decision):

* Periodic wrapping happens at chunk boundaries, not every step
  (the reference wraps per step, cuda_sim.cu:597-601).  Within a chunk a
  walker strays at most ~1 µm past a face, where the MNP periodic images
  (border = 6 µm) reproduce the wrapped-position field exactly for every
  dipole within `border` of the crossing, and cells never cross faces —
  trajectories are identical modulo the box.  The residual is the phase
  picked up from *unimaged* dipole tails (>= border away, B ~ M/border³)
  during the excursion: the same truncation order as the reference's own
  image construction, i.e. neither wrap rule is more correct.  Tested
  adversarially with a per-step-wrapping oracle on a face-hugging scene
  (tests/test_engine.py TestWrapSemantics).
* Phase is accumulated per window in full precision and folded into the
  per-walker phase with Kahan compensation — 4e7 f32 additions of
  ~1e-4-rad kicks would otherwise round away the curve.
* The kick is evaluated at the *recorded* (post-reflection) position with
  the recorded in-cell flag, matching computePhaseAccumulation's use of
  the trajectory buffers; the reverted position's field is the previous
  step's field, so it is carried, not recomputed.
* Output is (sum cos phi, sum sin phi) per window; the reference only
  emitted the in-phase sum (cuda_sim.cu:825,1013) — column one matches it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import rng
from ..fields import expansion
from ..fields import dipole
from ..fields import grid as grid_mod
from ..params import (DIRECTION_CUBE, FIELD_EXACT, FIELD_GRID,
                      KICK_AS_WRITTEN, KICK_CONSTANT, KICK_INTENDED,
                      KICK_NONE, Params)


class WalkerState(NamedTuple):
    """Everything that persists across sprints (and into checkpoints)."""
    pos: jnp.ndarray         # [W, 3] positions, µm
    in_cell: jnp.ndarray     # [W] bool
    phase: jnp.ndarray       # [W] accumulated phase, rad
    phase_comp: jnp.ndarray  # [W] Kahan compensation for phase
    step: jnp.ndarray        # scalar uint32, completed global steps
    escapes: jnp.ndarray     # scalar int32, chunk-anchor escape count
    #: scalar int32: walker-chunks whose anchor had MORE dipoles within
    #: cell_r + travel than the near list holds (near_k) — each one is a
    #: potential in-cell misclassification this chunk.  The runtime
    #: counterpart of the validate_near_k pre-run proof, counted like
    #: ``escapes`` (the reference's DEBUG_TREE residency asserts,
    #: octree.cpp:39-41, made always-on and free).
    coverage: jnp.ndarray


def _check_dyn_overrides(tcp, cell_r, d_scale=None, reflect=None):
    """Host-side guard on concrete tcp/cell_r/d_scale/reflect overrides
    (traced sweep values are validated upstream by run_ensemble/
    run_parameter_sweep).  tcp=0 would reach the kernels' unsigned
    ``end_step % tcp``."""
    for name, v in (("tcp", tcp), ("cell_r", cell_r),
                    ("d_scale", d_scale)):
        if v is None:
            continue
        try:
            vf = float(v)
        except Exception:       # traced value - validated upstream
            continue
        if vf <= 0:
            raise ValueError(f"{name} override must be > 0; got {vf}")
    if reflect is not None:
        for i, comp in enumerate(("reflect_io", "reflect_oi")):
            try:
                vf = float(reflect[i])
            except Exception:   # traced value - validated upstream
                continue
            if not (0.0 <= vf <= 1.0):
                raise ValueError(
                    f"{comp} override must be in [0, 1]; got {vf}")


def init_state(waters: np.ndarray, params: Params,
               dtype=jnp.float32, phase_dtype=None,
               decompose: bool = False) -> WalkerState:
    """``phase_dtype`` (default = dtype) sets the phase-accumulation
    precision independently of the trajectory precision — positions never
    depend on phase, so f32 trajectories with f64 phase isolate the
    accumulation drift exactly (the accuracy dossier's precision arm).

    ``decompose=True`` builds the state for a phase-decomposition run
    (see make_sprint_fn): phase / phase_comp become [W, 2] with column 0
    the dipole-field part and column 1 the kick part.

    Built as host NumPy arrays on purpose: the state is only ever
    consumed as a jitted-function argument (a pure transfer), while
    building it with jnp ops would compile and dispatch several tiny
    device programs at CLI startup."""
    w = waters.shape[0]
    pdt = phase_dtype or dtype
    pshape = (w, 2) if decompose else (w,)
    return WalkerState(
        pos=np.asarray(waters, dtype),
        in_cell=np.zeros(w, np.bool_),   # refreshed at first chunk start
        phase=np.zeros(pshape, pdt),
        phase_comp=np.zeros(pshape, pdt),
        step=np.uint32(0),
        escapes=np.int32(0),
        coverage=np.int32(0),
    )


def intracellular_kick(params: Params, u_kick, in_cell, dtype):
    """Per-step intracellular phase kick (accumulatePhase,
    cuda_sim.cu:625-640), gated on cell residency.

    KICK_AS_WRITTEN reproduces the reference's operator-precedence bug: the
    Cauchy term's sign factor ``(((nD-.5)>0) - ((nD-.5))<0)`` parses to 0
    for every input, leaving only the constant chemical-shift term (SURVEY
    §7 quirk 1).  KICK_INTENDED implements the evident intent,
    sign(u - 1/2).  Shared by all engines.
    """
    mode = params.kick_mode
    if mode == KICK_NONE:
        return None
    del dtype  # python-float constants stay weak-typed in any precision
    if mode == KICK_AS_WRITTEN:
        per_step = float(params.chem_shift_kick)
    elif mode == KICK_CONSTANT:
        per_step = float(params.phase_k * params.tau)
    elif mode == KICK_INTENDED:
        centered = u_kick - 0.5
        cauchy = jnp.sqrt(
            1.0 / jnp.maximum(2.0 * jnp.abs(centered), 1e-12) - 1.0)
        per_step = (float(params.phase_stdev * params.tau) * cauchy
                    * jnp.sign(centered) + float(params.chem_shift_kick))
    else:
        raise ValueError(mode)
    return jnp.where(in_cell, per_step, 0.0)


class _AnchorOnly(NamedTuple):
    """Stand-in field model for backends that need no chunk rebuild
    (FIELD_GRID / FIELD_EXACT query arbitrary positions directly)."""
    anchor: jnp.ndarray


def make_sprint_fn(params: Params, dtype=jnp.float32, field_grid=None,
                   phase_dtype=None, decompose: bool = False):
    """Build the jitted sprint function.

    Returns ``sprint(mnp_pos, mnp_M, key, state, lane_offset, tcp=None,
    cell_r=None) -> (state', windows)`` where ``key`` is a [2] uint32
    array and ``windows`` is [n_windows, 2] local (sum cos, sum sin) per
    output window.  ``lane_offset`` makes walker RNG lanes globally unique
    when walkers are sharded across devices.  ``tcp`` (steps, uint32),
    ``cell_r`` (µm), ``d_scale`` and ``reflect`` (a (reflect_io,
    reflect_oi) pair — requires reflection enabled in the static params)
    optionally override their static params values with traced runtime
    scalars so taucp / cell_r / D / permeability sweeps share one
    compiled program (see pallas_engine.make_sprint_fn for the
    rationale).

    ``field_grid`` (a :class:`fields.grid.FieldGrid`) is required when
    ``params.field_mode == FIELD_GRID``; the grid is scene-static, so build
    it once with :func:`fields.grid.build_grid` and reuse across sprints.

    ``phase_dtype`` (default = dtype) accumulates phase in a different
    precision; trajectories are unaffected (phase never feeds back), so
    f32 positions + f64 phase isolates accumulation drift exactly.

    ``decompose=True`` selects the *phase-decomposition* run: trajectories
    are independent of the dipole moment (diffusion, reflection and
    residency use geometry + RNG only), so every walker's phase is EXACTLY
    linear in a global moment scale s:  phase = s*A + B, where A is the
    accumulated dipole-field phase at the base moments and B the
    accumulated intracellular-kick phase (Carr-Purcell flips negate both,
    preserving linearity).  In this mode the state carries (A, B) as
    [W, 2] phase planes (init_state(decompose=True)) and ``windows``
    becomes the per-walker [n_windows, W, 2] (A, B) record instead of the
    (sum cos, sum sin) pair — one such run reconstructs the curve at ANY
    moment scale as mean(cos(s*A + B)), replacing the reference's
    recompile-per-mmoment sweep workflow with a single simulation (see
    engine/decompose.py and inverse.py).
    """
    params.validate()
    pdt = phase_dtype or dtype
    window_major = params.pfreq % params.chunk_steps == 0
    if window_major:
        # rebuild >= once per window: scan windows -> chunks -> steps
        chunks_per_window = params.pfreq // params.chunk_steps
    elif params.chunk_steps % params.pfreq == 0:
        # rebuild spans windows: scan chunks -> windows -> steps (the
        # pallas production configuration, e.g. chunk 2000 / pfreq 1000)
        windows_per_chunk = params.chunk_steps // params.pfreq
    else:
        raise ValueError("chunk_steps must divide or be a multiple of pfreq")
    n_windows = params.sprint_steps // params.pfreq
    travel2 = dtype(expansion.default_travel_bound(params) ** 2)
    use_reflection = params.reflect_io > 0 or params.reflect_oi > 0
    use_kick_u = params.kick_mode == KICK_INTENDED
    n_words = 7 if (use_reflection or use_kick_u) else 5
    cell_r_static = dtype(params.cell_r)
    in_stdev = dtype(params.in_stdev)
    out_stdev = dtype(params.out_stdev)
    phase_per_tesla = dtype(params.phase_per_tesla)
    bound = dtype(params.bound)

    exact_mode = params.field_mode == FIELD_EXACT
    grid_mode = params.field_mode == FIELD_GRID
    if grid_mode:
        if field_grid is None:
            raise ValueError("field_mode='grid' requires a prebuilt "
                             "field_grid (fields.grid.build_grid)")
        # the grid clamps out-of-box queries, so grid mode wraps positions
        # every step — which is exactly the reference's per-step
        # boundary_conditions semantics (cuda_sim.cu:597-601)
        travel2 = dtype(np.inf)

    def field_at(nf, pos, mnp_pos, mnp_M):
        """Field + residency: expansion (production), uniform grid
        (the reference octree's direct analogue, octree.cpp:151-158), or
        brute-force exact (EXPLICIT mode, octree.cpp:395-396)."""
        cell_r = dyn_ref[0]  # static constant unless a sweep overrides it
        if grid_mode:
            return grid_mod.query(field_grid, pos, cell_r)
        if not exact_mode:
            b, in_c, _ = expansion.evaluate(nf, pos, cell_r)
            return b, in_c
        d = pos[:, None, :] - mnp_pos
        d2 = jnp.sum(d * d, axis=-1)
        b = dipole.total_field_masked(pos, mnp_pos, mnp_M, cell_r)
        return b, jnp.any(d2 < cell_r * cell_r, axis=-1)

    travel_f = float(expansion.default_travel_bound(params))

    def build_field_model(pos, mnp_pos, mnp_M, cache):
        if grid_mode:
            return _AnchorOnly(anchor=pos)
        # coverage sentinel: count dipoles within (cell_r + travel) of
        # each anchor; > near_k means the near list is provably missing
        # one (skipped in exact mode, which has no near list to violate)
        reach2 = None
        if not exact_mode:
            reach = dyn_ref[0] + travel_f
            reach2 = reach * reach
        return expansion.build(pos, mnp_pos, mnp_M, params, cache=cache,
                               reach2=reach2)

    def coverage_inc(nf):
        if getattr(nf, "n_reach", None) is None:
            return jnp.int32(0)
        return jnp.sum(nf.n_reach > params.near_k, dtype=jnp.int32)

    mnp_pos_ref = [None, None]  # set by each sprint call before tracing
    # [cell_r, tcp]: runtime-sweepable scalars, set per sprint call before
    # tracing (same ref-cell pattern as mnp_pos_ref).  Defaults are the
    # static params constants; a taucp / cell_r sweep passes traced
    # overrides so all values share one compiled program.
    # [cell_r, tcp, stdev_scale, reflect_io, reflect_oi]; stdev_scale =
    # sqrt(d_scale) multiplies both diffusion stdevs (in/out_stdev =
    # sqrt(pi*D*tau), so scaling D by d_scale scales the stdevs by its
    # square root) — a traced launch scalar so diffusion-coefficient
    # fits/sweeps share one compiled program, and the path reverse-mode
    # AD uses to differentiate trajectories in D
    # (inverse.fit_diffusion_scale).  reflect_io/oi are the membrane
    # bounce probabilities (cell_reflect thresholds) — launch scalars so
    # permeability sweeps/fits share one compile; they only exist in the
    # traced program when the STATIC params enable reflection (the coin
    # word is not drawn otherwise), which `guarded` enforces.
    dyn_ref = [cell_r_static, jnp.uint32(params.tcp), dtype(1.0),
               dtype(params.reflect_io), dtype(params.reflect_oi)]

    def _set_dyn(tcp, cell_r, d_scale=None, reflect=None):
        dyn_ref[0] = (cell_r_static if cell_r is None
                      else jnp.asarray(cell_r, dtype))
        dyn_ref[1] = (jnp.uint32(params.tcp) if tcp is None
                      else jnp.asarray(tcp, jnp.uint32))
        dyn_ref[2] = (dtype(1.0) if d_scale is None
                      else jnp.sqrt(jnp.asarray(d_scale, dtype)))
        dyn_ref[3] = (dtype(params.reflect_io) if reflect is None
                      else jnp.asarray(reflect[0], dtype))
        dyn_ref[4] = (dtype(params.reflect_oi) if reflect is None
                      else jnp.asarray(reflect[1], dtype))

    def step_fn(key, nf, lane, carry, step_idx):
        """One timestep for all walkers (simulateDiffusion body,
        cuda_sim.cu:708-732, fused with the phase kick)."""
        pos, in_cell, b_prev, acc, max_d2 = carry
        # word layout: direction xyz (0-2), normal pair (3-4), coin+kick
        # (5-6, only generated when reflection / intended-kick needs them —
        # the default config needs 5 words, saving a Threefry call)
        words = rng.words_for_step(key, step_idx, lane, n_words,
                                   rounds=params.rng_rounds)
        u_dir = [rng.uniform_from_bits(w, dtype) for w in words[:3]]
        nrm = rng.normal_from_bits(words[3], words[4], dtype)
        u_coin = rng.uniform_from_bits(words[5], dtype) if n_words > 5 \
            else None
        u_kick = rng.uniform_from_bits(words[6], dtype) if n_words > 6 \
            else None

        # displacement: direction x (normal magnitude scaled by the in/out
        # diffusion stdev) — rand_displacement, cuda_sim.cu:562-586.
        if params.direction_mode == DIRECTION_CUBE:
            # reference quirk: direction = normalized uniform-in-cube
            dx = 2.0 * u_dir[0] - 1.0
            dy = 2.0 * u_dir[1] - 1.0
            dz = 2.0 * u_dir[2] - 1.0
            inv_norm = jax.lax.rsqrt(
                jnp.maximum(dx * dx + dy * dy + dz * dz, dtype(1e-12)))
        else:  # DIRECTION_SPHERE: corrected uniform-on-sphere
            cos_t = 2.0 * u_dir[0] - 1.0
            sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, dtype(0)))
            phi = dtype(2.0 * np.pi) * u_dir[1]
            dx = sin_t * jnp.cos(phi)
            dy = sin_t * jnp.sin(phi)
            dz = cos_t
            inv_norm = dtype(1.0)
        mag = (nrm * jnp.where(in_cell, in_stdev, out_stdev)
               * inv_norm * dyn_ref[2])
        new_pos = pos + jnp.stack([dx * mag, dy * mag, dz * mag], axis=-1)
        if grid_mode:
            # per-step periodic wrap (boundary_conditions,
            # cuda_sim.cu:597-601): the grid query clamps to the box
            new_pos = jnp.mod(new_pos + bound, bound)

        b, in_new = field_at(nf, new_pos, mnp_pos_ref[0], mnp_pos_ref[1])

        if use_reflection:
            # cell_reflect (cuda_sim.cu:502-509): a membrane crossing
            # bounces with probability reflectIO / reflectOI; a bounce
            # reverts the walker wholesale (w = init, cuda_sim.cu:720-722),
            # so position, field, and residency all roll back
            # thresholds ride launch scalars (dyn_ref[3:5]) so
            # permeability sweeps/fits share this compiled program;
            # defaults are the static params values (same trace)
            flip = ((in_cell & ~in_new & (u_coin < dyn_ref[3]))
                    | (~in_cell & in_new & (u_coin < dyn_ref[4])))
            new_pos = jnp.where(flip[:, None], pos, new_pos)
            b = jnp.where(flip, b_prev, b)
            in_new = jnp.where(flip, in_cell, in_new)

        kick = b * phase_per_tesla
        intra = intracellular_kick(params, u_kick, in_new, dtype)
        if params.use_gradient:
            # background-gradient kick at the recorded position (like
            # the dipole field).  Moment-INDEPENDENT, so in decompose
            # mode it belongs with the intracellular kick in the B
            # column — moment-scale reconstruction stays exact.
            gx, gy, gz = (dtype(g) for g in params.b0_gradient)
            bg_kick = (new_pos[:, 0] * gx + new_pos[:, 1] * gy
                       + new_pos[:, 2] * gz) * phase_per_tesla
            intra = bg_kick if intra is None else intra + bg_kick
        if decompose:
            # keep the moment-linear dipole part (col 0) and the
            # moment-independent kick part (col 1) in separate streams
            acc = acc + jnp.stack(
                [kick, jnp.zeros_like(kick) if intra is None else intra],
                axis=-1).astype(acc.dtype)
        else:
            if intra is not None:
                kick = kick + intra
            acc = acc + kick.astype(acc.dtype)

        delta = new_pos - nf.anchor
        max_d2 = jnp.maximum(max_d2, jnp.sum(delta * delta, axis=-1))
        return (new_pos, in_new, b, acc, max_d2)

    def sprint(mnp_pos, mnp_M, key_arr, state: WalkerState, lane_offset,
               tcp=None, cell_r=None, d_scale=None, reflect=None):
        mnp_pos_ref[0], mnp_pos_ref[1] = mnp_pos, mnp_M
        _set_dyn(tcp, cell_r, d_scale, reflect)
        key = (key_arr[0], key_arr[1])
        w = state.pos.shape[0]
        lane = jnp.arange(w, dtype=jnp.uint32) + jnp.uint32(lane_offset)
        cache = (expansion.build_cache(mnp_pos, mnp_M, params,
                               far_table=False)
                 if not grid_mode
                 and expansion.uses_large_path(w, mnp_pos.shape[0])
                 else None)

        def chunk_body(chunk_carry, chunk_idx):
            pos, in_cell, acc, step0, escapes, coverage = chunk_carry
            # wrap into the box (boundary_conditions, cuda_sim.cu:597-601,
            # applied at chunk granularity — see module docstring)
            pos = jnp.mod(pos + bound, bound)
            nf = build_field_model(pos, mnp_pos, mnp_M, cache)
            coverage = coverage + coverage_inc(nf)
            b0, in0 = field_at(nf, pos, mnp_pos, mnp_M)

            base = step0 + chunk_idx * jnp.uint32(params.chunk_steps)

            def inner(c, i):
                return step_fn(key, nf, lane, c, base + i), None

            init = (pos, in0, b0, acc, jnp.zeros(w, dtype))  # max_d2 stays dtype
            (pos, in_cell, _, acc, max_d2), _ = jax.lax.scan(
                inner, init,
                jnp.arange(params.chunk_steps, dtype=jnp.uint32),
                unroll=params.scan_unroll)
            escapes = escapes + jnp.sum(max_d2 > travel2,
                                        dtype=jnp.int32)
            return (pos, in_cell, acc, step0, escapes, coverage), None

        def window_body(st: WalkerState, win_idx):
            del win_idx  # st.step already advances window by window
            step0 = st.step
            acc0 = jnp.zeros((w, 2) if decompose else w, pdt)
            (pos, in_cell, acc, _, escapes, coverage), _ = jax.lax.scan(
                chunk_body,
                (st.pos, st.in_cell, acc0, step0, st.escapes,
                 st.coverage),
                jnp.arange(chunks_per_window, dtype=jnp.uint32))

            # performUpdate (cuda_sim.cu:814-828): fold the window's kick
            # sum into the phase (Kahan-compensated), then emit the net
            # magnetization
            y = acc - st.phase_comp
            t = st.phase + y
            comp = (t - st.phase) - y
            phase = t
            out = phase if decompose else jnp.stack(
                [jnp.sum(jnp.cos(phase)), jnp.sum(jnp.sin(phase))])

            # Carr-Purcell flip AFTER emission when the global step count
            # reaches a multiple of tcp (cuda_sim.cu:1015-1020)
            end_step = step0 + jnp.uint32(params.pfreq)
            do_flip = (end_step % dyn_ref[1]) == 0
            phase = jnp.where(do_flip, -phase, phase)
            comp = jnp.where(do_flip, -comp, comp)

            return WalkerState(pos=pos, in_cell=in_cell, phase=phase,
                               phase_comp=comp, step=end_step,
                               escapes=escapes, coverage=coverage), out

        state, wins = jax.lax.scan(window_body, state,
                                   jnp.arange(n_windows, dtype=jnp.uint32))
        return state, wins

    def sprint_chunk_major(mnp_pos, mnp_M, key_arr, state: WalkerState,
                           lane_offset, tcp=None, cell_r=None,
                           d_scale=None, reflect=None):
        mnp_pos_ref[0], mnp_pos_ref[1] = mnp_pos, mnp_M
        _set_dyn(tcp, cell_r, d_scale, reflect)
        key = (key_arr[0], key_arr[1])
        w = state.pos.shape[0]
        lane = jnp.arange(w, dtype=jnp.uint32) + jnp.uint32(lane_offset)
        n_chunks = params.sprint_steps // params.chunk_steps
        cache = (expansion.build_cache(mnp_pos, mnp_M, params,
                               far_table=False)
                 if not grid_mode
                 and expansion.uses_large_path(w, mnp_pos.shape[0])
                 else None)

        def chunk_body(st: WalkerState, _):
            pos = jnp.mod(st.pos + bound, bound)
            nf = build_field_model(pos, mnp_pos, mnp_M, cache)
            coverage = st.coverage + coverage_inc(nf)
            b0, in0 = field_at(nf, pos, mnp_pos, mnp_M)
            maxd2_0 = jnp.zeros(w, dtype)

            def window_body(win_carry, win_idx):
                pos, in_cell, b_prev, maxd2, phase, comp = win_carry
                base = st.step + win_idx * jnp.uint32(params.pfreq)

                def inner(c, i):
                    return step_fn(key, nf, lane, c, base + i), None

                acc0 = jnp.zeros((w, 2) if decompose else w, pdt)
                (pos, in_cell, b_prev, acc, maxd2), _ = jax.lax.scan(
                    inner, (pos, in_cell, b_prev, acc0,
                            maxd2),
                    jnp.arange(params.pfreq, dtype=jnp.uint32),
                    unroll=params.scan_unroll)
                y = acc - comp
                t = phase + y
                comp = (t - phase) - y
                phase = t
                out = phase if decompose else jnp.stack(
                    [jnp.sum(jnp.cos(phase)), jnp.sum(jnp.sin(phase))])
                end_step = base + jnp.uint32(params.pfreq)
                do_flip = (end_step % dyn_ref[1]) == 0
                phase = jnp.where(do_flip, -phase, phase)
                comp = jnp.where(do_flip, -comp, comp)
                return (pos, in_cell, b_prev, maxd2, phase, comp), out

            (pos, in_cell, _, maxd2, phase, comp), outs = jax.lax.scan(
                window_body, (pos, in0, b0, maxd2_0, st.phase,
                              st.phase_comp),
                jnp.arange(windows_per_chunk, dtype=jnp.uint32))
            escapes = st.escapes + jnp.sum(maxd2 > travel2, dtype=jnp.int32)
            return WalkerState(
                pos=pos, in_cell=in_cell, phase=phase, phase_comp=comp,
                step=st.step + jnp.uint32(params.chunk_steps),
                escapes=escapes, coverage=coverage), outs

        state, wins = jax.lax.scan(chunk_body, state, None, length=n_chunks)
        return state, wins.reshape(n_windows, *wins.shape[2:])

    inner = jax.jit(sprint if window_major else sprint_chunk_major)

    def guarded(mnp_pos, mnp_M, key_arr, state, lane_offset,
                tcp=None, cell_r=None, d_scale=None, reflect=None):
        if grid_mode and cell_r is not None:
            # the grid guard must fire on concrete AND traced overrides:
            # FieldGrid residency reach was baked at build_grid time
            raise ValueError(
                "cell_r runtime overrides are not supported in "
                "field_mode='grid': the grid's resident lists were built "
                "for the static cell_r — rebuild the grid instead")
        if reflect is not None and not use_reflection:
            # the coin word is only drawn (and the branch only traced)
            # when the STATIC params enable reflection — a runtime-only
            # override would silently do nothing
            raise ValueError(
                "reflect overrides need reflection enabled in the static "
                "params (e.g. params.with_permeability()); the engine "
                "was built with reflect_io = reflect_oi = 0")
        _check_dyn_overrides(tcp, cell_r, d_scale, reflect)
        return inner(mnp_pos, mnp_M, key_arr, state, lane_offset,
                     tcp=tcp, cell_r=cell_r, d_scale=d_scale,
                     reflect=reflect)

    return guarded


def run_simulation(scene, params: Params, seed: int = 0, dtype=jnp.float32,
                   max_steps: int | None = None, phase_dtype=None):
    """Convenience driver: run the full (or truncated) simulation on one
    device and return (times_ms [n], sum_cos [n], sum_sin [n], state).

    The production path with CSV streaming and checkpointing lives in
    engine/sim.py; this is the compact form used by tests and notebooks.
    """
    mnp_pos = jnp.asarray(scene.mnps[:, :3], dtype)
    mnp_M = jnp.asarray(scene.mnps[:, 4], dtype)
    field_grid = None
    if params.field_mode == FIELD_GRID:
        field_grid = grid_mod.build_grid(
            mnp_pos, mnp_M, params, grid_n=params.grid_n,
            max_residents=params.grid_max_residents, dtype=dtype)
    sprint_fn = make_sprint_fn(params, dtype, field_grid=field_grid,
                               phase_dtype=phase_dtype)
    k = rng.key_from_seed(seed)
    key_arr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
    state = init_state(scene.waters, params, dtype, phase_dtype=phase_dtype)

    total = params.t if max_steps is None else min(params.t, max_steps)
    n_sprints = total // params.sprint_steps
    outs = []
    for _ in range(n_sprints):
        state, wins = sprint_fn(mnp_pos, mnp_M, key_arr, state, 0)
        outs.append(wins)
    wins = jnp.concatenate(outs, axis=0) if outs \
        else jnp.zeros((0, 2), dtype)
    n = wins.shape[0]
    times = (np.arange(1, n + 1) * params.pfreq) * params.tau
    return times, np.asarray(wins[:, 0]), np.asarray(wins[:, 1]), state
