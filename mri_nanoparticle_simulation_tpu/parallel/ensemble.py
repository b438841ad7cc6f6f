"""Multi-trial ensembles and parameter sweeps.

The reference achieved "multitrial" runs by resubmitting PBS jobs with a
timestamped filename (T2_GPU_sim.cu:45, GPU_Test.sub) — T2 curves were
then averaged offline.  Here an ensemble is a first-class device
computation: T independent trials (each its own scene and RNG streams)
run as a vmapped sprint over a 2D ``(trials, walkers)`` mesh — trials
spread over chips, walkers vectorized (or further sharded) within each
trial, magnetization psum'd per trial.

Scenes differ per trial (different random cell configurations and/or a
swept ``mmoment``), so per-trial MNP arrays are padded to a common length
with far-away zero-moment dipoles that can never be selected into a near
list (they sit 1e6 µm outside the box) and contribute zero field.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import rng
from ..engine import pallas_engine, reference_engine
from ..params import Params
from ..scene import BacteriaBox

TRIAL_AXIS = "trials"


def window_times(params: Params, n_windows: int) -> np.ndarray:
    """Window-end times in ms for n output windows (the CSV time column:
    row i covers steps (i*pfreq, (i+1)*pfreq], cuda_sim.cu:1022)."""
    return (np.arange(1, n_windows + 1) * params.pfreq) * params.tau


def build_trial_scenes(params: Params, n_trials: int, base_seed: int = 0,
                       mmoments: Optional[Sequence[float]] = None,
                       cell_rs: Optional[Sequence[float]] = None,
                       scene_seeds: Optional[Sequence[int]] = None):
    """Build T scenes -> stacked (mnp_pos [T,N,3], mnp_M [T,N],
    waters [T,W,3]).  ``mmoments`` (len T) sweeps the per-cell moment;
    ``cell_rs`` (len T) sweeps the cell radius (a geometry knob: each
    trial's scene is built with its own radius).  ``scene_seeds``
    (len T) overrides the default ``base_seed + i`` per-trial seeds —
    repeated seeds give trials the SAME scene (paired sweeps)."""
    trial_params = [params if cell_rs is None
                    else params.replace(cell_r=float(cell_rs[i]))
                    for i in range(n_trials)]
    seeds = ([base_seed + i for i in range(n_trials)]
             if scene_seeds is None else list(scene_seeds))
    # paired sweeps repeat (seed, geometry) across values: build each
    # distinct scene once and share the object (scenes are read-only)
    built = {}
    scenes = []
    for i in range(n_trials):
        key = (seeds[i], trial_params[i].cell_r)
        if key not in built:
            built[key] = BacteriaBox(trial_params[i],
                                     seed=seeds[i]).populate()
        scenes.append(built[key])
    n_max = max(s.mnps.shape[0] for s in scenes)
    pos = np.full((n_trials, n_max, 3), 1e6)
    mom = np.zeros((n_trials, n_max))
    waters = np.zeros((n_trials, params.num_water, 3))
    for i, s in enumerate(scenes):
        n = s.mnps.shape[0]
        pos[i, :n] = s.mnps[:, :3]
        mom[i, :n] = s.mnps[:, 4]
        if mmoments is not None:
            mom[i, :n] *= mmoments[i] / params.mmoment
        waters[i] = s.waters
    return pos, mom, waters, scenes


def make_ensemble_sprint_fn(params: Params, mesh: Mesh, dtype=jnp.float32,
                            use_reflect: bool = False):
    """vmapped-over-trials sprint, trials sharded over the mesh.

    sprint(mnp_pos [T,N,3], mnp_M [T,N], keys [T,2], states (leading T),
           tcps [T] uint32, cell_rs [T] f32, d_scales [T] f32
           [, reflects [T,2] f32])
        -> (states, wins [T, n_windows, 2])

    ``tcps`` / ``cell_rs`` / ``d_scales`` are the per-trial Carr-Purcell
    interval (steps), cell radius, and diffusion-coefficient scale:
    runtime data, so a taucp / cell_r / D sweep rides one compiled
    program exactly like an mmoment sweep.  ``use_reflect=True`` adds a
    per-trial (reflect_io, reflect_oi) pair riding the engines' reflect
    launch scalars — the permeability axis (requires reflection enabled
    in the static params, e.g. params.with_permeability()).
    """
    local = reference_engine.make_sprint_fn(params, dtype)
    if use_reflect:
        vm = jax.vmap(lambda mp, mm, k, st, tc, cr, ds, rf: local(
            mp, mm, k, st, 0, tcp=tc, cell_r=cr, d_scale=ds,
            reflect=(rf[0], rf[1])))
    else:
        vm = jax.vmap(lambda mp, mm, k, st, tc, cr, ds: local(
            mp, mm, k, st, 0, tcp=tc, cell_r=cr, d_scale=ds))

    tspec = P(TRIAL_AXIS)
    state_spec = reference_engine.WalkerState(
        pos=tspec, in_cell=tspec, phase=tspec, phase_comp=tspec,
        step=tspec, escapes=tspec, coverage=tspec)
    n_in = 8 if use_reflect else 7
    sharded = jax.shard_map(
        vm, mesh=mesh,
        in_specs=tuple([tspec, tspec, tspec, state_spec]
                       + [tspec] * (n_in - 4)),
        out_specs=(state_spec, tspec), check_vma=False)
    return jax.jit(sharded)


def make_ensemble_pallas_sprint_fn(params: Params, mesh: Mesh,
                                   dtype=jnp.float32,
                                   rng_impl: str = pallas_engine.RNG_THREEFRY,
                                   interpret: bool = False,
                                   use_reflect: bool = False):
    """Production-engine ensemble: trials sharded over the mesh, each
    shard scanning its local trials through ONE compiled chunk kernel
    (the trial axis is a lax.scan over launches; a kernel that batches
    trials side by side to fill more of the card is a ROADMAP item).

    sprint(mnp_pos [T,N,3], mnp_M [T,N], keys [T,2], planes (leading T),
           tcps [T] uint32, cell_rs [T] f32, d_scales [T] f32)
        -> (planes, wins [T, n_windows, 2])
    """
    local = pallas_engine.make_sprint_fn(params, params.num_water, dtype,
                                         rng_impl, interpret)

    def shard_fn(mnp_pos, mnp_M, keys, planes, tcps, cell_rs, dscales,
                 *reflects):
        def body(_, xs):
            mp, mm, key, ps, tc, cr, ds = xs[:7]
            # trials are distinguished by their per-trial key (run_seed+i),
            # exactly like single runs — lane_offset stays 0 so each trial
            # is bitwise-identical to its standalone run.  tcp / cell_r /
            # d_scale (/ reflect) ride the kernel's launch scalars
            # (runtime sweep data).
            rf = (xs[7][0], xs[7][1]) if use_reflect else None
            new_ps, wins = local(mp, mm, key, ps, jnp.uint32(0),
                                 tcp=tc, cell_r=cr, d_scale=ds,
                                 reflect=rf)
            return _, (new_ps, wins)

        _, (new_planes, wins) = jax.lax.scan(
            body, 0, (mnp_pos, mnp_M, keys, planes, tcps, cell_rs,
                      dscales) + reflects)
        return new_planes, wins

    tspec = P(TRIAL_AXIS)
    planes_spec = pallas_engine.PlaneState(
        px=tspec, py=tspec, pz=tspec, in_cell=tspec, phase=tspec,
        phase_comp=tspec, step=tspec, escapes=tspec, coverage=tspec)
    n_in = 8 if use_reflect else 7
    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=tuple([tspec, tspec, tspec, planes_spec]
                       + [tspec] * (n_in - 4)),
        out_specs=(planes_spec, tspec), check_vma=False)
    return jax.jit(sharded)


def make_ensemble_sprint_fn_2d(params: Params, mesh: Mesh,
                               dtype=jnp.float32,
                               use_reflect: bool = False):
    """Trials x walker-sharding on ONE 2D mesh — the pod layout: trials
    are embarrassingly parallel across one axis while each trial's
    walkers shard over the other (ICI-adjacent) axis with a per-window
    psum, composing parallel/sharding.py's exact-lane contract with the
    ensemble layout.  Physics is bitwise per walker vs the single-device
    run (global Threefry lanes); curves differ only by f32 summation
    order.

    sprint(mnp_pos [T,N,3], mnp_M [T,N], keys [T,2], states (leading T,
           walker dims sharded), tcps [T], cell_rs [T], d_scales [T])
        -> (states, wins [T, n_windows, 2] — per-trial GLOBAL sums)
    """
    from . import sharding
    n_wshards = mesh.shape[sharding.WALKER_AXIS]
    if params.num_water % n_wshards != 0:
        raise ValueError(
            f"num_water ({params.num_water}) must divide evenly over "
            f"{n_wshards} walker shards")
    local_w = params.num_water // n_wshards
    local = reference_engine.make_sprint_fn(params, dtype)

    def per_trial(mp, mm, key, st, tc, cr, ds, *rf):
        widx = jax.lax.axis_index(sharding.WALKER_AXIS)
        lane_offset = (widx * local_w).astype(jnp.uint32)
        esc0, cov0 = st.escapes, st.coverage
        new, wins = local(mp, mm, key, st, lane_offset,
                          tcp=tc, cell_r=cr, d_scale=ds,
                          reflect=(rf[0][0], rf[0][1]) if use_reflect
                          else None)
        wins = jax.lax.psum(wins, sharding.WALKER_AXIS)
        esc = jax.lax.psum(new.escapes - esc0,
                           sharding.WALKER_AXIS) + esc0
        cov = jax.lax.psum(new.coverage - cov0,
                           sharding.WALKER_AXIS) + cov0
        return new._replace(escapes=esc, coverage=cov), wins

    vm = jax.vmap(per_trial)

    tspec = P(TRIAL_AXIS)
    trow = P(TRIAL_AXIS, sharding.WALKER_AXIS)
    state_spec = reference_engine.WalkerState(
        pos=trow, in_cell=trow, phase=trow, phase_comp=trow,
        step=tspec, escapes=tspec, coverage=tspec)
    n_in = 8 if use_reflect else 7
    sharded = jax.shard_map(
        vm, mesh=mesh,
        in_specs=tuple([tspec, tspec, tspec, state_spec]
                       + [tspec] * (n_in - 4)),
        out_specs=(state_spec, tspec), check_vma=False)
    return jax.jit(sharded)


def make_ensemble_pallas_sprint_fn_2d(
        params: Params, mesh: Mesh, dtype=jnp.float32,
        rng_impl: str = pallas_engine.RNG_THREEFRY,
        interpret: bool = False, use_reflect: bool = False):
    """The production engine on the 2D (trials x walkers) mesh: each
    shard scans its local trials through a chunk kernel sized for its
    LOCAL walkers (per-shard plane packing, sharding.to_planes_sharded
    per trial), per-window psum over the walker axis."""
    from . import sharding
    n_wshards = mesh.shape[sharding.WALKER_AXIS]
    if params.num_water % n_wshards != 0:
        raise ValueError(
            f"num_water ({params.num_water}) must divide evenly over "
            f"{n_wshards} walker shards")
    local_w = params.num_water // n_wshards
    local = pallas_engine.make_sprint_fn(params, local_w, dtype,
                                         rng_impl, interpret)

    def shard_fn(mnp_pos, mnp_M, keys, planes, tcps, cell_rs, dscales,
                 *reflects):
        widx = jax.lax.axis_index(sharding.WALKER_AXIS)
        lane_offset = (widx * local_w).astype(jnp.uint32)

        def body(_, xs):
            mp, mm, key, ps, tc, cr, ds = xs[:7]
            rf = (xs[7][0], xs[7][1]) if use_reflect else None
            esc0, cov0 = ps.escapes, ps.coverage
            new_ps, wins = local(mp, mm, key, ps, lane_offset,
                                 tcp=tc, cell_r=cr, d_scale=ds,
                                 reflect=rf)
            wins = jax.lax.psum(wins, sharding.WALKER_AXIS)
            esc = jax.lax.psum(new_ps.escapes - esc0,
                               sharding.WALKER_AXIS) + esc0
            cov = jax.lax.psum(new_ps.coverage - cov0,
                               sharding.WALKER_AXIS) + cov0
            return _, (new_ps._replace(escapes=esc, coverage=cov), wins)

        _, (new_planes, wins) = jax.lax.scan(
            body, 0, (mnp_pos, mnp_M, keys, planes, tcps, cell_rs,
                      dscales) + reflects)
        return new_planes, wins

    tspec = P(TRIAL_AXIS)
    trow = P(TRIAL_AXIS, sharding.WALKER_AXIS)
    planes_spec = pallas_engine.PlaneState(
        px=trow, py=trow, pz=trow, in_cell=trow, phase=trow,
        phase_comp=trow, step=tspec, escapes=tspec, coverage=tspec)
    n_in = 8 if use_reflect else 7
    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=tuple([tspec, tspec, tspec, planes_spec]
                       + [tspec] * (n_in - 4)),
        out_specs=(planes_spec, tspec), check_vma=False)
    return jax.jit(sharded)


def _trial_mesh(n_trials: int, mesh: Optional[Mesh]):
    """Pick a trial mesh; returns (mesh, padded_n_trials).

    When we choose the mesh, it is right-sized so padding is minimal at
    the optimal wall-clock: rounds r = ceil(n_trials / n_devices) is the
    fastest any schedule can finish, and the smallest device count d
    with r*d >= n_trials keeps that wall-clock while wasting at most
    r-1 padding trials (a full-width mesh would discard up to
    n_devices-1 whole simulations — e.g. 2 trials on 8 devices used to
    burn 6 padding trials; now it runs a 2-device mesh with zero).

    A caller-provided mesh is honored as-is (trials then pad up to a
    multiple of its trial-axis size, with a warning)."""
    if mesh is not None:
        n_dev = mesh.shape[TRIAL_AXIS]
        pad = (-n_trials) % n_dev
        if pad:
            warnings.warn(
                f"n_trials={n_trials} does not divide over the given "
                f"{n_dev}-device mesh; running {pad} extra padding "
                f"trial(s) (their results are discarded). Use a multiple "
                f"of the mesh size, or drop the mesh argument to get a "
                f"right-sized one.", stacklevel=3)
        return mesh, n_trials + pad
    devs = jax.devices()
    rounds = -(-n_trials // len(devs))
    d = -(-n_trials // rounds)        # smallest width keeping `rounds`
    mesh = Mesh(np.asarray(devs[:d]), (TRIAL_AXIS,))
    pad = rounds * d - n_trials
    if pad:
        warnings.warn(
            f"n_trials={n_trials} pads to {rounds * d} on a right-sized "
            f"{d}-device mesh ({pad} discarded padding trial(s) — the "
            f"minimum at this wall-clock).", stacklevel=3)
    return mesh, rounds * d


def _trial_mesh_2d(n_trials: int, walker_shards: int,
                   mesh: Optional[Mesh]):
    """2D (trials x walkers) mesh; same right-sizing rule as
    _trial_mesh applied to the trial axis with len(devices) //
    walker_shards slots."""
    from . import sharding
    if mesh is not None:
        if set(mesh.axis_names) != {TRIAL_AXIS, sharding.WALKER_AXIS}:
            raise ValueError(
                f"a walker-sharded ensemble mesh needs axes "
                f"({TRIAL_AXIS!r}, {sharding.WALKER_AXIS!r}); got "
                f"{mesh.axis_names}")
        if mesh.shape[sharding.WALKER_AXIS] != walker_shards:
            # the pallas path packs planes with walker_shards but sizes
            # the kernel and RNG lane offsets from the mesh axis — a
            # mismatch would silently misassign walkers to streams
            raise ValueError(
                f"mesh walker axis ({mesh.shape[sharding.WALKER_AXIS]}) "
                f"must equal walker_shards ({walker_shards})")
        n_dev = mesh.shape[TRIAL_AXIS]
        pad = (-n_trials) % n_dev
        if pad:
            warnings.warn(
                f"n_trials={n_trials} does not divide over the given "
                f"{n_dev}-trial-slot mesh; running {pad} extra padding "
                f"trial(s).", stacklevel=3)
        return mesh, n_trials + pad
    devs = jax.devices()
    if len(devs) % walker_shards != 0 or walker_shards > len(devs):
        raise ValueError(
            f"walker_shards ({walker_shards}) must divide the device "
            f"count ({len(devs)})")
    avail = len(devs) // walker_shards
    rounds = -(-n_trials // avail)
    d = -(-n_trials // rounds)
    mesh = Mesh(np.asarray(devs[:d * walker_shards]).reshape(
        d, walker_shards), (TRIAL_AXIS, sharding.WALKER_AXIS))
    pad = rounds * d - n_trials
    if pad:
        warnings.warn(
            f"n_trials={n_trials} pads to {rounds * d} on a right-sized "
            f"{d}x{walker_shards} mesh ({pad} discarded padding "
            f"trial(s)).", stacklevel=3)
    return mesh, rounds * d


def run_ensemble(params: Params, n_trials: int,
                 mesh: Optional[Mesh] = None, base_seed: int = 0,
                 run_seed: int = 1000,
                 mmoments: Optional[Sequence[float]] = None,
                 taucps: Optional[Sequence[float]] = None,
                 cell_rs: Optional[Sequence[float]] = None,
                 run_cell_rs: Optional[Sequence[float]] = None,
                 d_scales: Optional[Sequence[float]] = None,
                 permeabilities: Optional[Sequence[float]] = None,
                 scene_seeds: Optional[Sequence[int]] = None,
                 run_seeds: Optional[Sequence[int]] = None,
                 walker_shards: int = 1,
                 dtype=jnp.float32, max_steps: Optional[int] = None,
                 engine: str = "scan",
                 rng_impl: str = pallas_engine.RNG_THREEFRY,
                 interpret: bool = False, check_coverage: bool = True):
    """Run T independent trials; returns (times_ms, sum_cos [T, n],
    sum_sin [T, n], state).  Average over axis 0 for the ensemble curve.

    ``engine='pallas'`` runs the production chunk kernel per trial;
    ``engine='scan'`` (default) vmaps the pure-JAX engine.
    ``check_coverage`` validates near_k against every trial's scene (the
    same guard SimulationRunner applies to its single scene).

    ``mmoments`` / ``taucps`` (ms) / ``cell_rs`` (µm) / ``d_scales``
    (dimensionless, scales D_cell AND D_extra together) /
    ``permeabilities`` (µm/ms, mapped to per-trial (reflect_io,
    reflect_oi) bounce probabilities via :meth:`Params.reflect_pair`;
    requires reflection enabled in the static params, e.g.
    ``params.with_permeability()``), each len T, give
    per-trial values of the corresponding knob as *runtime data* — all
    trials share one compiled program (the engines accept tcp / cell_r /
    d_scale as launch scalars).  Every taucp must keep tcp a multiple of
    pfreq (checked here, like Params.validate does for the static knob).
    d_scales > 1 walk farther per chunk, so the near-list coverage is
    validated against the SCALED diffusion coefficients per trial.

    ``run_cell_rs`` (µm, len T) also rides the cell_r launch scalar but
    keeps every scene's GEOMETRY at ``params.cell_r`` — same centers and
    walkers, only the runtime residency radius varies (the
    :func:`inverse.fit_cell_radius_crn` semantics, and the golden
    harness's cell_r arm).  ``cell_rs`` by contrast rebuilds each
    trial's scene at its radius (the full geometry knob); the two are
    mutually exclusive.

    ``scene_seeds`` / ``run_seeds`` (each len T) override the default
    ``base_seed + i`` / ``run_seed + i`` per-trial seeds.  Repeating a
    seed across trials gives them the same scene and the same RNG
    stream — PAIRED sweeps: two trials differing only in a swept knob
    see identical scenes and identical random draws, so their curve
    difference is the knob's effect alone, with the Monte-Carlo noise
    common-mode cancelled (run_parameter_sweep(paired=True)).

    ``walker_shards`` > 1 runs each trial's walkers sharded over that
    many devices on a 2D (trials x walkers) mesh — the pod layout:
    trials across one axis, per-trial psum over the other.  Per-walker
    physics stays bitwise-identical to the single-device run (global
    Threefry lanes).
    """
    params.validate()
    for name, vals in (("scene_seeds", scene_seeds),
                       ("run_seeds", run_seeds)):
        if vals is not None and len(vals) != n_trials:
            raise ValueError(f"{name} must have one value per trial "
                             f"([{n_trials}]), got {len(vals)}")
    if taucps is not None:
        for v in taucps:
            params.replace(taucp=float(v)).validate()
    if cell_rs is not None and run_cell_rs is not None:
        raise ValueError("cell_rs rebuilds each scene at its radius; "
                         "run_cell_rs varies only the runtime residency "
                         "radius on fixed geometry — pass one, not both")
    if cell_rs is not None:
        # same host-side validation as taucps: a zero/negative radius
        # would otherwise only fail obscurely inside scene building
        for v in cell_rs:
            params.replace(cell_r=float(v)).validate()
    if run_cell_rs is not None:
        if len(run_cell_rs) != n_trials:
            raise ValueError(f"run_cell_rs must have one value per trial "
                             f"([{n_trials}]), got {len(run_cell_rs)}")
        for v in run_cell_rs:
            params.replace(cell_r=float(v)).validate()
    if d_scales is not None:
        for v in d_scales:
            if not float(v) > 0:
                raise ValueError(f"d_scales must be > 0; got {v}")
            params.scale_D(float(v)).validate()
    if permeabilities is not None:
        if not (params.reflect_io > 0 or params.reflect_oi > 0):
            raise ValueError(
                "permeability sweeps ride the engines' reflect launch "
                "scalars, which need reflection enabled in the static "
                "params — build them with params.with_permeability() "
                "(any value; per-trial probabilities override it)")
        # host-side validation via THE P->(rio, roi) mapping
        # (params.reflect_pair, parameters.h:116-117 formulas); raises
        # for P outside the formulas' validity bounds
        for v in permeabilities:
            params.reflect_pair(float(v))
    from ..params import FIELD_EXPANSION
    if params.field_mode != FIELD_EXPANSION:
        raise ValueError(
            f"ensembles run the expansion field backend; field_mode="
            f"{params.field_mode!r} is only wired into single-scene "
            f"SimulationRunner/scan runs")
    if walker_shards > 1:
        mesh, n_padded = _trial_mesh_2d(n_trials, walker_shards, mesh)
    else:
        mesh, n_padded = _trial_mesh(n_trials, mesh)

    def pad_vals(vals):
        if vals is not None and n_padded > n_trials:
            return list(vals) + [vals[-1]] * (n_padded - n_trials)
        return vals

    mmoments = pad_vals(mmoments)
    taucps = pad_vals(taucps)
    cell_rs = pad_vals(cell_rs)
    run_cell_rs = pad_vals(run_cell_rs)
    d_scales = pad_vals(d_scales)
    permeabilities = pad_vals(permeabilities)
    scene_seeds = pad_vals(scene_seeds)
    run_seeds = pad_vals(run_seeds)
    use_reflect = permeabilities is not None
    mnp_pos, mnp_M, waters, scenes = build_trial_scenes(
        params, n_padded, base_seed, mmoments, cell_rs,
        scene_seeds=scene_seeds)
    if check_coverage:
        from ..fields import expansion
        validated = {}    # (scene, effective params) -> worst count;
        # paired sweeps repeat both, so each distinct case runs once
        for i, s in enumerate(scenes[:n_trials]):
            p_i = params if cell_rs is None \
                else params.replace(cell_r=float(cell_rs[i]))
            if run_cell_rs is not None:
                # fixed geometry, runtime residency radius: the reach
                # (cell_r + travel) follows the RUN radius
                p_i = p_i.replace(cell_r=float(run_cell_rs[i]))
            if d_scales is not None and float(d_scales[i]) > 1:
                # the chunk-travel bound scales with sqrt(D): validate
                # the near-list coverage at the trial's actual reach
                p_i = p_i.scale_D(float(d_scales[i]))
            vkey = (id(s), p_i)
            if vkey not in validated:
                validated[vkey] = expansion.validate_near_k(
                    s.mnps[:, :3], p_i, n_probe=20_000)
            worst = validated[vkey]
            if worst > params.near_k:
                seed_i = (base_seed + i if scene_seeds is None
                          else scene_seeds[i])
                raise ValueError(
                    f"trial {i} (scene seed {seed_i}) requires "
                    f"near_k >= {worst} (configured {params.near_k}); "
                    f"raise near_k or lower chunk_steps")

    keys = []
    for i in range(n_padded):
        k = rng.key_from_seed(run_seed + i if run_seeds is None
                              else int(run_seeds[i]))
        keys.append([np.uint32(k[0]), np.uint32(k[1])])
    keys = jnp.asarray(keys)

    states = [reference_engine.init_state(waters[i], params, dtype)
              for i in range(n_padded)]
    if engine == "pallas":
        if walker_shards > 1:
            from . import sharding as sharding_mod
            state = jax.tree.map(
                lambda *xs: jnp.stack(xs),
                *[sharding_mod.to_planes_sharded(s, params, walker_shards)
                  for s in states])
            sprint = make_ensemble_pallas_sprint_fn_2d(
                params, mesh, dtype, rng_impl, interpret,
                use_reflect=use_reflect)
        else:
            state = jax.tree.map(
                lambda *xs: jnp.stack(xs),
                *[pallas_engine.to_planes(s, params) for s in states])
            sprint = make_ensemble_pallas_sprint_fn(
                params, mesh, dtype, rng_impl, interpret,
                use_reflect=use_reflect)
    elif engine == "scan":
        state = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
        sprint = (make_ensemble_sprint_fn_2d(params, mesh, dtype,
                                             use_reflect=use_reflect)
                  if walker_shards > 1
                  else make_ensemble_sprint_fn(params, mesh, dtype,
                                               use_reflect=use_reflect))
    else:
        raise ValueError(f"unknown engine {engine!r}")
    mnp_pos = jnp.asarray(mnp_pos, dtype)
    mnp_M = jnp.asarray(mnp_M, dtype)
    tcps = jnp.asarray(
        [params.tcp if taucps is None else int(round(taucps[i] / params.tau))
         for i in range(n_padded)], jnp.uint32)
    run_crs = run_cell_rs if run_cell_rs is not None else cell_rs
    crs = jnp.asarray(
        [params.cell_r if run_crs is None else float(run_crs[i])
         for i in range(n_padded)], jnp.float32)
    dss = jnp.asarray(
        [1.0 if d_scales is None else float(d_scales[i])
         for i in range(n_padded)], jnp.float32)
    extra_axes = ()
    if use_reflect:
        extra_axes = (jnp.asarray(
            [params.reflect_pair(float(permeabilities[i]))
             for i in range(n_padded)], jnp.float32),)

    # AOT warm-start for repeat sweeps (single-device trial mesh, the
    # CLI case, where tracing and kernel lowering repeat every run):
    # same key discipline as the single-run cache (engine/aot.py) with
    # the trial count and padded MNP width in the key.  Any failure
    # falls back to the jit path — the cache is only an accelerator.
    # the AOT ensemble executable is lowered on the 7-argument call;
    # the reflect axis changes the signature, so it bypasses the cache
    if engine == "pallas" and walker_shards == 1 and not interpret \
            and not use_reflect and mesh.devices.size == 1:
        from ..engine import aot
        loaded = aot.load_ensemble_sprint(
            params, n_padded, mnp_pos.shape[1], dtype, rng_impl)
        if loaded is not None:
            sprint = loaded
        else:
            saved = aot.compile_and_save_ensemble(
                sprint, params, n_padded,
                (mnp_pos, mnp_M, keys, state, tcps, crs, dss), dtype,
                rng_impl)
            if saved is not None:
                sprint = saved

    total = params.t if max_steps is None else min(params.t, max_steps)
    outs = []
    for _ in range(total // params.sprint_steps):
        state, wins = sprint(mnp_pos, mnp_M, keys, state, tcps, crs, dss,
                             *extra_axes)
        outs.append(wins)
    wins = jnp.concatenate(outs, axis=1) if outs \
        else jnp.zeros((n_padded, 0, 2), dtype)
    if engine == "pallas":
        if walker_shards > 1:
            from . import sharding as sharding_mod
            # one vmapped conversion over the trial axis (the static
            # per-shard slicing inside from_planes_sharded batches
            # fine) instead of n_trials x walker_shards host dispatches
            state = jax.vmap(
                lambda ps: sharding_mod.from_planes_sharded(
                    ps, params.num_water, walker_shards))(state)
        else:
            state = jax.vmap(
                lambda ps: pallas_engine.from_planes(
                    ps, params.num_water))(state)
    # drop padding trials
    wins = wins[:n_trials]
    state = jax.tree.map(
        lambda x: x[:n_trials] if getattr(x, "ndim", 0) > 0 else x, state)
    times = window_times(params, wins.shape[1])
    return times, np.asarray(wins[..., 0]), np.asarray(wins[..., 1]), state


#: Params knobs the engines accept as launch scalars (runtime data, one
#: compiled program across values); everything else recompiles per value
SCALAR_AXES = ("mmoment", "taucp", "cell_r", "D", "P")

#: sweep-axis name -> run_ensemble per-trial kwarg (shared by
#: grid_per_trial and run_parameter_sweep so they cannot diverge)
_AXIS_KWARG = {"mmoment": "mmoments", "taucp": "taucps",
               "cell_r": "cell_rs", "D": "d_scales",
               "P": "permeabilities"}


def sweep_params_for(base_params: Params, name: str, value):
    """The ONE mapping from a sweep-axis name + value to concrete
    Params — used by run_parameter_sweep AND the CLI's per-point output
    metadata so the two can never drift.  Special axes: ``D`` scales
    both diffusion coefficients; ``Gz`` sets the z background gradient
    (a tuple field the generic replace cannot reach)."""
    if name == "D":
        return base_params.scale_D(float(value))
    if name == "P":
        return base_params.with_permeability(float(value))
    if name == "Gz":
        bg = base_params.b0_gradient
        return base_params.replace(b0_gradient=(bg[0], bg[1],
                                                float(value)))
    return base_params.replace(**{name: value})


def grid_per_trial(axes: dict, n_trials_each: int, paired: bool,
                   base_seed: int, run_seed: int):
    """Shared grid expansion (single-process and multihost callers):
    validates that every axis is a launch scalar, expands the cross
    product, and returns (value_lists, combos, per_trial_kwargs) where
    per_trial_kwargs holds the per-trial axis vectors for
    :func:`run_ensemble` (+ paired seed overrides when asked).  ONE
    definition so the paired-seed assignment and axis mapping cannot
    diverge between the local and DCN paths."""
    import itertools
    names = list(axes.keys())
    bad = [n for n in names if n not in SCALAR_AXES]
    if bad:
        raise ValueError(
            f"parameter grids sweep launch-scalar knobs only "
            f"({SCALAR_AXES}); {bad} would need a recompile per value "
            f"— loop run_parameter_sweep for those")
    if not names:
        raise ValueError("axes must name at least one knob")
    value_lists = [list(axes[n]) for n in names]
    combos = list(itertools.product(*value_lists))   # row-major
    per_trial = {}
    for ai, n in enumerate(names):
        per_trial[_AXIS_KWARG[n]] = [c[ai] for c in combos
                                     for _ in range(n_trials_each)]
    if paired:
        per_trial["scene_seeds"] = [base_seed + k for _ in combos
                                    for k in range(n_trials_each)]
        per_trial["run_seeds"] = [run_seed + k for _ in combos
                                  for k in range(n_trials_each)]
    return value_lists, combos, per_trial


def run_parameter_grid(base_params: Params, axes: dict,
                       n_trials_each: int = 1, base_seed: int = 0,
                       run_seed: int = 1000, dtype=jnp.float32,
                       max_steps=None, engine: str = "scan",
                       rng_impl: str = pallas_engine.RNG_THREEFRY,
                       interpret: bool = False, paired: bool = False,
                       walker_shards: int = 1,
                       mesh: Optional[Mesh] = None,
                       quadrature: bool = False):
    """Cross-product sweep over MULTIPLE launch-scalar knobs in ONE
    compiled program: ``axes`` maps knob names (a subset of
    :data:`SCALAR_AXES`) to value lists; every combination runs as a
    trial of one ensemble — e.g. ``{"D": [.25, .5, 1], "taucp":
    [1, 2, 5.5]}`` is the full 9-point motional-narrowing surface
    R2(D, taucp), a single device computation where the reference
    re-ran nvcc + a ~14-minute job per point.

    ``paired=True`` gives trial k of EVERY grid point the same scene
    and RNG stream (common random numbers across the whole surface).

    Returns ``(times_ms, curves)`` with curves shaped
    ``[n1, n2, ..., n_trials_each, n_windows]`` — one leading axis per
    key of ``axes`` in iteration order.  ``quadrature=True`` appends a
    trailing component axis stacking (sum cos, sum sin):
    ``[..., n_windows, 2]`` (the reference emits cos only,
    cuda_sim.cu:825).
    """
    value_lists, combos, per_trial = grid_per_trial(
        axes, n_trials_each, paired, base_seed, run_seed)
    if "P" in axes and not (base_params.reflect_io > 0
                            or base_params.reflect_oi > 0):
        # the reflect launch scalars need the reflection branch traced
        # in; the static values are immaterial (every trial overrides)
        base_params = base_params.with_permeability()
    times, cos, sin, _ = run_ensemble(
        base_params, n_trials=len(combos) * n_trials_each,
        base_seed=base_seed, run_seed=run_seed, **per_trial,
        dtype=dtype, max_steps=max_steps, engine=engine,
        rng_impl=rng_impl, interpret=interpret,
        walker_shards=walker_shards, mesh=mesh)
    flat = np.stack([cos, sin], -1) if quadrature else cos
    shape = [len(v) for v in value_lists] + [n_trials_each, -1] + \
        ([2] if quadrature else [])
    return times, flat.reshape(shape)


def run_parameter_sweep(base_params: Params, name: str, values,
                        n_trials_each: int = 1, base_seed: int = 0,
                        run_seed: int = 1000, dtype=jnp.float32,
                        max_steps=None, engine: str = "scan",
                        rng_impl: str = pallas_engine.RNG_THREEFRY,
                        interpret: bool = False, paired: bool = False,
                        walker_shards: int = 1,
                        quadrature: bool = False):
    """Sweep any Params field (e.g. cell_r, taucp, mmoment) across runs.

    ``mmoment``, ``taucp``, ``cell_r``, ``D``, and ``P`` sweeps share
    ONE compiled program via :func:`run_ensemble` — the moment is plain
    array data, and tcp / cell_r / d_scale / reflect ride the engines'
    launch scalars (the reference recompiled with nvcc per value of any
    of these, README.md:13).  ``D`` is the global diffusion scale:
    value v scales D_cell AND D_extra by v (parameters.h:84-85
    individually remain sweepable as compile-time knobs).  ``P`` is the
    membrane permeability (µm/ms): each value maps to (reflect_io,
    reflect_oi) bounce probabilities through
    :meth:`Params.reflect_pair` (the commented-out parameters.h:116-117
    formulas); reflection is traced in automatically when the base
    params ship it disabled.  Every other knob is a compile-time
    constant of the kernels, so each value compiles its own program;
    scenes are rebuilt per value since geometry knobs change cell
    placement (cell_r rebuilds scenes too — per *trial* — but without
    recompiling).

    ``name='Gz'`` sweeps the z component of ``b0_gradient`` (the
    diffusion-weighting series of a DWI acquisition); gradients are
    compile-time constants of the kernels, so each value compiles its
    own program like any non-launch-scalar knob.

    ``paired=True`` gives trial k of EVERY value the same scene seed
    (``base_seed + k``) and the same RNG stream (``run_seed + k``):
    common random numbers across the sweep axis, so the difference
    between two values' curves is the knob's effect alone — the
    Monte-Carlo noise is common-mode and cancels in contrasts (the
    default, ``paired=False``, keeps every trial independent, which is
    what you want for an unbiased ensemble average but wastes variance
    when the question is a CONTRAST along the axis).  For geometry
    knobs (cell_r) pairing means the same throw sequence: scenes share
    their cell placement pattern at each trial index.

    Returns (times_ms, curves [len(values), n_trials_each, n_windows]);
    ``quadrature=True`` appends a trailing (cos, sin) component axis.
    """
    if name in SCALAR_AXES:
        if name == "P" and not (base_params.reflect_io > 0
                                or base_params.reflect_oi > 0):
            # trace the reflection branch in; per-trial scalars override
            base_params = base_params.with_permeability()
        key = _AXIS_KWARG[name]
        per_trial = {key: [v for v in values for _ in range(n_trials_each)]}
        if paired:
            per_trial["scene_seeds"] = [base_seed + k for _ in values
                                        for k in range(n_trials_each)]
            per_trial["run_seeds"] = [run_seed + k for _ in values
                                     for k in range(n_trials_each)]
        times, cos, sin, _ = run_ensemble(
            base_params, n_trials=len(values) * n_trials_each,
            base_seed=base_seed, run_seed=run_seed, **per_trial,
            dtype=dtype, max_steps=max_steps, engine=engine,
            rng_impl=rng_impl, interpret=interpret,
            walker_shards=walker_shards)
        flat = np.stack([cos, sin], -1) if quadrature else cos
        shape = (len(values), n_trials_each, -1) + \
            ((2,) if quadrature else ())
        return times, flat.reshape(shape)

    curves = []
    times = None
    for i, v in enumerate(values):
        p = sweep_params_for(base_params, name, v).validate()
        times, cos, sin, _ = run_ensemble(
            p, n_trials=n_trials_each, base_seed=base_seed,
            run_seed=run_seed if paired else run_seed + i * 10000,
            dtype=dtype,
            max_steps=max_steps, engine=engine, rng_impl=rng_impl,
            interpret=interpret, walker_shards=walker_shards)
        curves.append(np.stack([cos, sin], -1) if quadrature else cos)
    return times, np.stack(curves)
