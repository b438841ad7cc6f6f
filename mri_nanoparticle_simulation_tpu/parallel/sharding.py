"""Multi-device walker sharding.

The reference is strictly single-GPU (SURVEY §2: no MPI/NCCL anywhere);
its only "collectives" are an intra-device cuBLAS gemv and a thrust
reduction (cuda_sim.cu:997, 1013).  Walkers are embarrassingly parallel —
the scene is replicated, walker state is sharded over the `walkers` mesh
axis, and the only cross-device communication is a psum of the
per-window (sum cos, sum sin) pairs: 8 bytes per window, the cheapest
possible collective.

Counter-based RNG makes sharding exact rather than approximate: each
shard passes ``lane_offset = axis_index * local_walkers`` so every walker
keeps the globally-unique Threefry stream it would have had on one chip —
an N-chip run produces bit-identical physics to the single-chip run,
modulo the f32 summation order of the final reduction.

Both engines run sharded: the scan engine shards its [W] state vectors
directly; the production Pallas engine shards its [R, 128] VPU planes
over the row axis, each shard padding its local walkers to whole planes
(``to_planes_sharded``).  Either way the per-walker physics is bitwise
identical to the single-chip run because the Threefry lane is the
*global* walker index.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import rng
from ..engine import pallas_engine, reference_engine
from ..params import Params

WALKER_AXIS = "walkers"


def make_walker_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (WALKER_AXIS,))


def make_sharded_sprint_fn(params: Params, mesh: Mesh, dtype=jnp.float32):
    """Sharded sprint: walker state split over the mesh's walker axis,
    scene replicated, window sums psum'd over ICI.

    Returns ``sprint(mnp_pos, mnp_M, key_arr, state) -> (state, wins)``
    where ``wins`` is replicated [n_windows, 2] global sums.
    """
    n_shards = mesh.shape[WALKER_AXIS]
    if params.num_water % n_shards != 0:
        raise ValueError(
            f"num_water ({params.num_water}) must divide evenly over "
            f"{n_shards} devices")
    local_w = params.num_water // n_shards
    local_sprint = reference_engine.make_sprint_fn(params, dtype)

    def shard_fn(mnp_pos, mnp_M, key_arr, state):
        idx = jax.lax.axis_index(WALKER_AXIS)
        lane_offset = (idx * local_w).astype(jnp.uint32)
        esc0 = state.escapes
        cov0 = state.coverage
        new_state, wins = local_sprint(mnp_pos, mnp_M, key_arr, state,
                                       lane_offset)
        wins = jax.lax.psum(wins, WALKER_AXIS)
        esc = jax.lax.psum(new_state.escapes - esc0, WALKER_AXIS) + esc0
        cov = jax.lax.psum(new_state.coverage - cov0, WALKER_AXIS) + cov0
        return new_state._replace(escapes=esc, coverage=cov), wins

    state_spec = reference_engine.WalkerState(
        pos=P(WALKER_AXIS), in_cell=P(WALKER_AXIS), phase=P(WALKER_AXIS),
        phase_comp=P(WALKER_AXIS), step=P(), escapes=P(), coverage=P())

    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), state_spec),
        out_specs=(state_spec, P()), check_vma=False)
    return jax.jit(sharded)


def _scene_inputs(scene, mesh: Mesh, seed: int, dtype):
    """Replicated scene inputs placed explicitly on the mesh — nothing
    may touch the process-default device (which can be a different,
    possibly unusable, backend when the dryrun runs on a CPU mesh)."""
    rep = NamedSharding(mesh, P())
    np_dtype = np.dtype(dtype)
    mnp_pos = jax.device_put(np.asarray(scene.mnps[:, :3], np_dtype), rep)
    mnp_M = jax.device_put(np.asarray(scene.mnps[:, 4], np_dtype), rep)
    k = rng.key_from_seed(seed)
    key_arr = jax.device_put(
        np.asarray([np.uint32(k[0]), np.uint32(k[1])]), rep)
    return mnp_pos, mnp_M, key_arr


def run_simulation_sharded(scene, params: Params, mesh: Optional[Mesh] = None,
                           seed: int = 0, dtype=jnp.float32,
                           max_steps: Optional[int] = None):
    """Full sharded run (tests / dryrun); mirrors
    reference_engine.run_simulation."""
    mesh = mesh or make_walker_mesh()
    sprint_fn = make_sharded_sprint_fn(params, mesh, dtype)
    mnp_pos, mnp_M, key_arr = _scene_inputs(scene, mesh, seed, dtype)
    with jax.default_device(mesh.devices.flat[0]):
        state = reference_engine.init_state(scene.waters, params, dtype)
    state_spec = reference_engine.WalkerState(
        pos=P(WALKER_AXIS), in_cell=P(WALKER_AXIS), phase=P(WALKER_AXIS),
        phase_comp=P(WALKER_AXIS), step=P(), escapes=P(), coverage=P())
    state = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        state, state_spec)

    total = params.t if max_steps is None else min(params.t, max_steps)
    outs = []
    for _ in range(total // params.sprint_steps):
        state, wins = sprint_fn(mnp_pos, mnp_M, key_arr, state)
        outs.append(wins)
    wins = jnp.concatenate(outs, 0) if outs else jnp.zeros((0, 2), dtype)
    n = wins.shape[0]
    times = (np.arange(1, n + 1) * params.pfreq) * params.tau
    return times, np.asarray(wins[:, 0]), np.asarray(wins[:, 1]), state


def make_sharded_decomp_sprint_fn(params: Params, mesh: Mesh,
                                  dtype=jnp.float32):
    """Sharded *phase-decomposition* sprint: like
    :func:`make_sharded_sprint_fn` but in decompose mode
    (reference_engine.make_sprint_fn(decompose=True)) — the per-window
    output is the per-walker [n_windows, W, 2] (A, B) record, SHARDED over
    the walker axis rather than psum'd (every walker's record row lives
    with its owner shard; only escapes/coverage cross the mesh).  Each
    process then reads only its addressable record shards — the
    per-process record-shard layout run_decomposition_multihost gathers
    once at the end.
    """
    n_shards = mesh.shape[WALKER_AXIS]
    if params.num_water % n_shards != 0:
        raise ValueError(
            f"num_water ({params.num_water}) must divide evenly over "
            f"{n_shards} devices")
    local_w = params.num_water // n_shards
    local_sprint = reference_engine.make_sprint_fn(params, dtype,
                                                   decompose=True)

    def shard_fn(mnp_pos, mnp_M, key_arr, state):
        idx = jax.lax.axis_index(WALKER_AXIS)
        lane_offset = (idx * local_w).astype(jnp.uint32)
        esc0 = state.escapes
        cov0 = state.coverage
        new_state, wins = local_sprint(mnp_pos, mnp_M, key_arr, state,
                                       lane_offset)
        esc = jax.lax.psum(new_state.escapes - esc0, WALKER_AXIS) + esc0
        cov = jax.lax.psum(new_state.coverage - cov0, WALKER_AXIS) + cov0
        return new_state._replace(escapes=esc, coverage=cov), wins

    row = P(WALKER_AXIS)
    state_spec = decomp_state_spec()
    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), state_spec),
        out_specs=(state_spec, P(None, WALKER_AXIS, None)),
        check_vma=False)
    return jax.jit(sharded)


def decomp_state_spec() -> reference_engine.WalkerState:
    """PartitionSpec tree for decompose-mode walker state (phase planes
    are [W, 2]: dipole part col 0, kick part col 1)."""
    row = P(WALKER_AXIS)
    return reference_engine.WalkerState(
        pos=row, in_cell=row, phase=P(WALKER_AXIS, None),
        phase_comp=P(WALKER_AXIS, None), step=P(), escapes=P(),
        coverage=P())


# ---------------------------------------------------------------------------
# Production (Pallas) engine, sharded
# ---------------------------------------------------------------------------

def _slice_state(state: reference_engine.WalkerState, lo: int, hi: int):
    return state._replace(pos=state.pos[lo:hi], in_cell=state.in_cell[lo:hi],
                          phase=state.phase[lo:hi],
                          phase_comp=state.phase_comp[lo:hi])


def to_planes_sharded(state: reference_engine.WalkerState, params: Params,
                      n_shards: int) -> pallas_engine.PlaneState:
    """[W]-vector state -> concatenated per-shard padded [R, 128] planes.

    Each shard owns a contiguous walker range padded independently to
    whole VPU planes, so shard s's rows are rows [s*r_local, (s+1)*r_local)
    of the global plane arrays and ``P(WALKER_AXIS)`` on the row axis
    splits them exactly.  Works for decompose-mode state too ([W, 2]
    phase -> [2, R, 128] planes): the row axis is always axis -2, so the
    per-shard pieces concatenate there regardless of mode."""
    w = state.pos.shape[0]
    if w % n_shards != 0:
        raise ValueError(f"num_water ({w}) must divide evenly over "
                         f"{n_shards} shards")
    local_w = w // n_shards
    pieces = [pallas_engine.to_planes(
        _slice_state(state, s * local_w, (s + 1) * local_w), params)
        for s in range(n_shards)]
    cat = lambda f: jnp.concatenate([getattr(p, f) for p in pieces],
                                    axis=-2)
    return pallas_engine.PlaneState(
        px=cat("px"), py=cat("py"), pz=cat("pz"), in_cell=cat("in_cell"),
        phase=cat("phase"), phase_comp=cat("phase_comp"),
        step=state.step, escapes=state.escapes, coverage=state.coverage)


def from_planes_sharded(ps: pallas_engine.PlaneState, num_water: int,
                        n_shards: int) -> reference_engine.WalkerState:
    local_w = num_water // n_shards
    r_local = ps.px.shape[0] // n_shards
    rows = lambda a, s: a[..., s * r_local:(s + 1) * r_local, :]
    parts = []
    for s in range(n_shards):
        local = pallas_engine.PlaneState(
            px=rows(ps.px, s), py=rows(ps.py, s), pz=rows(ps.pz, s),
            in_cell=rows(ps.in_cell, s), phase=rows(ps.phase, s),
            phase_comp=rows(ps.phase_comp, s),
            step=ps.step, escapes=ps.escapes, coverage=ps.coverage)
        parts.append(pallas_engine.from_planes(local, local_w))
    cat = lambda f: jnp.concatenate([getattr(p, f) for p in parts], axis=0)
    return reference_engine.WalkerState(
        pos=cat("pos"), in_cell=cat("in_cell"), phase=cat("phase"),
        phase_comp=cat("phase_comp"), step=ps.step, escapes=ps.escapes,
        coverage=ps.coverage)


def make_sharded_pallas_sprint_fn(params: Params, num_water: int, mesh: Mesh,
                                  dtype=jnp.float32,
                                  rng_impl: str = pallas_engine.RNG_THREEFRY,
                                  interpret: bool = False, cache=None,
                                  decompose: bool = False):
    """Sharded sprint over the production Pallas engine: per-shard plane
    blocks run the fused chunk kernel locally (each shard's kernel grid
    covers only its walkers), window sums psum across devices.

    sprint(mnp_pos, mnp_M, key_arr, plane_state) -> (plane_state', wins)
    with ``plane_state`` laid out by :func:`to_planes_sharded`.

    ``cache`` (an ``expansion.SceneCache``, scene-constant) is replicated
    over the mesh and passed to every shard's sprint, so big scenes run
    the field-model rebuild with the scene's far table per shard instead
    of auto-building a cube cache inside every sprint.

    ``decompose=True``: phase-decomposition mode — the plane state carries
    [2, R, 128] (A, B) stacks and ``wins`` is the per-walker
    [n_windows, 2, R, 128] record, SHARDED over its row axis instead of
    psum'd (each shard keeps its own walkers' record rows; see
    distributed.run_decomposition_multihost).
    """
    n_shards = mesh.shape[WALKER_AXIS]
    if num_water % n_shards != 0:
        raise ValueError(
            f"num_water ({num_water}) must divide evenly over "
            f"{n_shards} devices")
    local_w = num_water // n_shards
    local_sprint = pallas_engine.make_sprint_fn(
        params, local_w, dtype, rng_impl, interpret, decompose=decompose)

    def shard_fn(mnp_pos, mnp_M, key_arr, ps: pallas_engine.PlaneState,
                 *cache_args):
        idx = jax.lax.axis_index(WALKER_AXIS)
        # global Threefry lane = global walker index: shard s, local j
        # -> s*local_w + j, exactly the single-chip lane assignment
        lane_offset = (idx * local_w).astype(jnp.uint32)
        esc0 = ps.escapes
        cov0 = ps.coverage
        new_ps, wins = local_sprint(mnp_pos, mnp_M, key_arr, ps,
                                    lane_offset,
                                    cache_args[0] if cache_args else None)
        if not decompose:    # per-walker records stay with their shard
            wins = jax.lax.psum(wins, WALKER_AXIS)
        esc = jax.lax.psum(new_ps.escapes - esc0, WALKER_AXIS) + esc0
        cov = jax.lax.psum(new_ps.coverage - cov0, WALKER_AXIS) + cov0
        return new_ps._replace(escapes=esc, coverage=cov), wins

    row = P(WALKER_AXIS)
    plane = P(None, WALKER_AXIS) if decompose else row
    wspec = P(None, None, WALKER_AXIS, None) if decompose else P()
    ps_spec = pallas_engine.PlaneState(
        px=row, py=row, pz=row, in_cell=row, phase=plane, phase_comp=plane,
        step=P(), escapes=P(), coverage=P())
    if cache is None:
        sharded = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P(), ps_spec),
            out_specs=(ps_spec, wspec), check_vma=False)
        return jax.jit(sharded)
    cache_spec = jax.tree.map(lambda _: P(), cache)
    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), ps_spec, cache_spec),
        out_specs=(ps_spec, wspec), check_vma=False)
    cache_dev = jax.device_put(cache, NamedSharding(mesh, P()))
    # cache rides as a real jit argument (not a closed-over constant):
    # embedding the multi-MB payload/far-table arrays as jaxpr constants
    # would inflate the compiled program and defeat executable caching
    # across scenes — the outer lambda stays un-jitted on purpose.
    jitted = jax.jit(sharded)
    return lambda mp, mM, k, ps: jitted(mp, mM, k, ps, cache_dev)


def run_simulation_sharded_pallas(scene, params: Params,
                                  mesh: Optional[Mesh] = None,
                                  seed: int = 0, dtype=jnp.float32,
                                  rng_impl: str = pallas_engine.RNG_THREEFRY,
                                  interpret: bool = False,
                                  max_steps: Optional[int] = None,
                                  cache=None):
    """Full sharded run on the production Pallas engine; mirrors
    pallas_engine.run_simulation.  Pass a scene ``cache``
    (expansion.build_cache) for big scenes so every shard's XLA field-model
    rebuild uses the per-cube far table."""
    mesh = mesh or make_walker_mesh()
    n_shards = mesh.shape[WALKER_AXIS]
    num_water = scene.waters.shape[0]
    sprint_fn = make_sharded_pallas_sprint_fn(
        params, num_water, mesh, dtype, rng_impl, interpret, cache=cache)
    mnp_pos, mnp_M, key_arr = _scene_inputs(scene, mesh, seed, dtype)
    with jax.default_device(mesh.devices.flat[0]):
        ps = to_planes_sharded(
            reference_engine.init_state(scene.waters, params, dtype),
            params, n_shards)
    row = P(WALKER_AXIS)
    ps_spec = pallas_engine.PlaneState(
        px=row, py=row, pz=row, in_cell=row, phase=row, phase_comp=row,
        step=P(), escapes=P(), coverage=P())
    ps = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), ps, ps_spec)

    total = params.t if max_steps is None else min(params.t, max_steps)
    outs = []
    for _ in range(total // params.sprint_steps):
        ps, wins = sprint_fn(mnp_pos, mnp_M, key_arr, ps)
        outs.append(wins)
    wins = jnp.concatenate(outs, 0) if outs else jnp.zeros((0, 2), dtype)
    n = wins.shape[0]
    times = (np.arange(1, n + 1) * params.pfreq) * params.tau
    state = from_planes_sharded(ps, num_water, n_shards)
    return times, np.asarray(wins[:, 0]), np.asarray(wins[:, 1]), state
