"""Multi-host (multi-process) execution over DCN.

The reference is a single-process, single-GPU program; its "multi-node"
story was resubmitting PBS jobs (SURVEY §5).  Here the DCN story is
first-class: ``jax.distributed`` connects N processes (one per host) into
one JAX runtime whose global device list spans all hosts, and the
existing walker-sharding / ensemble machinery runs unchanged on a GLOBAL
mesh — shard_map + psum lower to ICI collectives within a host and DCN
transfers across hosts, scheduled by XLA.

Layout guidance (How-to-Scale-Your-Model recipe): walkers within a trial
shard over the fast axis (ICI; the per-window psum is 8 bytes, so even
DCN is fine), while *trials* (ensembles / parameter sweeps) are
embarrassingly parallel and map across hosts — each trial's entire
computation stays on one host's devices and only the final [T, n]
curves cross DCN, once.  Both layouts are implemented here:
``run_simulation_multihost`` (walkers over the global mesh) and
``run_ensemble_multihost`` (contiguous trial blocks per process, one
curve allgather at the end).

Usage (one process per host, same program):

    from mri_nanoparticle_simulation_tpu.parallel import distributed
    distributed.initialize()          # env-driven (JAX_COORDINATOR_...)
    mesh = distributed.global_walker_mesh()
    runner = SimulationRunner(params, mesh=mesh)   # sharded across hosts

Verification without multi-host hardware: ``python -m
mri_nanoparticle_simulation_tpu.parallel.distributed --num-processes 2
--process-id I --coordinator localhost:P`` runs one process of a
2-process x 4-virtual-CPU-device dry run; tests/test_distributed.py
spawns both and asserts cross-process equality with the single-device
run (the same contract the single-process dryrun proves on 8 devices).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Idempotent ``jax.distributed.initialize`` wrapper.

    With no arguments, defers to jax's own env/cluster autodetection
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or
    a cluster manager's environment when running under one).
    Single-process callers (num_processes in (None, 0, 1) and no
    coordinator) are a no-op so the same program runs unmodified on one
    host.
    """
    import jax
    if coordinator_address is None and num_processes in (None, 0, 1) \
            and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def global_walker_mesh():
    """Walker mesh over ALL global devices (every process must call this
    with the same jax.distributed world)."""
    from . import sharding
    import jax
    return sharding.make_walker_mesh(jax.devices())


def put_global(mesh, spec, host_array):
    """Place an identical-on-every-host numpy array as a global jax.Array
    with the given PartitionSpec on a (possibly multi-process) mesh."""
    import jax
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, spec)
    arr = np.asarray(host_array)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def run_simulation_multihost(scene, params, mesh=None, seed: int = 0,
                             dtype=None, max_steps=None,
                             engine: str = "scan",
                             rng_impl: str = "threefry",
                             interpret: bool = False):
    """Walker-sharded full run on a global (multi-host) mesh.

    Identical physics contract to sharding.run_simulation_sharded (global
    Threefry lanes -> bitwise-equal to the single-device run), but all
    inputs are constructed as global arrays via make_array_from_callback
    so the same code runs under 1 or N processes.  ``engine`` is
    ``"scan"`` or ``"pallas"`` (the production kernel, per-shard plane
    blocks as in sharding.run_simulation_sharded_pallas).  Returns
    (times, sum_cos, sum_sin, state); `state` leaves are global
    jax.Arrays — inspect local shards via ``.addressable_shards`` (a
    host only holds its own walkers).  The Pallas engine's state is
    returned AS a PlaneState (not converted back to walker vectors —
    a host cannot materialize non-addressable shards; apply
    sharding.from_planes_sharded to a gathered copy if needed).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from .. import rng as rng_mod
    from ..engine import pallas_engine, reference_engine
    from . import sharding

    dtype = dtype or jnp.float32
    mesh = mesh or global_walker_mesh()
    np_dtype = np.dtype(dtype)
    row = P(sharding.WALKER_AXIS)
    host_state = reference_engine.init_state(scene.waters, params, dtype)
    if engine == "scan":
        sprint_fn = sharding.make_sharded_sprint_fn(params, mesh, dtype)
        state_spec = reference_engine.WalkerState(
            pos=row, in_cell=row, phase=row, phase_comp=row,
            step=P(), escapes=P(), coverage=P())
    elif engine == "pallas":
        n_shards = mesh.shape[sharding.WALKER_AXIS]
        sprint_fn = sharding.make_sharded_pallas_sprint_fn(
            params, scene.waters.shape[0], mesh, dtype, rng_impl,
            interpret)
        host_state = sharding.to_planes_sharded(host_state, params,
                                                n_shards)
        state_spec = pallas_engine.PlaneState(
            px=row, py=row, pz=row, in_cell=row, phase=row,
            phase_comp=row, step=P(), escapes=P(), coverage=P())
    else:
        raise ValueError(f"unknown engine {engine!r}")

    mnp_pos = put_global(mesh, P(), np.asarray(scene.mnps[:, :3], np_dtype))
    mnp_M = put_global(mesh, P(), np.asarray(scene.mnps[:, 4], np_dtype))
    k = rng_mod.key_from_seed(seed)
    key_arr = put_global(mesh, P(),
                         np.asarray([np.uint32(k[0]), np.uint32(k[1])]))
    state = jax.tree.map(lambda x, s: put_global(mesh, s, x),
                         host_state, state_spec)

    total = params.t if max_steps is None else min(params.t, max_steps)
    outs = []
    for _ in range(total // params.sprint_steps):
        state, wins = sprint_fn(mnp_pos, mnp_M, key_arr, state)
        outs.append(np.asarray(wins))       # replicated: host-readable
    wins = np.concatenate(outs, 0) if outs else np.zeros((0, 2))
    times = (np.arange(1, len(wins) + 1) * params.pfreq) * params.tau
    return times, wins[:, 0], wins[:, 1], state


def run_decomposition_multihost(scene, params, mesh=None, seed: int = 0,
                                dtype=None, max_steps=None,
                                engine: str = "scan",
                                rng_impl: str = "threefry",
                                interpret: bool = False):
    """Walker-sharded phase-decomposition run across hosts: per-process
    record shards, ONE gather at the end.

    The decomposition record is per-walker (decompose.run_decomposition:
    [n_windows, W] per component), so under walker sharding each window's
    record row is naturally sharded too — no psum exists to hide the
    layout.  Each process drains only its *addressable* record shards to
    host per sprint (the big transfer stays host-local; nothing crosses
    DCN during the run), then the full record is assembled with one
    ``process_allgather`` of the per-process column blocks — the same
    single-collective-at-the-end discipline as run_ensemble_multihost.

    ``engine`` is ``"scan"`` or ``"pallas"`` (the production kernel; its
    [n_win, 2, R, 128] record planes shard over the row axis and unpack
    to walker columns per shard here).  Physics contract: global Threefry
    lanes make the per-walker (A, B) series bitwise-equal to the
    single-device ``decompose.run_decomposition`` record of the same
    engine, regardless of the process/device partition (asserted by the
    2-process dryrun).  Every process returns the same complete
    DecompositionResult, ready for ``decompose.bootstrap_t2`` /
    ``curves_at_plane``.
    """
    import jax
    import jax.numpy as jnp
    from .. import rng as rng_mod
    from ..engine import pallas_engine, reference_engine
    from ..engine.decompose import DecompositionResult
    from . import sharding

    dtype = dtype or jnp.float32
    p = params.validate()
    mesh = mesh or global_walker_mesh()
    n_shards = mesh.shape[sharding.WALKER_AXIS]
    num_water = scene.waters.shape[0]
    host_state = reference_engine.init_state(scene.waters, p, dtype,
                                             decompose=True)
    row = jax.sharding.PartitionSpec(sharding.WALKER_AXIS)
    if engine == "scan":
        sprint_fn = sharding.make_sharded_decomp_sprint_fn(p, mesh, dtype)
        state_spec = sharding.decomp_state_spec()
    elif engine == "pallas":
        sprint_fn = sharding.make_sharded_pallas_sprint_fn(
            p, num_water, mesh, dtype, rng_impl, interpret, decompose=True)
        host_state = sharding.to_planes_sharded(host_state, p, n_shards)
        plane = jax.sharding.PartitionSpec(None, sharding.WALKER_AXIS)
        state_spec = pallas_engine.PlaneState(
            px=row, py=row, pz=row, in_cell=row, phase=plane,
            phase_comp=plane, step=jax.sharding.PartitionSpec(),
            escapes=jax.sharding.PartitionSpec(),
            coverage=jax.sharding.PartitionSpec())
        local_w = num_water // n_shards
        r_local = pallas_engine.pad_count(local_w) // pallas_engine.LANES
    else:
        raise ValueError(f"unknown engine {engine!r}")

    np_dtype = np.dtype(dtype)
    mnp_pos = put_global(mesh, jax.sharding.PartitionSpec(),
                         np.asarray(scene.mnps[:, :3], np_dtype))
    mnp_M = put_global(mesh, jax.sharding.PartitionSpec(),
                       np.asarray(scene.mnps[:, 4], np_dtype))
    k = rng_mod.key_from_seed(seed)
    key_arr = put_global(mesh, jax.sharding.PartitionSpec(),
                         np.asarray([np.uint32(k[0]), np.uint32(k[1])]))
    state = jax.tree.map(lambda x, s: put_global(mesh, s, x),
                         host_state, state_spec)

    total = p.t if max_steps is None else min(p.t, max_steps)
    n_sprints = total // p.sprint_steps

    def drain_local(wins):
        """This process's addressable column blocks of one sprint's
        record, as (global_col_lo, [n_win, w_local, 2] host array) pairs.
        Scan: wins is [n_win, W, 2] sharded on axis 1.  Pallas: wins is
        [n_win, 2, R, 128] planes sharded on axis 2 — each shard's rows
        unpack (pad-stripped) to its contiguous global walker range."""
        out = []
        for sh in wins.addressable_shards:
            if engine == "scan":
                lo = sh.index[1].start or 0
                out.append((lo, np.asarray(sh.data)))
            else:
                row_lo = sh.index[2].start or 0
                s = row_lo // r_local
                d = np.asarray(sh.data)    # [n_win, 2, r_local, 128]
                flat = d.reshape(d.shape[0], 2, -1)[:, :, :local_w]
                out.append((s * local_w, np.moveaxis(flat, 1, -1)))
        return out

    # 1-deep drain pipeline (as in decompose.run_decomposition): dispatch
    # sprint i+1 before reading sprint i's record shards, so the host
    # transfer overlaps the next sprint's compute
    blocks: dict[int, list] = {}
    pending = None
    for _ in range(n_sprints):
        state, wins = sprint_fn(mnp_pos, mnp_M, key_arr, state)
        if pending is not None:
            for lo, arr in drain_local(pending):
                blocks.setdefault(lo, []).append(arr)
        pending = wins
    if pending is not None:
        for lo, arr in drain_local(pending):
            blocks.setdefault(lo, []).append(arr)

    # assemble this process's contiguous-by-shard column blocks
    los = sorted(blocks)
    if los:
        local = np.concatenate(
            [np.concatenate(blocks[lo], axis=0) for lo in los], axis=1)
        cols = np.concatenate(
            [np.arange(lo, lo + blocks[lo][0].shape[1], dtype=np.int64)
             for lo in los])
    else:   # zero sprints requested
        local = np.zeros((0, 0, 2), np_dtype)
        cols = np.zeros((0,), np.int64)
    n_windows = local.shape[0]

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        # one gather; requires every process to hold the same local
        # record width (even device distribution — true on pods and in
        # the dryrun; num_water % n_shards == 0 is enforced upstream)
        gdata = np.asarray(multihost_utils.process_allgather(local))
        gcols = np.asarray(multihost_utils.process_allgather(cols))
        full = np.empty((n_windows, num_water, 2), local.dtype)
        for pi in range(gdata.shape[0]):
            full[:, gcols[pi]] = gdata[pi]
    else:
        full = np.empty((n_windows, num_water, 2), local.dtype)
        full[:, cols] = local

    times = (np.arange(1, n_windows + 1) * p.pfreq) * p.tau
    stats = {
        "steps": int(np.asarray(state.step)),
        "escapes": int(np.asarray(state.escapes)),
        "coverage_violations": int(np.asarray(state.coverage)),
    }
    return DecompositionResult(times_ms=times, A=full[..., 0],
                               B=full[..., 1], stats=stats)


def run_plane_multihost(scene, params, scales, taucps=None, mesh=None,
                        seed: int = 0, engine: str = "scan",
                        rng_impl: str = "threefry",
                        interpret: bool = False, echo_pairs=(),
                        max_steps=None):
    """On-device (moment x taucp) plane folding over a global (multi-
    host) mesh: decompose.run_plane_on_device(mesh=...) with every input
    constructed as a global array, so the sharded plane step's psum of
    per-shard walker means rides ICI within hosts and DCN across them;
    per sprint only the KB-scale (replicated) curve block reaches each
    host.  ``echo_pairs`` matrices are per-walker and therefore sharded:
    each process scatters only its addressable columns and ONE
    process_allgather at the end assembles the full capture on every
    process (disjoint zero-filled columns sum exactly).

    Same physics contract as the single-device plane: global Threefry
    lanes make per-walker values partition-invariant; curves differ
    only by the f32 mean-of-means grouping (2-process dryrun).
    Returns what run_plane_on_device returns.
    """
    import jax

    from ..engine import decompose

    mesh = mesh or global_walker_mesh()
    times, curves, stats, echoes = decompose.run_plane_on_device(
        scene, params, scales, taucps, seed=seed, engine=engine,
        rng_impl=rng_impl, interpret=interpret, echo_pairs=echo_pairs,
        max_steps=max_steps, mesh=mesh)
    if jax.process_count() > 1 and echoes:
        from jax.experimental import multihost_utils
        echoes = [
            e._replace(cos=np.asarray(
                multihost_utils.process_allgather(e.cos)).sum(axis=0))
            for e in echoes]
    return times, curves, stats, echoes


def local_trial_mesh(n_trials: int, walker_shards: int = 1):
    """Right-sized trial mesh over THIS process's local devices (the
    cross-host ensemble layout: a trial's whole computation stays on one
    host's devices; only final curves cross DCN).  Same right-sizing rule
    as ensemble._trial_mesh, restricted to local devices;
    ``walker_shards`` > 1 returns the 2D (trials x walkers) local mesh
    — trials across hosts, walkers over each host's ICI-adjacent
    devices, the full pod layout."""
    import jax
    from jax.sharding import Mesh
    from . import ensemble, sharding
    devs = jax.local_devices()
    if walker_shards > 1:
        if len(devs) % walker_shards != 0 or walker_shards > len(devs):
            raise ValueError(
                f"walker_shards ({walker_shards}) must divide this "
                f"process's local device count ({len(devs)})")
        avail = len(devs) // walker_shards
        rounds = -(-n_trials // avail)
        d = -(-n_trials // rounds)
        return Mesh(np.asarray(devs[:d * walker_shards]).reshape(
            d, walker_shards),
            (ensemble.TRIAL_AXIS, sharding.WALKER_AXIS))
    rounds = -(-n_trials // len(devs))
    d = -(-n_trials // rounds)
    return Mesh(np.asarray(devs[:d]), (ensemble.TRIAL_AXIS,))


def run_ensemble_multihost(params, n_trials: int, base_seed: int = 0,
                           run_seed: int = 1000, engine: str = "scan",
                           rng_impl: str = "threefry", dtype=None,
                           max_steps=None, mmoments=None, taucps=None,
                           cell_rs=None, run_cell_rs=None, d_scales=None,
                           scene_seeds=None, run_seeds=None,
                           walker_shards: int = 1):
    """Multi-trial ensemble partitioned across hosts over DCN.

    Trials [0, n_trials) are split into contiguous blocks, one per
    process; each process runs its block entirely on its *local* devices
    through :func:`ensemble.run_ensemble` (trial i keeps scene seed
    ``base_seed + i`` and run seed ``run_seed + i``, so the partition is
    invisible in the physics — the same curves as a single-process run,
    in the same trial order).  The only cross-host traffic is ONE
    allgather of the [T, n_windows] curves at the end — the
    embarrassingly-parallel layout SURVEY §5 prescribes for ensembles
    (the reference's PBS-resubmission workflow, T2_GPU_sim.cu:45, as one
    SPMD program).

    ``mmoments`` / ``taucps`` / ``cell_rs`` / ``run_cell_rs`` /
    ``d_scales`` (each len n_trials) are the per-trial sweep axes of
    :func:`ensemble.run_ensemble`: each process receives its contiguous
    slice, so a parameter sweep partitions across hosts exactly like a
    plain ensemble (trial i keeps ITS value regardless of the
    partition).

    Every process returns the same (times_ms, sum_cos [n_trials, n],
    sum_sin [n_trials, n]).
    """
    import jax
    import jax.numpy as jnp
    from . import ensemble

    dtype = dtype or jnp.float32
    for name, vals in (("mmoments", mmoments), ("taucps", taucps),
                       ("cell_rs", cell_rs),
                       ("run_cell_rs", run_cell_rs),
                       ("d_scales", d_scales),
                       ("scene_seeds", scene_seeds),
                       ("run_seeds", run_seeds)):
        if vals is not None and len(vals) != n_trials:
            raise ValueError(f"{name} must have one value per trial "
                             f"([{n_trials}]), got {len(vals)}")
    pid, n_proc = jax.process_index(), jax.process_count()
    counts = [n_trials // n_proc + (i < n_trials % n_proc)
              for i in range(n_proc)]
    lo = sum(counts[:pid])
    mine = counts[pid]

    def my_slice(vals):
        return None if vals is None else list(vals[lo:lo + mine])

    total = params.t if max_steps is None else min(params.t, max_steps)
    n_windows = (total // params.sprint_steps) * \
        (params.sprint_steps // params.pfreq)
    max_count = max(counts)
    local = np.zeros((max_count, n_windows, 2), np.dtype(dtype))
    if mine:
        _, cos, sin, _ = ensemble.run_ensemble(
            params, mine, mesh=local_trial_mesh(mine, walker_shards),
            base_seed=base_seed + lo, run_seed=run_seed + lo,
            engine=engine, rng_impl=rng_impl, dtype=dtype,
            max_steps=max_steps, mmoments=my_slice(mmoments),
            taucps=my_slice(taucps), cell_rs=my_slice(cell_rs),
            run_cell_rs=my_slice(run_cell_rs),
            d_scales=my_slice(d_scales),
            scene_seeds=my_slice(scene_seeds),
            run_seeds=my_slice(run_seeds),
            walker_shards=walker_shards)
        local[:mine, :, 0] = cos
        local[:mine, :, 1] = sin
    # every process (including trial-less ones) derives the same axis
    times = ensemble.window_times(params, n_windows)

    if n_proc > 1:
        from jax.experimental import multihost_utils
        gathered = np.asarray(
            multihost_utils.process_allgather(local))  # [P, max_count, n, 2]
        rows = [gathered[i, :counts[i]] for i in range(n_proc)]
        allw = np.concatenate(rows, axis=0)
    else:
        allw = local[:mine]
    return times, allw[..., 0], allw[..., 1]


def run_parameter_grid_multihost(params, axes: dict,
                                 n_trials_each: int = 1,
                                 base_seed: int = 0, run_seed: int = 1000,
                                 engine: str = "scan",
                                 rng_impl: str = "threefry", dtype=None,
                                 max_steps=None, paired: bool = False,
                                 quadrature: bool = False):
    """Cross-product launch-scalar grid partitioned across hosts:
    ensemble.run_parameter_grid's contract (one compiled program per
    process, curves shaped [n1, ..., n_trials_each, n_windows]) with
    grid points split into contiguous per-process blocks over DCN.
    Seeds are assigned by GLOBAL trial index (explicit overrides when
    ``paired``), so the partition is invisible: every process returns
    the same surface a single-process run produces.  ``quadrature=True``
    appends the (cos, sin) component axis, as in the local wrapper.
    """
    import numpy as _np

    from . import ensemble

    value_lists, combos, per_trial = ensemble.grid_per_trial(
        axes, n_trials_each, paired, base_seed, run_seed)
    times, cos, sin = run_ensemble_multihost(
        params, len(combos) * n_trials_each, base_seed=base_seed,
        run_seed=run_seed, engine=engine, rng_impl=rng_impl,
        dtype=dtype, max_steps=max_steps, **per_trial)
    flat = _np.stack([cos, sin], -1) if quadrature else cos
    shape = [len(v) for v in value_lists] + [n_trials_each, -1] + \
        ([2] if quadrature else [])
    return times, flat.reshape(shape)


def _dry_context(num_processes: int):
    """Shared scene/params for every dry-run path (kept identical to the
    historical monolith so per-path results stay comparable across
    rounds)."""
    from ..params import small_test_params
    from ..scene import BacteriaBox
    p = small_test_params(num_water=256, num_cells=8, sprint_steps=200,
                          totaltime=0.0002, chunk_steps=100,
                          print_interval=0.0001, taucp=0.0001)
    sc = BacteriaBox(p, seed=1).populate()
    return p, sc


def _dry_path_run(jax, p, sc, num_processes):
    """Walker-sharded run (scan + pallas) over the global mesh: window
    sums match the single-device run, and THIS process's local shards
    are bitwise-identical to the corresponding slice."""
    from ..engine import pallas_engine as pe
    from ..engine import reference_engine

    t, cos, sin, st = run_simulation_multihost(
        sc, p, seed=0, max_steps=p.sprint_steps)
    with jax.default_device(jax.local_devices()[0]):
        t1, cos1, sin1, st1 = reference_engine.run_simulation(
            sc, p, seed=0, max_steps=p.sprint_steps)
    np.testing.assert_allclose(cos, cos1, atol=1e-3)
    np.testing.assert_allclose(sin, sin1, atol=1e-3)
    ref_pos = np.asarray(st1.pos)
    ref_phase = np.asarray(st1.phase)
    checked = 0
    for shard_pos, shard_phase in zip(st.pos.addressable_shards,
                                      st.phase.addressable_shards):
        sl = shard_pos.index[0]
        np.testing.assert_array_equal(np.asarray(shard_pos.data),
                                      ref_pos[sl])
        np.testing.assert_array_equal(np.asarray(shard_phase.data),
                                      ref_phase[sl])
        checked += np.asarray(shard_pos.data).shape[0]
    assert checked == p.num_water // num_processes
    assert int(np.asarray(st.escapes)) == int(st1.escapes)
    assert int(np.asarray(st.coverage)) == int(st1.coverage)

    # the production (Pallas) engine over the same global mesh; local
    # PLANE shards == per-shard re-packing of the single-device state
    n_global = len(jax.devices())
    _, cos_p, sin_p, st_p = run_simulation_multihost(
        sc, p, seed=0, engine="pallas", interpret=True,
        max_steps=p.sprint_steps)
    with jax.default_device(jax.local_devices()[0]):
        _, cos_p1, sin_p1, st_p1 = pe.run_simulation(
            sc, p, seed=0, interpret=True, max_steps=p.sprint_steps)
    np.testing.assert_allclose(cos_p, cos_p1, atol=1e-3)
    np.testing.assert_allclose(sin_p, sin_p1, atol=1e-3)
    # only the first local_w lanes are real walkers (padding lanes
    # evolve as masked dummies)
    local_w = p.num_water // n_global
    r_local = pe.pad_count(local_w) // pe.LANES
    ref_x = np.asarray(st_p1.pos)[:, 0]
    ref_ph = np.asarray(st_p1.phase)
    for shard_px, shard_phase in zip(st_p.px.addressable_shards,
                                     st_p.phase.addressable_shards):
        s = (shard_px.index[0].start or 0) // r_local
        w_sl = slice(s * local_w, (s + 1) * local_w)
        np.testing.assert_array_equal(
            np.asarray(shard_px.data).reshape(-1)[:local_w], ref_x[w_sl])
        np.testing.assert_array_equal(
            np.asarray(shard_phase.data).reshape(-1)[:local_w],
            ref_ph[w_sl])
    return f"run: {checked} local walkers bitwise (scan + pallas)"


def _local_single_mesh(jax):
    from jax.sharding import Mesh
    from . import ensemble
    return Mesh(np.asarray(jax.local_devices()[:1]),
                (ensemble.TRIAL_AXIS,))


def _dry_path_ensemble(jax, p, sc, num_processes):
    """Ensemble partitioning over DCN: trials split across processes
    reproduce the single-process per-trial curves (same seeds), with
    per-trial sweep values riding along — a parameter sweep is
    partition-invariant.  Also the full pod layout (trials x walker
    shards)."""
    import warnings as _w

    from . import ensemble

    n_tr = 3
    taucps = [0.0001, 0.0002, 0.0001]
    dss = [1.0, 0.25, 0.5]
    rcrs = [p.cell_r, 0.8, 0.7]   # run_cell_rs: runtime radius
    _, cos_mh, sin_mh = run_ensemble_multihost(
        p, n_tr, base_seed=11, run_seed=7, max_steps=p.sprint_steps,
        taucps=taucps, d_scales=dss, run_cell_rs=rcrs)
    mesh1 = _local_single_mesh(jax)
    with _w.catch_warnings():
        _w.simplefilter("ignore")   # 3 trials on 1 device: no padding
        _, cos_1p, sin_1p, _ = ensemble.run_ensemble(
            p, n_tr, mesh=mesh1, base_seed=11, run_seed=7,
            max_steps=p.sprint_steps, taucps=taucps, d_scales=dss,
            run_cell_rs=rcrs)
    np.testing.assert_allclose(cos_mh, cos_1p, atol=1e-3)
    np.testing.assert_allclose(sin_mh, sin_1p, atol=1e-3)

    _, cos_2d, sin_2d = run_ensemble_multihost(
        p, n_tr, base_seed=11, run_seed=7, max_steps=p.sprint_steps,
        taucps=taucps, d_scales=dss, run_cell_rs=rcrs, walker_shards=2)
    np.testing.assert_allclose(cos_2d, cos_1p, atol=1e-3)
    np.testing.assert_allclose(sin_2d, sin_1p, atol=1e-3)
    return f"ensemble: {n_tr} trials partition-invariant (1D + pod 2D)"


def _dry_path_record(jax, p, sc, num_processes):
    """Decomposition record across DCN (scan + pallas): the assembled
    [n_windows, W] (A, B) record is bitwise-identical to the
    single-device run on every process, and downstream closed-form
    reconstruction consumes it unchanged."""
    from ..engine import decompose

    rec_mh = run_decomposition_multihost(sc, p, seed=0,
                                         max_steps=p.sprint_steps)
    with jax.default_device(jax.local_devices()[0]):
        rec_1 = decompose.run_decomposition(sc, p, seed=0, engine="scan",
                                            max_steps=p.sprint_steps)
    np.testing.assert_array_equal(rec_mh.A, rec_1.A)
    np.testing.assert_array_equal(rec_mh.B, rec_1.B)
    assert rec_mh.stats == rec_1.stats
    c_mh = decompose.curves_at_scales(rec_mh.A, rec_mh.B, [0.5, 2.0])
    c_1 = decompose.curves_at_scales(rec_1.A, rec_1.B, [0.5, 2.0])
    np.testing.assert_array_equal(c_mh, c_1)
    rec_pmh = run_decomposition_multihost(sc, p, seed=0, engine="pallas",
                                          interpret=True,
                                          max_steps=p.sprint_steps)
    with jax.default_device(jax.local_devices()[0]):
        rec_p1 = decompose.run_decomposition(sc, p, seed=0,
                                             engine="pallas",
                                             interpret=True,
                                             max_steps=p.sprint_steps)
    np.testing.assert_array_equal(rec_pmh.A, rec_p1.A)
    np.testing.assert_array_equal(rec_pmh.B, rec_p1.B)
    return "record: scan + pallas records bitwise across DCN"


def _dry_path_plane(jax, p, sc, num_processes):
    """On-device plane folding over the global mesh: per-shard Kahan
    carries + one psum per sprint; echo capture allgathered."""
    from ..engine import decompose

    pairs = [(1.0, p.taucp)]
    _, pl_mh, pst_mh, ech_mh = run_plane_multihost(
        sc, p, [1.0, 2.0], None, seed=0, echo_pairs=pairs,
        max_steps=p.sprint_steps)
    with jax.default_device(jax.local_devices()[0]):
        _, pl_1, pst_1, ech_1 = decompose.run_plane_on_device(
            sc, p, [1.0, 2.0], None, seed=0, engine="scan",
            echo_pairs=pairs, max_steps=p.sprint_steps)
    np.testing.assert_allclose(pl_mh, pl_1, atol=1e-4)
    np.testing.assert_allclose(ech_mh[0].cos, ech_1[0].cos, atol=1e-6)
    assert pst_mh == pst_1
    return "plane: folded curves + echo capture match single-device"


def _dry_path_grid(jax, p, sc, num_processes):
    """Paired parameter grid across DCN (+ quadrature surface) equals
    the single-process grid."""
    import warnings as _w

    from . import ensemble

    axes = {"D": [1.0, 0.5], "taucp": [0.0001, 0.0002]}
    _, grid_mh = run_parameter_grid_multihost(
        p, axes, base_seed=11, run_seed=7, max_steps=p.sprint_steps,
        paired=True)
    mesh1 = _local_single_mesh(jax)
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        _, grid_1p = ensemble.run_parameter_grid(
            p, axes, base_seed=11, run_seed=7, mesh=mesh1,
            max_steps=p.sprint_steps, paired=True)
    np.testing.assert_allclose(grid_mh, grid_1p, atol=1e-3)
    _, grid_q = run_parameter_grid_multihost(
        p, axes, base_seed=11, run_seed=7, max_steps=p.sprint_steps,
        paired=True, quadrature=True)
    assert grid_q.shape == grid_mh.shape + (2,)
    np.testing.assert_array_equal(grid_q[..., 0], grid_mh)
    assert np.any(grid_q[..., 1] != 0.0)
    return "grid: paired 2x2 surface (+ quadrature) partition-invariant"


#: multihost dry-run paths, individually selectable (--path) so a
#: failure triages to ONE subsystem instead of a 130-second monolith
_DRY_PATHS = {
    "run": _dry_path_run,
    "ensemble": _dry_path_ensemble,
    "record": _dry_path_record,
    "plane": _dry_path_plane,
    "grid": _dry_path_grid,
}


def _dryrun(num_processes: int, process_id: int, coordinator: str,
            devices_per_process: int, paths=("all",)) -> None:
    """One process of the multi-host dry run: N x M virtual CPU devices
    -> one global mesh; runs the selected verification paths (see
    _DRY_PATHS) and asserts each against a single-device oracle this
    process computes independently."""
    # NOTE: importing this module already imported jax (package
    # __init__), so platform/device-count env vars must be set by the
    # LAUNCHER (see tests/test_distributed.py); these lines only help
    # when the module is exec'd before any jax import
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--xla_force_host_platform_device_count" not in \
            os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count="
            f"{devices_per_process}").strip()
    import jax
    initialize(coordinator, num_processes, process_id)
    assert jax.process_count() == num_processes
    n_global = len(jax.devices())
    assert n_global == num_processes * devices_per_process

    selected = list(_DRY_PATHS) if "all" in paths else list(paths)
    bad = [n for n in selected if n not in _DRY_PATHS]
    if bad:
        raise ValueError(f"unknown dryrun path(s) {bad}; "
                         f"choose from {sorted(_DRY_PATHS)} or 'all'")
    p, sc = _dry_context(num_processes)
    results = [_DRY_PATHS[name](jax, p, sc, num_processes)
               for name in selected]
    summary = "; ".join(results)
    print(f"multihost dryrun OK: process {process_id}/{num_processes} "
          f"paths [{', '.join(selected)}] — {summary} "
          f"(global devices: {n_global})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="One process of the multi-host CPU dry run")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0")
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--path", default="all",
                    help="comma-separated dry-run paths "
                         f"({', '.join(sorted(_DRY_PATHS))}) or 'all'")
    args = ap.parse_args(argv)
    _dryrun(args.num_processes, args.process_id, args.coordinator,
            args.devices_per_process,
            paths=tuple(p.strip() for p in args.path.split(",")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
