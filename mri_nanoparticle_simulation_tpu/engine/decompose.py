"""Phase-decomposition runs: the whole (moment x echo-spacing) plane
from ONE simulation.

Walker trajectories never depend on the dipole moment — diffusion,
membrane reflection and cell residency are pure functions of the RNG
stream and the scene geometry (simulateDiffusion consumes no field,
cuda_sim.cu:688-746).  The moment enters only through the per-step phase
kick, linearly (accumulatePhase: B*2pi*g*tau, cuda_sim.cu:637), and
Carr-Purcell flips are sign changes.  Therefore every walker's phase is
EXACTLY linear in a global moment scale s:

    phase_i(t; s) = s * A_i(t) + B_i(t)

with A the accumulated dipole-field phase at the base moments and B the
accumulated intracellular-kick phase.  A single forward run that records
per-walker (A, B) at each output window is a *complete basis* for the
moment axis:

    m(t; s) = mean_i cos(s * A_i(t) + B_i(t))

reconstructs the T2 curve at ANY moment scale — the reference's
mmoment-sweep workflow ("edit parameters.h, make clean && make", one
~14-minute GPU run per value, README.md:13,16) collapses to one
production-speed simulation plus closed-form evaluation.  The inverse
problem (recover the moment from a measured decay) becomes 1-D
optimization over a cheap differentiable expression (see inverse.py).

The Carr-Purcell axis falls out of the same record: a flip only
multiplies the accumulated phase by -1 at a window boundary, so the raw
per-window increments are recoverable from the recorded series
(window_increments) and ANY taucp aligned to the output interval is one
cumulative sum away (reconstruct_curves / curves_at_plane) — the full
(moment x taucp) sweep plane from a single simulation, on common random
numbers (trajectories depend on neither knob).

Both engines support the mode: the Pallas production kernel carries
(A, comp_A, B, comp_B) as separate Kahan streams and emits per-walker
(A, B) planes per window (pallas_engine.make_chunk_kernel, decompose=True);
the scan engine mirrors it for cross-validation.  The reconstruction at
s = 1 matches a direct run up to the rounding difference between one
joint and two split Kahan accumulations (tested in
tests/test_decompose.py).

Memory: the record is [n_windows, num_water] per component — 1.3 GB for
the full reference run (40,000 windows x 4032 walkers x 2 x f32),
streamed to host per sprint; pass ``max_steps`` or enlarge ``pfreq`` to
subsample if that matters.
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple, Optional

import numpy as np

from ..params import Params


class DecompositionResult(NamedTuple):
    times_ms: np.ndarray   #: [n] window end times, ms
    A: np.ndarray          #: [n, W] dipole-field phase at the base moments
    B: np.ndarray          #: [n, W] kick phase (moment-independent)
    stats: dict            #: escapes / coverage_violations / steps


def _unpack_wins(wins, engine: str, num_water: int):
    """One sprint's device record -> ([n_win, W] A, [n_win, W] B) host
    arrays.  Scan emits [n_win, W, 2]; the Pallas kernel emits
    [n_win, 2, R, 128] planes whose padded lanes are stripped here."""
    w = np.asarray(wins)
    if engine == "pallas":
        return (w[:, 0].reshape(w.shape[0], -1)[:, :num_water],
                w[:, 1].reshape(w.shape[0], -1)[:, :num_water])
    return w[..., 0], w[..., 1]


def _unpack_wins_sharded(wins, engine: str, num_water: int,
                         n_shards: int):
    """:func:`_unpack_wins` for a single-process WALKER-SHARDED record
    block.  Scan shards [n_win, W, 2] on the walker axis — the global
    gather is already walker-ordered.  The Pallas planes shard on the
    row axis with PER-SHARD padding (each shard packs its local_w
    walkers into pad_count(local_w) lanes), so the global flatten must
    strip each shard's padding individually — a plain reshape would
    interleave padding lanes into the walker columns."""
    if engine == "scan":
        w = np.asarray(wins)
        return w[..., 0], w[..., 1]
    from . import pallas_engine as pe
    local_w = num_water // n_shards
    r_local = pe.pad_count(local_w) // pe.LANES
    w = np.asarray(wins)                  # [n_win, 2, R_total, 128]
    a = np.empty((w.shape[0], num_water), w.dtype)
    b = np.empty_like(a)
    for s in range(n_shards):
        d = w[:, :, s * r_local:(s + 1) * r_local, :]
        flat = d.reshape(d.shape[0], 2, -1)[:, :, :local_w]
        a[:, s * local_w:(s + 1) * local_w] = flat[:, 0]
        b[:, s * local_w:(s + 1) * local_w] = flat[:, 1]
    return a, b


def run_decomposition(scene, params: Params, seed: int = 0,
                      engine: str = "pallas", dtype=None,
                      rng_impl: str = "threefry",
                      interpret: bool = False,
                      max_steps: Optional[int] = None,
                      consumer=None) -> DecompositionResult:
    """One forward simulation recording per-walker (A, B) per window.

    ``engine`` is ``"pallas"`` (production kernel) or ``"scan"``; both
    consume the same Threefry streams, so their records agree to f32
    rounding (bitwise under the shared step semantics).

    ``consumer``: optionally a :class:`StreamingPlane` (or anything with
    ``update(a_block, b_block)``) fed each sprint's [n_win, W] record
    blocks in window order INSTEAD of materializing the record — the
    returned result then carries empty (0-window) A/B arrays and the
    reconstruction lives in the consumer.  This removes the record's
    host-memory ceiling (O(n_windows x W)) for dense-plane sweeps at
    scale-up walker counts.
    """
    import jax.numpy as jnp

    from .. import rng
    from . import pallas_engine as pe
    from . import reference_engine as re

    dtype = dtype or jnp.float32
    p = params.validate()
    num_water = scene.waters.shape[0]
    mnp_pos = jnp.asarray(np.asarray(scene.mnps[:, :3], np.float32), dtype)
    mnp_M = jnp.asarray(np.asarray(scene.mnps[:, 4], np.float32), dtype)
    k = rng.key_from_seed(seed)
    key_arr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
    state = re.init_state(scene.waters, p, dtype, decompose=True)

    total = p.t if max_steps is None else min(p.t, max_steps)
    n_sprints = total // p.sprint_steps
    a_parts, b_parts = [], []
    n_emitted = 0

    def emit(a_blk, b_blk):
        nonlocal n_emitted
        n_emitted += a_blk.shape[0]
        if consumer is not None:
            consumer.update(a_blk, b_blk)
        else:
            a_parts.append(a_blk)
            b_parts.append(b_blk)

    # 1-deep drain pipeline: dispatch sprint i+1 (async under jax)
    # BEFORE reading sprint i's window record, so the (large, per-walker)
    # host transfer overlaps the next sprint's device compute
    if engine == "pallas":
        sprint = pe.make_sprint_fn(p, num_water, dtype, rng_impl,
                                   interpret=interpret, decompose=True)
        ps = pe.to_planes(state, p)
        pending = None
        for _ in range(n_sprints):
            ps, wins = sprint(mnp_pos, mnp_M, key_arr, ps, 0)
            if pending is not None:
                emit(*_unpack_wins(pending, engine, num_water))
            pending = wins
        if pending is not None:
            emit(*_unpack_wins(pending, engine, num_water))
        final = pe.from_planes(ps, num_water)
    elif engine == "scan":
        sprint = re.make_sprint_fn(p, dtype, decompose=True)
        pending = None
        for _ in range(n_sprints):
            state, wins = sprint(mnp_pos, mnp_M, key_arr, state, 0)
            if pending is not None:
                emit(*_unpack_wins(pending, engine, num_water))
            pending = wins
        if pending is not None:
            emit(*_unpack_wins(pending, engine, num_water))
        final = state
    else:
        raise ValueError(f"unknown engine {engine!r}")

    A = np.concatenate(a_parts) if a_parts else np.zeros((0, num_water))
    B = np.concatenate(b_parts) if b_parts else np.zeros((0, num_water))
    times = (np.arange(1, n_emitted + 1) * p.pfreq) * p.tau
    stats = {
        "steps": int(final.step),
        "escapes": int(np.asarray(final.escapes)),
        "coverage_violations": int(np.asarray(final.coverage)),
    }
    return DecompositionResult(times_ms=times, A=A, B=B, stats=stats)


def _setup_engine(engine: str, p: Params, scene, seed: int, state,
                  dtype, rng_impl: str, interpret: bool):
    """Shared durable-run plumbing: a per-sprint ``step_fn(dev_state) ->
    (dev_state, wins)`` over the given engine, the initial device state,
    and a ``to_walker`` converter for checkpointing."""
    import jax.numpy as jnp

    from .. import rng
    from . import pallas_engine as pe
    from . import reference_engine as re

    num_water = scene.waters.shape[0]
    mnp_pos = jnp.asarray(np.asarray(scene.mnps[:, :3], np.float32), dtype)
    mnp_M = jnp.asarray(np.asarray(scene.mnps[:, 4], np.float32), dtype)
    k = rng.key_from_seed(seed)
    key_arr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])

    if engine == "pallas":
        sprint = pe.make_sprint_fn(p, num_water, dtype, rng_impl,
                                   interpret=interpret, decompose=True)
        dev_state = pe.to_planes(state, p)

        def step_fn(s):
            return sprint(mnp_pos, mnp_M, key_arr, s, 0)

        def to_walker(s):
            return pe.from_planes(s, num_water)
    elif engine == "scan":
        sprint = re.make_sprint_fn(p, dtype, decompose=True)
        dev_state = state

        def step_fn(s):
            return sprint(mnp_pos, mnp_M, key_arr, s, 0)

        def to_walker(s):
            return s
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return step_fn, dev_state, to_walker


def _setup_engine_sharded(engine: str, p: Params, scene, seed: int, state,
                          dtype, rng_impl: str, interpret: bool, mesh):
    """:func:`_setup_engine` under walker sharding: the per-sprint step
    runs the sharded sprint (parallel/sharding.py) over the mesh, with
    the decompose-mode record staying sharded with its walkers (no psum
    exists to hide the layout).  Inputs are constructed as GLOBAL arrays
    (distributed.put_global), so the same code runs over a local mesh
    or a multi-process (DCN) world."""
    import jax
    from jax.sharding import PartitionSpec as P

    from .. import rng
    from ..parallel import sharding
    from ..parallel.distributed import put_global
    from . import pallas_engine as pe

    num_water = scene.waters.shape[0]
    n_shards = mesh.shape[sharding.WALKER_AXIS]
    np_dt = np.dtype(dtype)
    mnp_pos = put_global(mesh, P(), np.asarray(scene.mnps[:, :3], np_dt))
    mnp_M = put_global(mesh, P(), np.asarray(scene.mnps[:, 4], np_dt))
    k = rng.key_from_seed(seed)
    key_arr = put_global(mesh, P(),
                         np.asarray([np.uint32(k[0]), np.uint32(k[1])]))

    if engine == "pallas":
        sprint = sharding.make_sharded_pallas_sprint_fn(
            p, num_water, mesh, dtype, rng_impl, interpret, decompose=True)
        dev = sharding.to_planes_sharded(state, p, n_shards)
        row = P(sharding.WALKER_AXIS)
        plane = P(None, sharding.WALKER_AXIS)
        spec = pe.PlaneState(px=row, py=row, pz=row, in_cell=row,
                             phase=plane, phase_comp=plane, step=P(),
                             escapes=P(), coverage=P())
    elif engine == "scan":
        sprint = sharding.make_sharded_decomp_sprint_fn(p, mesh, dtype)
        dev = state
        spec = sharding.decomp_state_spec()
    else:
        raise ValueError(f"unknown engine {engine!r}")
    dev_state = jax.tree.map(
        lambda x, s: put_global(mesh, s, np.asarray(x)), dev, spec)

    def step_fn(s):
        return sprint(mnp_pos, mnp_M, key_arr, s)

    return step_fn, dev_state


def run_decomposition_durable(scene, params: Params, record_path: str,
                              seed: int = 0, scene_seed: int = 0,
                              engine: str = "pallas", dtype=None,
                              rng_impl: str = "threefry",
                              interpret: bool = False,
                              max_steps: Optional[int] = None,
                              checkpoint_path: Optional[str] = None,
                              checkpoint_every_sprints: int = 1,
                              fault_hook=None,
                              progress: bool = False,
                              mesh=None) -> DecompositionResult:
    """:func:`run_decomposition` with a DISK-backed record and
    checkpoint/resume — the long-record production form.

    The per-sprint (A, B) blocks stream into an ``io.record.RecordStore``
    directory instead of host RAM (a scale-up record is 32 GB; host
    memory here stays one sprint block), and the walker state checkpoints
    every ``checkpoint_every_sprints`` through ``io.checkpoint`` with the
    record-before-checkpoint ordering discipline: a checkpoint at sprint
    j is saved only after sprint j's record rows are committed, so on any
    crash ``store.rows >= checkpoint-step rows`` and resume just trims
    the record overhang (the CSV analogue is
    ``resilience.trim_csv_overhang``).  Re-running the SAME call after a
    process death resumes from the checkpoint and produces a record
    bitwise-identical to an uninterrupted run (counter RNG; proven in
    tests/test_record_store.py).  A re-run of a COMPLETE store returns
    its result immediately without touching the device.

    The 1-deep drain pipeline of :func:`run_decomposition` is kept
    (sprint i+1 dispatches before sprint i's record drains); the state
    checkpointed alongside sprint i's rows is the held post-sprint-i
    state, not the in-flight one.

    ``fault_hook(sprint_index)`` is the chaos seam of
    ``resilience.FaultInjector``, called before each sprint dispatch.

    ``mesh``: an optional single-process walker-sharding mesh (the CLI's
    --shard-walkers layout); the sprint runs sharded over it
    (parallel/sharding.py) while the record/checkpoint stream stays a
    HOST artifact — each sprint's record block is gathered from the
    addressable shards, and the checkpointed state is the gathered
    walker state, so a run can crash under one mesh and resume under
    another (or none): global Threefry lanes make the partition
    physically invisible (proven in the driver dryrun,
    __graft_entry__.py).

    Returns a :class:`DecompositionResult` whose A/B are READ-ONLY disk
    memmaps — every downstream consumer (``curves_at_plane``,
    ``bootstrap_t2``, ``inverse.fit_moment_scale_decomposed``) streams
    from them unchanged.
    """
    import jax.numpy as jnp

    from ..io import checkpoint as ckpt_mod
    from ..io import record as record_mod
    from . import reference_engine as re

    dtype = dtype or jnp.float32
    p = params.validate()
    num_water = scene.waters.shape[0]
    wps = p.sprint_steps // p.pfreq            # record rows per sprint
    total = p.t if max_steps is None else min(p.t, max_steps)
    n_sprints = total // p.sprint_steps
    n_windows = n_sprints * wps
    if n_windows == 0:
        raise ValueError("durable decomposition needs at least one full "
                         "sprint of windows")
    if checkpoint_path is not None and checkpoint_every_sprints < 1:
        raise ValueError("checkpoint_every_sprints must be >= 1")
    scene_fp = ckpt_mod.scene_fingerprint(scene)
    identity = {
        "params_fp": ckpt_mod.params_fingerprint(p), "seed": int(seed),
        "scene_seed": int(scene_seed), "engine": engine,
        "rng_impl": rng_impl, "scene_fp": scene_fp,
        # the knobs offline reconstruction needs (record_params)
        "taucp": p.taucp, "tau": p.tau, "pfreq": p.pfreq,
        "mmoment": p.mmoment,
    }

    def result_from(store, stats):
        a, b = store.arrays()
        return DecompositionResult(times_ms=store.times_ms(), A=a, B=b,
                                   stats=stats)

    if record_mod.is_record_dir(record_path):
        store = record_mod.RecordStore.open(record_path, writable=True)
        if (store.n_windows, store.num_water) != (n_windows, num_water):
            raise ValueError(
                f"record store at {record_path} holds a "
                f"[{store.n_windows}, {store.num_water}] record; this "
                f"run produces [{n_windows}, {num_water}] — refusing to "
                f"mix records")
        for k, v in identity.items():
            theirs = store.meta.get(k)
            if theirs != v:
                raise ValueError(
                    f"record store at {record_path} was written under "
                    f"{k}={theirs!r}, this run uses {k}={v!r}; the "
                    f"resumed record would silently mix random sequences "
                    f"— use a fresh --record-dir or the original config")
        if store.complete:
            return result_from(store, dict(store.meta.get("stats", {})))
    else:
        store = record_mod.RecordStore.create(record_path, n_windows,
                                              num_water, identity)

    # resume point: the checkpoint pins the walker state; the store is
    # trimmed to exactly the checkpointed sprint (record overhang = rows
    # committed after the last checkpoint before the crash)
    start_sprint = 0
    state = None
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, ck_seed, ck_scene_seed = ckpt_mod.load_checkpoint(
            checkpoint_path, p, dtype, engine=engine, rng_impl=rng_impl,
            scene_fp=scene_fp)
        if (ck_seed, ck_scene_seed) != (int(seed), int(scene_seed)):
            raise ValueError(
                f"checkpoint seeds (run={ck_seed}, scene={ck_scene_seed}) "
                f"do not match this run's ({seed}, {scene_seed}); "
                f"refusing to resume")
        step = int(np.asarray(state.step))
        if step % p.sprint_steps != 0:
            raise ValueError(
                f"checkpoint step {step} is not a sprint boundary "
                f"(sprint_steps={p.sprint_steps}); it was not written by "
                f"a durable decomposition run")
        start_sprint = step // p.sprint_steps
        need = start_sprint * wps
        if store.rows < need:
            raise ValueError(
                f"checkpoint is AHEAD of the record store ({need} rows "
                f"needed, {store.rows} committed) — the store was "
                f"truncated or replaced; delete the checkpoint to "
                f"restart, or restore the matching store")
        dropped = store.truncate(need)
        if dropped and progress:
            print(f"  resume: trimmed {dropped} record row(s) past the "
                  f"checkpoint (sprint {start_sprint})", file=sys.stderr)
    else:
        store.truncate(0)   # no checkpoint: any partial rows restart
    if state is None:
        state = re.init_state(scene.waters, p, dtype, decompose=True)

    if mesh is None:
        step_fn, dev_state, to_walker = _setup_engine(
            engine, p, scene, seed, state, dtype, rng_impl, interpret)

        def unpack(wins):
            return _unpack_wins(wins, engine, num_water)
    else:
        from ..parallel import sharding
        n_shards = mesh.shape[sharding.WALKER_AXIS]
        if num_water % n_shards != 0:
            raise ValueError(
                f"num_water ({num_water}) must divide evenly over "
                f"{n_shards} walker shards")
        step_fn, dev_state = _setup_engine_sharded(
            engine, p, scene, seed, state, dtype, rng_impl, interpret,
            mesh)
        if engine == "pallas":
            def to_walker(dev_s):
                return sharding.from_planes_sharded(dev_s, num_water,
                                                    n_shards)
        else:
            def to_walker(dev_s):
                return dev_s        # sharded WalkerState; saving gathers

        def unpack(wins):
            return _unpack_wins_sharded(wins, engine, num_water,
                                        n_shards)

    def save_ckpt(dev_s):
        ckpt_mod.save_checkpoint(
            checkpoint_path, to_walker(dev_s), p, seed, scene_seed,
            engine=engine, rng_impl=rng_impl, scene_fp=scene_fp)

    def commit(wins, dev_s, sprint_idx):
        """Sprint ``sprint_idx``'s record rows, then (ordering!) its
        checkpoint when one is due."""
        store.append(*unpack(wins))
        if checkpoint_path is not None and \
                (sprint_idx + 1) % checkpoint_every_sprints == 0:
            save_ckpt(dev_s)

    # 1-deep drain pipeline, as in run_decomposition
    pending = None          # (wins, post-sprint state, sprint index)
    for i in range(start_sprint, n_sprints):
        if fault_hook is not None:
            fault_hook(i)
        new_state, wins = step_fn(dev_state)
        if pending is not None:
            commit(*pending)
        pending = (wins, new_state, i)
        dev_state = new_state
        if progress:
            print(f"  sprint {i + 1}/{n_sprints}", file=sys.stderr)
    if pending is not None:
        commit(*pending)

    final = to_walker(dev_state)
    stats = {
        "steps": int(np.asarray(final.step)),
        "escapes": int(np.asarray(final.escapes)),
        "coverage_violations": int(np.asarray(final.coverage)),
    }
    if checkpoint_path is not None:
        save_ckpt(dev_state)
    store.finalize({"stats": stats})
    return result_from(store, stats)


def run_streaming_durable(scene, params: Params, plane: "StreamingPlane",
                          snapshot_path: str, seed: int = 0,
                          scene_seed: int = 0, engine: str = "pallas",
                          dtype=None, rng_impl: str = "threefry",
                          interpret: bool = False,
                          max_steps: Optional[int] = None,
                          snapshot_every_sprints: int = 1,
                          fault_hook=None, progress: bool = False) -> dict:
    """Crash-safe ``--stream-plane`` runs: the third decomposition form
    (no record in RAM, no record on disk) made durable.

    Feeds ``plane`` (a :class:`StreamingPlane`) exactly like
    ``run_decomposition(consumer=plane)``, but every
    ``snapshot_every_sprints`` sprints the walker state AND the plane's
    consumed-stream state snapshot into ONE atomic npz
    (``io.checkpoint.save_checkpoint(extra=plane.state_dict())``) — a
    single file, so walker/plane consistency is structural rather than
    an ordering discipline.  A killed run re-invoked with the same
    arguments resumes from the snapshot and produces bitwise-identical
    curves/echo matrices to an uninterrupted run (same per-sprint block
    boundaries and row_block → identical float64 summation order;
    pinned in tests/test_record_store.py).

    The plane must be freshly constructed (or match the snapshot's
    configuration digest).  Returns the run stats dict; read results
    from ``plane.result()`` / ``plane.echo_matrix()``.
    """
    import jax.numpy as jnp

    from ..io import checkpoint as ckpt_mod
    from . import reference_engine as re

    dtype = dtype or jnp.float32
    p = params.validate()
    wps = p.sprint_steps // p.pfreq
    total = p.t if max_steps is None else min(p.t, max_steps)
    n_sprints = total // p.sprint_steps
    if n_sprints * wps != plane._n:
        raise ValueError(
            f"plane was declared with {plane._n} windows but this run "
            f"produces {n_sprints * wps}; construct the StreamingPlane "
            f"with n_windows = total_steps // pfreq")
    if snapshot_every_sprints < 1:
        raise ValueError("snapshot_every_sprints must be >= 1")
    scene_fp = ckpt_mod.scene_fingerprint(scene)

    start_sprint = 0
    state = None
    if os.path.exists(snapshot_path):
        state, ck_seed, ck_scene_seed = ckpt_mod.load_checkpoint(
            snapshot_path, p, dtype, engine=engine, rng_impl=rng_impl,
            scene_fp=scene_fp)
        if (ck_seed, ck_scene_seed) != (int(seed), int(scene_seed)):
            raise ValueError(
                f"snapshot seeds (run={ck_seed}, scene={ck_scene_seed}) "
                f"do not match this run's ({seed}, {scene_seed}); "
                f"refusing to resume")
        step = int(np.asarray(state.step))
        if step % p.sprint_steps != 0:
            raise ValueError(
                f"snapshot step {step} is not a sprint boundary "
                f"(sprint_steps={p.sprint_steps})")
        start_sprint = step // p.sprint_steps
        plane.load_state(ckpt_mod.load_extra(snapshot_path))
        if plane._r != start_sprint * wps:
            raise ValueError(
                f"snapshot is internally inconsistent: plane consumed "
                f"{plane._r} windows but the walker state sits at "
                f"sprint {start_sprint} ({start_sprint * wps} windows)")
        if progress:
            print(f"  resume: sprint {start_sprint}/{n_sprints} "
                  f"({plane._r} windows already streamed)",
                  file=sys.stderr)
    elif plane._r != 0:
        raise ValueError("no snapshot exists but the plane has already "
                         "consumed rows; pass a fresh StreamingPlane")
    if state is None:
        state = re.init_state(scene.waters, p, dtype, decompose=True)

    num_water = scene.waters.shape[0]
    step_fn, dev_state, to_walker = _setup_engine(
        engine, p, scene, seed, state, dtype, rng_impl, interpret)

    def commit(wins, dev_s, sprint_idx):
        plane.update(*_unpack_wins(wins, engine, num_water))
        if (sprint_idx + 1) % snapshot_every_sprints == 0:
            ckpt_mod.save_checkpoint(
                snapshot_path, to_walker(dev_s), p, seed, scene_seed,
                engine=engine, rng_impl=rng_impl, scene_fp=scene_fp,
                extra=plane.state_dict())

    pending = None
    for i in range(start_sprint, n_sprints):
        if fault_hook is not None:
            fault_hook(i)
        new_state, wins = step_fn(dev_state)
        if pending is not None:
            commit(*pending)
        pending = (wins, new_state, i)
        dev_state = new_state
        if progress:
            print(f"  sprint {i + 1}/{n_sprints}", file=sys.stderr)
    if pending is not None:
        commit(*pending)

    final = to_walker(dev_state)
    stats = {
        "steps": int(np.asarray(final.step)),
        "escapes": int(np.asarray(final.escapes)),
        "coverage_violations": int(np.asarray(final.coverage)),
    }
    # final snapshot marks completion (resume of a finished run is a
    # no-op loop; the plane state is the full stream)
    ckpt_mod.save_checkpoint(
        snapshot_path, final, p, seed, scene_seed, engine=engine,
        rng_impl=rng_impl, scene_fp=scene_fp, extra=plane.state_dict())
    return stats


def make_plane_step(params: Params, num_water: int, scales, n_taucps: int,
                    engine: str, dtype, echo_specs=(), raw: bool = False):
    """The jitted on-device plane update of :func:`run_plane_on_device`
    (``raw=True`` returns the unjitted step — the per-shard body of
    :func:`make_sharded_plane_step`).

    Consumes one sprint's RAW record planes (never leaving the device),
    carries per-taucp signed Kahan sums, and emits only the
    ``[n_scales, n_taucps, wps, 2]`` walker-mean curve block — the
    host drain drops from the 8-byte-per-walker-window record to a
    few KB per sprint.

    Math (the device form of :class:`StreamingPlane`): with raw
    per-window increments ``d_r`` recovered by undoing the base run's
    flips, window j's phase at echo-spacing t and moment scale s is
    ``g_{j-1}(s * SA_j + SB_j)`` where ``SA_j = sum_{k<=j} g_{k-1} dA_k``
    — a cumsum per sprint plus a carried (SA, SB).  The carry is
    f32 + Kahan compensation, the same precision discipline as the
    engine's own phase accumulation (ACCURACY.md measures that scheme
    at 5e-8 curve RMS over the full run); the host
    :class:`StreamingPlane` (float64) remains the oracle it is tested
    against.

    ``echo_specs``: static ``((scale_value, taucp_index), ...)`` —
    per spec, the step also gathers the PER-WALKER ``cos`` rows at the
    requested local row indices (spin-echo rows, padded; see
    :func:`run_plane_on_device`) so walker-bootstrap error bars come
    from the same on-device pass ([E_max, W] per spec — KBs, not the
    record).
    """
    import jax
    import jax.numpy as jnp

    s_arr = jnp.asarray(np.asarray(scales, np.float32), dtype)

    def unpack(wins):
        # -> [wps, W] per component, on device
        if engine == "pallas":     # [n_win, 2, R, 128] planes
            w = wins.reshape(wins.shape[0], 2, -1)[:, :, :num_water]
            return w[:, 0], w[:, 1]
        return wins[..., 0], wins[..., 1]   # scan: [n_win, W, 2]

    def step(wins, carry, u_prev, g_blk, echo_rows):
        """``u_prev``: [wps] sign undoing the base flip before each row
        (row 0's entry pairs with the carried prev row).  ``g_blk``:
        [n_taucps, wps] reconstruction parities g_{j-1}.  ``carry`` =
        (SA, cA, SB, cB [T, W], prev_A, prev_B [W]).  ``echo_rows``:
        [n_specs, E_max] local row indices (padding rows are masked on
        the host)."""
        SA, cA, SB, cB, prev_A, prev_B = carry
        A, B = unpack(wins)
        dA = A.at[0].add(-u_prev[0] * prev_A)
        dA = dA.at[1:].add(-u_prev[1:, None] * A[:-1])
        dB = B.at[0].add(-u_prev[0] * prev_B)
        dB = dB.at[1:].add(-u_prev[1:, None] * B[:-1])

        def fold(s_sum, comp, inc):   # Kahan fold of a sprint increment
            y = inc - comp
            t_new = s_sum + y
            return t_new, (t_new - s_sum) - y

        # echo specs grouped by taucp lane so the gathers happen INSIDE
        # that lane's iteration — the full [wps, W] prefix sums stay
        # fusable per lane instead of living across the whole step
        echo_by_t: dict = {}
        for i, (sv, ti) in enumerate(echo_specs):
            echo_by_t.setdefault(ti, []).append((i, sv))

        blks = []
        sa_all, ca_all, sb_all, cb_all = [], [], [], []
        echo_out = [None] * len(echo_specs)
        for t in range(n_taucps):     # small static T: unrolled
            g = g_blk[t][:, None]                     # [wps, 1]
            ca = jnp.cumsum(g * dA, axis=0)           # [wps, W]
            cb = jnp.cumsum(g * dB, axis=0)
            sa = SA[t] + ca                           # broadcast [wps, W]
            sb = SB[t] + cb

            def per_scale(sv, sa=sa, sb=sb, t=t):
                inner = sv * sa + sb
                return jnp.stack([jnp.mean(jnp.cos(inner), axis=1),
                                  g_blk[t] * jnp.mean(jnp.sin(inner),
                                                      axis=1)], axis=-1)

            blks.append(jax.lax.map(per_scale, s_arr))   # [S, wps, 2]
            for i, sv in echo_by_t.get(t, ()):
                rows = echo_rows[i]                   # [E_max]
                echo_out[i] = jnp.cos(
                    dtype(sv) * jnp.take(sa, rows, axis=0)
                    + jnp.take(sb, rows, axis=0))     # [E_max, W]
            sa_new, ca_new = fold(SA[t], cA[t], ca[-1])
            sb_new, cb_new = fold(SB[t], cB[t], cb[-1])
            sa_all.append(sa_new)
            ca_all.append(ca_new)
            sb_all.append(sb_new)
            cb_all.append(cb_new)

        new_carry = (jnp.stack(sa_all), jnp.stack(ca_all),
                     jnp.stack(sb_all), jnp.stack(cb_all), A[-1], B[-1])
        out_blk = jnp.stack(blks, axis=1)             # [S, T, wps, 2]
        if echo_specs:
            return new_carry, out_blk, jnp.stack(echo_out)
        return new_carry, out_blk

    if raw:
        return step
    return jax.jit(step)


def make_sharded_plane_step(params: Params, num_water: int, scales,
                            n_taucps: int, engine: str, dtype, mesh,
                            echo_specs=()):
    """:func:`make_plane_step` under walker sharding: each shard folds
    its own walkers' record planes (the per-walker math is elementwise,
    so carries stay sharded exactly like the record) and only the
    [S, T, wps, 2] curve block crosses the mesh — one ``psum`` of the
    per-shard walker means (equal shard sizes, so the mean of means IS
    the global mean).  Echo matrices stay sharded over walker columns
    (out_spec ``P(None, None, walkers)``) — they are per-walker data.

    The local step is built at ``local_w`` so the production kernel's
    per-shard plane padding unpacks correctly (the global
    [n_win, 2, R, 128] record concatenates per-shard padded blocks on
    the row axis — a GLOBAL pad-strip slice would misalign walkers, the
    same reason run_decomposition_multihost drains per shard)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ..parallel import sharding

    n_shards = mesh.shape[sharding.WALKER_AXIS]
    if num_water % n_shards != 0:
        raise ValueError(f"num_water ({num_water}) must divide evenly "
                         f"over {n_shards} devices")
    local_step = make_plane_step(params, num_water // n_shards, scales,
                                 n_taucps, engine, dtype,
                                 echo_specs=echo_specs, raw=True)

    def shard_fn(wins, carry, u_prev, g_blk, echo_rows):
        out = local_step(wins, carry, u_prev, g_blk, echo_rows)
        blk = jax.lax.psum(out[1], sharding.WALKER_AXIS) / n_shards
        return (out[0], blk) + tuple(out[2:])

    col = P(None, sharding.WALKER_AXIS)
    wins_spec = P(None, None, sharding.WALKER_AXIS, None) \
        if engine == "pallas" else P(None, sharding.WALKER_AXIS, None)
    carry_spec = (col, col, col, col, P(sharding.WALKER_AXIS),
                  P(sharding.WALKER_AXIS))
    out_specs = (carry_spec, P())
    if echo_specs:
        out_specs = out_specs + (P(None, None, sharding.WALKER_AXIS),)
    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(wins_spec, carry_spec, P(), P(), P()),
        out_specs=out_specs, check_vma=False)
    return jax.jit(sharded)


class EchoCapture(NamedTuple):
    scale: float            #: moment scale of this capture
    taucp_ms: float         #: echo spacing
    times_ms: np.ndarray    #: [n_echoes] spin-echo times
    cos: np.ndarray         #: [n_echoes, W] per-walker cos at the echoes


def save_echoes(path: str, echoes, seed=None) -> None:
    """Save a list of :class:`EchoCapture` as one .npz (the
    ``mri-t2-sim --plane-device --dump-echoes`` artifact).  The cos
    matrices are stored float32 — losslessly, since the on-device plane
    computes them in f32 — so a full-scale grid stays KB-to-MB scale
    where the decomposition record is hundreds of MB."""
    d = {"n_pairs": np.int64(len(echoes))}
    if seed is not None:
        d["seed"] = np.int64(seed)
    for i, e in enumerate(echoes):
        d[f"pair{i}_scale"] = np.float64(e.scale)
        d[f"pair{i}_taucp"] = np.float64(e.taucp_ms)
        d[f"pair{i}_times_ms"] = np.asarray(e.times_ms, np.float64)
        d[f"pair{i}_cos"] = np.asarray(e.cos, np.float32)
    np.savez_compressed(path, **d)


def load_echoes(path: str):
    """Load :func:`save_echoes` output back into
    :class:`EchoCapture` entries (``mri-t2-fit --echoes``)."""
    with np.load(path) as z:
        if "n_pairs" not in z.files:
            raise ValueError(
                f"{path} is not an echo-capture file; expected the "
                f"mri-t2-sim --plane-device --dump-echoes .npz schema")
        return [EchoCapture(scale=float(z[f"pair{i}_scale"]),
                            taucp_ms=float(z[f"pair{i}_taucp"]),
                            times_ms=np.asarray(z[f"pair{i}_times_ms"],
                                                np.float64),
                            cos=np.asarray(z[f"pair{i}_cos"], np.float64))
                for i in range(int(z["n_pairs"]))]


def run_plane_on_device(scene, params: Params, scales, taucps=None,
                        seed: int = 0, engine: str = "pallas",
                        dtype=None, rng_impl: str = "threefry",
                        interpret: bool = False,
                        max_steps: Optional[int] = None,
                        echo_pairs=(), mesh=None):
    """The (moment x taucp) plane computed ON DEVICE as the simulation
    runs — the production form of the dense-sweep workflow.

    :func:`run_decomposition` + :class:`StreamingPlane` drain the
    per-walker record to the host every sprint (8 bytes x walkers x
    windows — 1.3 GB for the full reference run), so the drain, not the
    kernel, sets that workflow's pace.  Here the raw record planes never
    leave the device: a jitted update (:func:`make_plane_step`) folds
    them into carried per-taucp signed Kahan sums and only the
    ``[S, T, wps, 2]`` curve block crosses to the host per sprint
    (KBs).

    Precision: carries are f32 + Kahan — the engine's own phase-
    accumulation discipline — so curves match the float64 host plane to
    f32 rounding (tested, and bounded by the same argument as
    ACCURACY.md's phase-drift dossier).

    ``echo_pairs``: optional ``[(scale, taucp_ms), ...]`` whose
    PER-WALKER spin-echo cos matrices are gathered on device in the
    same pass ([n_echoes, W] each — KBs) and returned as
    :class:`EchoCapture` entries, ready for
    :func:`bootstrap_from_echoes` — Monte-Carlo T2 error bars at
    production speed, no record anywhere.

    ``mesh``: optional walker-sharding mesh (CLI ``--shard-walkers``)
    — sprints AND the plane folding run sharded
    (:func:`make_sharded_plane_step`: per-shard Kahan carries, one psum
    of the walker means per sprint), so dense sweeps at scale-up walker
    counts spread over local devices with nothing per-walker ever
    crossing the mesh.  Global Threefry lanes keep per-walker physics
    equal to the single-device run; curves differ only by the f32
    mean-of-means grouping (tested at the usual f32 tolerance).
    Under a MULTI-PROCESS mesh each process fills only its addressable
    walker columns of the echo matrices (zero elsewhere) — call
    :func:`parallel.distributed.run_plane_multihost`, which allgathers
    them, instead of using this entry point directly.

    Returns ``(times_ms, curves [S, T, n, 2], stats, echoes)`` with
    curves as walker MEANS stacking (cos, sin) —
    :class:`StreamingPlane.result`'s quadrature contract; ``echoes`` is
    a list of :class:`EchoCapture` (empty without ``echo_pairs``).
    """
    import jax.numpy as jnp

    from ..analysis import echo_indices
    from . import reference_engine as re

    dtype = dtype or jnp.float32
    p = params.validate()
    num_water = scene.waters.shape[0]
    wps = p.sprint_steps // p.pfreq
    total = p.t if max_steps is None else min(p.t, max_steps)
    n_sprints = total // p.sprint_steps
    n = n_sprints * wps
    if n == 0:
        raise ValueError("run_plane_on_device needs at least one full "
                         "sprint of windows")
    taucps_l = [p.taucp] if taucps is None else \
        [float(t) for t in np.asarray(taucps, np.float64).reshape(-1)]
    T_req = len(taucps_l)
    s_arr = np.asarray(scales, np.float64).reshape(-1)
    times = np.arange(1, n + 1, dtype=np.float64) * p.pfreq * p.tau

    # echo specs: (scale value, index into the taucp table) — echo
    # taucps not among the requested ones append extra cumsum lanes
    # whose curve rows are sliced off the output
    echo_specs = []
    echo_meta = []
    for es, et in echo_pairs:
        et = float(et)
        if et not in taucps_l:
            p.replace(taucp=et).validate()
            taucps_l.append(et)
        ti = taucps_l.index(et)
        eidx = echo_indices(times, et)
        if eidx.size == 0:
            raise ValueError(
                f"no spin echo (t = 2k*taucp = {2 * et:g} ms) falls "
                f"inside the {times[-1]:g} ms run")
        echo_specs.append((float(es), ti))
        echo_meta.append({"scale": float(es), "taucp": et, "eidx": eidx})
    tcps = [p.replace(taucp=t).validate().tcp for t in taucps_l]
    T = len(taucps_l)

    # host-precomputed sign tables, sliced per sprint (shapes static ->
    # one compile): u_prev[r] undoes the base flip before record row r;
    # g[t, r] is the reconstruction parity g_{j-1} for row r
    j = np.arange(1, n + 1, dtype=np.int64)
    undo = np.where((j * p.pfreq) % p.tcp == 0, -1.0, 1.0)
    u_prev_full = np.concatenate([[1.0], undo[:-1]]).astype(np.float32)
    g_full = np.stack([_flip_parity(n, tcp, p.pfreq)
                       for tcp in tcps]).astype(np.float32)

    # per-sprint echo row tables, padded to one static width (row 0,
    # masked on the host by simply not scattering padding entries)
    n_specs = len(echo_specs)
    e_max = 1
    sprint_rows = []        # [n_sprints][n_specs] -> (local_rows, global_ks)
    if n_specs:
        for i in range(n_sprints):
            lo = i * wps
            per_spec = []
            for m in echo_meta:
                sel = np.nonzero((m["eidx"] >= lo)
                                 & (m["eidx"] < lo + wps))[0]
                per_spec.append((m["eidx"][sel] - lo, sel))
                e_max = max(e_max, sel.size)
            sprint_rows.append(per_spec)

    state = re.init_state(scene.waters, p, dtype, decompose=True)
    if mesh is not None:
        # walker-sharded: sharded sprints + per-shard plane folding with
        # one psum of the walker means (make_sharded_plane_step); the
        # record planes never leave their shard's device
        step_fn, dev_state = _setup_engine_sharded(
            engine, p, scene, seed, state, dtype, rng_impl, interpret,
            mesh)
        plane_step = make_sharded_plane_step(
            p, num_water, s_arr, T, engine, dtype, mesh,
            echo_specs=tuple(echo_specs))
    else:
        step_fn, dev_state, _ = _setup_engine(
            engine, p, scene, seed, state, dtype, rng_impl, interpret)
        plane_step = make_plane_step(p, num_water, s_arr, T, engine,
                                     dtype, echo_specs=tuple(echo_specs))

    np_dt = np.dtype(dtype)
    if mesh is not None:
        # global arrays so the same code runs under 1 or N processes
        # (put_global = make_array_from_callback; on a single-process
        # mesh it is just a sharded device_put)
        from jax.sharding import PartitionSpec as _P

        from ..parallel import sharding as _sh
        from ..parallel.distributed import put_global
        _col = _P(None, _sh.WALKER_AXIS)
        _row = _P(_sh.WALKER_AXIS)

        def put_in(x):
            return put_global(mesh, _P(), np.asarray(x))

        carry = tuple(put_global(mesh, s, np.zeros(shp, np_dt))
                      for s, shp in ((_col, (T, num_water)),) * 4
                      + ((_row, (num_water,)),) * 2)
    else:
        put_in = jnp.asarray
        carry = (jnp.zeros((T, num_water), dtype),) * 4 \
            + (jnp.zeros((num_water,), dtype),) * 2
    # zeros (not empty): under multi-process meshes each process fills
    # only its addressable walker columns; disjoint-column zero matrices
    # then sum to the full capture (distributed.run_plane_multihost)
    echo_mats = [np.zeros((m["eidx"].size, num_water), np.float64)
                 for m in echo_meta]
    blocks = []
    pending = None      # 1-deep drain overlap (blocks are tiny, but the
    # device->host sync would otherwise serialize sprints)

    def drain(pend):
        blk, emat, rows_i = pend
        blocks.append(np.asarray(blk))   # psum'd/replicated: host-readable
        if not n_specs:
            return
        if mesh is not None:
            # sharded over walker columns: scatter each addressable
            # shard into its global column range (a process only holds
            # its own walkers' columns)
            for shd in emat.addressable_shards:
                em = np.asarray(shd.data)
                c0 = shd.index[2].start or 0
                for si, (local, global_ks) in enumerate(rows_i):
                    echo_mats[si][global_ks, c0:c0 + em.shape[2]] = \
                        em[si, :local.size]
        else:
            em = np.asarray(emat)
            for si, (local, global_ks) in enumerate(rows_i):
                # only the real (unpadded) rows scatter into the matrix
                echo_mats[si][global_ks] = em[si, :local.size]

    for i in range(n_sprints):
        dev_state, wins = step_fn(dev_state)
        lo = i * wps
        rows_i = sprint_rows[i] if n_specs else []
        if n_specs:
            rows_arr = np.zeros((n_specs, e_max), np.int32)
            for si, (local, _) in enumerate(rows_i):
                rows_arr[si, :local.size] = local
            carry, blk, emat = plane_step(
                wins, carry, put_in(u_prev_full[lo:lo + wps]),
                put_in(g_full[:, lo:lo + wps]), put_in(rows_arr))
        else:
            carry, blk = plane_step(
                wins, carry, put_in(u_prev_full[lo:lo + wps]),
                put_in(g_full[:, lo:lo + wps]),
                put_in(np.zeros((0, 1), np.int32)))
            emat = None
        if pending is not None:
            drain(pending)
        pending = (blk, emat, rows_i)
    if pending is not None:
        drain(pending)

    # step/escapes/coverage live unsharded on both engines' state trees
    stats = {
        "steps": int(np.asarray(dev_state.step)),
        "escapes": int(np.asarray(dev_state.escapes)),
        "coverage_violations": int(np.asarray(dev_state.coverage)),
    }
    # appended echo-only taucp lanes are not part of the requested plane
    curves = np.concatenate(blocks, axis=2)[:, :T_req]   # [S, T, n, 2]
    echoes = [EchoCapture(scale=m["scale"], taucp_ms=m["taucp"],
                          times_ms=times[m["eidx"]], cos=echo_mats[si])
              for si, m in enumerate(echo_meta)]
    return times, curves, stats, echoes


def window_increments(A, B, params: Params):
    """Undo the base run's Carr-Purcell flips: raw per-window phase
    increments ``(dA, dB)`` as float64 host arrays.

    The engines emit each window's accumulated phase BEFORE applying the
    flip that fires at that window's end (cuda_sim.cu:996-1023 order:
    performUpdate, reduce, THEN flipPhases), so with ``s_j = -1`` iff
    ``(j*pfreq) % tcp == 0`` the recorded series satisfies
    ``A_j = s_{j-1} * A_{j-1} + dA_j`` — the increments are exactly
    recoverable in post-processing, no kernel support needed.
    """
    p = params.validate()
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    n = A.shape[0]
    j = np.arange(1, n + 1, dtype=np.int64)
    sign = np.where((j * p.pfreq) % p.tcp == 0, -1.0, 1.0)
    dA, dB = A.copy(), B.copy()
    dA[1:] -= sign[:-1, None] * A[:-1]
    dB[1:] -= sign[:-1, None] * B[:-1]
    return dA, dB


def _flip_parity(n_windows: int, tcp: int, pfreq: int) -> np.ndarray:
    """``g[r] = (-1)**F(r)`` where ``F(r)`` counts Carr-Purcell flips in
    windows 1..r (flip after window j iff ``(j*pfreq) % tcp == 0``, i.e.
    at multiples of tcp//pfreq windows).  Row r of the record holds
    window j = r+1, whose phase needs the parity of flips BEFORE it,
    ``g_{j-1} = g[r]``."""
    r = np.arange(n_windows, dtype=np.int64)
    flips = (r * pfreq) // tcp
    return (1.0 - 2.0 * (flips & 1)).astype(np.float64)


def flip_parity_schedule(n_windows: int, flip_windows) -> np.ndarray:
    """``g`` for an ARBITRARY refocusing schedule: ``flip_windows`` lists
    the (1-based) output windows after whose end a 180-degree pulse
    fires.  Row r of the record holds window j = r+1, whose phase needs
    the parity of pulses BEFORE it — the count of schedule entries
    <= r."""
    f = np.asarray(sorted({int(x) for x in flip_windows}), np.int64)
    if f.size and (f[0] < 1 or f[-1] > n_windows):
        raise ValueError(
            f"flip windows must be 1-based window indices in "
            f"[1, {n_windows}]; got range [{f[0]}, {f[-1]}]")
    counts = np.searchsorted(f, np.arange(n_windows, dtype=np.int64),
                             side="right")
    return (1.0 - 2.0 * (counts & 1)).astype(np.float64)


def _reconstruct(dA, dB, s_arr, g_stack, quadrature: bool,
                 walker_block: int) -> np.ndarray:
    """Shared inner loop: walker-mean curves [n_scales, n_schedules,
    n_windows(, 2)] given per-schedule parity vectors ``g_stack``
    [n_schedules, n_windows].  float64, streamed over walker blocks."""
    n, w = dA.shape
    comps = 2 if quadrature else 1
    acc = np.zeros((len(s_arr), g_stack.shape[0], n, comps), np.float64)
    for lo in range(0, w, walker_block):
        hi = min(lo + walker_block, w)
        a_blk, b_blk = dA[:, lo:hi], dB[:, lo:hi]
        for si, sv in enumerate(s_arr):
            dphi = sv * a_blk + b_blk
            for ti in range(g_stack.shape[0]):
                gi = g_stack[ti][:, None]
                phi = gi * np.cumsum(gi * dphi, axis=0)
                acc[si, ti, :, 0] += np.sum(np.cos(phi), axis=1)
                if quadrature:
                    acc[si, ti, :, 1] += np.sum(np.sin(phi), axis=1)
    acc /= w
    return acc if quadrature else acc[..., 0]


def reconstruct_curves(dA, dB, scales, taucps, params: Params,
                       quadrature: bool = False,
                       walker_block: int = 1024) -> np.ndarray:
    """T2 curves over the whole (moment-scale x echo-spacing) plane from
    ONE simulation's increment record.

    Phase is linear in the moment scale (phase_j = s*dA_j + dB_j per
    window) and a Carr-Purcell schedule only multiplies prefix sums by
    +-1, so for any taucp' whose flips land on window boundaries

        phi'_j = g_{j-1} * sum_{k<=j} g_{k-1} * dphi_k,
        g_m = (-1)**(number of flips among windows 1..m)

    — one cumulative sum per (scale, taucp) pair.  The reference answers
    this question with one ~14-minute recompile-and-rerun per grid point
    (README.md:13,16); here the whole plane is closed-form post-processing
    on common random numbers.

    Returns walker-MEAN curves ``[n_scales, n_taucps, n_windows]`` of
    cos(phi) (or ``[..., 2]`` stacking cos/sin when ``quadrature``).
    Accumulation is float64, streamed over walker blocks so the peak
    temporary stays ~``n_windows x walker_block`` regardless of the
    record size.
    """
    dA = np.asarray(dA, np.float64)
    dB = np.asarray(dB, np.float64)
    n = dA.shape[0]
    s_arr = np.asarray(scales, np.float64).reshape(-1)
    taucps = list(np.asarray(taucps, np.float64).reshape(-1))
    # one validated tcp per taucp (reuses the params error messages for
    # misaligned / sub-window echo spacings)
    tcps = [params.replace(taucp=float(t)).validate().tcp for t in taucps]
    g = np.stack([_flip_parity(n, tcp, params.pfreq) for tcp in tcps])
    return _reconstruct(dA, dB, s_arr, g, quadrature, walker_block)


def reconstruct_at_schedule(dA, dB, scales, schedules,
                            quadrature: bool = False,
                            walker_block: int = 1024) -> np.ndarray:
    """Curves for ARBITRARY refocusing-pulse schedules from one record —
    echo trains the engines never simulated.

    ``schedules`` is a list of pulse schedules, each a sequence of
    1-based output-window indices after whose end a 180-degree pulse
    fires (an empty schedule = free decay).  A 180-degree pulse only
    negates every walker's accumulated phase — it changes neither
    trajectories nor the per-window phase increments — so the exact
    reconstruction argument of :func:`reconstruct_curves` applies
    verbatim to non-uniform trains: variable-spacing CPMG, T2-prep
    blocks, or any other aligned sequence is one ±1-signed cumulative
    sum over the recorded increments.  (For the uniform-taucp grid the
    reference's workflow targets, use :func:`reconstruct_curves`; this
    is the generalization it cannot express at all.)

    Returns ``[n_scales, n_schedules, n_windows]`` walker-mean curves
    (``[..., 2]`` stacking cos/sin when ``quadrature``).
    """
    dA = np.asarray(dA, np.float64)
    dB = np.asarray(dB, np.float64)
    n = dA.shape[0]
    s_arr = np.asarray(scales, np.float64).reshape(-1)
    g = np.stack([flip_parity_schedule(n, sched) for sched in schedules])
    return _reconstruct(dA, dB, s_arr, g, quadrature, walker_block)


class StreamingPlane:
    """Incremental (moment-scale x taucp) plane reconstruction from
    per-sprint record blocks — the dense-sweep workflow WITHOUT ever
    materializing the [n_windows, W] record.

    Per window the phase increment is linear in the moment scale
    (dphi = s*dA + dB) and a Carr-Purcell train only signs prefix sums
    (reconstruct_curves), so per echo spacing it suffices to carry the
    per-walker SIGNED increment sums ``S_A = sum g_{k-1} dA_k`` and
    ``S_B`` — window j's phase at ANY scale is ``g_{j-1}(s*S_A + S_B)``,
    closed form.  Memory is ``2 x n_taucps x W`` float64, independent of
    BOTH the window count and the scale count: the full record for a
    100k-walker x 40k-window scale-up run is 32 GB; this is ~16 MB.

    Feed the engines' RAW recorded rows (accumulated phase with the base
    run's CP flips applied, exactly what ``run_decomposition`` drains per
    sprint) via :meth:`update` in window order — pass this object as
    ``run_decomposition(..., consumer=plane)``.  ``result()`` returns
    what :func:`curves_at_plane` returns, to float64 summation-order
    rounding (the batch path sums walkers in blocks of 1024).

    ``echo_pairs``: optional [(scale, taucp), ...] whose per-walker echo
    cos-matrices are captured during the stream (memory n_echoes x W
    each) for :func:`bootstrap_from_echoes` — streaming Monte-Carlo
    error bars with no record.
    """

    def __init__(self, params: Params, n_windows: int, scales,
                 taucps=None, quadrature: bool = False,
                 echo_pairs=(), row_block: int = 256):
        from ..analysis import echo_indices

        p = params.validate()
        self._p = p
        n = int(n_windows)
        if n <= 0:
            raise ValueError(f"n_windows must be > 0, got {n_windows!r}")
        if row_block < 1:
            raise ValueError(f"row_block must be >= 1, got {row_block!r}")
        self._n = n
        self._scales = np.asarray(scales, np.float64).reshape(-1)
        self._taucps = [p.taucp] if taucps is None else \
            [float(t) for t in np.asarray(taucps, np.float64).reshape(-1)]
        tcps = [p.replace(taucp=t).validate().tcp for t in self._taucps]
        self._g = np.stack([_flip_parity(n, tcp, p.pfreq) for tcp in tcps])
        # sign applied to the base run's accumulated phase AFTER window j
        # (1-based) — undoing it recovers raw increments, as in
        # window_increments
        j = np.arange(1, n + 1, dtype=np.int64)
        self._undo = np.where((j * p.pfreq) % p.tcp == 0, -1.0, 1.0)
        self._quad = bool(quadrature)
        self._row_block = int(row_block)
        self._curves = np.zeros(
            (len(self._scales), len(self._taucps), n,
             2 if self._quad else 1), np.float64)
        self.times_ms = np.arange(1, n + 1, dtype=np.float64) \
            * p.pfreq * p.tau
        self._echo = []
        for es, et in echo_pairs:
            tcp_e = p.replace(taucp=float(et)).validate().tcp
            eidx = echo_indices(self.times_ms, float(et))
            if eidx.size == 0:
                raise ValueError(
                    f"no spin echo (t = 2k*taucp = {2 * float(et):g} ms) "
                    f"falls inside the {self.times_ms[-1]:g} ms stream")
            self._echo.append({
                "scale": float(es), "taucp": float(et),
                "g": _flip_parity(n, tcp_e, p.pfreq),
                "eidx": eidx, "times": self.times_ms[eidx],
                "mat": None, "SA": None, "SB": None})
        self._r = 0
        self._prev_A = self._prev_B = None
        self._SA = self._SB = None

    def update(self, a_block, b_block) -> None:
        """Consume the next [n_block, W] raw record rows (window order)."""
        a_block = np.asarray(a_block, np.float64)
        b_block = np.asarray(b_block, np.float64)
        if a_block.shape != b_block.shape or a_block.ndim != 2:
            raise ValueError(
                f"expected matching [n_block, W] blocks; got "
                f"{a_block.shape} and {b_block.shape}")
        nb, w = a_block.shape
        if self._r + nb > self._n:
            raise ValueError(
                f"stream overflow: {self._r} + {nb} rows > the declared "
                f"{self._n} windows")
        if self._SA is None:
            t = len(self._taucps)
            self._SA = np.zeros((t, w), np.float64)
            self._SB = np.zeros((t, w), np.float64)
            for e in self._echo:
                e["SA"] = np.zeros(w, np.float64)
                e["SB"] = np.zeros(w, np.float64)
                e["mat"] = np.empty((e["eidx"].size, w), np.float64)
        elif w != self._SA.shape[1]:
            raise ValueError(f"walker count changed mid-stream: "
                             f"{self._SA.shape[1]} -> {w}")

        for c0 in range(0, nb, self._row_block):
            c1 = min(c0 + self._row_block, nb)
            g0 = self._r + c0
            # undo the base run's flips: dA_r = A_r - undo[r-1] * A_{r-1}
            dA = a_block[c0:c1].copy()
            dB = b_block[c0:c1].copy()
            if g0 > 0:
                dA[0] -= self._undo[g0 - 1] * self._prev_A
                dB[0] -= self._undo[g0 - 1] * self._prev_B
            if c1 - c0 > 1:
                u = self._undo[g0:g0 + (c1 - c0) - 1, None]
                dA[1:] -= u * a_block[c0:c1 - 1]
                dB[1:] -= u * b_block[c0:c1 - 1]
            self._prev_A = a_block[c1 - 1]
            self._prev_B = b_block[c1 - 1]

            for ti in range(len(self._taucps)):
                gc = self._g[ti, g0:g0 + (c1 - c0)][:, None]
                sa = self._SA[ti] + np.cumsum(gc * dA, axis=0)
                sb = self._SB[ti] + np.cumsum(gc * dB, axis=0)
                self._SA[ti] = sa[-1]
                self._SB[ti] = sb[-1]
                for si, sv in enumerate(self._scales):
                    inner = sv * sa + sb        # phi = g * inner
                    self._curves[si, ti, g0:g0 + (c1 - c0), 0] = \
                        np.mean(np.cos(inner), axis=1)
                    if self._quad:
                        self._curves[si, ti, g0:g0 + (c1 - c0), 1] = \
                            gc[:, 0] * np.mean(np.sin(inner), axis=1)
            for e in self._echo:
                gc = e["g"][g0:g0 + (c1 - c0)][:, None]
                sa = e["SA"] + np.cumsum(gc * dA, axis=0)
                sb = e["SB"] + np.cumsum(gc * dB, axis=0)
                e["SA"], e["SB"] = sa[-1], sb[-1]
                lo = np.searchsorted(e["eidx"], g0)
                hi = np.searchsorted(e["eidx"], g0 + (c1 - c0))
                for k in range(lo, hi):
                    r_loc = e["eidx"][k] - g0
                    e["mat"][k] = np.cos(
                        e["scale"] * sa[r_loc] + sb[r_loc])
        self._r += nb

    # -- snapshot / restore (durable streaming, run_streaming_durable) --
    def config_digest(self) -> str:
        """Hash of everything that shapes the stream's state and its
        float64 summation order — a snapshot may only be restored into
        an identically-configured plane."""
        import hashlib
        h = hashlib.sha256()
        h.update(repr((self._n, self._scales.tolist(), self._taucps,
                       self._quad, self._row_block, self._p.tcp,
                       self._p.pfreq,
                       [(e["scale"], e["taucp"]) for e in self._echo]))
                 .encode())
        return h.hexdigest()[:16]

    def state_dict(self) -> dict:
        """The consumed-stream state as flat numpy arrays (npz-able);
        :meth:`load_state` restores it exactly (bitwise)."""
        d = {"r": np.int64(self._r), "digest": self.config_digest()}
        if self._SA is not None:
            d.update(SA=self._SA, SB=self._SB, prev_A=self._prev_A,
                     prev_B=self._prev_B, curves=self._curves)
            for i, e in enumerate(self._echo):
                d[f"echo{i}_SA"] = e["SA"]
                d[f"echo{i}_SB"] = e["SB"]
                d[f"echo{i}_mat"] = e["mat"]
        return d

    def load_state(self, d: dict) -> None:
        """Restore a :meth:`state_dict` snapshot (same configuration
        required; refuses a digest mismatch)."""
        theirs = str(np.asarray(d["digest"]))
        if theirs != self.config_digest():
            raise ValueError(
                f"stream snapshot was taken under a different plane "
                f"configuration (digest {theirs} != "
                f"{self.config_digest()}); scales/taucps/quadrature/"
                f"row_block/echo_pairs must match exactly")
        self._r = int(np.asarray(d["r"]))
        if "SA" in d:
            self._SA = np.array(d["SA"], np.float64)
            self._SB = np.array(d["SB"], np.float64)
            self._prev_A = np.array(d["prev_A"], np.float64)
            self._prev_B = np.array(d["prev_B"], np.float64)
            self._curves = np.array(d["curves"], np.float64)
            for i, e in enumerate(self._echo):
                e["SA"] = np.array(d[f"echo{i}_SA"], np.float64)
                e["SB"] = np.array(d[f"echo{i}_SB"], np.float64)
                e["mat"] = np.array(d[f"echo{i}_mat"], np.float64)
        elif self._r:
            raise ValueError("stream snapshot claims consumed rows but "
                             "carries no state arrays")

    def _check_complete(self):
        if self._r != self._n:
            raise ValueError(
                f"stream incomplete: {self._r}/{self._n} windows consumed")

    def result(self) -> np.ndarray:
        """Walker-mean curves ``[n_scales, n_taucps, n_windows]``
        (``[..., 2]`` when quadrature) — :func:`curves_at_plane`'s
        contract, computed in one pass."""
        self._check_complete()
        return self._curves if self._quad else self._curves[..., 0]

    def echo_matrix(self, i: int = 0):
        """``(echo_times_ms, cos_echo [n_echoes, W])`` for echo_pairs[i]
        — :func:`echo_cos_matrix`'s contract, captured in-stream."""
        if not self._echo:
            raise ValueError("no echo_pairs were requested at construction")
        self._check_complete()
        e = self._echo[i]
        return e["times"], e["mat"]


def curves_at_plane(A, B, scales, taucps, params: Params,
                    quadrature: bool = False) -> np.ndarray:
    """Convenience: ``window_increments`` + ``reconstruct_curves`` —
    the (moment x taucp) sweep plane from one decomposition record."""
    dA, dB = window_increments(A, B, params)
    return reconstruct_curves(dA, dB, scales, taucps, params,
                              quadrature=quadrature)


def open_record(path: str):
    """Load a saved decomposition record from EITHER format: a
    ``--dump-record`` .npz file (arrays in RAM) or an ``io.record``
    store directory (``--record-dir``; A/B stay read-only disk memmaps,
    so fits over records larger than RAM stream from disk).

    Returns ``(A, B, meta)`` with ``meta`` a dict holding whichever of
    ``times_ms / mmoment / seed / taucp / tau / pfreq`` the record
    carries (value ``None`` when absent)."""
    from ..io import record as record_mod

    keys = ("times_ms", "mmoment", "seed", "taucp", "tau", "pfreq")
    if record_mod.is_record_dir(path):
        store = record_mod.RecordStore.open(path)
        if not store.complete:
            raise ValueError(
                f"record store at {path} is incomplete "
                f"({store.rows}/{store.n_windows} windows committed); "
                f"finish or resume the run first")
        a, b = store.arrays()
        meta = {k: store.meta.get(k) for k in keys}
        meta["times_ms"] = store.times_ms()
        return a, b, meta
    with np.load(path) as z:
        a, b = z["A"], z["B"]
        meta = {k: (z[k] if k in z.files else None) for k in keys}
    for k in ("mmoment", "seed", "taucp", "tau"):
        if meta[k] is not None:
            meta[k] = float(meta[k])
    if meta["pfreq"] is not None:
        meta["pfreq"] = int(meta["pfreq"])
    return a, b, meta


def record_params(path: str, n_windows: int = None,
                  meta: dict = None) -> Params:
    """A minimal Params consistent with a saved record
    (``mri-t2-sim --dump-record`` / ``--record-dir``): the time axis and
    echo knobs the reconstruction math needs; every other field is an
    unused default.  Raises if the record predates the knob fields.
    ``meta``: pass :func:`open_record`'s meta to skip re-opening the
    record (for .npz, reading the shape decompresses the whole
    potentially GB-scale A entry — pass ``n_windows`` to avoid it)."""
    from ..io import record as record_mod

    if meta is None:
        if record_mod.is_record_dir(path):
            store = record_mod.RecordStore.open(path)
            meta = {k: store.meta.get(k) for k in ("taucp", "tau", "pfreq")}
            if n_windows is None:
                n_windows = store.rows
        else:
            with np.load(path) as z:
                meta = {k: (float(z[k]) if k != "pfreq" else int(z[k]))
                        for k in ("taucp", "tau", "pfreq")
                        if k in z.files}
                if n_windows is None:
                    n_windows = z["A"].shape[0]
    for k in ("taucp", "tau", "pfreq"):
        if meta.get(k) is None:
            raise ValueError(
                f"{path} lacks {k!r}; re-dump the record with a "
                f"current build to reconstruct offline")
    if n_windows is None:
        times = meta.get("times_ms")
        if times is None:
            raise ValueError(f"{path} lacks a time axis; pass n_windows")
        n_windows = len(times)
    taucp, tau, pfreq = meta["taucp"], meta["tau"], meta["pfreq"]
    if n_windows == 0:
        raise ValueError(f"{path} holds an empty record (0 windows); "
                         f"nothing to reconstruct")
    pi = pfreq * tau
    return Params(totaltime=n_windows * pi, print_interval=pi, tau=tau,
                  taucp=taucp, sprint_steps=n_windows * pfreq,
                  chunk_steps=pfreq).validate()


def reconstruct_record(path: str, scales, taucps=None,
                       quadrature: bool = False, schedules=None):
    """Offline reconstruction from a saved record file alone: curves
    at each moment scale (``taucps=None``), over the full
    (moment x taucp) plane, or at arbitrary pulse ``schedules``
    (:func:`reconstruct_at_schedule`) — no simulator, no original
    Params object.  Returns what :func:`curves_at_scales` /
    :func:`curves_at_plane` / :func:`reconstruct_at_schedule` return
    (normalized per-walker means)."""
    if taucps is not None and schedules is not None:
        raise ValueError("pass taucps OR schedules, not both")
    A, B, meta = open_record(path)
    if taucps is None and schedules is None:
        return curves_at_scales(A, B, scales, quadrature=quadrature)
    # pass the window count: record_params would otherwise decompress
    # the (potentially GB-scale) A array a second time just for shape
    p = record_params(path, n_windows=A.shape[0], meta=meta)
    if schedules is not None:
        dA, dB = window_increments(A, B, p)
        return reconstruct_at_schedule(dA, dB, scales, schedules,
                                       quadrature=quadrature)
    return curves_at_plane(A, B, scales, taucps, p, quadrature=quadrature)


class BootstrapT2(NamedTuple):
    fit: "object"           #: analysis.T2Fit on the full-walker echo envelope
    t2_lo_ms: float         #: lower percentile bound of the T2 resamples
    t2_hi_ms: float         #: upper percentile bound
    t2_stderr_ms: float     #: sample std-dev of the T2 resamples
    n_ok: int               #: resamples that produced a valid fit
    t2_samples: np.ndarray  #: the resampled T2 values themselves


def echo_cos_matrix(A, B, params: Params, scale: float = 1.0,
                    taucp: Optional[float] = None,
                    walker_block: int = 1024, increments=None):
    """Per-walker ``cos(phi)`` at the spin-echo rows (t = 2k·taucp) for a
    given moment scale and echo spacing, from a decomposition record.

    Returns ``(echo_times_ms, cos_echo)`` with ``cos_echo`` shaped
    ``[n_echoes, num_water]`` — the sufficient statistic for any
    walker-resampling analysis of the echo envelope.  Streamed over
    walker blocks like :func:`reconstruct_curves`.  ``increments``:
    optionally pass precomputed ``window_increments(A, B, params)`` so
    multi-taucp callers pay the flip-undo once (A/B are then ignored).
    """
    from ..analysis import echo_indices

    p = params.validate()
    taucp_v = p.taucp if taucp is None else float(taucp)
    tcp = p.tcp if taucp is None else p.replace(taucp=taucp_v).validate().tcp
    dA, dB = increments if increments is not None \
        else window_increments(A, B, p)
    n, w = dA.shape
    times = np.arange(1, n + 1, dtype=np.float64) * p.pfreq * p.tau
    eidx = echo_indices(times, taucp_v)
    if eidx.size == 0:
        raise ValueError(
            f"no spin echo (t = 2k*taucp = {2 * taucp_v:g} ms) falls inside "
            f"the {times[-1]:g} ms record; nothing to sample")
    g = _flip_parity(n, tcp, p.pfreq)[:, None]
    cos_echo = np.empty((eidx.size, w), np.float64)
    for lo in range(0, w, walker_block):
        hi = min(lo + walker_block, w)
        dphi = scale * dA[:, lo:hi] + dB[:, lo:hi]
        phi = g * np.cumsum(g * dphi, axis=0)
        cos_echo[:, lo:hi] = np.cos(phi[eidx])
    return times[eidx], cos_echo


def bootstrap_t2(A, B, params: Params, scale: float = 1.0,
                 taucp: Optional[float] = None, n_boot: int = 200,
                 seed: int = 0, ci: float = 0.95, floor: float = 0.02,
                 walker_block: int = 1024,
                 increments=None) -> BootstrapT2:
    """Walker-bootstrap confidence interval on T2 from ONE simulation.

    The decay curve is a mean over walkers, so the record's per-walker
    (A, B) basis carries the full sampling distribution: resample the
    walker columns with replacement, reconstruct each resample's echo
    envelope (a single BLAS product against the multinomial weights), and
    fit T2 per resample.  This measures the real Monte-Carlo uncertainty
    of the simulation — which the per-row fit stderr understates, since
    decay rows share walkers and are strongly time-correlated.  The
    reference's only route to an error bar is N independent ~14-minute
    reruns (README.md:16); here it is closed-form post-processing.

    ``ci`` is the two-sided percentile level (0.95 -> [2.5%, 97.5%]).
    Resamples whose fit fails (e.g. a pathological draw that does not
    decay) are skipped and counted via ``n_ok``.
    """
    from ..analysis import fit_t2

    if not 0 < ci < 1:        # fail before the (possibly GB-scale)
        raise ValueError(f"ci must be in (0, 1), got {ci!r}")
    if n_boot < 2:            # echo-matrix pass, not after it
        raise ValueError(f"n_boot must be >= 2, got {n_boot!r}")
    te, cos_echo = echo_cos_matrix(A, B, params, scale=scale, taucp=taucp,
                                   walker_block=walker_block,
                                   increments=increments)
    return bootstrap_from_echoes(te, cos_echo, n_boot=n_boot, seed=seed,
                                 ci=ci, floor=floor)


def bootstrap_from_echoes(te, cos_echo, n_boot: int = 200, seed: int = 0,
                          ci: float = 0.95,
                          floor: float = 0.02) -> BootstrapT2:
    """The walker-bootstrap core of :func:`bootstrap_t2`, on an already
    materialized per-walker echo matrix ``[n_echoes, W]`` — e.g. one
    captured in-stream by :class:`StreamingPlane` (``echo_pairs``), where
    no record ever exists to pass to :func:`bootstrap_t2`."""
    from ..analysis import fit_t2

    if not 0 < ci < 1:
        raise ValueError(f"ci must be in (0, 1), got {ci!r}")
    if n_boot < 2:
        raise ValueError(f"n_boot must be >= 2, got {n_boot!r}")
    te = np.asarray(te, np.float64)
    cos_echo = np.asarray(cos_echo, np.float64)
    w = cos_echo.shape[1]
    point = fit_t2(te, cos_echo.mean(axis=1), floor=floor)

    rng = np.random.default_rng(seed)
    counts = rng.multinomial(w, np.full(w, 1.0 / w), size=n_boot)
    curves = cos_echo @ (counts.T / w)          # [n_echoes, n_boot]
    samples = []
    for b in range(n_boot):
        try:
            samples.append(fit_t2(te, curves[:, b], floor=floor).t2_ms)
        except ValueError:
            continue
    if len(samples) < max(2, n_boot // 2):
        raise ValueError(
            f"only {len(samples)}/{n_boot} bootstrap resamples produced a "
            f"valid T2 fit; the curve is too noisy to bootstrap")
    s = np.asarray(samples, np.float64)
    alpha = 100.0 * (1.0 - ci) / 2.0
    lo, hi = np.percentile(s, [alpha, 100.0 - alpha])
    return BootstrapT2(fit=point, t2_lo_ms=float(lo), t2_hi_ms=float(hi),
                       t2_stderr_ms=float(s.std(ddof=1)),
                       n_ok=len(samples), t2_samples=s)


def bootstrap_dispersion(A, B, params: Params, taucps, scale: float = 1.0,
                         n_boot: int = 200, seed: int = 0,
                         ci: float = 0.95, floor: float = 0.02) -> list:
    """The CPMG dispersion table R2(taucp) WITH Monte-Carlo confidence
    intervals, from ONE decomposition record: per echo spacing, the
    walker bootstrap of :func:`bootstrap_t2` (the flip-undo pass over
    the record is paid once and shared).

    Returns one dict per taucp:
    ``{taucp_ms, r2_per_ms, t2_ms, t2_lo_ms, t2_hi_ms, t2_stderr_ms,
    n_ok}`` — nan row (n_ok=0) for grid points with too few echoes or
    an unfittable envelope, mirroring the ``--fit-r2`` sentinel.  The
    reference's route to this table is one recompile + ~14-minute run
    per (taucp, replicate) pair.
    """
    p = params.validate()
    inc = window_increments(A, B, p)
    rows = []
    nan = float("nan")
    for t_cp in np.asarray(taucps, np.float64).reshape(-1):
        try:
            b = bootstrap_t2(A, B, p, scale=scale, taucp=float(t_cp),
                             n_boot=n_boot, seed=seed, ci=ci,
                             floor=floor, increments=inc)
            rows.append({"taucp_ms": float(t_cp),
                         "r2_per_ms": 1.0 / b.fit.t2_ms,
                         "t2_ms": b.fit.t2_ms,
                         "t2_lo_ms": b.t2_lo_ms,
                         "t2_hi_ms": b.t2_hi_ms,
                         "t2_stderr_ms": b.t2_stderr_ms,
                         "n_ok": b.n_ok})
        except ValueError:
            rows.append({"taucp_ms": float(t_cp), "r2_per_ms": nan,
                         "t2_ms": nan, "t2_lo_ms": nan, "t2_hi_ms": nan,
                         "t2_stderr_ms": nan, "n_ok": 0})
    return rows


def bootstrap_t2_record(path: str, scale: float = 1.0,
                        taucp: Optional[float] = None, n_boot: int = 200,
                        seed: int = 0, ci: float = 0.95,
                        floor: float = 0.02) -> BootstrapT2:
    """:func:`bootstrap_t2` from a saved record (``--dump-record`` npz
    or ``--record-dir`` store) alone — error bars on T2 with no
    simulator and no original Params object."""
    A, B, meta = open_record(path)
    p = record_params(path, n_windows=A.shape[0], meta=meta)
    return bootstrap_t2(A, B, p, scale=scale, taucp=taucp, n_boot=n_boot,
                        seed=seed, ci=ci, floor=floor)


def bootstrap_dispersion_record(path: str, taucps, scale: float = 1.0,
                                n_boot: int = 200, seed: int = 0,
                                ci: float = 0.95,
                                floor: float = 0.02) -> list:
    """:func:`bootstrap_dispersion` from a saved record (npz or store
    directory)."""
    A, B, meta = open_record(path)
    p = record_params(path, n_windows=A.shape[0], meta=meta)
    return bootstrap_dispersion(A, B, p, taucps, scale=scale,
                                n_boot=n_boot, seed=seed, ci=ci,
                                floor=floor)


def curves_at_scales(A, B, scales, quadrature: bool = False):
    """Reconstruct normalized magnetization curves at each moment scale:
    ``curves[s, t] = mean_i cos(scales[s] * A[t, i] + B[t, i])``
    (and the sin component when ``quadrature``).

    One memory pass over (A, B) per scale (``lax.map``), so sweeping
    hundreds of scales over the full-run record stays bounded.
    """
    import jax
    import jax.numpy as jnp

    A = jnp.asarray(np.asarray(A, np.float32))
    B = jnp.asarray(np.asarray(B, np.float32))
    s = jnp.asarray(np.asarray(scales, np.float32)).reshape(-1)

    def one(sv):
        ph = sv * A + B
        if quadrature:
            return jnp.stack([jnp.mean(jnp.cos(ph), axis=-1),
                              jnp.mean(jnp.sin(ph), axis=-1)])
        return jnp.mean(jnp.cos(ph), axis=-1)

    return np.asarray(jax.lax.map(one, s))
