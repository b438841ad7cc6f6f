"""Simulation orchestrator: scene -> device -> sprints -> CSV.

The analogue of ``simulateWaters`` (src/cuda_sim.cu:902-1034)
and the ``main`` driver (src/T2_GPU_sim.cu:58-61): builds the scene, runs
the sprint loop, streams the T2 curve to CSV with the reference's filename
convention and schema, reports throughput, and (beyond the reference)
checkpoints and resumes.

Host<->device flow: the device only ever sends back [n_windows, 2] window
sums per sprint (a few hundred bytes); sprints are dispatched ahead of
reads, so the device never waits on the host CSV writer.

Run as a CLI:
    python -m mri_nanoparticle_simulation_tpu.engine.sim \
        --num-water 4032 --totaltime 40 --engine pallas --out t2.csv
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import rng
from ..fields import expansion
from ..fields import grid as grid_mod
from ..io import checkpoint as ckpt_mod
from ..io import writer as writer_mod
from ..params import FIELD_GRID, Params
from ..scene import BacteriaBox
from . import pallas_engine, reference_engine

ENGINES = pallas_engine.ENGINES


def fit_chunk_steps(params: Params, requested: int) -> int:
    """Largest chunk size <= requested that is a multiple of pfreq and
    divides the total step count (falls back to pfreq)."""
    c = min(requested, params.t)
    c -= c % params.pfreq
    while c > params.pfreq and params.t % c != 0:
        c -= params.pfreq
    return max(c, params.pfreq)


def fit_sprint_steps(params: Params, requested: int) -> int:
    """Largest sprint size <= requested that divides the total step count
    and is a multiple of both pfreq and chunk_steps.  Bigger sprints mean
    fewer host dispatches; the value has no effect on physics or output
    cadence."""
    unit = params.chunk_steps if params.chunk_steps >= params.pfreq \
        else params.pfreq
    best = unit
    for mult in range(1, requested // unit + 1):
        cand = unit * mult
        if params.t % cand == 0:
            best = cand
    return best


def _emit_sweep_outputs(csv_path, times, names, combos, flat, pv_fn,
                        fit_path, quadrature=False):
    """Per-grid-point outputs shared by --sweep and --sweep-grid: one
    reference-schema CSV per point (suffix KNOB=V[_KNOB2=V2]) and,
    when ``fit_path`` is set, the fitted dispersion table with one knob
    column per axis.  ``flat`` is [n_points, trials, n_windows]
    (+ a trailing (cos, sin) component axis when ``quadrature``);
    ``pv_fn(combo)`` yields the point's physical Params (header
    metadata AND the echo spacing each point is fitted at)."""
    import os
    stem, ext = os.path.splitext(csv_path)
    fit_rows = []
    for ci, combo in enumerate(combos):
        pv = pv_fn(combo).validate()
        tag = "_".join(f"{n}={v:g}" for n, v in zip(names, combo))
        path = f"{stem}_{tag}{ext or '.csv'}"
        pt = flat[ci].mean(axis=0)           # trial mean
        if quadrature:
            mean, wins = pt[:, 0], pt
        else:
            mean = pt
            wins = np.stack([pt, np.zeros_like(pt)], -1)
        with writer_mod.T2CsvWriter(path, pv, quadrature=quadrature) as w:
            w.append_windows(0, wins)
        print(f"  {tag}: wrote {path}", file=sys.stderr)
        if fit_path:
            from .. import analysis
            try:
                te, me = analysis.sample_at_echoes(times, mean, pv.taucp)
                fit = analysis.fit_t2(te, me)
                # error bar: with >=2 trials, the scatter of per-trial
                # fits is the honest Monte-Carlo error of the mean-curve
                # fit (independent replicates); a single trial falls back
                # to the fit's linearized stderr, which UNDERSTATES
                # (rows share walkers) — see analysis.T2Fit
                se = fit.t2_stderr_ms
                if flat[ci].shape[0] >= 2:
                    t2s = []
                    for trial in flat[ci]:
                        try:
                            tt, mt = analysis.sample_at_echoes(
                                times,
                                trial[:, 0] if quadrature else trial,
                                pv.taucp)
                            t2s.append(analysis.fit_t2(tt, mt).t2_ms)
                        except ValueError:
                            continue
                    if len(t2s) >= 2:
                        se = float(np.std(t2s, ddof=1) / np.sqrt(len(t2s)))
                fit_rows.append(combo + (1.0 / fit.t2_ms, fit.t2_ms,
                                         fit.r_squared, fit.n_used, se))
            except ValueError as e:
                print(f"  fit-t2: {tag} unfittable ({e})",
                      file=sys.stderr)
                fit_rows.append(combo + (float("nan"), float("nan"),
                                         float("nan"), 0, float("nan")))
    if fit_path:
        with open(fit_path, "w") as f:
            f.write(",".join(names)
                    + ",r2_per_ms,t2_ms,r_squared,n_echoes,t2_stderr_ms\n")
            for row in fit_rows:
                f.write(",".join(
                    [f"{v:g}" for v in row[:len(names)]]
                    + [str(v) for v in row[len(names):]]) + "\n")
        print(f"Sweep dispersion table written: {fit_path}",
              file=sys.stderr)


class SimulationRunner:
    """Owns the scene, the compiled sprint function, and walker state."""

    def __init__(self, params: Params, scene_seed: int = 0, seed: int = 0,
                 engine: str = "pallas", dtype=jnp.float32,
                 rng_impl: str = pallas_engine.RNG_THREEFRY,
                 interpret: bool = False, check_coverage: bool = True,
                 mesh=None, scene=None):
        """``mesh``: an optional jax.sharding.Mesh with a 'walkers' axis;
        when given, walker state is sharded over it and window sums psum
        over ICI (parallel/sharding.py) — for both engines.

        ``scene``: an optional prebuilt Scene (e.g. a
        ClusteredBacteriaBox product); default builds a BacteriaBox from
        scene_seed.  The coverage guard applies either way."""
        self.params = params.validate()
        self.seed = seed
        self.scene_seed = scene_seed
        self.engine = engine = pallas_engine.choose_engine(
            engine, interpret=interpret)
        self.rng_impl = pallas_engine.check_rng_impl(rng_impl)
        self.dtype = dtype
        self.mesh = mesh
        grid_mode = params.field_mode == FIELD_GRID
        if grid_mode and engine == "pallas":
            raise ValueError(
                "field_mode='grid' is a scan-engine backend (the pallas "
                "engine's fused kernel always uses the local expansion, "
                "which is both faster and more accurate); use "
                "engine='scan'")

        self.scene = scene if scene is not None \
            else BacteriaBox(params, seed=scene_seed).populate()
        # geometry content hash for checkpoints: pure function of the
        # (immutable) scene — computed once, not per periodic save
        self._scene_fp = ckpt_mod.scene_fingerprint(self.scene)
        # whether this engine will actually consult the cube-candidate
        # tables (both engines take the cube path on large scenes; the
        # kernel sees the padded walker count)
        n_mnp = len(self.scene.mnps)
        uses_cubes = expansion.uses_large_path(
            pallas_engine.pad_count(params.num_water) if engine == "pallas"
            else params.num_water, n_mnp)

        if check_coverage and not grid_mode:
            worst = expansion.validate_near_k(
                self.scene.mnps[:, :3], params, n_probe=50_000)
            if worst > params.near_k:
                raise ValueError(
                    f"scene requires near_k >= {worst} for exact in-cell "
                    f"tests at chunk_steps={params.chunk_steps} "
                    f"(configured near_k={params.near_k}); raise near_k or "
                    f"lower chunk_steps")
            if uses_cubes:
                worst_c = expansion.validate_cube_candidates(
                    self.scene.mnps[:, :3], params)
                if worst_c > params.cube_candidates:
                    raise ValueError(
                        f"scene requires cube_candidates >= {worst_c} "
                        f"(configured {params.cube_candidates}); raise it "
                        f"or shrink cube_hash_dim cubes")

        # cast in NumPy, transfer uncast: jnp.asarray(f64_array, f32)
        # would compile a device convert_element_type at startup
        self.mnp_pos = jnp.asarray(np.asarray(self.scene.mnps[:, :3],
                                              dtype))
        self.mnp_M = jnp.asarray(np.asarray(self.scene.mnps[:, 4], dtype))
        k = rng.key_from_seed(seed)
        self.key_arr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])

        self._field_grid = None
        if grid_mode:
            self._field_grid = grid_mod.build_grid(
                self.mnp_pos, self.mnp_M, params, grid_n=params.grid_n,
                max_residents=params.grid_max_residents, dtype=dtype)

        # scene-constant selection cache (large scenes): built once here
        # instead of once per sprint; carries the per-cube far table the
        # XLA field-model rebuild reads.  Sharded pallas sprints get it
        # replicated over the mesh.  Only built when the pallas sprint
        # will actually take the cube path (uses_cubes) — smaller scenes
        # would pay the order-5 jacfwd table sweep for nothing.
        self._cache = None
        if engine == "pallas" and uses_cubes:
            self._cache = expansion.build_cache(
                self.mnp_pos, self.mnp_M, params)

        self.state = reference_engine.init_state(
            self.scene.waters, params, dtype)

        if mesh is not None:
            from ..parallel import sharding
            if engine == "pallas":
                self._sprint = sharding.make_sharded_pallas_sprint_fn(
                    params, params.num_water, mesh, dtype, rng_impl,
                    interpret, cache=self._cache)
            else:
                if grid_mode:
                    raise ValueError("sharded grid-mode runs are not "
                                     "wired up; use field_mode="
                                     "'expansion'")
                self._sprint = sharding.make_sharded_sprint_fn(
                    params, mesh, dtype)
        elif engine == "pallas":
            self._sprint = self._make_pallas_sprint(interpret)
        else:
            self._sprint = reference_engine.make_sprint_fn(
                params, dtype, field_grid=self._field_grid)

    def _make_pallas_sprint(self, interpret: bool):
        """Single-device pallas sprint, AOT-warm-started when possible.

        A repeat CLI run deserializes the cached compiled executable
        directly (engine/aot.py), skipping tracing, kernel lowering and
        compilation.  Scenes needing the cube cache, interpret mode, and
        every load/serialize failure fall back to the ordinary jit
        path."""
        from . import aot
        params = self.params
        if interpret or self._cache is not None:
            return pallas_engine.make_sprint_fn(
                params, params.num_water, self.dtype, self.rng_impl,
                interpret)
        n_mnp = int(self.mnp_pos.shape[0])
        fn = aot.load_sprint(params, params.num_water, n_mnp, self.dtype,
                             self.rng_impl)
        if fn is not None:
            print("Loaded the compiled sprint from the executable cache",
                  file=sys.stderr)
            return fn
        base = pallas_engine.make_sprint_fn(
            params, params.num_water, self.dtype, self.rng_impl,
            interpret)
        example = (self.mnp_pos, self.mnp_M, self.key_arr,
                   pallas_engine.to_planes(self.state, params), 0)
        fn = aot.compile_and_save(base.inner, params, params.num_water,
                                  example, self.dtype, self.rng_impl)
        return fn if fn is not None else base

    # -- state plumbing ------------------------------------------------------

    def _run_sprint(self):
        if self.engine == "pallas":
            ps = getattr(self, "_planes", None)
            if self.mesh is not None:
                from ..parallel import sharding
                if ps is None:
                    ps = sharding.to_planes_sharded(
                        self.state, self.params,
                        self.mesh.shape[sharding.WALKER_AXIS])
                ps, wins = self._sprint(self.mnp_pos, self.mnp_M,
                                        self.key_arr, ps)
            else:
                if ps is None:
                    ps = pallas_engine.to_planes(self.state, self.params)
                ps, wins = self._sprint(self.mnp_pos, self.mnp_M,
                                        self.key_arr, ps, 0,
                                        cache=self._cache)
            self._planes = ps
            return wins
        if self.mesh is not None:
            st, wins = self._sprint(self.mnp_pos, self.mnp_M, self.key_arr,
                                    self.state)
        else:
            st, wins = self._sprint(self.mnp_pos, self.mnp_M, self.key_arr,
                                    self.state, 0)
        self.state = st
        return wins

    def _sync_state(self):
        if self.engine == "pallas" and getattr(self, "_planes", None) is not None:
            if self.mesh is not None:
                from ..parallel import sharding
                self.state = sharding.from_planes_sharded(
                    self._planes, self.params.num_water,
                    self.mesh.shape[sharding.WALKER_AXIS])
            else:
                self.state = pallas_engine.from_planes(
                    self._planes, self.params.num_water)

    def resume(self, path: str):
        state, seed, scene_seed = ckpt_mod.load_checkpoint(
            path, self.params, self.dtype,
            engine=self.engine, rng_impl=self.rng_impl,
            scene_fp=self._scene_fp)
        if seed != self.seed or scene_seed != self.scene_seed:
            raise ValueError(
                f"checkpoint seeds (run={seed}, scene={scene_seed}) do not "
                f"match runner seeds (run={self.seed}, "
                f"scene={self.scene_seed})")
        self.state = state
        self._planes = None
        if self.engine == "pallas":
            if self.mesh is not None:
                from ..parallel import sharding
                self._planes = sharding.to_planes_sharded(
                    state, self.params,
                    self.mesh.shape[sharding.WALKER_AXIS])
            else:
                self._planes = pallas_engine.to_planes(state, self.params)

    # -- main loop -----------------------------------------------------------

    def run(self, csv_path: Optional[str] = None, quadrature: bool = False,
            checkpoint_path: Optional[str] = None,
            checkpoint_every_sprints: int = 0, progress: bool = True,
            max_steps: Optional[int] = None, drain_depth: int = 32,
            fault_hook=None, drain_timeout_s: Optional[float] = None):
        """Run from the current state to completion, streaming CSV.

        ``drain_depth`` is the durability/throughput tradeoff: sprints
        are dispatched asynchronously and their window sums are only
        read back (and their CSV rows flushed) every ``drain_depth``
        sprints, because each host readback waits for the device to
        drain its queue.  An un-checkpointed crash therefore loses up to
        ``drain_depth`` sprints of rows; pass 1 for per-sprint
        durability.

        ``fault_hook``: optional callable invoked with the absolute
        sprint index before each dispatch — the chaos-testing seam for
        the elastic-recovery layer (engine/resilience.py); anything it
        raises is handled exactly like a device failure.

        ``drain_timeout_s``: watchdog deadline on every blocking device
        readback — window-sum drains AND the checkpoint/final walker-
        state fetches; any that exceeds it raises
        ``resilience.WatchdogTimeout`` instead of blocking forever (the
        reference's only watchdog was the PBS job walltime, SURVEY §5).

        Returns (times_ms, sum_cos, sum_sin, stats_dict).
        """
        if drain_depth < 1:
            raise ValueError("drain_depth must be >= 1")
        self._drain_timeout_s = drain_timeout_s
        p = self.params
        total = p.t if max_steps is None else min(p.t, max_steps)
        start_step = int(np.asarray(self.state.step))
        n_sprints = (total - start_step) // p.sprint_steps
        win_per_sprint = p.sprint_steps // p.pfreq

        writer = None
        if csv_path is not None:
            writer = writer_mod.T2CsvWriter(csv_path, p, quadrature,
                                            append=start_step > 0)
            writer.__enter__()

        t0 = time.perf_counter()
        pending = []          # dispatched sprints not yet written out
        all_wins = []
        # Drain in deep batches: every host read of device data waits for
        # the device queue, so the default 32-sprint pipeline lets the
        # device run ahead asynchronously; see the drain_depth docstring
        # for the crash-loss contract.
        depth = drain_depth
        try:
            for i in range(n_sprints):
                if fault_hook is not None:
                    fault_hook(start_step // p.sprint_steps + i)
                wins = self._run_sprint()
                pending.append((start_step // p.pfreq + i * win_per_sprint,
                                wins))
                if len(pending) >= depth:
                    self._drain_batch(pending, writer, all_wins)
                if checkpoint_path and checkpoint_every_sprints and \
                        (i + 1) % checkpoint_every_sprints == 0:
                    # flush the CSV first: a checkpoint must never be
                    # ahead of the rows on disk or a crash loses the gap.
                    # The state sync + save fetch the full walker state,
                    # so they run under the same watchdog as drains
                    self._drain_batch(pending, writer, all_wins)

                    def _sync_and_save():
                        self._sync_state()
                        ckpt_mod.save_checkpoint(
                            checkpoint_path, self.state, p, self.seed,
                            self.scene_seed, engine=self.engine,
                            rng_impl=self.rng_impl,
                            scene_fp=self._scene_fp)
                    self._guarded(_sync_and_save)
                if progress and (i + 1) % max(1, n_sprints // 20) == 0:
                    done = (i + 1) * p.sprint_steps
                    rate = done * p.num_water / (time.perf_counter() - t0)
                    print(f"  sprint {i + 1}/{n_sprints} "
                          f"({rate:.2e} walker-steps/s)", file=sys.stderr)
            self._drain_batch(pending, writer, all_wins)
        finally:
            if writer is not None:
                writer.close()
        wall = time.perf_counter() - t0

        def _final_sync():
            self._sync_state()
            if checkpoint_path:
                ckpt_mod.save_checkpoint(
                    checkpoint_path, self.state, p, self.seed,
                    self.scene_seed, engine=self.engine,
                    rng_impl=self.rng_impl,
                    scene_fp=self._scene_fp)
        self._guarded(_final_sync)

        wins = np.concatenate(all_wins, 0) if all_wins else np.zeros((0, 2))
        n = len(wins)
        times = (np.arange(start_step // p.pfreq + 1,
                           start_step // p.pfreq + n + 1) * p.pfreq) * p.tau
        stats = {
            "wall_s": wall,
            "walker_steps_per_s": n_sprints * p.sprint_steps * p.num_water
            / wall if wall > 0 else 0.0,
            "escapes": int(np.asarray(self.state.escapes)),
            "coverage_violations": int(np.asarray(self.state.coverage)),
            "steps": int(np.asarray(self.state.step)),
        }
        return times, wins[:, 0], wins[:, 1], stats

    def _fetch_pending(self, pending):
        """The one blocking device->host transfer of the steady state:
        all pending sprints' window sums in ONE fetch (each np.asarray
        pays a full dispatch round trip, so fetching sprint by sprint
        would cost more than the physics).  Split out so the watchdog
        can bound it and tests can inject hangs."""
        return np.asarray(jnp.concatenate([w for _, w in pending], axis=0))

    def _guarded(self, fn):
        """Run a blocking device interaction under the drain watchdog
        (when one is armed) so checkpoint state fetches can hang no
        longer than drains can."""
        timeout = getattr(self, "_drain_timeout_s", None)
        if timeout is None:
            return fn()
        from . import resilience
        return resilience.watchdog_call(fn, timeout,
                                        what="walker-state readback")

    def _drain_batch(self, pending, writer, all_wins):
        if not pending:
            return
        first_idx = pending[0][0]
        timeout = getattr(self, "_drain_timeout_s", None)
        if timeout is not None:
            from . import resilience
            wins = resilience.watchdog_call(
                lambda: self._fetch_pending(pending), timeout,
                what=f"drain of {len(pending)} pending sprint(s)")
        else:
            wins = self._fetch_pending(pending)
        pending.clear()
        all_wins.append(wins)
        if writer is not None:
            writer.append_windows(first_idx, wins)


def main(argv=None):
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser(
        description="Monte Carlo MRI T2 simulation (reference: "
                    "RabinKarp/MRI_Nanoparticle_Simulation)")
    ap.add_argument("--num-water", type=int, default=4032)
    ap.add_argument("--num-cells", type=int, default=270)
    ap.add_argument("--totaltime", type=float, default=40.0,
                    help="simulated time, ms")
    ap.add_argument("--taucp", type=float, default=5.5)
    ap.add_argument("--mmoment", type=float, default=3.5e-17)
    ap.add_argument("--cell-r", type=float, default=0.55)
    ap.add_argument("--kick-mode", default="as_written",
                    choices=["as_written", "intended", "constant", "none"])
    ap.add_argument("--permeable", action="store_true",
                    help="use the physical reflectIO/OI permeability")
    ap.add_argument("--impermeable", action="store_true",
                    help="reflectIO = reflectOI = 1")
    ap.add_argument("--engine", default="pallas", choices=ENGINES)
    ap.add_argument("--walker-shards", type=int, default=1,
                    metavar="N",
                    help="with --ensemble/--sweep: shard each trial's "
                         "walkers over N devices on a 2D "
                         "(trials x walkers) mesh — the pod layout "
                         "(single runs use --shard-walkers)")
    ap.add_argument("--shard-walkers", action="store_true",
                    help="shard walkers over ALL local devices "
                         "(jax.sharding.Mesh; window sums psum across "
                         "devices) — bitwise-identical to the "
                         "single-device run, for multi-GPU hosts")
    ap.add_argument("--drain-depth", type=int, default=32,
                    help="sprints dispatched between CSV drains; a crash "
                         "loses up to this many sprints of rows (1 = "
                         "per-sprint durability)")
    ap.add_argument("--rng", default=pallas_engine.RNG_THREEFRY,
                    choices=[pallas_engine.RNG_THREEFRY],
                    help="random-number generator: the counter-based "
                         "Threefry stream both engines share")
    ap.add_argument("--field-mode", default="expansion",
                    choices=["expansion", "exact", "grid"],
                    help="scan-engine field backend (the pallas engine "
                         "always uses the expansion). 'exact' and 'grid' "
                         "are cross-validation oracles, NOT production "
                         "engines: 'grid' (the reference octree's direct "
                         "analogue) is dispatch-bound at ~1000x the "
                         "production path's runtime — use it to check "
                         "curves, not to run experiments")
    ap.add_argument("--grid-n", type=int, default=64,
                    help="field-grid resolution (field-mode=grid)")
    ap.add_argument("--chunk-steps", type=int, default=4000,
                    help="field-model rebuild interval (auto-shrunk for "
                         "short runs)")
    ap.add_argument("--near-k", type=int, default=10)
    ap.add_argument("--max-neighbors", type=int, default=13,
                    help="nearest-cell lookup capacity; raise for dense "
                         "scenes (thousands of cells)")
    ap.add_argument("--hash-dim", type=int, default=20)
    ap.add_argument("--tau", type=float, default=1e-6,
                    help="timestep in ms (reference: 1e-6 = 1 ns)")
    ap.add_argument("--gradient", default=None, metavar="GX,GY,GZ",
                    help="constant background B_z gradient in T/µm — "
                         "diffusion-weighting physics (CPMG/PGSE "
                         "acquisitions) beyond the reference's "
                         "zero-gradient world; the phase term is "
                         "moment-independent and composes with "
                         "--moment-scales reconstruction; a negative "
                         "LEADING component needs the = form "
                         "(--gradient=-1e-4,0,0 — argparse treats a "
                         "bare leading '-' as an option)")
    ap.add_argument("--cube-candidates", type=int, default=96)
    ap.add_argument("--far-table-order", type=int, default=5,
                    help="per-cube far-field Taylor order on the "
                         "large-scene path (0 = exact far sums each "
                         "chunk)")
    ap.add_argument("--sprint-steps", type=int, default=100000,
                    help="steps per host dispatch batch (auto-shrunk to "
                         "divide the total step count)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene-seed", type=int, default=0)
    ap.add_argument("--scene-family", default="bacteria",
                    choices=["bacteria", "clustered", "fcc"],
                    help="cell geometry: 'bacteria' = uniform random "
                         "throws (BacteriaBox.cpp:49-72), 'clustered' = "
                         "Gaussian clumps (octree-adaptivity stress "
                         "family), 'fcc' = deterministic face-centered-"
                         "cubic lattice (the reference lineage's "
                         "fcc_diffusion.h geometry, octree_test.cpp:14)")
    ap.add_argument("--n-clusters", type=int, default=8,
                    help="cluster count for --scene-family clustered")
    ap.add_argument("--cluster-sigma", type=float, default=1.5,
                    help="cluster spread (µm) for clustered scenes")
    ap.add_argument("--lattice-a", type=float, default=None,
                    help="FCC cubic lattice constant (µm); default "
                         "sizes the lattice to host num_cells centered "
                         "sites")
    ap.add_argument("--out", default=None,
                    help="CSV path (default: reference-style filename)")
    ap.add_argument("--quadrature", action="store_true",
                    help="also emit the sum-sin column")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="sprints between checkpoints")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--max-retries", type=int, default=0, metavar="N",
                    help="elastic recovery: on a device failure, rebuild "
                         "the runner, resume from --checkpoint (trimming "
                         "CSV rows past it) and retry, up to N "
                         "consecutive failures without progress; "
                         "requires --checkpoint and --checkpoint-every. "
                         "The reference aborted on any CUDA error "
                         "(HANDLE_ERROR, cuda_sim.cu:407)")
    ap.add_argument("--drain-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="watchdog deadline on each device readback; a "
                         "hung drain raises (and, with --max-retries, "
                         "recovers) instead of blocking forever")
    ap.add_argument("--ensemble", type=int, default=1, metavar="N",
                    help="run N independent trials (scenes seeded "
                         "scene-seed..scene-seed+N-1) and write the "
                         "ensemble-averaged curve — the reference's "
                         "'multitrial' PBS-resubmission workflow "
                         "(T2_GPU_sim.cu:45) as one device computation")
    ap.add_argument("--sweep", default=None, metavar="KNOB",
                    help="sweep a numeric Params knob over --sweep-values, "
                         "writing one CSV per value; mmoment/taucp/cell_r, "
                         "D (global diffusion scale: v scales D_cell "
                         "and D_extra together) and P (membrane "
                         "permeability µm/ms via the parameters.h:116-117 "
                         "formulas) ride runtime launch "
                         "scalars so the whole sweep shares ONE compiled "
                         "program (the reference re-ran nvcc per value, "
                         "README.md:13)")
    ap.add_argument("--sweep-values", default=None, metavar="V1,V2,...",
                    help="comma-separated values for --sweep")
    ap.add_argument("--sweep-grid", default=None, metavar="SPEC",
                    help="cross-product sweep over launch-scalar knobs "
                         "in ONE compiled program, e.g. "
                         "'D=0.25,0.5,1;taucp=0.001,0.002' runs every "
                         "combination as a trial (the full dispersion "
                         "surface; knobs: mmoment/taucp/cell_r/D); "
                         "writes one CSV per grid point and composes "
                         "with --paired/--trials-per-value/"
                         "--walker-shards/--fit-t2")
    ap.add_argument("--fit-t2", default=None, metavar="PATH",
                    help="with --sweep: fit each value's mean curve "
                         "(spin-echo envelope at its taucp) and write "
                         "the dispersion table "
                         "KNOB,r2_per_ms,t2_ms,r_squared,n_echoes to "
                         "PATH — e.g. R2(D) from --sweep D, or R2(taucp) "
                         "by fresh simulation (--echo-taucps + --fit-r2 "
                         "gets the same axis from ONE run)")
    ap.add_argument("--paired", action="store_true",
                    help="with --sweep: give trial k of every value the "
                         "same scene and the same RNG stream (common "
                         "random numbers), so differences along the "
                         "sweep axis are the knob's effect alone — "
                         "Monte-Carlo noise cancels in contrasts")
    ap.add_argument("--trials-per-value", type=int, default=1,
                    help="independent trials averaged per sweep value")
    ap.add_argument("--moment-scales", default=None, metavar="S1,S2,...",
                    help="reconstruct the T2 curve at each moment scale s "
                         "(dipole moment = s * --mmoment) from ONE "
                         "phase-decomposition run, writing one CSV per "
                         "scale next to --out: trajectories never depend "
                         "on the moment, so a single simulation is a "
                         "complete basis for the whole moment axis "
                         "(engine/decompose.py).  All scales share the "
                         "same trajectories (common random numbers); "
                         "--sweep mmoment instead simulates fresh trials "
                         "per value.  Host memory: the per-walker record "
                         "is 8 bytes x windows x waters (~1.3 GB for the "
                         "full 4032 x 40 ms run)")
    ap.add_argument("--echo-taucps", default=None, metavar="T1,T2,...",
                    help="reconstruct the curve at each Carr-Purcell "
                         "half-echo spacing (ms) from the SAME "
                         "decomposition run: flips only multiply window "
                         "prefix sums by +-1, so any taucp aligned to "
                         "the output interval is a closed-form cumsum "
                         "over the recorded increments "
                         "(engine/decompose.py).  Composes with "
                         "--moment-scales into the full (moment x taucp) "
                         "plane — the reference re-ran nvcc + ~14 min of "
                         "GPU per grid point; one CSV per pair")
    ap.add_argument("--dump-record", default=None, metavar="PATH",
                    help="with --moment-scales/--echo-taucps: also save "
                         "the raw per-walker decomposition record "
                         "(times_ms, A [n,W], B [n,W] + params "
                         "fingerprint) as .npz — a complete basis for "
                         "offline reconstruction at ANY moment scale / "
                         "aligned echo spacing (engine/decompose.py) "
                         "and for closed-form inverse fits "
                         "(inverse.fit_moment_scale_decomposed)")
    ap.add_argument("--record-dir", default=None, metavar="DIR",
                    help="with --moment-scales/--echo-taucps: stream the "
                         "per-walker record to a DISK-backed store "
                         "directory (io/record.py) instead of host RAM "
                         "and --dump-record's end-of-run .npz — host "
                         "memory stays one sprint block regardless of "
                         "record size, and with --checkpoint/"
                         "--checkpoint-every the run RESUMES after a "
                         "process death (re-run the same command; the "
                         "record overhang past the checkpoint is "
                         "trimmed and the result is bitwise-identical "
                         "to an uninterrupted run).  Every --record "
                         "consumer (mri-t2-fit, mri-t2-invert, "
                         "decompose.reconstruct_record) accepts the "
                         "directory in place of the .npz")
    ap.add_argument("--plane-device", action="store_true",
                    help="with --moment-scales/--echo-taucps: compute "
                         "the (moment x taucp) plane ON DEVICE "
                         "(decompose.run_plane_on_device) — the raw "
                         "per-walker record never crosses to the host; "
                         "only KB-scale curve blocks drain per sprint.  "
                         "Carries are f32 + Kahan (the engine's own "
                         "phase discipline): curves "
                         "match the float64 host reconstruction to f32 "
                         "rounding.  For walker-bootstrap error bars "
                         "use --stream-plane or --record-dir instead")
    ap.add_argument("--dump-echoes", default=None, metavar="NPZ",
                    help="with --plane-device: also gather the "
                         "PER-WALKER spin-echo cos matrices for every "
                         "(moment-scale x echo-taucp) grid point on "
                         "device (KBs each) and save them as .npz — "
                         "mri-t2-fit --echoes NPZ --bootstrap N then "
                         "delivers walker-bootstrap T2 confidence "
                         "intervals for the whole grid with no record "
                         "ever existing")
    ap.add_argument("--stream-plane", action="store_true",
                    help="with --moment-scales/--echo-taucps: reconstruct "
                         "the plane INCREMENTALLY per sprint "
                         "(decompose.StreamingPlane) instead of "
                         "materializing the per-walker record — host "
                         "memory drops from 8 bytes x windows x waters "
                         "(32 GB at 100k walkers x 40k windows) to "
                         "O(taucps x waters).  Same curves to f64 "
                         "rounding; incompatible with --dump-record "
                         "(there is no record to save).  With "
                         "--checkpoint the stream is DURABLE: walker "
                         "and plane state snapshot into one atomic "
                         "file every --checkpoint-every sprints, and "
                         "re-running the same command after a process "
                         "death resumes bitwise")
    ap.add_argument("--fit-r2", default=None, metavar="PATH",
                    help="with --echo-taucps: fit each grid point's "
                         "spin-echo envelope (analysis.fit_t2 at "
                         "t = 2k*taucp) and write the CPMG dispersion "
                         "table mscale,taucp_ms,r2_per_ms,t2_ms,"
                         "r_squared,n_echoes to PATH — R2(taucp) is the "
                         "quantity MRI relaxometry experiments measure, "
                         "here from ONE simulation; grid points whose "
                         "envelope cannot be fit (too few echoes, no "
                         "decay) get nan rows")
    ap.add_argument("--dump-field", default=None, metavar="PATH",
                    help="write B_z on a uniform lattice over the scene "
                         "to PATH as x,y,z,Bz rows and exit — the "
                         "reference's DEBUG_FIELD product "
                         "(octree.cpp:435-449) as a runtime flag")
    ap.add_argument("--dump-field-n", type=int, default=32,
                    help="lattice points per box edge for --dump-field")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a jax.profiler device trace of the run "
                         "to DIR (TensorBoard-viewable) — kernel-level "
                         "observability the reference's Timer never had")
    ap.add_argument("--scene-file", default=None, metavar="PATH",
                    help="simulate a user-provided geometry: a .csv of "
                         "x,y,z cell centers (µm; dipoles, images, "
                         "lookup table and waters are built around "
                         "them — num_cells follows the file), or a "
                         ".npz scene archive from scene.save_scene "
                         "(exact array round trip; params must match). "
                         "The reference hard-codes its generator "
                         "(BacteriaBox.cpp) — geometry here is runtime "
                         "data")
    ap.add_argument("--dump-stats", default=None, metavar="PATH",
                    help="write the scene statistics CSV (MNPs, waters, "
                         "cells) to PATH and exit — the reference's "
                         "SimboxTest / print_simulation_stats product "
                         "(SimulationBox.cpp:214-237) as a runtime flag")
    ap.add_argument("--save-scene", default=None, metavar="NPZ",
                    help="archive the run's exact scene (cells, MNPs + "
                         "images, waters, lookup table) as a .npz "
                         "before simulating — reload it with "
                         "--scene-file, render it with mri-t2-plot "
                         "--scene")
    args = ap.parse_args(argv)

    params = Params(
        num_water=args.num_water, num_cells=args.num_cells,
        totaltime=args.totaltime, taucp=args.taucp, mmoment=args.mmoment,
        cell_r=args.cell_r, kick_mode=args.kick_mode,
        chunk_steps=args.chunk_steps, near_k=args.near_k,
        sprint_steps=args.sprint_steps, max_neighbors=args.max_neighbors,
        hash_dim=args.hash_dim, tau=args.tau,
        cube_candidates=args.cube_candidates,
        far_table_order=args.far_table_order,
        field_mode=args.field_mode, grid_n=args.grid_n,
    )
    if args.gradient:
        try:
            g = tuple(float(v) for v in args.gradient.split(","))
            if len(g) != 3:
                raise ValueError(args.gradient)
        except ValueError:
            ap.error("--gradient wants three comma-separated numbers "
                     "(GX,GY,GZ in T/µm)")
        params = params.replace(b0_gradient=g)
    params = params.replace(
        chunk_steps=fit_chunk_steps(params, args.chunk_steps))
    params = params.replace(
        sprint_steps=fit_sprint_steps(params, args.sprint_steps))
    if args.permeable:
        params = params.with_permeability()
    if args.impermeable:
        params = params.impermeable()
    params.validate()

    custom_cells = None
    if args.scene_file:
        if args.scene_family != "bacteria":
            ap.error("--scene-file IS the geometry; drop --scene-family")
        if not args.scene_file.endswith(".npz"):
            from ..scene import io as scene_io
            custom_cells = scene_io.load_cells_csv(args.scene_file)
            if len(custom_cells) != params.num_cells:
                # the file defines the cell count; --num-cells is the
                # generator knob and silently disagreeing would build a
                # scene inconsistent with its params
                params = params.replace(
                    num_cells=len(custom_cells)).validate()

    def build_scene():
        """The --scene-family / --scene-file geometry (None = the
        runner's default BacteriaBox, so the production path is
        untouched)."""
        if args.scene_file:
            from ..scene import io as scene_io
            if args.scene_file.endswith(".npz"):
                return scene_io.load_scene(args.scene_file, params)
            return scene_io.CustomBox(params, custom_cells,
                                      seed=args.scene_seed).populate()
        if args.scene_family == "clustered":
            from ..scene import ClusteredBacteriaBox
            return ClusteredBacteriaBox(
                params, seed=args.scene_seed, n_clusters=args.n_clusters,
                cluster_sigma=args.cluster_sigma).populate()
        if args.scene_family == "fcc":
            from ..scene import FCCLatticeBox
            return FCCLatticeBox(params, seed=args.scene_seed,
                                 lattice_a=args.lattice_a).populate()
        return None

    if args.save_scene:
        if not args.save_scene.endswith(".npz"):
            args.save_scene += ".npz"    # np.savez appends it anyway
        _inner_build = build_scene

        def build_scene():
            sc = _inner_build() or BacteriaBox(
                params, seed=args.scene_seed).populate()
            from ..scene import io as scene_io
            scene_io.save_scene(sc, args.save_scene)
            print(f"Scene archived: {args.save_scene}", file=sys.stderr)
            return sc

    if args.dump_field:
        from ..fields import debug as dbg
        sc = build_scene() or BacteriaBox(params,
                                          seed=args.scene_seed).populate()
        dbg.dump_field_csv(sc.mnps, params, args.dump_field,
                           grid_n=args.dump_field_n)
        print(f"Field dump written: {args.dump_field} "
              f"({args.dump_field_n}^3 points)", file=sys.stderr)
        return 0

    if args.dump_stats:
        sc = build_scene() or BacteriaBox(params,
                                          seed=args.scene_seed).populate()
        sc.write_stats(args.dump_stats)
        print(f"Scene statistics written: {args.dump_stats}",
              file=sys.stderr)
        return 0

    csv_path = args.out or writer_mod.default_output_path(params)
    try:
        args.engine = pallas_engine.choose_engine(args.engine)
    except RuntimeError as e:
        ap.error(str(e))
    print(f"Starting simulation ({args.engine} engine on "
          f"{jax.devices()[0].device_kind})...\nPrinting to: {csv_path}",
          file=sys.stderr)

    decomp_mode = bool(args.moment_scales or args.echo_taucps)
    sweepish = bool(args.sweep or args.sweep_grid)
    if args.sweep and args.sweep_grid:
        ap.error("--sweep is one knob, --sweep-grid a cross product; "
                 "use one")
    durable_decomp = decomp_mode and (args.record_dir
                                      or (args.stream_plane
                                          and args.checkpoint))
    if (sweepish or args.ensemble > 1 or decomp_mode) and \
            (args.checkpoint or args.resume or args.checkpoint_every
             or args.max_retries) and not durable_decomp:
        ap.error("--checkpoint/--resume/--max-retries are single-run "
                 "features; drop them for --ensemble/--sweep/"
                 "--moment-scales/--echo-taucps runs (decomposition "
                 "runs checkpoint through --record-dir, streaming "
                 "runs through --stream-plane --checkpoint)")
    if durable_decomp and (args.resume or args.max_retries):
        ap.error("--record-dir resumes automatically when its "
                 "checkpoint exists; drop --resume/--max-retries")
    if args.record_dir:
        if not decomp_mode:
            ap.error("--record-dir stores a phase-decomposition record; "
                     "run with --moment-scales and/or --echo-taucps")
        if args.dump_record:
            ap.error("--record-dir IS the saved record; drop "
                     "--dump-record")
        if args.stream_plane:
            ap.error("--stream-plane never materializes the record; "
                     "drop --record-dir (or drop --stream-plane to "
                     "store the record)")
        if args.checkpoint_every and not args.checkpoint:
            ap.error("--checkpoint-every needs --checkpoint PATH")
        import os as _os
        _d = _os.path.dirname(_os.path.abspath(args.record_dir)) or "."
        if not _os.path.isdir(_d):
            ap.error(f"--record-dir parent directory does not exist: "
                     f"{_d}")
    if decomp_mode and (sweepish or args.ensemble > 1):
        ap.error("--moment-scales/--echo-taucps are themselves sweeps "
                 "over the (moment, taucp) plane; drop --sweep/--ensemble")
    if decomp_mode and args.shard_walkers and not args.plane_device:
        ap.error("--moment-scales/--echo-taucps record per-walker phase "
                 "components on one device; drop --shard-walkers (or add "
                 "--plane-device, whose sharded plane folding keeps the "
                 "record distributed with its walkers)")
    if args.fit_r2 and not args.echo_taucps:
        ap.error("--fit-r2 is the dispersion over the --echo-taucps "
                 "grid; pass the echo spacings to fit")
    if args.plane_device:
        if not decomp_mode:
            ap.error("--plane-device computes a phase-decomposition "
                     "plane; run with --moment-scales and/or "
                     "--echo-taucps")
        for bad, flag in ((args.stream_plane, "--stream-plane"),
                          (args.dump_record, "--dump-record"),
                          (args.record_dir, "--record-dir"),
                          (args.checkpoint, "--checkpoint")):
            if bad:
                ap.error(f"--plane-device keeps the record on the "
                         f"device; {flag} needs the host/disk record "
                         f"paths — drop one of the two")
    if args.dump_echoes and not args.plane_device:
        ap.error("--dump-echoes captures spin-echo matrices during an "
                 "on-device plane run; add --plane-device (record-based "
                 "paths bootstrap from the record itself, mri-t2-fit "
                 "--record)")
    if args.stream_plane:
        if not decomp_mode:
            ap.error("--stream-plane streams a phase-decomposition "
                     "reconstruction; run with --moment-scales and/or "
                     "--echo-taucps")
        if args.dump_record:
            ap.error("--stream-plane never materializes the record; "
                     "drop --dump-record (or drop --stream-plane to "
                     "save the record)")
    if args.dump_record:
        if not decomp_mode:
            ap.error("--dump-record saves a phase-decomposition record; "
                     "run with --moment-scales and/or --echo-taucps")
        import os as _os
        _d = _os.path.dirname(_os.path.abspath(args.dump_record)) or "."
        if not _os.path.isdir(_d):
            # fail fast: discovering an unwritable path AFTER a
            # multi-hour decomposition run would lose everything
            ap.error(f"--dump-record directory does not exist: {_d}")
        if not args.dump_record.endswith(".npz"):
            args.dump_record += ".npz"   # np.savez appends it anyway;
            # keep the printed path identical to the file on disk
    if args.max_retries:
        if args.max_retries < 0:
            ap.error("--max-retries must be >= 0")
        if not (args.checkpoint and args.checkpoint_every >= 1):
            ap.error("--max-retries needs --checkpoint PATH and "
                     "--checkpoint-every N>=1 (recovery resumes from "
                     "the last checkpoint)")
        if args.resume:
            ap.error("--max-retries auto-resumes from --checkpoint when "
                     "it exists; drop --resume")
        if not args.out:
            ap.error("--max-retries needs an explicit --out: the "
                     "default output filename embeds a timestamp, so a "
                     "re-run after a process death would resume the "
                     "checkpoint but write its rows to a NEW file")
    if args.resume and not args.out:
        ap.error("--resume needs an explicit --out (the CSV being "
                 "continued): the default output filename embeds a "
                 "timestamp, so the resumed rows would land in a NEW "
                 "file while the original keeps its untrimmed overhang")
    if args.shard_walkers and (sweepish or args.ensemble > 1):
        ap.error("--shard-walkers shards ONE population; for "
                 "ensembles/sweeps use --walker-shards N (the 2D "
                 "trials x walkers mesh)")
    if args.walker_shards != 1:
        if args.walker_shards < 1:
            ap.error("--walker-shards must be >= 1")
        if not (sweepish or args.ensemble > 1):
            ap.error("--walker-shards is the ensemble/sweep 2D-mesh "
                     "knob; single runs shard with --shard-walkers")
    if (args.scene_family != "bacteria" or args.scene_file
            or args.save_scene) and (sweepish or args.ensemble > 1):
        ap.error("--scene-family/--scene-file/--save-scene are "
                 "single-run features (ensembles/sweeps build their "
                 "per-trial BacteriaBox scenes internally)")
    cli_rng = args.rng

    if args.paired and not sweepish:
        ap.error("--paired is a --sweep/--sweep-grid modifier (common "
                 "random numbers across sweep values)")
    if args.fit_t2 and not sweepish:
        ap.error("--fit-t2 is the dispersion over the --sweep/"
                 "--sweep-grid axes; pass the knob(s) and values to "
                 "sweep (the echo axis has --echo-taucps + --fit-r2)")
    if args.sweep_grid:
        if args.ensemble > 1:
            ap.error("--sweep-grid runs --trials-per-value trials per "
                     "grid point; drop --ensemble")
        from ..parallel import ensemble as ens
        axes = {}
        try:
            for part in args.sweep_grid.split(";"):
                knob, eq, vals = part.partition("=")
                knob = knob.strip()
                if not eq or knob in axes:
                    raise ValueError(part)
                axes[knob] = [float(v) for v in vals.split(",")]
                if knob == "D" and any(not v > 0 for v in axes[knob]):
                    ap.error("--sweep-grid D values must be > 0")
        except ValueError:
            ap.error("--sweep-grid wants 'KNOB=V1,V2;KNOB2=V1,V2' with "
                     "distinct knobs and numeric values")
        bad = [n for n in axes if n not in ens.SCALAR_AXES]
        if bad:
            ap.error(f"--sweep-grid knobs must be launch scalars "
                     f"{ens.SCALAR_AXES}; got {bad}")
        from ..utils import profiling
        t0 = time.perf_counter()
        with profiling.device_trace(args.trace):
            times, curves = ens.run_parameter_grid(
                params, axes, n_trials_each=args.trials_per_value,
                base_seed=args.scene_seed, run_seed=args.seed + 1000,
                engine=args.engine, rng_impl=cli_rng,
                paired=args.paired, walker_shards=args.walker_shards,
                quadrature=args.quadrature)
        wall = time.perf_counter() - t0
        import itertools
        names = list(axes)
        flat = curves.reshape((-1, args.trials_per_value)
                              + curves.shape[len(axes) + 1:])
        combos = list(itertools.product(*[axes[n] for n in names]))

        def pv_fn(combo):
            pv = params
            for n, v in zip(names, combo):
                pv = pv.scale_D(v) if n == "D" \
                    else pv.replace(**{n: v})
            return pv

        _emit_sweep_outputs(csv_path, times, names, combos, flat,
                            pv_fn, args.fit_t2,
                            quadrature=args.quadrature)
        n_runs = len(combos) * args.trials_per_value
        rate = n_runs * params.t * params.num_water / wall
        print(f"Grid sweep complete: {len(combos)} grid points x "
              f"{args.trials_per_value} trial(s) in {wall:.1f}s "
              f"({rate:.3e} walker-steps/s)", file=sys.stderr)
        if args.trace:
            print(f"Profiler trace written to {args.trace}",
                  file=sys.stderr)
        return 0

    if args.sweep:
        if not args.sweep_values:
            ap.error("--sweep requires --sweep-values")
        if args.ensemble > 1:
            ap.error("--sweep runs --trials-per-value trials per value; "
                     "drop --ensemble")
        name = args.sweep
        if name == "Gz":
            # the DWI b-value axis: z background gradient, T/um (a
            # compile-per-value knob — gradients are kernel constants)
            values = [float(v) for v in args.sweep_values.split(",")]
        elif name == "D":
            # global diffusion scale: value v scales D_cell AND D_extra
            # together via the engines' d_scale launch scalar — one
            # compiled program for the whole sweep (sweeping D_cell or
            # D_extra alone takes the recompile-per-value path below)
            values = [float(v) for v in args.sweep_values.split(",")]
            if any(not v > 0 for v in values):
                ap.error("--sweep D values must be > 0 (diffusion scale)")
        elif name == "P":
            # membrane permeability (µm/ms): each value maps to
            # (reflect_io, reflect_oi) through Params.reflect_pair and
            # rides the engines' reflect launch scalars — one compiled
            # program for the whole sweep
            values = [float(v) for v in args.sweep_values.split(",")]
            for v in values:
                try:
                    params.reflect_pair(v)
                except ValueError as e:
                    ap.error(f"--sweep P: {e}")
        else:
            # real dataclass fields only: hasattr would also accept
            # derived read-only properties (tcp, t, in_stdev, ...) and
            # then crash with a raw TypeError inside dataclasses.replace
            import dataclasses as _dc
            if name not in {f.name for f in _dc.fields(params)}:
                ap.error(f"unknown Params knob {name!r} (must be a "
                         f"settable field, not a derived property, or "
                         f"'D' for the global diffusion scale)")
            cast = type(getattr(params, name))
            if cast not in (int, float):
                ap.error(f"--sweep only supports numeric knobs; {name!r} "
                         f"is {cast.__name__}")
            values = [cast(float(v)) for v in args.sweep_values.split(",")]
        from ..parallel import ensemble as ens
        from ..utils import profiling
        t0 = time.perf_counter()
        with profiling.device_trace(args.trace):
            times, curves = ens.run_parameter_sweep(
                params, name, values, n_trials_each=args.trials_per_value,
                base_seed=args.scene_seed, run_seed=args.seed + 1000,
                engine=args.engine, rng_impl=cli_rng, paired=args.paired,
                walker_shards=args.walker_shards,
                quadrature=args.quadrature)
        wall = time.perf_counter() - t0
        _emit_sweep_outputs(
            csv_path, times, [name], [(v,) for v in values],
            np.asarray(curves),
            lambda combo: ens.sweep_params_for(params, name, combo[0]),
            args.fit_t2,
            quadrature=args.quadrature)
        n_runs = len(values) * args.trials_per_value
        rate = n_runs * params.t * params.num_water / wall
        print(f"Sweep complete: {len(values)} values x "
              f"{args.trials_per_value} trial(s) in {wall:.1f}s "
              f"({rate:.3e} walker-steps/s)", file=sys.stderr)
        if args.trace:
            print(f"Profiler trace written to {args.trace}",
                  file=sys.stderr)
        return 0

    if args.ensemble > 1:
        from ..parallel import ensemble as ens
        from ..utils import profiling
        t0 = time.perf_counter()
        with profiling.device_trace(args.trace):
            times, cos, sin, _ = ens.run_ensemble(
                params, n_trials=args.ensemble, base_seed=args.scene_seed,
                run_seed=args.seed + 1000, engine=args.engine,
                rng_impl=cli_rng, walker_shards=args.walker_shards)
        wall = time.perf_counter() - t0
        with writer_mod.T2CsvWriter(csv_path, params,
                                    args.quadrature) as w:
            wins = np.stack([cos.mean(axis=0), sin.mean(axis=0)], -1)
            w.append_windows(0, wins)
        rate = args.ensemble * params.t * params.num_water / wall
        print(f"Ensemble complete: {args.ensemble} trials x {params.t} "
              f"steps in {wall:.1f}s ({rate:.3e} walker-steps/s)",
              file=sys.stderr)
        if args.trace:
            print(f"Profiler trace written to {args.trace}",
                  file=sys.stderr)
        return 0

    if decomp_mode:
        if params.field_mode == FIELD_GRID:
            ap.error("--moment-scales/--echo-taucps need the production "
                     "expansion backend (the grid backend is a "
                     "cross-validation oracle)")
        try:
            scales = ([float(v) for v in args.moment_scales.split(",")]
                      if args.moment_scales else [1.0])
            taucps = ([float(v) for v in args.echo_taucps.split(",")]
                      if args.echo_taucps else None)
        except ValueError:
            ap.error("--moment-scales/--echo-taucps must be "
                     "comma-separated lists of numbers")
        for s in scales:
            # fail fast on scales the single-run path would reject
            params.replace(mmoment=params.mmoment * s).validate()
        for t_cp in taucps or ():
            # fail fast on sub-window / misaligned echo spacings
            params.replace(taucp=t_cp).validate()
        from ..utils import profiling
        from . import decompose as dec
        sc = build_scene() or BacteriaBox(params,
                                          seed=args.scene_seed).populate()
        t0 = time.perf_counter()
        with profiling.device_trace(args.trace):
            if args.plane_device:
                # on-device plane: the record never crosses to the host
                taucps_eff = taucps if taucps is not None \
                    else [params.taucp]
                echo_pairs = []
                if args.dump_echoes:
                    # every grid point whose first spin echo (t=2*taucp)
                    # fits inside the run; points without one cannot be
                    # bootstrapped and are skipped with a note
                    for s in scales:
                        for t_cp in taucps_eff:
                            if 2.0 * t_cp <= params.totaltime:
                                echo_pairs.append((s, t_cp))
                            else:
                                print(f"  --dump-echoes: skipping "
                                      f"mscale={s:g} taucp={t_cp:g} "
                                      f"(no spin echo inside "
                                      f"{params.totaltime:g} ms)",
                                      file=sys.stderr)
                    if not echo_pairs:
                        ap.error("--dump-echoes: no (scale, taucp) grid "
                                 "point hosts a spin echo inside the run")
                plane_mesh = None
                if args.shard_walkers:
                    from ..parallel import sharding as sh
                    plane_mesh = sh.make_walker_mesh()
                    print(f"Sharding walkers + plane folding over "
                          f"{plane_mesh.shape[sh.WALKER_AXIS]} device(s)",
                          file=sys.stderr)
                t_pd, curves, stats, echoes_out = dec.run_plane_on_device(
                    sc, params, scales, taucps, seed=args.seed,
                    engine=args.engine, rng_impl=cli_rng,
                    echo_pairs=echo_pairs, mesh=plane_mesh)
                res = dec.DecompositionResult(
                    times_ms=t_pd, A=np.zeros((0, params.num_water)),
                    B=np.zeros((0, params.num_water)), stats=stats)
            elif args.stream_plane:
                plane = dec.StreamingPlane(params, params.t // params.pfreq,
                                           scales, taucps, quadrature=True)
                if args.checkpoint:
                    # durable streaming: walker + plane state snapshot
                    # in one atomic file; a re-run after a process
                    # death resumes and finishes bitwise-identically
                    stats = dec.run_streaming_durable(
                        sc, params, plane, args.checkpoint,
                        seed=args.seed, scene_seed=args.scene_seed,
                        engine=args.engine, rng_impl=cli_rng,
                        snapshot_every_sprints=args.checkpoint_every
                        or 1, progress=True)
                    res = dec.DecompositionResult(
                        times_ms=plane.times_ms,
                        A=np.zeros((0, params.num_water)),
                        B=np.zeros((0, params.num_water)), stats=stats)
                else:
                    res = dec.run_decomposition(sc, params,
                                                seed=args.seed,
                                                engine=args.engine,
                                                rng_impl=cli_rng,
                                                consumer=plane)
                curves = plane.result()     # [s, t, n, 2], walker means
                taucps_eff = taucps if taucps is not None \
                    else [params.taucp]
            else:
                if args.record_dir:
                    # disk-backed store + checkpoint/resume; A/B come
                    # back as read-only memmaps, so the reconstruction
                    # below streams from disk unchanged
                    res = dec.run_decomposition_durable(
                        sc, params, args.record_dir, seed=args.seed,
                        scene_seed=args.scene_seed, engine=args.engine,
                        rng_impl=cli_rng,
                        checkpoint_path=args.checkpoint,
                        checkpoint_every_sprints=args.checkpoint_every
                        or 1, progress=True)
                    print(f"Decomposition record stored: "
                          f"{args.record_dir} (A/B {res.A.shape})",
                          file=sys.stderr)
                else:
                    res = dec.run_decomposition(sc, params,
                                                seed=args.seed,
                                                engine=args.engine,
                                                rng_impl=cli_rng)
                if taucps is None:
                    curves = dec.curves_at_scales(res.A, res.B, scales,
                                                  quadrature=True)
                    # [s, 2, n] -> [s, 1, n, 2] so one writer loop serves
                    # both branches
                    curves = np.moveaxis(curves, 1, -1)[:, None]
                    taucps_eff = [params.taucp]
                else:
                    curves = dec.curves_at_plane(res.A, res.B, scales,
                                                 taucps, params,
                                                 quadrature=True)
                    taucps_eff = taucps
        wall = time.perf_counter() - t0
        import os
        stem, ext = os.path.splitext(csv_path)
        for si, s in enumerate(scales):
            for ti, t_cp in enumerate(taucps_eff):
                pv = params.replace(mmoment=params.mmoment * s,
                                    taucp=t_cp).validate()
                path = f"{stem}_mscale={s:g}"
                if taucps is not None:
                    path += f"_taucp={t_cp:g}"
                path += ext or ".csv"
                cv = curves[si, ti]
                # reconstruction returns walker MEANS [n, 2]; the
                # reference schema streams walker SUMS
                # (cuda_sim.cu:1013,1022)
                wins = cv * params.num_water
                with writer_mod.T2CsvWriter(path, pv,
                                            quadrature=args.quadrature) as w:
                    w.append_windows(0, wins)
                print(f"  mscale={s:g} taucp={t_cp:g}: wrote {path}",
                      file=sys.stderr)
        if args.dump_record:
            # after the CSVs: a dump failure must never cost the run's
            # primary products
            from ..io.checkpoint import params_fingerprint
            np.savez_compressed(
                args.dump_record, times_ms=res.times_ms,
                A=np.asarray(res.A), B=np.asarray(res.B),
                params_fp=params_fingerprint(params),
                mmoment=params.mmoment, seed=args.seed,
                # the knobs offline echo-axis reconstruction needs
                # (decompose.record_params / curves_at_plane)
                taucp=params.taucp, tau=params.tau,
                pfreq=params.pfreq)
            print(f"Decomposition record written: {args.dump_record} "
                  f"(A/B {np.asarray(res.A).shape})", file=sys.stderr)
        if args.dump_echoes:
            # after the CSVs, like --dump-record: a dump failure must
            # never cost the run's primary products
            dec.save_echoes(args.dump_echoes, echoes_out, seed=args.seed)
            print(f"Spin-echo capture written: {args.dump_echoes} "
                  f"({len(echoes_out)} grid point(s); bootstrap with "
                  f"mri-t2-fit --echoes)", file=sys.stderr)
        if args.fit_r2:
            from .. import analysis
            with open(args.fit_r2, "w") as f:
                f.write("mscale,taucp_ms,r2_per_ms,t2_ms,r_squared,"
                        "n_echoes,t2_stderr_ms\n")
                # single-run record: the linearized fit stderr (see
                # analysis.T2Fit — it understates; the honest bar is
                # `mri-t2-fit --record basis.npz --bootstrap N` per point)
                for si, s in enumerate(scales):
                    for ti, t_cp in enumerate(taucps_eff):
                        curve = curves[si, ti, :, 0] * params.num_water
                        try:
                            te, me = analysis.sample_at_echoes(
                                res.times_ms, curve, t_cp)
                            fit = analysis.fit_t2(te, me)
                            f.write(f"{s:g},{t_cp:g},{1.0 / fit.t2_ms},"
                                    f"{fit.t2_ms},{fit.r_squared},"
                                    f"{fit.n_used},{fit.t2_stderr_ms}\n")
                        except ValueError as e:
                            print(f"  fit-r2: mscale={s:g} taucp={t_cp:g}"
                                  f" unfittable ({e})", file=sys.stderr)
                            f.write(f"{s:g},{t_cp:g},nan,nan,nan,0,nan\n")
            print(f"CPMG dispersion table written: {args.fit_r2}",
                  file=sys.stderr)
        n_pts = len(scales) * len(taucps_eff)
        rate = params.t * params.num_water / wall if wall > 0 else 0.0
        print(f"(moment x taucp)-plane reconstruction complete: {n_pts} "
              f"grid point(s) from ONE {params.t}-step run in {wall:.1f}s "
              f"({rate:.3e} walker-steps/s), "
              f"{res.stats['escapes']} chunk escapes, "
              f"{res.stats['coverage_violations']} coverage violations",
              file=sys.stderr)
        if args.trace:
            print(f"Profiler trace written to {args.trace}",
                  file=sys.stderr)
        return 0

    mesh = None
    if args.shard_walkers:
        from ..parallel import sharding
        mesh = sharding.make_walker_mesh()
        print(f"Sharding walkers over {mesh.shape[sharding.WALKER_AXIS]} "
              f"device(s)", file=sys.stderr)
    from ..utils import profiling
    if args.max_retries:
        from . import resilience

        def make_runner():
            return SimulationRunner(
                params, scene_seed=args.scene_seed, seed=args.seed,
                engine=args.engine, rng_impl=cli_rng, mesh=mesh,
                scene=build_scene())

        with profiling.device_trace(args.trace):
            _, _, _, stats = resilience.run_resilient(
                make_runner, csv_path=csv_path,
                quadrature=args.quadrature,
                checkpoint_path=args.checkpoint,
                checkpoint_every_sprints=args.checkpoint_every,
                drain_depth=args.drain_depth,
                max_retries=args.max_retries,
                drain_timeout_s=args.drain_timeout)
        if stats.get("recovery_attempts"):
            print(f"Recovered from {stats['recovery_attempts']} "
                  f"failure(s)", file=sys.stderr)
    else:
        runner = SimulationRunner(params, scene_seed=args.scene_seed,
                                  seed=args.seed, engine=args.engine,
                                  rng_impl=cli_rng, mesh=mesh,
                                  scene=build_scene())
        if args.resume:
            from . import resilience
            runner.resume(args.resume)
            resilience.trim_csv_overhang(runner, csv_path)

        with profiling.device_trace(args.trace):
            _, _, _, stats = runner.run(
                csv_path=csv_path, quadrature=args.quadrature,
                checkpoint_path=args.checkpoint,
                checkpoint_every_sprints=args.checkpoint_every,
                drain_depth=args.drain_depth,
                drain_timeout_s=args.drain_timeout)
    if args.trace:
        print(f"Profiler trace written to {args.trace}", file=sys.stderr)
    print(f"Simulation complete: {stats['steps']} steps in "
          f"{stats['wall_s']:.1f}s "
          f"({stats['walker_steps_per_s']:.3e} walker-steps/s), "
          f"{stats['escapes']} chunk escapes, "
          f"{stats['coverage_violations']} coverage violations",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
