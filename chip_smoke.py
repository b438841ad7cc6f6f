#!/usr/bin/env python3
"""Smoke test of the production path on one NVIDIA GPU.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One process drives the card (a second JAX process could not get its
memory).  Phases, each printed with its result and wall time:

1. device check — JAX's default platform must be ``gpu``;
2. compile — the chunk kernel at real widths (headline 4032 waters x
   270 cells, chunk 4000, K=5, plain and decompose modes; scale-up
   100k x 2000 cells, K=10, C=32, big-scene mode), with
   ``memory_analysis()``;
3. kernel vs scan engine — one 20k-step sprint on the same Threefry
   streams at both widths, and a decomposition record;
4. golden parity — tests/test_golden_full.py's comparison with the
   reference oracle curves in golden/testdata/;
5. CLI end to end — the default ``mri-t2-sim`` command twice (the second
   run must load the compiled sprint from the executable cache);
6. the ``gpu``-marked tests, in this process.

Any failure exits non-zero without the final line.  On success the last
line is ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Precision of every comparison: f32 positions and phases with Kahan phase
folds on both engines.  Triton and XLA contract to FMA and sum in their
own order, so trajectories are equal only up to f32 rounding: a walker is
counted as divergent when its position differs by more than 1e-3 µm (it
took another branch at a cell membrane), and window sums are gated at
1e-4 of the walker count plus two per divergent walker (|cos| <= 1 on
each side).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: sizes of the one-card phases (the reference's headline workload and the
#: scale-up configuration); the 20k-step sprint is the CLI's unit of work
HEADLINE = dict(chunk_steps=4000, near_k=5, sprint_steps=20_000)
SCALEUP = dict(num_water=100_000, num_cells=2000, tau=5e-7,
               sprint_steps=20_000, mmoment=3.5e-17, water_start_bound=28.0,
               max_neighbors=24, near_k=10, cube_candidates=32,
               chunk_steps=4000)
CLI_ARGS = ["--chunk-steps", "4000", "--near-k", "5", "--scene-seed", "42",
            "--totaltime", "2"]
CLI_ROWS = 2000
DIVERGED_UM = 1e-3
PLATFORM = "gpu"


def smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def log(*a):
    print(*a, flush=True)


class Smoke:
    def __init__(self):
        self.failed = []

    def phase(self, name, fn, *a, **k):
        t0 = time.perf_counter()
        try:
            out = fn(*a, **k)
        except Exception:
            log(f"[{name}] FAILED after {time.perf_counter() - t0:.2f}s")
            traceback.print_exc(file=sys.stdout)
            self.failed.append(name)
            return None
        log(f"[{name}] ok {time.perf_counter() - t0:.2f}s")
        return out


def timed(fn, n):
    """Mean wall time of ``n`` calls after one untimed call, each waited
    for with block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n, out


def compare(tag, pos_k, pos_s, win_k, win_s, w):
    """Kernel vs scan-engine trajectories and window sums (see the
    module docstring for the gates)."""
    dpos = np.abs(np.asarray(pos_k) - np.asarray(pos_s)).max(axis=1)
    n_div = int((dpos > DIVERGED_UM).sum())
    kept = dpos[dpos <= DIVERGED_UM]
    dwin = float(np.abs(np.asarray(win_k) - np.asarray(win_s)).max()) / w
    log(f"  {tag}: max|dpos| {dpos.max():.3e} um (non-divergent "
        f"{kept.max() if kept.size else 0.0:.3e}); divergent walkers "
        f"{n_div}/{w}; max|dwin|/W {dwin:.3e}")
    assert n_div <= max(1, w // 200), f"{tag}: {n_div} divergent walkers"
    assert dwin <= 1e-4 + 2.0 * n_div / w, f"{tag}: window diff {dwin}"


def zero_counters(tag, escapes, coverage):
    log(f"  {tag}: escapes {int(escapes)} coverage {int(coverage)}")
    assert int(escapes) == 0 and int(coverage) == 0, tag


class Headline:
    """The reference workload and its inputs, built once."""

    def __init__(self):
        import jax.numpy as jnp

        from mri_nanoparticle_simulation_tpu import rng
        from mri_nanoparticle_simulation_tpu.engine import reference_engine
        from mri_nanoparticle_simulation_tpu.params import Params
        from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
        self.p = Params(**HEADLINE).validate()
        self.sc = BacteriaBox(self.p, seed=42).populate()
        self.w = self.p.num_water
        self.mp = jnp.asarray(np.asarray(self.sc.mnps[:, :3], np.float32))
        self.mM = jnp.asarray(np.asarray(self.sc.mnps[:, 4], np.float32))
        k = rng.key_from_seed(7)
        self.key = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
        self.st0 = reference_engine.init_state(self.sc.waters, self.p,
                                               jnp.float32)
        log(f"  headline: {self.w} walkers, {len(self.sc.mnps)} dipoles, "
            f"{self.p.sprint_steps} steps per sprint")


def phase_compile(h: Headline):
    import jax.numpy as jnp

    from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
    from mri_nanoparticle_simulation_tpu.engine import reference_engine
    out = {}
    for mode in ("plain", "decompose"):
        dec = mode == "decompose"
        f = pe.make_sprint_fn(h.p, h.w, decompose=dec)
        ps0 = pe.to_planes(reference_engine.init_state(
            h.sc.waters, h.p, jnp.float32, decompose=dec), h.p)
        t0 = time.perf_counter()
        comp = f.inner.lower(h.mp, h.mM, h.key, ps0, 0).compile()
        log(f"  headline {mode}: compiled in "
            f"{time.perf_counter() - t0:.2f}s; {comp.memory_analysis()}")
        out[mode] = (f, ps0)
    return out


def phase_kernel_vs_scan(h: Headline, fns):
    from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
    from mri_nanoparticle_simulation_tpu.engine import reference_engine
    f, ps0 = fns["plain"]
    tk, (ps, wk) = timed(lambda: f(h.mp, h.mM, h.key, ps0, 0), 5)
    fs = reference_engine.make_sprint_fn(h.p)
    ts, (st, ws) = timed(lambda: fs(h.mp, h.mM, h.key, h.st0, 0), 2)
    rate = h.p.sprint_steps * h.w
    log(f"  20k-step sprint: kernel {tk * 1e3:.3f} ms "
        f"({rate / tk:.4e} walker-steps/s), scan engine {ts * 1e3:.3f} ms "
        f"({rate / ts:.4e} walker-steps/s), kernel {ts / tk:.1f}x faster")
    compare("headline", pe.from_planes(ps, h.w).pos, st.pos, wk, ws, h.w)
    zero_counters("kernel", ps.escapes, ps.coverage)
    zero_counters("scan", st.escapes, st.coverage)
    assert tk < ts, "the kernel must beat the scan engine"


def phase_decompose(h: Headline):
    from mri_nanoparticle_simulation_tpu.engine import decompose
    recs = {}
    for engine in ("pallas", "scan"):
        t0 = time.perf_counter()
        recs[engine] = decompose.run_decomposition(
            h.sc, h.p, seed=7, engine=engine, max_steps=h.p.sprint_steps)
        log(f"  run_decomposition({engine}): "
            f"{time.perf_counter() - t0:.2f}s (compile included)")
    rk, rs = recs["pallas"], recs["scan"]
    for name in ("A", "B"):
        d = np.abs(np.asarray(getattr(rk, name))
                   - np.asarray(getattr(rs, name)))
        log(f"  record {name}: max|d| {d.max():.3e} rad")
    ck = np.cos(rk.A + rk.B).sum(axis=1)
    cs = np.cos(rs.A + rs.B).sum(axis=1)
    dcurve = float(np.abs(ck - cs).max()) / h.w
    log(f"  reconstructed curve at scale 1: max|d|/W {dcurve:.3e}")
    assert dcurve < 1e-3, dcurve
    for engine, r in recs.items():
        zero_counters(f"decompose {engine}", r.stats["escapes"],
                      r.stats["coverage_violations"])


def phase_scaleup():
    import jax
    import jax.numpy as jnp

    from mri_nanoparticle_simulation_tpu import rng
    from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
    from mri_nanoparticle_simulation_tpu.engine import reference_engine
    from mri_nanoparticle_simulation_tpu.fields import expansion
    from mri_nanoparticle_simulation_tpu.params import Params
    from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
    p = Params(**SCALEUP).validate()
    sc = BacteriaBox(p, seed=42).populate()
    w = p.num_water
    mp = jnp.asarray(np.asarray(sc.mnps[:, :3], np.float32))
    mM = jnp.asarray(np.asarray(sc.mnps[:, 4], np.float32))
    k = rng.key_from_seed(11)
    key = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
    st0 = reference_engine.init_state(sc.waters, p, jnp.float32)
    ps0 = pe.to_planes(st0, p)
    log(f"  scale-up: {w} walkers, {len(sc.mnps)} dipoles")
    t0 = time.perf_counter()
    cache = expansion.build_cache(mp, mM, p)
    jax.block_until_ready(cache)
    log(f"  scene cache with far table: {time.perf_counter() - t0:.2f}s")
    f = pe.make_sprint_fn(p, w)
    t0 = time.perf_counter()
    comp = f.inner.lower(mp, mM, key, ps0, 0, cache=cache).compile()
    log(f"  big-scene kernel compiled in {time.perf_counter() - t0:.2f}s; "
        f"{comp.memory_analysis()}")
    tk, (ps, _) = timed(lambda: f(mp, mM, key, ps0, 0, cache=cache), 2)
    log(f"  sprint with the far-table cache: {tk * 1e3:.3f} ms "
        f"({p.sprint_steps * w / tk:.4e} walker-steps/s)")
    zero_counters("scale-up kernel", ps.escapes, ps.coverage)
    # the same sprint with the cache built inside the sprint (exact far
    # sums, no table) on both engines: identical field models
    ps, wk = jax.block_until_ready(f(mp, mM, key, ps0, 0))
    fs = reference_engine.make_sprint_fn(p)
    ts, (st, ws) = timed(lambda: fs(mp, mM, key, st0, 0), 1)
    log(f"  scan engine sprint {ts * 1e3:.3f} ms")
    compare("scale-up", pe.from_planes(ps, w).pos, st.pos, wk, ws, w)
    zero_counters("scale-up scan", st.escapes, st.coverage)


def phase_golden():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_golden_full", os.path.join(REPO, "tests",
                                         "test_golden_full.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.check_parity(log=lambda *a: log("  golden", *a))


def phase_cli():
    from mri_nanoparticle_simulation_tpu.engine import sim
    warm = []
    with tempfile.TemporaryDirectory() as d:
        for run in (1, 2):
            out = os.path.join(d, f"cli{run}.csv")
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = sim.main(CLI_ARGS + ["--out", out])
            wall = time.perf_counter() - t0
            text = err.getvalue()
            rows = np.loadtxt(out, delimiter=",", ndmin=2)
            warm.append("from the executable cache" in text)
            done = [ln for ln in text.splitlines()
                    if ln.startswith("Simulation complete")]
            log(f"  CLI run {run}: rc {rc}, {wall:.2f}s, {rows.shape[0]} "
                f"rows, warm start {warm[-1]}; "
                f"{done[-1] if done else 'no summary line'}")
            assert rc == 0 and "pallas engine" in text, text[-2000:]
            assert rows.shape[0] == CLI_ROWS and np.isfinite(rows).all()
    assert warm[1], "the second CLI run did not load the executable cache"


def phase_gpu_tests():
    import pytest

    class Count:
        passed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.passed and report.when == "call":
                Count.passed += 1
            elif report.skipped:
                Count.skipped += 1

    os.environ["MRI_GPU_TESTS"] = "1"
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:xdist", "-p", "no:cacheprovider",
         "-p", "no:randomly", "--deselect",
         "tests/test_golden_full.py::TestGoldenFullScale::"
         "test_paired_deep_decay_parity",
         os.path.join(REPO, "tests")], plugins=[Count()])
    log(f"  gpu-marked tests: rc {int(rc)}, {Count.passed} passed, "
        f"{Count.skipped} skipped")
    assert int(rc) == 0 and Count.passed > 0 and Count.skipped == 0


def phase_four_cards():
    import jax

    from mri_nanoparticle_simulation_tpu.engine import pallas_engine as pe
    from mri_nanoparticle_simulation_tpu.parallel import ensemble, sharding
    h = Headline()
    mesh = sharding.make_walker_mesh(jax.devices()[:4])
    steps = h.p.sprint_steps
    t0 = time.perf_counter()
    _, c1, _, st1 = sharding.run_simulation_sharded_pallas(
        h.sc, h.p, mesh, seed=3, max_steps=steps)
    log(f"  walker-sharded kernel on {mesh.devices.shape} mesh: "
        f"{time.perf_counter() - t0:.2f}s (compile included)")
    _, c0, _, st0 = pe.run_simulation(h.sc, h.p, seed=3, max_steps=steps)
    compare("sharded vs one card", st1.pos, st0.pos,
            np.asarray(c1)[:, None], np.asarray(c0)[:, None], h.w)
    # both trials on the headline scene (K=5 is certified for seed 42),
    # each with its own random stream
    common = dict(n_trials=2, scene_seeds=[42, 42], run_seeds=[50, 51],
                  engine="pallas", max_steps=steps)
    t0 = time.perf_counter()
    _, e2, _, es2 = ensemble.run_ensemble(h.p, walker_shards=2, **common)
    log(f"  2x2 trials x walkers ensemble: {time.perf_counter() - t0:.2f}s "
        f"(compile included)")
    _, e1, _, es1 = ensemble.run_ensemble(h.p, **common)
    compare("2x2 ensemble vs trial-parallel",
            np.asarray(es2.pos).reshape(-1, 3),
            np.asarray(es1.pos).reshape(-1, 3),
            np.asarray(e2).reshape(-1, 1), np.asarray(e1).reshape(-1, 1),
            h.w)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card walker-sharded kernel "
                         "and 2x2 ensemble against their one-card runs")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    card = smi()
    log(card)

    import jax
    devs = jax.devices()
    log(f"devices: {len(devs)} x {devs[0].platform} {devs[0].device_kind}")
    if devs[0].platform != PLATFORM or len(devs) < n_cards:
        print(f"chip_smoke needs {n_cards} NVIDIA GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform!r} device(s)", file=sys.stderr)
        return 1
    try:
        from mri_nanoparticle_simulation_tpu.utils.cache import \
            enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke must run from a checkout of the repository: {e}",
              file=sys.stderr)
        return 1
    log(f"compile cache: {enable_compile_cache()}")

    s = Smoke()
    if args.four_cards:
        s.phase("four cards", phase_four_cards)
    else:
        h = s.phase("headline inputs", Headline)
        fns = s.phase("compile", phase_compile, h) if h else None
        if fns:
            s.phase("kernel vs scan engine", phase_kernel_vs_scan, h, fns)
        if h:
            s.phase("decompose kernel vs scan engine", phase_decompose, h)
        s.phase("scale-up kernel vs scan engine", phase_scaleup)
        s.phase("golden parity", phase_golden)
        s.phase("CLI end to end", phase_cli)
        s.phase("gpu-marked tests", phase_gpu_tests)
    if s.failed:
        print(f"chip_smoke: failed phases: {', '.join(s.failed)}",
              file=sys.stderr)
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
