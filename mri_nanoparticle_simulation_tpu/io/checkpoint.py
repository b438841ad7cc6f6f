"""Checkpoint / resume for walker state.

The reference has no checkpointing at all — all state lives on the GPU for
the entire 14-minute run and a crash loses everything (SURVEY §5).
Counter-based RNG makes snapshots trivial here: the complete resumable
state is (positions, in_cell, phase, phase compensation, step counter,
escape counter) plus the seed — the RNG needs no state because the step
counter IS its state.

Format: a single .npz with a params fingerprint so mismatched resumes fail
loudly instead of silently simulating a different experiment.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..engine.reference_engine import WalkerState
from ..params import Params

FORMAT_VERSION = 2


def params_fingerprint(params: Params) -> str:
    """Content hash of the NON-DEFAULT params fields.

    Defaults-aware on purpose: a field sitting at its dataclass default
    is omitted from the payload, so ADDING a new knob to Params (at a
    default that reproduces the old physics) does not invalidate every
    existing checkpoint and durable record — the b0_gradient extension
    would otherwise have refused to resume every pre-extension run
    despite bit-identical physics.  A field moved OFF its default still
    changes the fingerprint, which is the contract that matters."""
    fields = {f.name: f.default for f in dataclasses.fields(params)}
    payload = json.dumps(
        {k: v for k, v in dataclasses.asdict(params).items()
         if not (k in fields and v == fields[k])},
        sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def scene_fingerprint(scene) -> str:
    """Content hash of the geometry the walkers move through.  With
    user-provided scenes (--scene-file, scene.CustomBox) the
    (params, scene_seed) pair no longer determines the geometry, so a
    resume must check the arrays themselves — a different cells file
    would otherwise silently continue the walk in a different box."""
    h = hashlib.sha256()
    for arr in (scene.cells, scene.mnps, scene.waters):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(path: str, state: WalkerState, params: Params,
                    seed: int, scene_seed: int,
                    engine: str = "", rng_impl: str = "",
                    scene_fp: str = "", extra: dict = None) -> None:
    """Atomic: writes to a temp file in the same directory and renames,
    so a process death mid-save can never leave a torn checkpoint (the
    elastic-recovery re-run contract depends on the file being either
    the old intact snapshot or the new one, engine/resilience.py).

    ``extra``: additional arrays stored alongside the walker state in
    the SAME atomic file (namespaced ``x_<key>``) — e.g. the streaming-
    plane state of a durable ``--stream-plane`` run, whose consistency
    with the walker state is then structural, not an ordering
    discipline.  Read back with :func:`load_extra`."""
    import tempfile
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    _write_npz(
        tmp,
        **{f"x_{k}": np.asarray(v) for k, v in (extra or {}).items()},
        version=FORMAT_VERSION,
        pos=np.asarray(state.pos),
        in_cell=np.asarray(state.in_cell),
        phase=np.asarray(state.phase),
        phase_comp=np.asarray(state.phase_comp),
        step=np.asarray(state.step),
        escapes=np.asarray(state.escapes),
        coverage=np.asarray(getattr(state, "coverage", 0)),
        seed=seed,
        scene_seed=scene_seed,
        params_fp=params_fingerprint(params),
        # the RNG implementation and engine are part of the random
        # sequence's identity: resuming under another generator (e.g.
        # a checkpoint recorded with a retired 'hardware' stream)
        # would continue a DIFFERENT sequence — exactly the silent
        # divergence the fingerprint exists to stop
        engine=engine,
        rng_impl=rng_impl,
        # geometry content hash: (params, scene_seed) no longer pins
        # the scene once --scene-file geometries exist
        scene_fp=scene_fp,
    )
    os.replace(tmp, path)


def _write_npz(path: str, **arrays) -> None:
    # write through a file object: np.savez on a *name* without .npz
    # appends the suffix, which would break the temp-file rename
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_checkpoint(path: str, params: Params,
                    dtype=jnp.float32, engine: str = "",
                    rng_impl: str = "",
                    scene_fp: str = "") -> Tuple[WalkerState, int, int]:
    """Returns (state, seed, scene_seed); raises on params mismatch, and
    on engine / rng_impl / scene-content mismatch when both sides
    recorded one (pass the resuming runner's values; empty string skips
    the check)."""
    z = np.load(path)
    if int(z["version"]) not in (1, FORMAT_VERSION):
        raise ValueError(f"unknown checkpoint version {z['version']}")
    fp = str(z["params_fp"])
    want = params_fingerprint(params)
    if fp != want:
        raise ValueError(
            f"checkpoint was written with different parameters "
            f"(fingerprint {fp} != {want}); refusing to resume")
    for name, ours in (("engine", engine), ("rng_impl", rng_impl)):
        theirs = str(z[name]) if name in z.files else ""
        if ours and theirs and ours != theirs:
            raise ValueError(
                f"checkpoint was written under {name}={theirs!r} but is "
                f"being resumed under {name}={ours!r}; the random "
                f"sequence would silently diverge — resume with the "
                f"original {name}")
    theirs = str(z["scene_fp"]) if "scene_fp" in z.files else ""
    if scene_fp and theirs and scene_fp != theirs:
        raise ValueError(
            f"checkpoint was written for a different scene (geometry "
            f"hash {theirs} != {scene_fp}); the walk would silently "
            f"continue in a different box — resume with the original "
            f"scene (same --scene-file / scene seed)")
    state = WalkerState(
        pos=jnp.asarray(z["pos"], dtype),
        in_cell=jnp.asarray(z["in_cell"], bool),
        phase=jnp.asarray(z["phase"], dtype),
        phase_comp=jnp.asarray(z["phase_comp"], dtype),
        step=jnp.uint32(z["step"]),
        escapes=jnp.int32(z["escapes"]),
        coverage=jnp.int32(z["coverage"]) if "coverage" in z.files
        else jnp.int32(0),
    )
    return state, int(z["seed"]), int(z["scene_seed"])


def load_extra(path: str) -> dict:
    """The ``extra`` arrays a checkpoint was saved with (empty dict if
    none) — the counterpart of ``save_checkpoint(extra=...)``."""
    with np.load(path) as z:
        return {k[2:]: z[k] for k in z.files if k.startswith("x_")}
