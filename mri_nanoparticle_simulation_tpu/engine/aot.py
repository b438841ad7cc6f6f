"""AOT warm-start: skip trace+lower on repeat CLI runs.

The reference pays nvcc at every parameter change (README.md:13); we pay
jit once per process: client-side tracing and the chunk kernel's lowering
run on every CLI invocation, even when the XLA *compile* itself hits the
persistent compilation cache.  This module caches the serialized compiled
executable (jax.experimental.serialize_executable) keyed by everything
that could change the program — engine source files, params, walker
count, dtype, RNG implementation, jax version, device kind — so a repeat
run deserializes and loads the binary directly, skipping tracing entirely.

Scope: the single-device pallas production path only (no runtime
tcp/cell_r overrides, no scene cache, no mesh).  Everything else falls
back to the ordinary jit path; every failure mode here falls back too —
the cache is an accelerator, never a correctness dependency.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile

import jax
import numpy as np

from ..params import Params
from ..utils import cache as cache_mod

#: engine sources whose bytes feed the cache key: editing any file that
#: shapes the traced program must invalidate stale executables
_SOURCE_MODULES = (
    "engine/pallas_engine.py",
    "engine/reference_engine.py",
    "fields/expansion.py",
    "fields/fartable.py",
    "fields/dipole.py",
    "rng.py",
    "params.py",
    "parallel/ensemble.py",
    "parallel/sharding.py",
)


def _source_digest() -> bytes:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for rel in _SOURCE_MODULES:
        with open(os.path.join(root, rel), "rb") as f:
            h.update(f.read())
    return h.digest()


def _cache_key(params: Params, num_water: int, n_mnp: int, dtype,
               rng_impl: str) -> str:
    h = hashlib.sha256()
    h.update(_source_digest())
    h.update(repr(params).encode())
    h.update(f"{num_water}|{n_mnp}|{np.dtype(dtype).name}|{rng_impl}|"
             f"{jax.__version__}|"
             f"{jax.devices()[0].device_kind}".encode())
    return h.hexdigest()[:32]


def _path(key: str) -> str:
    return os.path.join(cache_mod._default_dir(), "aot", f"{key}.pkl")


def _wrap_compiled(compiled):
    """Sprint-shaped guard over a loaded executable.  The executable was
    lowered on (..., 0) with kwargs all None; the call must replicate
    that (args, kwargs) structure exactly, so runtime overrides are
    rejected rather than silently mis-bound."""
    def sprint(mnp_pos, mnp_M, key_arr, ps, lane_offset,
               cache=None, tcp=None, cell_r=None, d_scale=None,
               reflect=None):
        if cache is not None or tcp is not None or cell_r is not None \
                or d_scale is not None or reflect is not None:
            raise ValueError("AOT sprint supports the plain production "
                             "call only")
        return compiled(mnp_pos, mnp_M, key_arr, ps, lane_offset,
                        cache=None, tcp=None, cell_r=None, d_scale=None,
                        reflect=None)
    return sprint


def _load(key: str):
    """Deserialize the executable stored under ``key`` onto the default
    device: both cached programs run on one device, and JAX would
    otherwise bind a loaded executable to every local device."""
    with open(_path(key), "rb") as f:
        payload, in_tree, out_tree = pickle.load(f)
    from jax.experimental.serialize_executable import deserialize_and_load
    return deserialize_and_load(payload, in_tree, out_tree,
                                execution_devices=jax.devices()[:1])


def load_sprint(params: Params, num_water: int, n_mnp: int, dtype,
                rng_impl: str):
    """Return a sprint-shaped callable backed by a cached executable, or
    None on any miss/incompatibility (caller uses the jit path)."""
    try:
        compiled = _load(_cache_key(params, num_water, n_mnp, dtype,
                                    rng_impl))
    except Exception:
        return None
    return _wrap_compiled(compiled)


def _ensemble_key(params: Params, n_trials: int, n_mnp: int,
                  dtype, rng_impl: str) -> str:
    h = hashlib.sha256()
    h.update(b"ensemble|")
    h.update(_source_digest())
    h.update(repr(params).encode())
    h.update(f"{n_trials}|{n_mnp}|{np.dtype(dtype).name}|{rng_impl}|"
             f"{jax.__version__}|"
             f"{jax.devices()[0].device_kind}".encode())
    return h.hexdigest()[:32]


def load_ensemble_sprint(params: Params, n_trials: int, n_mnp: int,
                         dtype, rng_impl: str):
    """Ensemble/sweep analogue of :func:`load_sprint`: the compiled
    trial-mesh program (positional 7-argument call, no runtime-override
    kwargs — tcp/cell_r/d_scale are per-trial ARRAYS here, part of the
    traced signature).  None on any miss; caller keeps its jit."""
    try:
        return _load(_ensemble_key(params, n_trials, n_mnp, dtype,
                                   rng_impl))
    except Exception:
        return None


def compile_and_save_ensemble(jit_fn, params: Params, n_trials: int,
                              example_args: tuple, dtype,
                              rng_impl: str):
    """AOT-compile the ensemble sprint on its first real inputs and
    persist the executable; None if this build cannot be serialized."""
    n_mnp = int(example_args[0].shape[1])
    try:
        lowered = jit_fn.lower(*example_args)
        compiled = lowered.compile()
    except Exception:
        return None
    # persistence is best-effort: the trace + compile above is the
    # expensive part and the executable is valid either way — a
    # serialize/write failure (CPU backends, read-only cache) must not
    # force the caller's jit path into a SECOND identical compile
    try:
        from jax.experimental.serialize_executable import serialize
        payload, in_tree, out_tree = serialize(compiled)
        key = _ensemble_key(params, n_trials, n_mnp, dtype, rng_impl)
        d = os.path.dirname(_path(key))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d)
        with os.fdopen(fd, "wb") as f:
            pickle.dump((payload, in_tree, out_tree), f)
        os.replace(tmp, _path(key))
    except Exception:
        pass
    return compiled


def compile_and_save(jit_sprint, params: Params, num_water: int,
                     example_args: tuple, dtype, rng_impl: str):
    """AOT-compile ``jit_sprint`` (the inner PjitFunction) on
    ``example_args`` = (mnp_pos, mnp_M, key_arr, planes, lane_offset),
    persist the executable, and return a sprint-shaped callable over it.
    Returns None if this build cannot be serialized (caller keeps jit)."""
    n_mnp = int(example_args[0].shape[0])
    try:
        lowered = jit_sprint.lower(*example_args,
                                   cache=None, tcp=None, cell_r=None,
                                   d_scale=None, reflect=None)
        compiled = lowered.compile()
    except Exception:
        return None
    try:    # persistence is best-effort (see compile_and_save_ensemble)
        from jax.experimental.serialize_executable import serialize
        payload, in_tree, out_tree = serialize(compiled)
        key = _cache_key(params, num_water, n_mnp, dtype, rng_impl)
        d = os.path.dirname(_path(key))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d)
        with os.fdopen(fd, "wb") as f:
            pickle.dump((payload, in_tree, out_tree), f)
        os.replace(tmp, _path(key))
    except Exception:
        pass
    return _wrap_compiled(compiled)
