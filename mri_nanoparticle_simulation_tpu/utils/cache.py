"""Persistent caches: XLA compilation, serialized sprint executables
(engine/aot.py) and coverage certificates.

All three live in one directory: ``JAX_COMPILATION_CACHE_DIR`` when it is
set (JAX reads that variable itself, so no other directory is set in
code), otherwise the fixed ``<checkout>/.jax_cache`` — a fixed path,
because the path is part of JAX's cache key and a moving directory never
hits.

The coverage-certificate cache plays the compile cache's role for the
host-side covering-lattice proofs (fields/expansion.validate_near_k and
validate_cube_candidates): the certified bound depends only on the
dipole positions and the reach radius, both fully deterministic, so the
lattice sweep is a one-time cost per scene rather than a per-run tax on
the CLI's wall clock.
"""

import hashlib
import os
import tempfile

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def _default_dir() -> str:
    return os.environ.get(ENV_VAR) or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache in :func:`_default_dir`
    and return that directory."""
    import jax

    path = _default_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def certificate_get(kind: str, key_bytes: bytes) -> int | None:
    """Look up a previously proven integer certificate (e.g. the
    covering-lattice near-K bound) by content hash.  Returns None on any
    miss or I/O problem — the caller then recomputes the proof."""
    h = hashlib.sha256(key_bytes).hexdigest()[:32]
    path = os.path.join(_default_dir(), "certs", f"{kind}-{h}.txt")
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def certificate_put(kind: str, key_bytes: bytes, value: int) -> None:
    """Record a proven certificate; atomic (tmp+rename), best-effort."""
    h = hashlib.sha256(key_bytes).hexdigest()[:32]
    d = os.path.join(_default_dir(), "certs")
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d)
        with os.fdopen(fd, "w") as f:
            f.write(str(int(value)))
        os.replace(tmp, os.path.join(d, f"{kind}-{h}.txt"))
    except OSError:
        pass
