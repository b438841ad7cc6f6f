"""Benchmark: walker-steps/sec on the reference headline config.

Runs the production chunk kernel on the reference workload (4032 waters,
270 cells, full dipole phase accumulation, Carr-Purcell flips) on one GPU
and prints ONE JSON line:

    {"metric": "walker_steps_per_sec_per_chip", "value": ..., "unit":
     "walker-steps/s", "vs_baseline": ..., "detail": {"device": ...}}

vs_baseline is the speedup over the reference's Tesla K40 throughput of
~1.9e8 walker-steps/s (README.md:16: 4032 waters x 4e7 steps in ~14 min;
BASELINE.md).  Installed as the ``mri-t2-bench`` console script; the
repo-root ``bench.py`` shim keeps the driver contract.  Exits non-zero
without a GPU: a rate measured anywhere else is not this program's rate.
"""

import json
import subprocess
import sys
import time

import numpy as np

K40_BASELINE = 1.9e8  # walker-steps/s (BASELINE.md, derived README.md:16)


def device_info() -> dict:
    """The device as JAX reports it, plus nvidia-smi's name and power
    limit (a card set below its maximum runs slower under load)."""
    import jax
    d = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "unavailable"
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def main():
    import jax
    from mri_nanoparticle_simulation_tpu.utils.cache import \
        enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from mri_nanoparticle_simulation_tpu import rng
    from mri_nanoparticle_simulation_tpu.engine import (pallas_engine,
                                                        reference_engine)
    from mri_nanoparticle_simulation_tpu.params import Params
    from mri_nanoparticle_simulation_tpu.scene import BacteriaBox

    if not pallas_engine.on_gpu():
        print(f"benchmark needs an NVIDIA GPU; this process runs on "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 1
    # chunk=4000/K=5 is the smallest DETERMINISTICALLY certified coverage
    # configuration for this scene (covering-lattice bound = 5 exactly,
    # expansion.validate_near_k)
    p = Params(chunk_steps=4000, near_k=5, sprint_steps=200_000).validate()
    sc = BacteriaBox(p, seed=42).populate()
    mnp_pos = jnp.asarray(np.asarray(sc.mnps[:, :3], np.float32))
    mnp_M = jnp.asarray(np.asarray(sc.mnps[:, 4], np.float32))
    k = rng.key_from_seed(7)
    key_arr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
    sprint = pallas_engine.make_sprint_fn(p, p.num_water, jnp.float32)
    ps = pallas_engine.to_planes(
        reference_engine.init_state(sc.waters, p, jnp.float32), p)

    t0 = time.perf_counter()
    ps, wins = sprint(mnp_pos, mnp_M, key_arr, ps, 0)
    jax.block_until_ready((ps, wins))
    compile_s = time.perf_counter() - t0

    n_sprints = 10
    t0 = time.perf_counter()
    for _ in range(n_sprints):
        ps, wins = sprint(mnp_pos, mnp_M, key_arr, ps, 0)
    jax.block_until_ready((ps, wins))
    wall = time.perf_counter() - t0

    rate = n_sprints * p.sprint_steps * p.num_water / wall
    print(json.dumps({
        "metric": "walker_steps_per_sec_per_chip",
        "value": rate,
        "unit": "walker-steps/s",
        "vs_baseline": rate / K40_BASELINE,
        "detail": {
            "config": "4032 waters x 270 cells, dipole phase accumulation,"
                      " CP flips (reference headline workload)",
            "device": device_info(),
            "engine": "pallas",
            "sprints_timed": n_sprints,
            "first_sprint_s_with_compile": compile_s,
            "projected_full_run_s": p.t * p.num_water / rate,
            "k40_full_run_s": 840.0,
            "sum_cos_per_walker": float(np.asarray(wins)[-1, 0])
            / p.num_water,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
