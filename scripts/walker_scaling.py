"""Single-GPU walker-count scaling of the production engine.

Measures steady-state walker-steps/s on the reference scene (270 cells,
in-kernel field-model rebuild) as the walker population grows — the
memory-bound axis the reference capped at ~8-10k walkers on a 12 GB K40
(README.md:48: 3.9 GB of RNG/trajectory buffers at 4032).  Here state is
O(num_water) and one walker runs per GPU thread, so small populations
leave most of the card idle and the rate grows with the population until
the card is full.

Usage: python scripts/walker_scaling.py   (needs a GPU)
Prints a markdown table.
"""

import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from mri_nanoparticle_simulation_tpu.utils.cache import \
        enable_compile_cache
    enable_compile_cache()
    from mri_nanoparticle_simulation_tpu import rng
    from mri_nanoparticle_simulation_tpu.engine import (pallas_engine,
                                                        reference_engine)
    from mri_nanoparticle_simulation_tpu.params import Params
    from mri_nanoparticle_simulation_tpu.scene import BacteriaBox

    print("| walkers | walker-steps/s | steps/s/walker |")
    print("|---|---|---|")
    for w in [4032, 16384, 49152, 100_000, 200_000]:
        p = Params(num_water=w, chunk_steps=4000, near_k=5,
                   sprint_steps=20000).validate()
        sc = BacteriaBox(p, seed=42).populate()
        mnp_pos = jnp.asarray(sc.mnps[:, :3], jnp.float32)
        mnp_M = jnp.asarray(sc.mnps[:, 4], jnp.float32)
        k = rng.key_from_seed(7)
        key_arr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
        state = reference_engine.init_state(sc.waters, p, jnp.float32)
        sprint = pallas_engine.make_sprint_fn(p, w, jnp.float32)
        ps = pallas_engine.to_planes(state, p)
        ps, wins = sprint(mnp_pos, mnp_M, key_arr, ps, 0)
        jax.block_until_ready((ps, wins))
        # enough sprints for >= 1 s of device time at the expected rate
        n = max(10, int(2e10 / (p.sprint_steps * w)))
        t0 = time.perf_counter()
        for _ in range(n):
            ps, wins = sprint(mnp_pos, mnp_M, key_arr, ps, 0)
        jax.block_until_ready((ps, wins))
        wall = time.perf_counter() - t0
        rate = n * p.sprint_steps * w / wall
        print(f"| {w} | {rate:.3e} | {rate / w:.3e} |", flush=True)


if __name__ == "__main__":
    main()
