"""Multi-device execution: walker sharding, ensembles, the pod layout.

The reference is single-GPU; its multi-trial story was resubmitting PBS
jobs (SURVEY §5).  Here walkers shard over a `jax.sharding.Mesh` with
per-window magnetization `psum`med across devices, trials map across
mesh axes, and the two compose into the 2D (trials x walkers) layout —
all with GLOBAL Threefry lanes, so every layout produces bitwise the
same physics as a single device (that is the tested contract, not an
aspiration: see __graft_entry__.dryrun_multichip and
tests/test_parallel.py).

This demo runs on 8 VIRTUAL CPU devices so it works anywhere; on a
multi-GPU host the same code runs unchanged over the real mesh.
Multi-HOST execution (one process per host) is the same API through
parallel/distributed.py: initialize(), then run_simulation_multihost /
run_ensemble_multihost / run_decomposition_multihost; a 2-process
dry run is built into __graft_entry__.dryrun_multihost.
"""

import os

# must happen before jax initializes its backends
os.environ.setdefault("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
import jax
import numpy as np

from mri_nanoparticle_simulation_tpu.engine import reference_engine
from mri_nanoparticle_simulation_tpu.parallel import run_ensemble, sharding
from mri_nanoparticle_simulation_tpu.params import small_test_params
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox

n_dev = len(jax.devices())
print(f"devices: {n_dev} x {jax.devices()[0].platform}")
# moment boosted so the 2000-step demo curve visibly dephases
params = small_test_params(num_water=256, num_cells=16, mmoment=3.5e-13)
scene = BacteriaBox(params, seed=1).populate()

# --- 1. walker sharding: one population over the whole mesh ----------
mesh = sharding.make_walker_mesh()
times, cos_sh, sin_sh, st = sharding.run_simulation_sharded(
    scene, params, mesh=mesh, seed=0)
# bitwise contract vs a single device (CLI: --shard-walkers)
_, cos_1, _, st_1 = reference_engine.run_simulation(scene, params, seed=0)
print(f"sharded over {mesh.shape[sharding.WALKER_AXIS]} devices; "
      f"positions bitwise-equal to 1 device:",
      np.array_equal(np.asarray(st.pos), np.asarray(st_1.pos)))

# --- 2. trial parallelism: an ensemble as ONE device computation -----
# (CLI: --ensemble 8; the mesh right-sizes itself to the trial count)
times, cos_e, sin_e, _ = run_ensemble(params, n_trials=4, base_seed=0,
                                      run_seed=100)
curve = cos_e.mean(axis=0) / params.num_water
print(f"4-trial ensemble curve: m(t_end) = {curve[-1]:+.4f} "
      f"+- {cos_e[:, -1].std(ddof=1) / params.num_water:.4f}")

# --- 3. the 2D layout: trials x walker shards on one mesh ------------
# trials across one mesh axis, each trial's walkers sharded over the
# other axis; curves bitwise-equal to the trial-parallel
# run (CLI: --ensemble 4 --walker-shards 2)
_, cos_2d, _, _ = run_ensemble(params, n_trials=4, base_seed=0,
                               run_seed=100, walker_shards=2)
print("2D (trials x walkers) mesh matches the trial-parallel curves:",
      np.allclose(cos_2d, cos_e, atol=1e-3))
