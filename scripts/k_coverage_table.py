"""Generate the K-vs-scene coverage table (ACCURACY.md §near-list sizing).

For each scene family (reference, clustered, dense, large-cell) and chunk
size, reports the validated worst-case near-list demand K* =
validate_near_k(...) at the default 7-sigma travel bound — the
expansion's analogue of the reference octree's adaptive depth
(octree.cpp:262-297).  Kernel cost is linear in K, so this table IS the
cost model for pathological scenes.

Run:  JAX_PLATFORMS=cpu python scripts/k_coverage_table.py
"""

import sys

import numpy as np

from mri_nanoparticle_simulation_tpu.fields import expansion
from mri_nanoparticle_simulation_tpu.params import Params
from mri_nanoparticle_simulation_tpu.scene import BacteriaBox
from mri_nanoparticle_simulation_tpu.scene.box import ClusteredBacteriaBox


def main():
    rows = []
    scenes = {
        "reference (270 cells, r=0.55, 30um box)":
            lambda p: BacteriaBox(p, seed=42),
        "dense 2x (540 cells)":
            lambda p: BacteriaBox(p.replace(num_cells=540), seed=42),
        "dense 4x (1080 cells)":
            lambda p: BacteriaBox(p.replace(num_cells=1080), seed=42),
        "large cells (2x cell_r=1.1, 135 cells)":
            lambda p: BacteriaBox(
                p.replace(cell_r=1.1, num_cells=135, max_neighbors=24),
                seed=42),
        "clustered (270 cells, 12 clumps sigma=2um)":
            lambda p: ClusteredBacteriaBox(p, seed=42, n_clusters=12,
                                           cluster_sigma=2.0),
        "clustered tight (270 cells, 8 clumps sigma=1.5um)":
            lambda p: ClusteredBacteriaBox(p, seed=42, n_clusters=8,
                                           cluster_sigma=1.5),
    }
    chunks = (1000, 2000, 4000)
    print("| scene | " + " | ".join(f"K* @ chunk={c}" for c in chunks)
          + " |")
    print("|---|" + "---|" * len(chunks))
    for name, make in scenes.items():
        ks = []
        for c in chunks:
            p = Params(chunk_steps=c, sprint_steps=20000,
                       max_neighbors=48).validate()
            try:
                sc = make(p).populate()
            except ValueError as e:
                ks.append(f"n/a ({e})")
                continue
            k = expansion.validate_near_k(sc.mnps[:, :3], p,
                                          n_probe=200_000)
            ks.append(str(k))
        print(f"| {name} | " + " | ".join(ks) + " |")
        sys.stdout.flush()
    return rows


if __name__ == "__main__":
    main()
