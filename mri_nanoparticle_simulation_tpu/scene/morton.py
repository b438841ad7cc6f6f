"""Morton (Z-order) codes for spatial sorting.

Replaces the reference's three 256-entry byte-interleave lookup tables
(src/octree.h:97-233, assembled bytewise at octree.cpp:37-72 and mirrored
to the GPU at cuda_sim.cu:129-161).  Here nothing in the hot loop needs
Morton codes — the octree they indexed is replaced by the chunked local
field expansion — but they are kept for:

* walker sorting at scene build (SimulationBox::sortWaters,
  SimulationBox.cpp:131-147), preserved for scene-API parity;
* spatially-coherent blocking utilities (useful when sharding very large
  walker populations so each chip's walkers are spatially clustered).

Implemented with the standard magic-number bit spreading rather than LUTs —
vectorizes cleanly in NumPy.
"""

from __future__ import annotations

import numpy as np


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are 2 zero bits between each."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_encode(ix, iy, iz) -> np.ndarray:
    """Interleave three integer grids into Morton codes.

    Bit order matches the reference LUTs: z occupies the least-significant
    bit of each triple, then y, then x (octree.h:97-233: morton_x entries
    are shifted left 2, morton_y left 1, morton_z unshifted).
    """
    ix = np.asarray(ix, np.uint64)
    iy = np.asarray(iy, np.uint64)
    iz = np.asarray(iz, np.uint64)
    return (_part1by2(ix) << np.uint64(2)) | (_part1by2(iy) << np.uint64(1)) \
        | _part1by2(iz)


def morton_code_positions(pos: np.ndarray, bound: float, depth: int) -> np.ndarray:
    """Morton code of each position at a given octree depth.

    Mirrors Octree::morton_code (octree.cpp:37-72): coordinates in
    [0, bound) are quantized to [0, 2**depth) and bit-interleaved.
    """
    size = float(2 ** depth)
    idx = np.floor(pos / bound * size).astype(np.uint64)
    idx = np.clip(idx, 0, 2 ** depth - 1)
    return morton_encode(idx[..., 0], idx[..., 1], idx[..., 2])


def morton_argsort(pos: np.ndarray, bound: float, depth: int = 7) -> np.ndarray:
    """Sort order of positions along a depth-``depth`` Z-curve.

    The reference sorts walkers by the Morton code of their *adaptive* octree
    leaf (SimulationBox.cpp:131-147), which interleaves leaf depth into the
    order; since walker order has no effect on the physics (only on GPU
    memory coalescing), we sort on a fixed-depth code.  ``kind='stable'``
    keeps the order deterministic.
    """
    return np.argsort(morton_code_positions(pos, bound, depth), kind="stable")
