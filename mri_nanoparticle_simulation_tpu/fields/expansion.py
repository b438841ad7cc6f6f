"""Chunked per-walker local field expansion — the replacement for the
reference's adaptive octree.

The reference accelerates field lookups with a CPU-built adaptive octree
(src/octree.{h,cpp}) deep-copied to the GPU (cuda_sim.cu:296-397): leaves
cache B_z at sub-octant centers, and dipoles near a leaf ("residents") are
excluded from the cache and summed exactly at query time
(octree.cpp:284-296, cuda_sim.cu:269-286).  Pointer-chasing a tree costs
divergent, dependent memory reads per step; this design exploits a fact
the reference leaves on the table: **over a few thousand 1-ns steps a
walker only travels ~0.1 µm** (rms; the Box-Muller tail caps a single
step at 5.8 sigma ~= 13 nm).  So instead of a global spatial structure queried per
step, each walker carries a tiny *chunk-local* model of the field, rebuilt
every ``chunk_steps`` steps at its current position ("anchor"):

* **near list** — the K nearest dipoles (positions + moments, gathered
  once per chunk), whose masked field is summed exactly each step: the
  analogue of octree residents, but per-walker and gather-free in the hot
  loop;
* **far Taylor** — a 2nd-order Taylor expansion (value, gradient,
  Hessian) about the anchor of the total field of all *other* dipoles,
  evaluated each step in ~25 flops: the analogue of the leaf B cache, but
  with controlled quadratic error instead of piecewise-constant error.

The same near list also answers the in-cell test (the reference's separate
nearest-cell hash table, cuda_sim.cu:453-485): a walker is inside a cell
iff its distance to one of the K nearest dipole centers is < cell_r, since
cells are disjoint and every dipole within cell_r of the walker is
necessarily among its K anchor-nearest (guaranteed by
``validate_near_k``).  One structure, zero gathers per step, O(num_water)
memory — versus the reference's 3.9 GB of trajectory buffers.

Everything is plain jnp: both engines call build() once per chunk, and
the chunk kernel evaluates the model per step with the same arithmetic
as evaluate().
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import Params
from ..utils import cache as cache_mod
from . import dipole, fartable


class SceneCache(NamedTuple):
    """Scene-constant selection + far-field tables for the large path.

    payload: [H^3, C, 5] per-cube candidate table (x, y, z, M, global idx)
    far_coeffs: [H^3, n_coeffs] per-cube Taylor table of the
        beyond-candidates field (fields/fartable.py), or None when the
        table is disabled (params.far_table_order == 0) — build() then
        computes exact far sums over all N dipoles instead.
    """
    payload: jnp.ndarray
    far_coeffs: jnp.ndarray | None


class NearField(NamedTuple):
    """Per-walker chunk-local field model (all leading dims = walkers)."""
    anchor: jnp.ndarray    # [W, 3] expansion point (chunk-start position)
    near_pos: jnp.ndarray  # [W, K, 3] K nearest dipole positions
    near_M: jnp.ndarray    # [W, K] their moments
    b0: jnp.ndarray        # [W] far-field B_z at anchor
    grad: jnp.ndarray      # [W, 3] far-field gradient at anchor
    hess: jnp.ndarray      # [W, 6] far-field Hessian (xx,yy,zz,xy,xz,yz)
    #: [W] count of dipoles within reach of the anchor, or None when the
    #: caller did not request the coverage sentinel (build(reach2=...)).
    #: Coverage is violated iff n_reach > K: the near list holds the K
    #: NEAREST dipoles, so by pigeonhole a count above K means a dipole
    #: that can matter this chunk is missing from it (the runtime
    #: analogue of the reference's DEBUG_TREE residency asserts,
    #: octree.cpp:39-41, 106-109, 141-144).
    n_reach: jnp.ndarray | None = None


def _pairwise_d2(a, b):
    """Pairwise squared distances as |a|^2 + |b|^2 - 2 a.b — one
    [A,3]x[3,B] matmul instead of materializing [A, B, 3] differences.
    The product is pinned to full f32 precision: a GPU may otherwise run
    an f32 matmul in TF32 (10-bit mantissa), which at |a|^2 ~ 1e3 µm^2
    (coordinates up to 30 µm) rounds by ~1 µm^2.  In f32 the
    cancellation noise is ~1e-4 µm^2; it only fuzzes the *selection
    order* of near-equidistant points (exact evaluation downstream
    recomputes true distances), which the K-slack absorbs."""
    an2 = jnp.sum(a * a, axis=-1)
    bn2 = jnp.sum(b * b, axis=-1)
    cross = jnp.dot(a, b.T, preferred_element_type=a.dtype,
                    precision=jax.lax.Precision.HIGHEST)
    return an2[:, None] + bn2[None, :] - 2.0 * cross


def _argmin_passes(d2, k, col=None):
    """K nearest columns per row via K masked argmin passes (K is small,
    so K passes beat a full top_k over [W, N]).  The passes run in
    bfloat16 — selection tolerates 0.4% distance fuzz
    for the K-slack reason — halving their HBM traffic."""
    n = d2.shape[1]
    if col is None:
        col = jnp.arange(n, dtype=jnp.int32)[None, :]
    remaining = d2.astype(jnp.bfloat16) if d2.dtype == jnp.float32 else d2
    idx_list = []
    for _ in range(k):
        j = jnp.argmin(remaining, axis=1).astype(jnp.int32)
        idx_list.append(j)
        remaining = jnp.where(col == j[:, None], jnp.inf, remaining)
    return jnp.stack(idx_list, axis=1), remaining


def uses_large_path(num_walkers: int, n_mnp: int) -> bool:
    """Policy: whether callers should precompute a cube-candidate cache
    (build() then takes the cube-pruned selection route).  Below this
    size (the reference scene) the full [W, N] selection is cheaper than
    building a cube table per sprint.  NOTE: engines auto-build
    the cache INSIDE the jitted sprint when none is passed, i.e. once per
    sprint call — long runs should precompute it once per scene
    (SimulationRunner does)."""
    return num_walkers * n_mnp > (1 << 24)


def build_cache(mnp_pos, mnp_M, params: Params,
                far_table: bool = True) -> SceneCache:
    """Scene-constant tables for large scenes: for each spatial cube,
    its C nearest dipoles (a superset of everything any walker in the cube
    can reach — validated by validate_cube_candidates) stored as a single
    [H^3, C, 5] payload of (x, y, z, M, global index), plus (when
    ``params.far_table_order > 0`` and ``far_table``) the per-cube Taylor
    table of the beyond-candidates field (fields/fartable.py).  One wide
    row gather per walker then replaces the per-element index gathers
    that dominate large-scene selection, and the far table caps the
    recandidate's dipole work at C instead of N.

    Build cost is one [H^3, N] distance matrix + C argmin passes (+ the
    jacfwd table sweep), paid once per scene.  The body is jitted (keyed
    on the cube geometry): run eagerly its ~C x 3 ops would each pay a
    dispatch.

    ``far_table=False`` skips the Taylor table regardless of params —
    used when build_cache runs *inside* a jitted sprint (the auto-build
    fallback), where the table would otherwise be rebuilt on device every
    sprint call; callers that want the table must precompute the cache
    once per scene (SimulationRunner does)."""
    h = params.cube_hash_dim
    c = min(params.cube_candidates, mnp_pos.shape[0])
    payload = _build_cache_jit(h, c, float(params.bound))(mnp_pos, mnp_M)
    coeffs = None
    if far_table and params.far_table_order > 0:
        cand_idx = payload[..., 4].astype(jnp.int32)
        coeffs = fartable.build_far_table(
            mnp_pos, mnp_M, cand_idx, h, float(params.bound),
            params.far_table_order)
    return SceneCache(payload=payload, far_coeffs=coeffs)


@functools.lru_cache(maxsize=32)
def _build_cache_jit(h: int, c: int, bound: float):
    cube = bound / h
    ax = (np.arange(h) + 0.5) * cube
    centers = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3)

    @jax.jit
    def f(mnp_pos, mnp_M):
        d2c = _pairwise_d2(jnp.asarray(centers, mnp_pos.dtype), mnp_pos)
        table, _ = _argmin_passes(d2c, c)               # [H^3, C]
        return jnp.concatenate(
            [mnp_pos[table],                            # [H^3, C, 3]
             mnp_M[table][..., None],
             table[..., None].astype(mnp_pos.dtype)], axis=-1)

    return f


def build(anchor, mnp_pos, mnp_M, params: Params,
          cache=None, reach2=None) -> NearField:
    """Select each walker's K nearest dipoles and Taylor-expand the rest.

    anchor: [W, 3] walker positions at chunk start.
    mnp_pos: [N, 3], mnp_M: [N] — all dipoles including periodic images
    (Scene.mnps).  Runs on device in XLA; cost O(W*N) per chunk (small
    scenes) or O(W*C + blocked sums) with a per-sprint cube table
    (``cache`` from build_cache), amortized to a few flops per
    walker-step.

    ``reach2`` (optional traced scalar, µm²): squared coverage reach
    ``(cell_r + travel_bound)²``.  When given, the returned NearField
    carries ``n_reach`` — the per-walker count of dipoles within reach —
    so engines can count coverage violations (n_reach > K) at runtime
    like they count travel-bound escapes.  Costs one compare+sum over
    the distance matrix the selection already computes.  On the cube
    path the count runs over the cube candidates, a validated superset
    of every within-reach dipole (validate_cube_candidates' covering
    margin), so the count is exact there too; the matmul distance
    form's ~1e-4 µm² rounding can flip borderline dipoles either way, which
    the travel bound's 7-sigma slack dwarfs.
    """
    k = params.near_k
    w = anchor.shape[0]
    n = mnp_pos.shape[0]
    if k > n:
        raise ValueError(
            f"near_k={k} exceeds the number of dipoles "
            f"({n}); selection would duplicate entries and "
            f"double-count their field")

    far_coeffs = None
    if isinstance(cache, SceneCache):
        far_coeffs = cache.far_coeffs
        cache = cache.payload

    # --- near selection -----------------------------------------------------
    far_mask = None
    if cache is not None:
        # cube-pruned selection: gather the walker's cube candidates
        # (a validated superset of everything reachable this chunk) and
        # pick K among those ~C instead of all N
        if k > cache.shape[-2]:
            raise ValueError(
                f"near_k={k} exceeds cube_candidates={cache.shape[-2]}; "
                f"selection would duplicate entries and double-count "
                f"their field")
        h = params.cube_hash_dim
        cube = params.bound / h
        ci = jnp.clip((anchor / cube).astype(jnp.int32), 0, h - 1)
        flat = (ci[:, 0] * h + ci[:, 1]) * h + ci[:, 2]
        # gather through a 2D view: XLA lowers a [H^3, C*5] row gather
        # ~2.4x faster than the equivalent [H^3, C, 5] gather (measured)
        payload = cache.reshape(cache.shape[0], -1)[flat] \
            .reshape(flat.shape[0], cache.shape[1], 5)  # [W, C, 5]
        cpos = payload[..., :3]
        dc = anchor[:, None, :] - cpos
        d2 = jnp.sum(dc * dc, axis=-1)                  # [W, C]
        n_reach = (jnp.sum(d2 < reach2, axis=1).astype(jnp.int32)
                   if reach2 is not None else None)
        # K argmin passes with the winner's payload row extracted by a
        # fused one-hot reduce per pass: XLA lowers take_along_axis on
        # [W, C, 5] to a serial gather that measured 3x the rest of the
        # selection combined; the one-hot extraction is bitwise-identical
        # and fuses into the pass's own compare/where.
        col = jnp.arange(d2.shape[1], dtype=jnp.int32)[None, :]
        remaining = d2.astype(jnp.bfloat16) if d2.dtype == jnp.float32 \
            else d2
        rows = []
        for _ in range(k):
            j = jnp.argmin(remaining, axis=1).astype(jnp.int32)
            onehot = col == j[:, None]
            rows.append(jnp.sum(
                jnp.where(onehot[..., None], payload, 0.0), axis=1))
            remaining = jnp.where(onehot, jnp.inf, remaining)
        sel = jnp.stack(rows, axis=1)                   # [W, K, 5]
        near_pos = sel[..., :3]                         # [W, K, 3]
        near_M = sel[..., 3]
        idx = sel[..., 4].astype(jnp.int32)             # global indices

        if far_coeffs is not None:
            # far = exact mid sums over the remaining candidates + the
            # per-cube Taylor table for everything beyond them.  Exact
            # partition: every dipole is counted once (near by selection,
            # mid by index exclusion, table by build-time index
            # exclusion); only the table term is an approximation
            # (fields/fartable.py docstring has the error analysis).
            order = params.far_table_order
            if far_coeffs.shape[-1] != fartable.n_coeffs(order):
                raise ValueError(
                    f"far table was built at a different order than "
                    f"params.far_table_order={order} "
                    f"({far_coeffs.shape[-1]} != "
                    f"{fartable.n_coeffs(order)} coefficients)")
            cidx = payload[..., 4].astype(jnp.int32)    # [W, C]
            mid = jnp.ones(cidx.shape, bool)
            for j in range(k):
                mid = mid & (cidx != idx[:, j:j + 1])
            # guard the closed forms at r -> 0 for the excluded (near)
            # entries; their weight is 0 but inf * 0 = nan
            dx = jnp.where(mid, dc[..., 0], 1.0)
            dy = jnp.where(mid, dc[..., 1], 1.0)
            dz = jnp.where(mid, dc[..., 2], 1.0)
            is_mid = mid.astype(anchor.dtype)
            cm = payload[..., 3]
            b0 = jnp.sum(dipole.dipole_bz(dx, dy, dz, cm) * is_mid, 1)
            g = jnp.stack(
                [jnp.sum(c * is_mid, 1)
                 for c in dipole.dipole_bz_grad(dx, dy, dz, cm)], -1)
            hs = jnp.stack(
                [jnp.sum(c * is_mid, 1)
                 for c in dipole.dipole_bz_hessian(dx, dy, dz, cm)], -1)
            e = anchor - (ci.astype(anchor.dtype) + 0.5) * cube
            tb0, tg, th = fartable.eval_far_table(far_coeffs[flat], e,
                                                  order)
            return NearField(anchor=anchor, near_pos=near_pos,
                             near_M=near_M, b0=b0 + tb0, grad=g + tg,
                             hess=hs + th, n_reach=n_reach)
    else:
        d2 = _pairwise_d2(anchor, mnp_pos)              # [W, N]
        n_reach = (jnp.sum(d2 < reach2, axis=1).astype(jnp.int32)
                   if reach2 is not None else None)
        idx, remaining = _argmin_passes(d2, k)
        near_pos = mnp_pos[idx]                         # [W, K, 3]
        near_M = mnp_M[idx]                             # [W, K]
        far_mask = jnp.isfinite(remaining)  # exactly the non-selected

    # --- far field -----------------------------------------------------------
    # Masked sum over all dipoles NOT in the near list.  We must not
    # compute it as (total - near): an anchor can sit arbitrarily close
    # to a near dipole, where the unmasked 1/r^3..1/r^7 terms reach Tesla
    # scale and their cancellation would wipe out the ~µT far field in f32.
    # Instead each contribution is weighted by an exclusion mask built from
    # the selected indices.
    if w * n <= (1 << 24):
        # small problems: single fused pass over [W, N]
        if far_mask is None:
            col = jnp.arange(n, dtype=jnp.int32)[None, :]
            far_mask = jnp.ones((w, n), bool)
            for j in range(k):
                far_mask = far_mask & (col != idx[:, j:j + 1])
        d = anchor[:, None, :] - mnp_pos[None, :, :]    # [W, N, 3]
        is_far = far_mask.astype(anchor.dtype)
        # guard the closed forms against r -> 0 at excluded dipoles: give
        # them a dummy displacement (their weight is 0, inf * 0 = nan).
        dx = jnp.where(far_mask, d[..., 0], 1.0)
        dy = jnp.where(far_mask, d[..., 1], 1.0)
        dz = jnp.where(far_mask, d[..., 2], 1.0)
        M = mnp_M[None, :]
        b0 = jnp.sum(dipole.dipole_bz(dx, dy, dz, M) * is_far, axis=1)
        g = jnp.stack([jnp.sum(c * is_far, axis=1)
                       for c in dipole.dipole_bz_grad(dx, dy, dz, M)], -1)
        h = jnp.stack([jnp.sum(c * is_far, axis=1)
                       for c in dipole.dipole_bz_hessian(dx, dy, dz, M)], -1)
    else:
        # large problems (the 100k-walker scale-up): accumulate over dipole
        # blocks so the [W, N]-sized intermediates never hit HBM whole
        b0, g, h = _far_sums_blocked(anchor, mnp_pos, mnp_M, idx)

    return NearField(anchor=anchor, near_pos=near_pos, near_M=near_M,
                     b0=b0, grad=g, hess=h, n_reach=n_reach)


def _far_sums_blocked(anchor, mnp_pos, mnp_M, near_idx, block: int = 512):
    """Far-field value/gradient/Hessian sums via a lax.scan over dipole
    blocks: carry is [W, 10] accumulators, per-iteration intermediates are
    [W, block]-shaped and fuse into the reductions instead of spilling
    tens of GB of [W, N] arrays.  Exclusion of the K selected dipoles is
    by index comparison (exact, immune to distance ties)."""
    w = anchor.shape[0]
    n = mnp_pos.shape[0]
    dtype = anchor.dtype
    pad = (-n) % block
    if pad:
        # far-away zero-moment padding can never contribute
        mnp_pos = jnp.concatenate(
            [mnp_pos, jnp.full((pad, 3), 1e6, dtype)])
        mnp_M = jnp.concatenate([mnp_M, jnp.zeros(pad, dtype)])
    nb = (n + pad) // block
    bpos = mnp_pos.reshape(nb, block, 3)
    bM = mnp_M.reshape(nb, block)
    bcol = jnp.arange(nb * block, dtype=jnp.int32).reshape(nb, block)

    ax, ay, az = anchor[:, 0:1], anchor[:, 1:2], anchor[:, 2:3]

    def body(acc, blk):
        pos_b, m_b, col_b = blk
        dx = ax - pos_b[None, :, 0]          # [W, B]
        dy = ay - pos_b[None, :, 1]
        dz = az - pos_b[None, :, 2]
        sel = jnp.zeros((w, block), bool)
        for j in range(near_idx.shape[1]):
            sel = sel | (col_b[None, :] == near_idx[:, j:j + 1])
        far = ~sel
        dx = jnp.where(far, dx, 1.0)
        dy = jnp.where(far, dy, 1.0)
        dz = jnp.where(far, dz, 1.0)
        is_far = far.astype(dtype)
        m = m_b[None, :]
        parts = [dipole.dipole_bz(dx, dy, dz, m)]
        parts += list(dipole.dipole_bz_grad(dx, dy, dz, m))
        parts += list(dipole.dipole_bz_hessian(dx, dy, dz, m))
        contrib = jnp.stack(
            [jnp.sum(c * is_far, axis=1) for c in parts], -1)  # [W, 10]
        return acc + contrib, None

    acc, _ = jax.lax.scan(body, jnp.zeros((w, 10), dtype), (bpos, bM, bcol))
    return acc[:, 0], acc[:, 1:4], acc[:, 4:10]


def evaluate(nf: NearField, pos, cell_r):
    """Field and cell residency at [W, 3] positions within the chunk.

    Returns (B [W] in Tesla, in_cell [W] bool, d2_min [W]).
    This is the per-step hot path: K fused masked dipole evaluations plus a
    10-coefficient Taylor evaluation — no memory gathers, no trees.
    """
    # exact masked near field + containment, fused over the K list
    d = pos[:, None, :] - nf.near_pos                   # [W, K, 3]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    d2 = dx * dx + dy * dy + dz * dz
    outside = d2 > cell_r * cell_r
    safe = jnp.where(outside, d2, jnp.ones_like(d2))
    inv_r5 = 1.0 / (safe * safe * jnp.sqrt(safe))
    contrib = nf.near_M * dipole.FIELD_SCALE * \
        (2 * dz * dz - dx * dx - dy * dy) * inv_r5
    b_near = jnp.sum(jnp.where(outside, contrib, 0.0), axis=-1)
    in_cell = jnp.any(~outside, axis=-1)
    d2_min = jnp.min(d2, axis=-1)

    # far-field Taylor about the anchor
    e = pos - nf.anchor                                 # [W, 3]
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    h = nf.hess
    b_far = (nf.b0
             + nf.grad[..., 0] * ex + nf.grad[..., 1] * ey
             + nf.grad[..., 2] * ez
             + 0.5 * (h[..., 0] * ex * ex + h[..., 1] * ey * ey
                      + h[..., 2] * ez * ez)
             + h[..., 3] * ex * ey + h[..., 4] * ex * ez
             + h[..., 5] * ey * ez)
    return b_near + b_far, in_cell, d2_min


def validate_cube_candidates(dipole_pos: np.ndarray, params: Params,
                             travel_bound: float | None = None) -> int:
    """Worst-case number of dipoles a cube's candidate table must hold:
    max over cube centers of dipoles within reach + cube half-diagonal.
    Callers raise if it exceeds params.cube_candidates (only relevant on
    the large-scene path)."""
    if travel_bound is None:
        travel_bound = default_travel_bound(params)
    h = params.cube_hash_dim
    cube = params.bound / h
    crit = params.cell_r + travel_bound + np.sqrt(3.0) * cube / 2.0
    pos = np.asarray(dipole_pos, np.float64)
    key = pos.tobytes() + np.float64(crit).tobytes() + \
        np.int64(h).tobytes() + b"cube_cand.v1"
    cached = cache_mod.certificate_get("cubec", key)
    if cached is not None:
        return cached
    ax = (np.arange(h) + 0.5) * cube
    centers = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3)
    counts = np.zeros(len(centers), np.int64)
    for c in pos:
        d2 = np.sum((centers - c) ** 2, axis=1)
        counts += d2 < crit * crit
    worst = int(counts.max())
    cache_mod.certificate_put("cubec", key, worst)
    return worst


def validate_near_k(dipole_pos: np.ndarray, params: Params,
                    travel_bound: float | None = None,
                    n_probe: int = 200_000, seed: int = 0) -> int:
    """Scene-level DETERMINISTIC guarantee for the near-list size K.

    Correctness requires: every dipole within ``cell_r + travel_bound`` of
    any chunk anchor is among that anchor's K nearest.  Sufficient
    condition: no point in the box has more than K dipoles within
    ``reach = cell_r + travel_bound``.  ``dipole_pos`` must be ALL
    dipoles **including periodic images** (Scene.mnps[:, :3]): near a box
    face, images compete for near-list slots and can crowd out the one
    base cell a walker is about to enter.

    Round 1-2 certified this by random probing ("observed maximum" over
    350k probes) — a sampled sufficient condition that could in principle
    miss a dense pocket.  This is now a PROVEN
    upper bound via a two-level covering lattice:

      For any continuous point x there is a lattice point l with
      |x - l| <= delta (half the lattice cell diagonal), so
      ball(x, reach) is contained in ball(l, reach + delta) and

          max_x count_reach(x)  <=  max_l count_{reach+delta}(l).

      Level 1 computes that bound on a coarse lattice; every coarse cell
      whose bound exceeds the level-1 *floor* (the max lattice-point
      count at exact reach, which is a lower bound on the true max) is
      re-covered with a fine lattice whose delta is ~reach/100,
      tightening the inflation to a sub-dipole-radius margin.  The
      returned value is a certified upper bound on the continuous max —
      if it equals the floor, it is exact.

    ``n_probe``/``seed`` are kept for API compatibility and ignored.
    """
    del n_probe, seed
    if travel_bound is None:
        travel_bound = default_travel_bound(params)
    reach = params.cell_r + travel_bound
    pos = np.asarray(dipole_pos, np.float64)
    key = pos.tobytes() + np.float64(reach).tobytes() + b"near_k.v1"
    cached = cache_mod.certificate_get("neark", key)
    if cached is not None:
        return cached
    worst = _max_count_bound(pos, reach, params.bound)
    cache_mod.certificate_put("neark", key, worst)
    return worst


def _counts_at(points: np.ndarray, dipole_pos: np.ndarray,
               radius: float) -> np.ndarray:
    """#{dipoles within radius} per point, via a dipole bin grid of cell
    size = radius (27-neighbor search): O(points * local density) instead
    of O(points * n_dipoles)."""
    if len(dipole_pos) <= 64:      # direct loop beats binning overhead
        counts = np.zeros(len(points), np.int64)
        for d in dipole_pos:
            d2 = np.sum((points - d) ** 2, axis=1)
            counts += d2 < radius * radius
        return counts
    c = radius
    dcell = np.floor(dipole_pos / c).astype(np.int64)
    lo = dcell.min(0) - 1
    dims = dcell.max(0) - lo + 3

    def code(cells):
        rel = cells - lo
        return (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]

    order = np.argsort(code(dcell), kind="stable")
    dsort = dipole_pos[order]
    dcode_s = code(dcell)[order]
    pcell = np.floor(points / c).astype(np.int64)
    counts = np.zeros(len(points), np.int64)
    r2 = radius * radius
    off = np.array([-1, 0, 1])
    for ox in off:
        for oy in off:
            for oz in off:
                ncell = pcell + np.array([ox, oy, oz])
                valid = np.all((ncell >= lo) & (ncell < lo + dims), axis=1)
                if not valid.any():
                    continue
                pt_idx = np.flatnonzero(valid)
                ncode = code(ncell[valid])
                s = np.searchsorted(dcode_s, ncode, "left")
                e = np.searchsorted(dcode_s, ncode, "right")
                lens = e - s
                total = int(lens.sum())
                if total == 0:
                    continue
                rep = np.repeat(np.arange(len(ncode)), lens)
                base = np.repeat(np.cumsum(lens) - lens, lens)
                didx = np.repeat(s, lens) + np.arange(total) - base
                d = points[pt_idx[rep]] - dsort[didx]
                within = np.einsum("ij,ij->i", d, d) < r2
                counts += np.bincount(pt_idx[rep][within],
                                      minlength=len(points))
    return counts


def _lattice_pass(dipole_pos: np.ndarray, reach: float, g: float,
                  batch: int = 512):
    """Exact dipole counts at every lattice point (spacing g) lying
    within reach + delta of any dipole, via one incidence histogram:
    each (dipole, nearby-lattice-point) pair is enumerated from a shared
    integer offset cube and bucketed by linear cell code — O(n_dipoles *
    ball volume), no point-wise neighbor search.  Dipoles are processed
    ``batch`` at a time so the [batch, C~3800, 3] candidate tensor stays
    ~50 MB regardless of scene size (a 30k-dipole clustered scene would
    otherwise peak at several GB); only the masked incidence codes
    (one int64 per in-ball pair, inherent to the histogram) accumulate.

    Returns (points [P, 3], counts_inflated [P] at radius reach+delta,
    counts_exact [P] at radius reach), delta = g*sqrt(3)/2."""
    delta = g * np.sqrt(3.0) / 2.0
    r_in = reach + delta
    base = np.floor(dipole_pos / g).astype(np.int64)        # [N, 3]
    n = int(np.ceil(r_in / g)) + 1
    offs = np.arange(-n, n + 1, dtype=np.int64)
    cube = np.stack(np.meshgrid(offs, offs, offs, indexing="ij"),
                    -1).reshape(-1, 3)
    # prefilter the shared cube: a lattice offset can only be within r_in
    # of a dipole whose in-cell fraction shifts it by < g*sqrt(3)
    keep = np.sum((cube * g) ** 2, axis=1) <= (r_in + g * np.sqrt(3)) ** 2
    cube = cube[keep]
    # global grid origin/extent from the dipole cells (covers every
    # candidate; decoded points add lo back so the choice is neutral)
    lo = base.min(0) - n
    dims = base.max(0) + n - lo + 1
    codes_in, codes_ex = [], []
    for i in range(0, len(base), batch):
        cand = base[i:i + batch, None, :] + cube[None]      # [B, C, 3]
        d = cand * g - dipole_pos[i:i + batch, None, :]
        d2 = np.sum(d * d, axis=-1)                         # [B, C]
        rel = cand - lo
        code = (rel[..., 0] * dims[1] + rel[..., 1]) * dims[2] \
            + rel[..., 2]
        codes_in.append(code[d2 < r_in * r_in])
        codes_ex.append(code[d2 < reach * reach])
    flat_in = np.concatenate(codes_in)
    occupied, inv = np.unique(flat_in, return_inverse=True)
    counts_inflated = np.bincount(inv, minlength=len(occupied))
    counts_exact = np.bincount(
        np.searchsorted(occupied, np.concatenate(codes_ex)),
        minlength=len(occupied))
    cz = occupied % dims[2]
    cy = (occupied // dims[2]) % dims[1]
    cx = occupied // (dims[1] * dims[2])
    pts = (np.stack([cx, cy, cz], -1) + lo) * g
    return pts, counts_inflated, counts_exact


def _max_count_bound(dipole_pos: np.ndarray, reach: float,
                     bound: float) -> int:
    """Certified upper bound on max_x #{dipoles within reach of x} —
    see validate_near_k for the covering argument.  Iteratively refines
    (lattice spacing /6 per round) around the points whose inflated
    bound still beats the exact floor; almost always converges to the
    floor (then the bound is exact).  ``bound`` (the box size) is unused:
    lattice points slightly outside the box still upper-bound interior
    positions, so no clipping is needed."""
    del bound
    g = max(reach / 6.0, 1e-3)
    pts, c_in, c_ex = _lattice_pass(dipole_pos, reach, g)
    floor = int(c_ex.max())
    hot = pts[c_in > floor]
    worst_bound = int(c_in.max())
    for _ in range(3):
        if not len(hot):
            return floor                 # bound meets floor: exact
        prev_delta = g * np.sqrt(3.0) / 2.0
        g = g / 6.0
        delta = g * np.sqrt(3.0) / 2.0
        new_hot = []
        worst_bound = floor
        # refine each hot point's prev_delta-neighborhood with local
        # dipoles only (every x that could beat the floor lies within
        # prev_delta of a hot point, by the covering induction)
        offs = np.arange(-(prev_delta + g), prev_delta + 2 * g, g)
        cube = np.stack(np.meshgrid(offs, offs, offs, indexing="ij"),
                        -1).reshape(-1, 3)
        for h in hot:
            d2h = np.sum((dipole_pos - h) ** 2, axis=1)
            local = dipole_pos[
                d2h <= (reach + delta + prev_delta + 2 * g) ** 2]
            fine = h[None] + cube
            ci = _counts_at(fine, local, reach + delta)
            ce = _counts_at(fine, local, reach)
            floor = max(floor, int(ce.max()))
            worst_bound = max(worst_bound, int(ci.max()))
            new_hot.append(fine[ci > floor])
        hot = np.concatenate(new_hot) if new_hot else np.zeros((0, 3))
        hot = hot[_counts_at(hot, dipole_pos, reach + delta) > floor] \
            if len(hot) else hot
    return worst_bound                   # still certified, conservative


def default_travel_bound(params: Params) -> float:
    """Per-chunk walker travel bound, µm: ``travel_sigmas`` sigma per axis
    (times sqrt(3) for the 3D norm).

    Per-axis displacement over ``chunk_steps`` is a random walk with
    sigma = out_stdev * sqrt(chunk_steps) (extracellular D dominates).
    By the reflection principle, P(max_t |axis| > s*sigma) <= 2 P(N > s),
    so P(any-time 3D excursion > s*sigma*sqrt(3)) <= 6 P(N > s).  At the
    default s = 7 that is ~8e-12 per walker-chunk, i.e. ~3e-4 expected
    escape events over the full reference run (4032 walkers x 1e4
    chunks) — and every escape is *counted* by the engines (the escapes
    metric), so a violated bound is observable, not silent.  The payoff
    for 7 instead of the looser 12 used in round 1 is a much smaller
    near list: at chunk_steps=4000 on the reference scene the worst-case
    K drops from 10 to 4 (validate_near_k), which is worth ~1.5x in the
    fused kernel.  Single steps are hard-capped at 5.8 sigma by the
    24-bit Box-Muller (rng.normal_from_bits).
    """
    sigma_axis = params.out_stdev * float(np.sqrt(params.chunk_steps))
    return float(params.travel_sigmas * sigma_axis * np.sqrt(3.0))
