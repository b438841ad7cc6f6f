"""Per-cube far-field Taylor tables — hierarchical far-field caching.

This mirrors the *hierarchy* of the reference's adaptive
octree (src/octree.cpp:262-297): the octree kept distant dipoles cheap by
caching their summed B_z per leaf; here we cache, for every spatial cube
of the selection lattice (fields/expansion.py ``build_cache``), a
high-order Taylor expansion about the cube center of the total field of
every dipole **not** in that cube's candidate table.  A chunk rebuild then
touches only the ~C candidate dipoles (exact mid-range sums + near-list
selection) plus one polynomial shift, instead of summing all N dipoles —
O(C) instead of O(N) per walker-chunk, which is what makes multi-thousand
-dipole scenes run at reference-scene speed.

Correctness structure (one exact partition, one controlled approximation):

* every dipole is in exactly one of {near list, mid sums, far table} —
  near = K nearest (subset of the cube candidates), mid = candidates
  minus near, table = everything minus candidates, excluded **by index**
  at table build time;
* the only approximation is the table's truncated Taylor series.  Its
  convergence ratio is (half-diagonal + travel) / r_min, where r_min is
  the distance from the cube center to the nearest *non-candidate*
  dipole — by construction the candidate table holds the C nearest, so
  r_min grows with C.  Measured on the 2000-cell scale-up scene
  (cube_candidates=32, order 5): b0 error 1.6e-3 of the far component's
  rms — i.e. ~1e-4 of the total field — far below the <1% curve target,
  and validated by tests/test_fields.py::TestFarTable.

Coefficients are produced by nested ``jax.jacfwd`` over the closed-form
dipole field (fields/dipole.py) — correct by construction at any order,
no hand-derived high-order derivatives.  Built once per scene (dipoles
never move).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from . import dipole


@functools.lru_cache(maxsize=16)
def monomials(order: int) -> tuple:
    """All (i, j, k) exponent triples with i+j+k <= order, grouped by
    total degree (the coefficient layout of the table's last axis)."""
    out = []
    for p in range(order + 1):
        for i in range(p, -1, -1):
            for j in range(p - i, -1, -1):
                out.append((i, j, p - i - j))
    return tuple(out)


def n_coeffs(order: int) -> int:
    return len(monomials(order))


def cube_centers(h: int, bound: float) -> np.ndarray:
    """[H^3, 3] cube-center lattice matching expansion.build_cache's
    flat index order ((ix * H + iy) * H + iz)."""
    cube = bound / h
    ax = (np.arange(h) + 0.5) * cube
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                    -1).reshape(-1, 3)


def build_far_table(mnp_pos, mnp_M, cand_idx, h: int, bound: float,
                    order: int):
    """[H^3, n_coeffs(order)] Taylor coefficients (monomial basis, 1/a!
    folded in) of the beyond-candidates field about each cube center.

    cand_idx: [H^3, C] int32 global dipole indices (build_cache payload
    column 4) — these dipoles are excluded from their cube's expansion.
    """
    return _build_far_table_jit(h, float(bound), order)(
        mnp_pos, mnp_M, cand_idx)


@functools.lru_cache(maxsize=16)
def _build_far_table_jit(h: int, bound: float, order: int):
    centers_np = cube_centers(h, bound)
    mons = monomials(order)

    @jax.jit
    def f(mnp_pos, mnp_M, cand_idx):
        n = mnp_pos.shape[0]
        centers = jnp.asarray(centers_np, mnp_pos.dtype)
        col = jnp.arange(n, dtype=jnp.int32)

        def f_single(center, mask):
            d = center[None, :] - mnp_pos
            return jnp.sum(
                dipole.dipole_bz(d[:, 0], d[:, 1], d[:, 2], mnp_M) * mask)

        # derivative tensors of increasing rank via nested forward-mode:
        # fns[p](center, mask) is the rank-p tensor of p-th partials
        fns = [f_single]
        for _ in range(order):
            fns.append(jax.jacfwd(fns[-1], argnums=0))

        def per_cube(center, idxrow):
            mask = jnp.all(idxrow[:, None] != col[None, :],
                           axis=0).astype(mnp_pos.dtype)
            tensors = [fn(center, mask) for fn in fns]
            coeffs = []
            for (i, j, k) in mons:
                p = i + j + k
                t = tensors[p]
                # the tensors are symmetric: any index permutation holds
                # the same partial; pick the sorted representative
                if p:
                    t = t[(0,) * i + (1,) * j + (2,) * k]
                coeffs.append(t / (math.factorial(i) * math.factorial(j)
                                   * math.factorial(k)))
            return jnp.stack(coeffs)

        # chunk the cube axis so the jacfwd tangent blow-up (~6^order x
        # the base [N] evaluation) never materializes for all H^3 cubes
        # at once
        n_cubes = h ** 3
        chunk = 128
        while n_cubes % chunk:
            chunk //= 2
        cs = centers.reshape(-1, chunk, 3)
        ci = cand_idx.reshape(-1, chunk, cand_idx.shape[-1])
        out = jax.lax.map(lambda a: jax.vmap(per_cube)(*a), (cs, ci))
        return out.reshape(n_cubes, len(mons))

    return f


def eval_far_table(coeffs, e, order: int):
    """Value, gradient and Hessian of the tabulated polynomial at offset
    ``e`` ([W, 3], walker anchor minus cube center).

    coeffs: [W, n_coeffs(order)] (already gathered per walker).
    Returns (b0 [W], grad [W, 3], hess [W, 6] in xx,yy,zz,xy,xz,yz order)
    — the same far-Taylor layout as expansion.NearField.
    """
    def pows(x):
        ps = [jnp.ones_like(x)]
        for _ in range(order):
            ps.append(ps[-1] * x)
        return ps

    px, py, pz = pows(e[..., 0]), pows(e[..., 1]), pows(e[..., 2])
    z = jnp.zeros_like(e[..., 0])
    b0, gx, gy, gz, hxx, hyy, hzz, hxy, hxz, hyz = (z,) * 10
    for t, (i, j, k) in enumerate(monomials(order)):
        c = coeffs[..., t]
        b0 = b0 + c * px[i] * py[j] * pz[k]
        if i:
            gx = gx + c * i * px[i - 1] * py[j] * pz[k]
        if j:
            gy = gy + c * j * px[i] * py[j - 1] * pz[k]
        if k:
            gz = gz + c * k * px[i] * py[j] * pz[k - 1]
        if i > 1:
            hxx = hxx + c * (i * (i - 1)) * px[i - 2] * py[j] * pz[k]
        if j > 1:
            hyy = hyy + c * (j * (j - 1)) * px[i] * py[j - 2] * pz[k]
        if k > 1:
            hzz = hzz + c * (k * (k - 1)) * px[i] * py[j] * pz[k - 2]
        if i and j:
            hxy = hxy + c * (i * j) * px[i - 1] * py[j - 1] * pz[k]
        if i and k:
            hxz = hxz + c * (i * k) * px[i - 1] * py[j] * pz[k - 1]
        if j and k:
            hyz = hyz + c * (j * k) * px[i] * py[j - 1] * pz[k - 1]
    return (b0, jnp.stack([gx, gy, gz], -1),
            jnp.stack([hxx, hyy, hzz, hxy, hxz, hyz], -1))
