"""Point-dipole B_z field and its spatial derivatives.

The physics kernel of the whole simulation: each cell carries a point
magnetic dipole, and a walker at displacement (dx, dy, dz) [µm] from a
dipole of moment M feels

    B_z = M * 1e11 * (2 dz^2 - dx^2 - dy^2) / |r|^5     [Tesla]

(reference: Octree::dipole_field, src/octree.cpp:206-210).  The GPU query
path additionally zeroes the field within ``cell_r`` of the dipole — the
intracellular field is modeled by the separate phase-kick mechanism
(``dipole_field`` at src/cuda_sim.cu:107-114).  Because every dipole closer
than ``cell_r`` to a query point is always in the evaluating walker's exact
near list (see fields/expansion.py), the masked form is the single source
of truth for the field the simulation integrates.

The closed-form gradient and Hessian below power the far-field Taylor
expansion; they are validated against ``jax.grad`` in tests/test_fields.py.
All functions are plain jnp and run unchanged inside Pallas kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

#: unit conversion baked into the reference formula (octree.cpp:209)
FIELD_SCALE = 1e11


def dipole_bz(dx, dy, dz, M):
    """Unmasked dipole B_z (octree.cpp:206-210). Inputs broadcast."""
    r2 = dx * dx + dy * dy + dz * dz
    # 1/r^5 via sqrt+multiplies: exactly rounded ops, unlike transcendental
    # pow (XLA CPU f64 pow(x, -2.5) shows ~1e-8 relative error).
    inv_r5 = 1.0 / (r2 * r2 * jnp.sqrt(r2))
    return M * FIELD_SCALE * (2 * dz * dz - dx * dx - dy * dy) * inv_r5


def dipole_bz_masked(dx, dy, dz, M, cell_r):
    """GPU-query dipole B_z: zero within cell_r (cuda_sim.cu:107-114).

    Division-safe at r -> 0 (the reference relies on IEEE inf*0; we clamp).
    """
    r2 = dx * dx + dy * dy + dz * dz
    outside = r2 > cell_r * cell_r
    safe_r2 = jnp.where(outside, r2, jnp.ones_like(r2))
    rs = jnp.sqrt(safe_r2)
    inv_r5 = 1.0 / (safe_r2 * safe_r2 * rs)
    val = M * FIELD_SCALE * (2 * dz * dz - dx * dx - dy * dy) * inv_r5
    return jnp.where(outside, val, jnp.zeros_like(val))


def dipole_bz_grad(dx, dy, dz, M):
    """Analytic gradient of the unmasked dipole B_z wrt the field point.

    With u = r^2 - 5 dz^2 and v = 3 r^2 - 5 dz^2:
        dB/dx = 3 M' dx u / r^7
        dB/dy = 3 M' dy u / r^7
        dB/dz = 3 M' dz v / r^7
    """
    m = M * FIELD_SCALE
    r2 = dx * dx + dy * dy + dz * dz
    inv_r7 = 1.0 / (r2 * r2 * r2 * jnp.sqrt(r2))
    u = r2 - 5 * dz * dz
    v = 3 * r2 - 5 * dz * dz
    gx = 3 * m * dx * u * inv_r7
    gy = 3 * m * dy * u * inv_r7
    gz = 3 * m * dz * v * inv_r7
    return gx, gy, gz


def dipole_bz_hessian(dx, dy, dz, M):
    """Analytic Hessian (xx, yy, zz, xy, xz, yz) of the unmasked dipole B_z.

        H_xx = 3 M' (u + 2 dx^2 - 7 dx^2 u / r^2) / r^7
        H_yy = 3 M' (u + 2 dy^2 - 7 dy^2 u / r^2) / r^7
        H_zz = 3 M' (v - 4 dz^2 - 7 dz^2 v / r^2) / r^7
        H_xy = 3 M' dx dy (2 - 7 u / r^2) / r^7
        H_xz = 3 M' dx dz (-8 - 7 u / r^2) / r^7
        H_yz = 3 M' dy dz (-8 - 7 u / r^2) / r^7

    Traceless (B_z is harmonic away from the dipole) — asserted in tests.
    """
    m3 = 3 * M * FIELD_SCALE
    r2 = dx * dx + dy * dy + dz * dz
    inv_r2 = 1.0 / r2
    inv_r7 = 1.0 / (r2 * r2 * r2 * jnp.sqrt(r2))
    u = r2 - 5 * dz * dz
    v = 3 * r2 - 5 * dz * dz
    u_r2 = 7 * u * inv_r2
    hxx = m3 * (u + 2 * dx * dx - dx * dx * u_r2) * inv_r7
    hyy = m3 * (u + 2 * dy * dy - dy * dy * u_r2) * inv_r7
    hzz = m3 * (v - 4 * dz * dz - 7 * dz * dz * v * inv_r2) * inv_r7
    hxy = m3 * dx * dy * (2 - u_r2) * inv_r7
    hxz = m3 * dx * dz * (-8 - u_r2) * inv_r7
    hyz = m3 * dy * dz * (-8 - u_r2) * inv_r7
    return hxx, hyy, hzz, hxy, hxz, hyz


def total_field_masked(pos, mnp_pos, mnp_M, cell_r):
    """Explicit masked dipole sum — the exact field the reference GPU
    integrates (get_field semantics, cuda_sim.cu:269-286, with every dipole
    treated at full precision).  O(n_pos * n_mnp); used by the expansion
    builder, the field-grid builder, and as the oracle in accuracy tests.

    pos: [..., 3]; mnp_pos: [N, 3]; mnp_M: [N].  Returns [...] B_z in Tesla.
    """
    d = pos[..., None, :] - mnp_pos  # [..., N, 3]
    return jnp.sum(
        dipole_bz_masked(d[..., 0], d[..., 1], d[..., 2], mnp_M, cell_r),
        axis=-1)
