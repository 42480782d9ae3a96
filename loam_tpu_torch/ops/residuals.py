"""Point-to-line / point-to-plane residuals and Gauss-Newton Jacobians
(counterpart of loam_tpu/ops/residuals.py).

The JAX package differentiates the residual scalars with jax.grad /
jacfwd; here the Jacobians are closed forms of the same functions,
built from the derivatives of the elementary rotations.  Points carry
any leading (scenario) axes, transforms the same leading axes or none.
"""

from __future__ import annotations

import torch

from ..parallel.context import constrain_axis0, constrain_rows, reduce_rows
from ..types import per_scenario
from ..utils import rotations
from ..utils.numerics import sqrt

_EPS = 1e-12


def point_to_line(p, p1, p2):
    """Distance and unit derivative direction from p to the line (p1, p2)
    (src/laserOdometry.cpp:534-562).  Returns (dir (..., 3), dist (...))."""
    d01 = p - p1
    d02 = p - p2
    d12 = p1 - p2
    cx = d01[..., 0] * d02[..., 1] - d02[..., 0] * d01[..., 1]
    cy = d01[..., 0] * d02[..., 2] - d02[..., 0] * d01[..., 2]
    cz = d01[..., 1] * d02[..., 2] - d02[..., 1] * d01[..., 2]
    a012 = sqrt(torch.clamp(cx * cx + cy * cy + cz * cz, min=_EPS))
    l12 = sqrt(torch.clamp((d12 * d12).sum(-1), min=_EPS))
    la = (d12[..., 1] * cx + d12[..., 2] * cy) / a012 / l12
    lb = -(d12[..., 0] * cx - d12[..., 2] * cz) / a012 / l12
    lc = -(d12[..., 0] * cy + d12[..., 1] * cz) / a012 / l12
    return torch.stack([la, lb, lc], -1), a012 / l12


def plane_from_tripod(p1, p2, p3):
    """Unit normal + offset through three points
    (src/laserOdometry.cpp:658-670)."""
    u = p2 - p1
    v = p3 - p1
    pa = u[..., 1] * v[..., 2] - v[..., 1] * u[..., 2]
    pb = u[..., 2] * v[..., 0] - v[..., 2] * u[..., 0]
    pc = u[..., 0] * v[..., 1] - v[..., 0] * u[..., 1]
    n = torch.stack([pa, pb, pc], -1)
    ps = sqrt(torch.clamp((n * n).sum(-1, keepdim=True), min=_EPS))
    n = n / ps
    return n, -(n * p1).sum(-1)


def point_to_plane(p, normal, pd):
    return (normal * p).sum(-1) + pd


def odom_point_jacobians(points, transform):
    """J_n = d T_start(p_n; theta, s=1) / d theta, shape (..., N, 3, 6),
    with T_start(p) = Ry(-ry) Rx(-rx) Rz(-rz) (p - t)."""
    rx, ry, rz = transform[..., 0], transform[..., 1], transform[..., 2]
    Ry, Rx, Rz = rotations.rot_y(-ry), rotations.rot_x(-rx), \
        rotations.rot_z(-rz)
    # d/da of rot(-a) is -drot(-a)
    dRy = -rotations.drot_y(-ry)
    dRx = -rotations.drot_x(-rx)
    dRz = -rotations.drot_z(-rz)
    M = Ry @ Rx @ Rz
    v = points - transform[..., None, 3:]
    cols = [v @ (Ry @ dRx @ Rz).mT, v @ (dRy @ Rx @ Rz).mT,
            v @ (Ry @ Rx @ dRz).mT]
    J_rot = torch.stack(cols, -1)                      # (..., N, 3, 3)
    J_t = (-M)[..., None, :, :].expand(J_rot.shape)
    return torch.cat([J_rot, J_t], -1)


def odom_jacobian_rows(points, coeffs, transform):
    """Rows d(coeff . T_start(p; theta, s=1))/d theta, (..., N, 6)."""
    J = odom_point_jacobians(points, transform)
    return (coeffs[..., :, None] * J).sum(-2)


def normal_equations_accumulated(J, C, b):
    """ata = sum_n J_n^T C_n J_n, atb = sum_n J_n^T b_n, for J
    (B, N, 3, 6), C (B, N, 3, 3), b (B, N, 3), one scenario at a time
    (types.per_scenario).  Under parallel.context.row_sharding each rank
    sums its block of the point axis and one all_reduce adds the
    blocks."""
    def one(J, C, b):
        CJ = torch.einsum("nab,nbj->naj", C, J)
        return (torch.einsum("nai,naj->ij", J, CJ),
                torch.einsum("nai,na->i", J, b))

    J, C, b = constrain_axis0(J), constrain_axis0(C), constrain_axis0(b)
    return reduce_rows(*per_scenario(one, J, C, b))


def map_jacobian_rows(points, coeffs, transform):
    """Rows d(coeff . (R(theta) p + t))/d theta (src/laserMapping.cpp:
    897-919); the translation block is the coeff itself."""
    rx, ry, rz = transform[..., 0], transform[..., 1], transform[..., 2]
    Ry, Rx, Rz = rotations.rot_y(ry), rotations.rot_x(rx), \
        rotations.rot_z(rz)
    dRy = rotations.drot_y(ry)
    dRx = rotations.drot_x(rx)
    dRz = rotations.drot_z(rz)
    cols = [Ry @ dRx @ Rz, dRy @ Rx @ Rz, Ry @ Rx @ dRz]
    rot = torch.stack(
        [((points @ D.mT) * coeffs).sum(-1) for D in cols], -1
    )
    return torch.cat([rot, coeffs], -1)


def normal_equations(rows, rhs, keep):
    """Masked JtJ / Jtb (src/laserOdometry.cpp:765-767) of rows
    (B, N, 6), one scenario at a time (types.per_scenario).  Under
    parallel.context.row_sharding each rank forms them over its block of
    the row axis and one all_reduce adds the (B, 6, 6) and (B, 6)
    partial sums."""
    def one(rows, rhs, keep):
        w = keep.to(rows.dtype)
        rows_m = rows * w[:, None]
        return rows_m.T @ rows_m, rows_m.T @ (rhs * w)

    rows, rhs, keep = (constrain_rows(t) for t in (rows, rhs, keep))
    return reduce_rows(*per_scenario(one, rows, rhs, keep))
