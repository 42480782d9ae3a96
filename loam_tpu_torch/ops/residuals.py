"""Point-to-line / point-to-plane residuals and Gauss-Newton Jacobians
(counterpart of loam_tpu/ops/residuals.py).

The JAX package differentiates the residual scalars with jax.grad /
jacfwd; here the Jacobians are closed forms of the same functions,
built from the derivatives of the elementary rotations.
"""

from __future__ import annotations

import torch

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
    """J_n = d T_start(p_n; theta, s=1) / d theta, shape (N, 3, 6), with
    T_start(p) = Ry(-ry) Rx(-rx) Rz(-rz) (p - t)."""
    rx, ry, rz = transform[0], transform[1], transform[2]
    Ry, Rx, Rz = rotations.rot_y(-ry), rotations.rot_x(-rx), \
        rotations.rot_z(-rz)
    # d/da of rot(-a) is -drot(-a)
    dRy = -rotations.drot_y(-ry)
    dRx = -rotations.drot_x(-rx)
    dRz = -rotations.drot_z(-rz)
    M = Ry @ Rx @ Rz
    v = points - transform[3:]
    cols = [v @ (Ry @ dRx @ Rz).T, v @ (dRy @ Rx @ Rz).T,
            v @ (Ry @ Rx @ dRz).T]
    J_rot = torch.stack(cols, -1)                           # (N, 3, 3)
    J_t = (-M).expand(points.shape[0], 3, 3)
    return torch.cat([J_rot, J_t], -1)


def odom_jacobian_rows(points, coeffs, transform):
    """Rows d(coeff . T_start(p; theta, s=1))/d theta, (N, 6)."""
    J = odom_point_jacobians(points, transform)
    return (coeffs[:, :, None] * J).sum(1)


def normal_equations_accumulated(J, C, b):
    """ata = sum_n J_n^T C_n J_n, atb = sum_n J_n^T b_n."""
    CJ = torch.einsum("nab,nbj->naj", C, J)
    ata = torch.einsum("nai,naj->ij", J, CJ)
    atb = torch.einsum("nai,na->i", J, b)
    return ata, atb


def map_jacobian_rows(points, coeffs, transform):
    """Rows d(coeff . (R(theta) p + t))/d theta (src/laserMapping.cpp:
    897-919); the translation block is the coeff itself."""
    rx, ry, rz = transform[0], transform[1], transform[2]
    Ry, Rx, Rz = rotations.rot_y(ry), rotations.rot_x(rx), \
        rotations.rot_z(rz)
    dRy = rotations.drot_y(ry)
    dRx = rotations.drot_x(rx)
    dRz = rotations.drot_z(rz)
    cols = [Ry @ dRx @ Rz, dRy @ Rx @ Rz, Ry @ Rx @ dRz]
    rot = torch.stack(
        [((points @ D.T) * coeffs).sum(-1) for D in cols], -1
    )
    return torch.cat([rot, coeffs], -1)


def normal_equations(rows, rhs, keep):
    """Masked JtJ / Jtb (src/laserOdometry.cpp:765-767)."""
    w = keep.to(rows.dtype)
    rows_m = rows * w[:, None]
    return rows_m.T @ rows_m, rows_m.T @ (rhs * w)
