"""Small batched linear algebra (counterpart of loam_tpu/utils/linalg.py).

Ported as written so the numbers match: the closed-form 3x3 eigensolver
and the Gram-Schmidt plane fit are the same op sequence as the JAX code.
"""

from __future__ import annotations

import math

import torch

from .numerics import seq_sum, sqrt


def solve_sym6(ata, atb):
    """Solve AtA x = Atb (LU, as jnp.linalg.solve).  ``solve_ex`` skips
    the error check that would sync with the card; a singular system
    yields inf/NaN, which the solvers' NaN guard rejects."""
    return torch.linalg.solve_ex(ata, atb)[0]


def degeneracy_projector(ata, eigen_threshold):
    """P = sum_k [lambda_k >= thr] v_k v_k^T, plus whether any
    eigenvalue is below thr (src/laserOdometry.cpp:770-797).

    A non-finite AtA yields a NaN projector flagged non-degenerate,
    which is what LAPACK's eigh gives the JAX code (torch's eigh would
    raise instead)."""
    finite = torch.isfinite(ata).all()
    safe = torch.where(finite, ata, torch.eye(6, dtype=ata.dtype,
                                              device=ata.device))
    w, v = torch.linalg.eigh(safe)
    keep = (w >= eigen_threshold).to(ata.dtype)
    P = (v * keep[None, :]) @ v.T
    P = torch.where(finite, P, torch.full_like(P, float("nan")))
    return P, (w < eigen_threshold).any() & finite


def eigh3x3(A):
    """Closed-form symmetric 3x3 eigendecomposition, batched: eigenvalues
    descending, unit eigenvectors as rows V[..., k, :]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = sqrt(torch.clamp(p2 / 6.0, min=1e-30))

    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    detb = b00 * c00 - a01 * c01 + a02 * c02
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.acos(r) / 3.0

    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    w = torch.stack([e1, e2, e3], -1)

    eye = torch.eye(3, dtype=A.dtype, device=A.device)

    def eigvec(l1, l2):
        M = (A - l1[..., None, None] * eye) @ (A - l2[..., None, None] * eye)
        norms = (M * M).sum(-2)
        best = torch.argmax(norms, dim=-1)
        vcol = torch.gather(
            M, -1, best[..., None, None].expand(M.shape[:-1] + (1,))
        )[..., 0]
        return vcol / sqrt(
            torch.clamp((vcol * vcol).sum(-1, keepdim=True), min=1e-30)
        )

    v1 = eigvec(e2, e3)
    v3 = eigvec(e1, e2)
    v2 = torch.linalg.cross(v3, v1)
    v2 = v2 / sqrt(torch.clamp((v2 * v2).sum(-1, keepdim=True),
                                     min=1e-30))
    return w, torch.stack([v1, v2, v3], -2)


def fit_plane5(pts):
    """Least-squares plane through k points via modified Gram-Schmidt QR
    of A x = -1 (src/laserMapping.cpp:826-843).  pts (..., k, 3).
    Returns (unit normal, d) with normal . p + d ~= 0."""
    b = -torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    eps = 1e-30
    a1, a2, a3 = pts[..., :, 0], pts[..., :, 1], pts[..., :, 2]

    def norm(v):
        return sqrt(torch.clamp(seq_sum(v * v), min=eps))

    def dot(u, v):
        return seq_sum(u * v)

    r11 = norm(a1)
    q1 = a1 / r11[..., None]
    r12 = dot(q1, a2)
    a2p = a2 - r12[..., None] * q1
    r22 = norm(a2p)
    q2 = a2p / r22[..., None]
    r13 = dot(q1, a3)
    a3p = a3 - r13[..., None] * q1
    r23 = dot(q2, a3p)
    a3p = a3p - r23[..., None] * q2
    r33 = norm(a3p)
    q3 = a3p / r33[..., None]

    y1, y2, y3 = dot(q1, b), dot(q2, b), dot(q3, b)
    x3 = y3 / r33
    x2 = (y2 - r23 * x3) / r22
    x1 = (y1 - r12 * x2 - r13 * x3) / r11
    x = torch.stack([x1, x2, x3], -1)

    ps = sqrt(torch.clamp(seq_sum(x * x), min=eps))[..., None]
    return x / ps, 1.0 / ps[..., 0]


def solve3x3(M, b):
    """Batched 3x3 linear solve via the adjugate (Cramer)."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    inv_det = 1.0 / torch.where(det.abs() < 1e-30,
                                torch.full_like(det, 1e-30), det)
    c10 = m02 * m21 - m01 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m01 * m20 - m00 * m21
    c20 = m01 * m12 - m02 * m11
    c21 = m02 * m10 - m00 * m12
    c22 = m00 * m11 - m01 * m10
    adj = torch.stack([
        torch.stack([c00, c10, c20], -1),
        torch.stack([c01, c11, c21], -1),
        torch.stack([c02, c12, c22], -1),
    ], -2)
    return torch.einsum("...ij,...j->...i", adj, b) * inv_det[..., None]
