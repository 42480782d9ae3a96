"""Trajectory accuracy metrics (counterpart of loam_tpu/metrics.py),
computed in float64 NumPy on the host."""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def umeyama_align(src, dst):
    """Rigid alignment of src onto dst (no scale)."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    cs, cd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(cs.T @ cd)
    S = np.eye(3)
    if np.linalg.det(Vt.T @ U.T) < 0:
        S[2, 2] = -1
    return ((Vt.T @ S @ U.T) @ cs.T).T + mu_d


def ate_rmse(est_pos, gt_pos, align: bool = False) -> float:
    """Absolute trajectory error RMSE over (F, 3) positions."""
    est, gt = _np(est_pos), _np(gt_pos)
    if align:
        est = umeyama_align(est, gt)
    err = est - gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def rpe_rmse(est_pos, gt_pos, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over windows of `delta`."""
    est, gt = _np(est_pos), _np(gt_pos)
    err = (est[delta:] - est[:-delta]) - (gt[delta:] - gt[:-delta])
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))

