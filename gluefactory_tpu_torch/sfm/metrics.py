"""Trajectory metrics: ATE with similarity (Umeyama) alignment, in float64
numpy (counterpart of gluefactory_tpu/sfm/metrics.py)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src (N,3) onto dst (N,3).
    Returns (s, R, t) with dst ~= s R src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def absolute_trajectory_error(
    est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True
) -> dict:
    """RMSE / median / max ATE after an optional similarity alignment."""
    est = np.asarray(est_positions, float)
    gt = np.asarray(gt_positions, float)
    if align and len(est) >= 3:
        s, R, t = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=-1)
    return {
        "ate_rmse": float(np.sqrt((err**2).mean())),
        "ate_median": float(np.median(err)),
        "ate_max": float(err.max()),
    }


def camera_centers(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """World positions of cameras from world->cam (R, t): c = -R^T t."""
    return -np.einsum("nji,nj->ni", R, t)


__all__ = ["umeyama_alignment", "absolute_trajectory_error", "camera_centers"]
