"""Homography warping, the weighted DLT and homography errors (counterpart
of gluefactory_tpu/geometry/homography.py:118-240).

All functions keep every leading dimension and run on the device of their
inputs; `warp_points_np` is the numpy helper of the data pipeline.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.linalg import smallest_eigenvector
from .utils import from_homogeneous, to_homogeneous


def warp_points_np(points: np.ndarray, H: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Warp (..., N, 2) numpy points by a (3, 3) homography."""
    M = np.linalg.inv(H) if inverse else H
    p = np.concatenate([points, np.ones_like(points[..., :1])], axis=-1)
    w = p @ M.T
    z = w[..., 2:]
    z = np.where(np.abs(z) < 1e-8, 1e-8, z)
    return w[..., :2] / z


def inv(H: torch.Tensor) -> torch.Tensor:
    """Batched inverse without a status check (no host read on the card); a
    singular matrix gives non-finite entries."""
    return torch.linalg.inv_ex(H)[0]


def warp_points(points: torch.Tensor, H: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Warp (..., N, 2) points by (..., 3, 3) homographies, in the points'
    dtype; `inverse=True` multiplies by H^-1."""
    H = H.to(points.dtype)
    M = inv(H) if inverse else H
    w = torch.einsum("...ij,...nj->...ni", M, to_homogeneous(points))
    return from_homogeneous(w, eps=1e-5)


def solve_homography_dlt(
    pts0: torch.Tensor, pts1: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """(Weighted) Hartley-normalised DLT: (..., N, 2) x2 -> (..., 3, 3), the
    null vector of the weighted 2N x 9 system as the smallest eigenvector of
    A^T A, normalised to H[2, 2] = 1."""
    dtype = torch.promote_types(pts0.dtype, torch.float32)
    P = torch.stack(torch.broadcast_tensors(pts0.to(dtype), pts1.to(dtype)))  # (2, ..., N, 2)
    if weights is None:
        weights = torch.ones(P.shape[1:-1], dtype=dtype, device=P.device)
    w = weights.to(dtype)[..., None]
    wsum = w.sum(-2, keepdim=True).clamp(min=1e-8)
    # weighted Hartley normalisation of both sets: zero mean, mean distance sqrt(2)
    mean = (P * w).sum(-2, keepdim=True) / wsum  # (2, ..., 1, 2)
    c = P - mean
    scale = ((c.norm(dim=-1, keepdim=True) * w).sum(-2, keepdim=True) / wsum).clamp(min=1e-8)
    s = math.sqrt(2.0) / scale  # (2, ..., 1, 1)
    pn = c * s
    # rows [p, 0, -u p] and [0, p, -v p] with p = (x, y, 1) in view 0, (u, v) in view 1
    p = torch.cat([pn[0], torch.ones_like(pn[0][..., :1])], -1)
    z = torch.zeros_like(p)
    uv = -pn[1]
    A = torch.cat([torch.cat([p, z, p * uv[..., 0:1]], -1),
                   torch.cat([z, p, p * uv[..., 1:2]], -1)], -2) * torch.cat([w, w], -2)
    Hn = smallest_eigenvector(A.transpose(-1, -2) @ A).unflatten(-1, (3, 3))
    # H = T1^-1 Hn T0 with T = [[s, 0, -s mx], [0, s, -s my], [0, 0, 1]]
    s0, s1 = s[0][..., 0, :], s[1][..., 0, :]  # (..., 1)
    m0, m1 = mean[0][..., 0, :], mean[1][..., 0, :]  # (..., 2)
    zero, one = torch.zeros_like(s0), torch.ones_like(s0)
    t0 = -(s0 * m0)
    T0 = torch.cat([s0, zero, t0[..., 0:1], zero, s0, t0[..., 1:2], zero, zero, one], -1)
    r1 = s1.reciprocal()
    T1inv = torch.cat([r1, zero, m1[..., 0:1], zero, r1, m1[..., 1:2], zero, zero, one], -1)
    H = T1inv.unflatten(-1, (3, 3)) @ Hn @ T0.unflatten(-1, (3, 3))
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() < 1e-8, torch.ones_like(h22), h22)


def sym_homography_error(kpts0, kpts1, H) -> torch.Tensor:
    """Mean of the forward and backward transfer errors per correspondence:
    kpts (..., N, 2), H (..., 3, 3) -> (..., N), in the points' dtype. Both
    directions go through one product."""
    H = H.to(kpts0.dtype)
    M = torch.stack([H, inv(H)], -3)  # (..., 2, 3, 3)
    src = to_homogeneous(torch.stack([kpts0, kpts1], -3))  # (..., 2, N, 3)
    dst = torch.stack([kpts1, kpts0], -3)
    d2 = ((from_homogeneous(src @ M.transpose(-1, -2), eps=1e-5) - dst) ** 2).sum(-1)
    return 0.5 * d2.sqrt().sum(-2)


def sym_homography_error_all(kpts0, kpts1, H) -> torch.Tensor:
    """All-pairs symmetric transfer error matrix (..., M, N)."""
    kp0_1 = warp_points(kpts0, H)
    kp1_0 = warp_points(kpts1, H, inverse=True)
    d0 = (kp0_1[..., :, None, :] - kpts1[..., None, :, :]).norm(dim=-1)
    d1 = (kpts0[..., :, None, :] - kp1_0[..., None, :, :]).norm(dim=-1)
    return (d0 + d1) / 2.0


def homography_corner_error(H, H_gt, image_size) -> torch.Tensor:
    """Mean displacement of the four image corners under H against H_gt;
    image_size (..., 2) is (w, h). Returns (...)."""
    W, Hh = image_size[..., 0], image_size[..., 1]
    zeros = torch.zeros_like(W)
    corners = torch.stack([
        torch.stack([zeros, zeros], -1), torch.stack([W, zeros], -1),
        torch.stack([W, Hh], -1), torch.stack([zeros, Hh], -1),
    ], -2)  # (..., 4, 2)
    c_gt = warp_points(corners, H_gt)
    c = warp_points(corners, H)
    return (c - c_gt).norm(dim=-1).mean(-1)


__all__ = [
    "warp_points", "warp_points_np", "inv", "solve_homography_dlt",
    "sym_homography_error", "sym_homography_error_all", "homography_corner_error",
]
