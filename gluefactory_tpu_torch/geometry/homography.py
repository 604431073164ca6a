"""Homography sampling, warping, the weighted DLT and homography errors
(counterpart of gluefactory_tpu/geometry/homography.py:26-240).

The torch functions keep every leading dimension and run on the device of
their inputs. The random sampler of the data pipeline and its helpers
(`sample_homography_corners`, `solve_homography_4pt_np`, `warp_points_np`)
are numpy, copied from the JAX module: they draw from the caller's
`RandomState` in the same order, so a seed gives the same homographies.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.linalg import smallest_eigenvector
from .utils import from_homogeneous, hartley_matrix, hartley_normalize, to_homogeneous


def _center_patch(shape, patch_shape=None):
    width, height = shape
    pw, ph = patch_shape if patch_shape is not None else shape
    l, b = (width - pw) / 2.0, (height - ph) / 2.0
    r, t = (width + pw) / 2.0, (height + ph) / 2.0
    return np.array([[l, b], [l, t], [r, t], [r, b]])


def _is_convex(patch: np.ndarray, min_convexity: float = 0.05) -> bool:
    n = patch.shape[0]
    for i in range(n):
        x1, y1 = patch[(i - 1) % n]
        x2, y2 = patch[i]
        x3, y3 = patch[(i + 1) % n]
        if (x2 - x1) * (y3 - y2) - (x3 - x2) * (y2 - y1) > -min_convexity:
            return False
    return True


def sample_homography_corners(
    shape,
    patch_shape,
    difficulty: float = 1.0,
    translation: float = 0.4,
    n_angles: int = 10,
    max_angle: float = 90.0,
    min_convexity: float = 0.05,
    rng=np.random,
):
    """A random convex warp of the image borders and its homography: a
    convex quadrilateral within the image, the first in-bounds of
    `n_angles` shuffled rotations, a scaled random translation; H maps the
    image corners to the patch. Returns (H, corners, warped_corners,
    patch_shape)."""
    max_angle_rad = max_angle / 180.0 * math.pi
    width, height = shape
    pwidth, pheight = width * (1 - difficulty), height * (1 - difficulty)
    min_pts1 = _center_patch(shape, (pwidth, pheight))
    full = _center_patch(shape)
    pts2 = _center_patch(patch_shape)
    scale = min_pts1 - full
    while True:
        offsets = rng.uniform(0.0, 1.0, size=(4, 2)) * scale
        pts1 = full + offsets
        if _is_convex(pts1 / np.array(shape), min_convexity):
            break

    # re-center
    pts1 = pts1 - pts1.mean(axis=0, keepdims=True) + min_pts1.mean(axis=0, keepdims=True)

    if n_angles > 0 and difficulty > 0:
        angles = np.linspace(-max_angle_rad * difficulty, max_angle_rad * difficulty, n_angles)
        rng.shuffle(angles)
        center = pts1.mean(axis=0, keepdims=True)
        for ang in angles:
            c, s = np.cos(ang), np.sin(ang)
            rot = np.array([[c, -s], [s, c]])
            cand = (pts1 - center) @ rot + center
            norm = cand / np.array(shape)
            if np.all((norm >= 0.0) & (norm < 1.0)):
                pts1 = cand
                break

    if translation > 0:
        min_trans = -pts1.min(axis=0)
        max_trans = np.array(shape) - pts1.max(axis=0)
        trans = rng.uniform(min_trans, max_trans)[None]
        pts1 = pts1 + trans * translation * difficulty

    H = solve_homography_4pt_np(pts1, pts2)
    warped = warp_points_np(full, H)
    return H, full, warped, patch_shape


def solve_homography_4pt_np(pts1: np.ndarray, pts2: np.ndarray) -> np.ndarray:
    """The exact homography of 4 correspondences (an 8 x 8 solve)."""
    A, b = [], []
    for (x, y), (u, v) in zip(pts1, pts2):
        A.append([x, y, 1, 0, 0, 0, -x * u, -y * u])
        A.append([0, 0, 0, x, y, 1, -x * v, -y * v])
        b.extend([u, v])
    h = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    return np.concatenate([h, [1.0]]).reshape(3, 3)


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
    pn, s, mean = hartley_normalize(P, w[..., 0])  # s (2, ..., 1), mean (2, ..., 2)
    # rows [p, 0, -u p] and [0, p, -v p] with p = (x, y, 1) in view 0, (u, v) in view 1
    p = torch.cat([pn[0], torch.ones_like(pn[0][..., :1])], -1)
    z = torch.zeros_like(p)
    uv = -pn[1]
    A = torch.cat([torch.cat([p, z, p * uv[..., 0:1]], -1),
                   torch.cat([z, p, p * uv[..., 1:2]], -1)], -2) * torch.cat([w, w], -2)
    Hn = smallest_eigenvector(A.transpose(-1, -2) @ A).unflatten(-1, (3, 3))
    # H = T1^-1 Hn T0 with T = [[s, 0, -s mx], [0, s, -s my], [0, 0, 1]]
    zero, one = torch.zeros_like(s[1]), torch.ones_like(s[1])
    r1, m1 = s[1].reciprocal(), mean[1]
    T1inv = torch.cat([r1, zero, m1[..., 0:1], zero, r1, m1[..., 1:2], zero, zero, one], -1)
    H = T1inv.unflatten(-1, (3, 3)) @ Hn @ hartley_matrix(s[0], mean[0])
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
    "sample_homography_corners", "solve_homography_4pt_np",
    "warp_points", "warp_points_np", "inv", "solve_homography_dlt",
    "sym_homography_error", "sym_homography_error_all", "homography_corner_error",
]
