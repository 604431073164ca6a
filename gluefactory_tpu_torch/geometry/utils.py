"""Geometric primitives (counterpart of gluefactory_tpu/geometry/utils.py):
homogeneous coordinates, Hartley conditioning, skew-symmetric matrices, the
SO(3) exponential and angular errors, batched over leading axes."""

from __future__ import annotations

import math

import torch


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last dimension: (..., D) -> (..., D+1)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def from_homogeneous(points: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Divide by the last coordinate: (..., D+1) -> (..., D). The denominator
    is clamped away from zero with its sign kept, so points on the plane at
    infinity stay finite."""
    z = points[..., -1:]
    z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps).to(z.dtype), z)
    return points[..., :-1] / z


def hartley_normalize(points: torch.Tensor, weights: torch.Tensor | None = None):
    """Weighted Hartley conditioning of (..., N, 2) points: zero weighted
    mean, weighted mean distance sqrt(2). `weights` (..., N) broadcasts
    against the points. Returns the conditioned points, the scale s (..., 1)
    and the mean m (..., 2) of the transform [[s, 0, -s m_x], [0, s, -s m_y],
    [0, 0, 1]] (`hartley_matrix`)."""
    w = torch.ones_like(points[..., :1]) if weights is None else weights[..., None]
    wsum = w.sum(-2, keepdim=True).clamp(min=1e-8)
    mean = (points * w).sum(-2, keepdim=True) / wsum
    c = points - mean
    scale = (torch.linalg.vector_norm(c, dim=-1, keepdim=True) * w).sum(-2, keepdim=True) / wsum
    s = math.sqrt(2.0) / scale.clamp(min=1e-8)
    return c * s, s[..., 0, :], mean[..., 0, :]


def hartley_matrix(s: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """The (..., 3, 3) conditioning transform of `hartley_normalize`."""
    z, o, t = torch.zeros_like(s), torch.ones_like(s), -(s * mean)
    return torch.cat([s, z, t[..., 0:1], z, s, t[..., 1:2], z, z, o], -1).unflatten(-1, (3, 3))


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """The cross-product matrix [v]_x of (..., 3) vectors: (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([z, -w, y, w, z, -x, -y, x, z], dim=-1).reshape(v.shape[:-1] + (3, 3))


def so3exp_map(w: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """SO(3) exponential: axis-angle (..., 3) -> rotation (..., 3, 3) by
    Rodrigues' formula, I + [w]_x below `eps` radians; in w's dtype, with the
    JAX package's order of operations."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    small = theta[..., 0] < eps
    W = skew_symmetric(w / torch.where(theta < eps, torch.ones_like(theta), theta))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    th = theta[..., None]
    R = eye + torch.sin(th) * W + (1.0 - torch.cos(th)) * (W @ W)
    return torch.where(small[..., None, None], eye + skew_symmetric(w), R)


def angle_error_mat(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in degrees between rotations (..., 3, 3)."""
    cos = (torch.diagonal(R1.transpose(-1, -2) @ R2, dim1=-2, dim2=-1).sum(-1) - 1) / 2
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)).abs())


def angle_error_vec(v1: torch.Tensor, v2: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Angle in degrees between (..., D) vectors."""
    n = torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1)
    cos = (v1 * v2).sum(-1) / n.clamp(min=eps)
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


__all__ = ["to_homogeneous", "from_homogeneous", "skew_symmetric", "so3exp_map",
           "angle_error_mat", "angle_error_vec"]
