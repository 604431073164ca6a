"""Homogeneous coordinates (counterpart of gluefactory_tpu/geometry/utils.py,
the two functions the homography warp needs)."""

from __future__ import annotations

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


__all__ = ["to_homogeneous", "from_homogeneous"]
