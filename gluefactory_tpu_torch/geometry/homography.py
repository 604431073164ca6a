"""Homography warping (counterpart of `warp_points`,
gluefactory_tpu/geometry/homography.py:132; solvers and errors come with the
evaluation slice)."""

from __future__ import annotations

import torch

from .utils import from_homogeneous, to_homogeneous


def warp_points(points: torch.Tensor, H: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Warp (..., N, 2) points by (..., 3, 3) homographies, in the points'
    dtype; `inverse=True` multiplies by H^-1."""
    H = H.to(points.dtype)
    M = torch.linalg.inv(H) if inverse else H
    w = torch.einsum("...ij,...nj->...ni", M, to_homogeneous(points))
    return from_homogeneous(w, eps=1e-5)


__all__ = ["warp_points"]
