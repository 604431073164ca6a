"""Multi-view triangulation (batched DLT) and reprojection errors
(counterpart of gluefactory_tpu/sfm/triangulation.py), in the inputs' dtype
with fp32 products (no TF32)."""

from __future__ import annotations

import torch

from ..geometry.wrappers import Camera
from ..models.utils.layers import no_tf32


def triangulate_dlt(rays: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Linear triangulation of one world point from K views.

    rays: (..., K, 2) normalised image coordinates x/z, y/z per view;
    R, t: (..., K, 3, 3), (..., K, 3) world->cam poses; valid: (..., K).
    Returns the (..., 3) world point: the least-squares DLT through its 3x3
    normal equations, damped by 1e-8 I for degenerate tracks. Each view
    contributes the rows [x P3 - P1; y P3 - P2] of P = [R | t]."""
    x, y = rays[..., 0:1], rays[..., 1:2]
    r1, r2, r3 = R[..., 0, :], R[..., 1, :], R[..., 2, :]
    t1, t2, t3 = t[..., 0], t[..., 1], t[..., 2]
    A = torch.cat([x * r3 - r1, y * r3 - r2], -2)  # (..., 2K, 3)
    c = -torch.cat([x[..., 0] * t3 - t1, y[..., 0] * t3 - t2], -1)  # (..., 2K)
    w = torch.cat([valid, valid], -1).to(A.dtype)
    Aw = A * w[..., None]
    with no_tf32():
        AtA = torch.einsum("...ki,...kj->...ij", Aw, A)
        Atc = torch.einsum("...ki,...k->...i", Aw, c)
    AtA = AtA + 1e-8 * torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(AtA, Atc[..., None])[0][..., 0]


def reprojection_errors(X: torch.Tensor, uv: torch.Tensor, camera: Camera, R: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """Pixel reprojection error of world points X (..., 3) observed at uv
    (..., 2) by cameras with world->cam (R, t)."""
    with no_tf32():
        p_cam = torch.einsum("...ij,...j->...i", R, X) + t
    proj, _ = camera.cam2image(p_cam[..., None, :])
    return torch.linalg.vector_norm(proj[..., 0, :] - uv, dim=-1)


__all__ = ["triangulate_dlt", "reprojection_errors"]
