"""Epipolar geometry (counterpart of gluefactory_tpu/geometry/epipolar.py):
essential and fundamental matrices, symmetric epipolar distances, the
decomposition of an essential matrix and the relative-pose error.

Products with a contraction of 3 are sums of elementwise products (see
`wrappers`), so that they stay in fp32 on the card whatever `allow_tf32`
says; a ground-truth label that flips at a threshold changes the loss.
"""

from __future__ import annotations

import torch

from ..ops.linalg import svd3x3
from .utils import angle_error_mat, angle_error_vec, skew_symmetric, to_homogeneous
from .wrappers import Camera, Pose, apply3, mat3


def T_to_E(T: Pose) -> torch.Tensor:
    """Relative pose -> essential matrix [t]_x R."""
    return mat3(skew_symmetric(T.t), T.R)


def _inv_K(cam: Camera) -> torch.Tensor:
    """The inverse of a camera's calibration matrix, in closed form (a
    general inverse reads its status back to the host on the card)."""
    fx, fy, cx, cy = (cam.f[..., 0], cam.f[..., 1], cam.c[..., 0], cam.c[..., 1])
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    Kinv = torch.stack([1 / fx, z, -cx / fx, z, 1 / fy, -cy / fy, z, z, o], -1)
    return Kinv.reshape(cam.shape + (3, 3))


def E_to_F(cam0: Camera, cam1: Camera, E: torch.Tensor) -> torch.Tensor:
    return mat3(mat3(_inv_K(cam1).transpose(-1, -2), E), _inv_K(cam0))


def T_to_F(cam0: Camera, cam1: Camera, T_0to1: Pose) -> torch.Tensor:
    return E_to_F(cam0, cam1, T_to_E(T_0to1))


def F_to_E(cam0: Camera, cam1: Camera, F: torch.Tensor) -> torch.Tensor:
    return mat3(mat3(cam1.calibration_matrix().transpose(-1, -2), F), cam0.calibration_matrix())


def _pairs3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N) dot products."""
    return sum(a[..., :, None, k] * b[..., None, :, k] for k in range(3))


def sym_epipolar_distance(p0, p1, E, squared: bool = True) -> torch.Tensor:
    """Symmetric epipolar distance of paired points (..., N, 2 | 3) under
    (..., 3, 3) E: (..., N)."""
    p0 = p0 if p0.shape[-1] == 3 else to_homogeneous(p0)
    p1 = p1 if p1.shape[-1] == 3 else to_homogeneous(p1)
    E_p0 = apply3(E, p0)
    Et_p1 = apply3(E.transpose(-1, -2), p1)
    p1_E_p0 = (p1 * E_p0).sum(-1)
    d0 = (E_p0[..., 0] ** 2 + E_p0[..., 1] ** 2).clamp(min=1e-6)
    d1 = (Et_p1[..., 0] ** 2 + Et_p1[..., 1] ** 2).clamp(min=1e-6)
    if squared:
        return p1_E_p0**2 * (1 / d0 + 1 / d1)
    return p1_E_p0.abs() * (1.0 / torch.sqrt(d0) + 1.0 / torch.sqrt(d1)) / 2


def sym_epipolar_distance_all(p0, p1, E, eps: float = 1e-15) -> torch.Tensor:
    """All-pairs symmetric epipolar distance (..., N0, N1): entry [n, m]
    relates p0[n] and p1[m]."""
    p0 = p0 if p0.shape[-1] == 3 else to_homogeneous(p0)
    p1 = p1 if p1.shape[-1] == 3 else to_homogeneous(p1)
    E_p0 = apply3(E, p0)
    Et_p1 = apply3(E.transpose(-1, -2), p1)
    p1_E_p0 = _pairs3(E_p0, p1).abs()
    d0 = p1_E_p0 / torch.sqrt(E_p0[..., :, None, 0] ** 2 + E_p0[..., :, None, 1] ** 2 + eps)
    d1 = p1_E_p0 / torch.sqrt(Et_p1[..., None, :, 0] ** 2 + Et_p1[..., None, :, 1] ** 2 + eps)
    return (d0 + d1) / 2


def generalized_epi_dist(kpts0, kpts1, cam0: Camera, cam1: Camera, T_0to1: Pose,
                         all_pairs: bool = True, essential: bool = True) -> torch.Tensor:
    """Epipolar distance in normalised (essential) or pixel (fundamental)
    units, all pairs (..., N0, N1) or paired (..., N)."""
    if essential:
        E = T_to_E(T_0to1)
        p0, p1 = cam0.image2cam(kpts0), cam1.image2cam(kpts1)
    else:
        E, p0, p1 = T_to_F(cam0, cam1, T_0to1), kpts0, kpts1
    if all_pairs:
        return sym_epipolar_distance_all(p0, p1, E)
    return sym_epipolar_distance(p0, p1, E, squared=False)


_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices: row 0 . (row 1 x row 2)."""
    return (M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :])).sum(-1)


def decompose_essential_matrix(E: torch.Tensor):
    """E (..., 3, 3) -> (R1, R2, t): the two rotations U W V^T and U W^T V^T
    (U and V made proper) and the translation direction U[:, 2]."""
    U, _, Vt = svd3x3(E)
    U = torch.where((det3(U) < 0)[..., None, None], U * U.new_tensor([1.0, 1.0, -1.0]), U)
    Vt = torch.where((det3(Vt) < 0)[..., None, None],
                     Vt * Vt.new_tensor([[1.0], [1.0], [-1.0]]), Vt)
    W = E.new_tensor(_W)
    return mat3(mat3(U, W), Vt), mat3(mat3(U, W.T), Vt), U[..., -1]


def relative_pose_error(T_0to1: Pose, R, t, ignore_gt_t_thr: float = 0.0):
    """Angular errors in degrees of an estimated relative pose against the
    ground truth: (t_err, r_err); t up to sign (an essential matrix's)."""
    t_err = angle_error_vec(t, T_0to1.t)
    t_err = torch.minimum(t_err, 180.0 - t_err)
    if ignore_gt_t_thr > 0:
        short = torch.linalg.vector_norm(T_0to1.t, dim=-1) < ignore_gt_t_thr
        t_err = torch.where(short, torch.zeros_like(t_err), t_err)
    return t_err, angle_error_mat(R, T_0to1.R)


__all__ = [
    "T_to_E", "T_to_F", "E_to_F", "F_to_E", "sym_epipolar_distance",
    "sym_epipolar_distance_all", "generalized_epi_dist", "decompose_essential_matrix",
    "relative_pose_error", "det3",
]
