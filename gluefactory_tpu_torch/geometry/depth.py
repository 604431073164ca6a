"""Depth sampling and two-view reprojection (counterpart of
gluefactory_tpu/geometry/depth.py).

Bilinear sampling at pixel centres (x - 0.5, the `align_corners=False`
convention of the reference's `grid_sample`), valid only inside the image
and where all four neighbours and the result have positive depth; no NaN is
ever made.
"""

from __future__ import annotations

import torch

from .wrappers import Camera, Pose


def _gather_2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img[..., iy, ix] with clamped indices: img (..., H, W), iy / ix (..., N)."""
    H, W = img.shape[-2:]
    idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    return torch.gather(img.reshape(img.shape[:-2] + (H * W,)), -1, idx)


def sample_depth(pts: torch.Tensor, depth: torch.Tensor):
    """Depth at (..., N, 2) xy pixel coordinates from (..., H, W) depth maps
    (<= 0: none). Returns (depth (..., N), valid (..., N) bool)."""
    H, W = depth.shape[-2:]
    x, y = pts[..., 0] - 0.5, pts[..., 1] - 0.5
    fx, fy = torch.floor(x), torch.floor(y)
    x0, y0 = fx.long(), fy.long()
    x1, y1 = x0 + 1, y0 + 1
    wx, wy = x - fx, y - fy
    d00, d01 = _gather_2d(depth, y0, x0), _gather_2d(depth, y0, x1)
    d10, d11 = _gather_2d(depth, y1, x0), _gather_2d(depth, y1, x1)
    interp = (d00 * (1 - wx) * (1 - wy) + d01 * wx * (1 - wy)
              + d10 * (1 - wx) * wy + d11 * wx * wy)
    inside = (x0 >= 0) & (y0 >= 0) & (x1 <= W - 1) & (y1 <= H - 1)
    valid = inside & (d00 > 0) & (d01 > 0) & (d10 > 0) & (d11 > 0) & (interp > 0)
    return torch.where(valid, interp, torch.zeros_like(interp)), valid


def project(kpi, di, depthj, camera_i: Camera, camera_j: Camera, T_itoj: Pose, validi,
            ccth: float | None = None):
    """Reproject keypoints (..., N, 2) of view i with depths (..., N) into
    view j. With `depthj` and `ccth`, a cycle check: back through view j's
    depth, the round trip must land within sqrt(ccth) pixels. Returns
    (points in j (..., N, 2), visible (..., N) bool)."""
    kpi_j, validj = camera_j.cam2image(T_itoj.transform(camera_i.image2cam(kpi) * di[..., None]))
    visible = validi & validj
    if depthj is None or ccth is None:
        return kpi_j, visible
    dj, valid_dj = sample_depth(kpi_j, depthj)
    back = T_itoj.inv().transform(camera_j.image2cam(kpi_j) * dj[..., None])
    kpi_j_i, validj_i = camera_i.cam2image(back)
    consistent = ((kpi - kpi_j_i) ** 2).sum(-1) < ccth
    return kpi_j, visible & consistent & validj_i & valid_dj


def dense_warp_consistency(depthi, depthj, T_itoj: Pose, camerai: Camera, cameraj: Camera,
                           **kwargs):
    """Every pixel centre of view i reprojected into view j: (..., H, W, 2)
    and its validity (..., H, W)."""
    H, W = depthi.shape[-2:]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depthi.dtype, device=depthi.device),
                            torch.arange(W, dtype=depthi.dtype, device=depthi.device),
                            indexing="ij")
    kpi = torch.stack([xs + 0.5, ys + 0.5], -1).reshape(1, H * W, 2)
    kpi = kpi.expand(depthi.shape[:-2] + (H * W, 2))
    di = depthi.reshape(depthi.shape[:-2] + (H * W,))
    kpir, validir = project(kpi, di, depthj, camerai, cameraj, T_itoj, di > 0, **kwargs)
    return (kpir.reshape(depthi.shape[:-2] + (H, W, 2)),
            validir.reshape(depthi.shape[:-2] + (H, W)))


__all__ = ["sample_depth", "project", "dense_warp_consistency"]
