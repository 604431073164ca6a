"""Batched `Pose` and `Camera` over `torch.Tensor`s (counterpart of
gluefactory_tpu/geometry/wrappers.py, whose classes are JAX pytrees).

Plain classes, not `nn.Module`s: each holds its tensors (`leaves()`), and
`map(fn)` rebuilds it from `fn` of each, which is how batches move
(`.to(device)`), stack (`stack`) and index (`[i]`). Conventions as in the
JAX package:
  - a Pose maps points from its source frame to its target frame,
    p' = R p + t, and `a @ b` applies b first;
  - a Camera packs (width, height, fx, fy, cx, cy[, k1, k2]); `cam2image`
    projects, distorts and denormalises with a validity mask, `image2cam`
    gives unit-depth rays (no undistortion).

The 3 x 3 products are written as sums of elementwise products, so that
they stay in fp32 on the card whatever `allow_tf32` says.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .utils import to_homogeneous


def mat3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for (..., 3, 3) matrices."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def apply3(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R p for (..., 3, 3) matrices and (..., N, 3) points: (..., N, 3)."""
    return (R[..., None, :, :] * p[..., :, None, :]).sum(-1)


class TensorWrapper:
    """A container of tensors with shared leading (batch) axes."""

    def leaves(self) -> tuple:
        raise NotImplementedError

    def map(self, fn: Callable):
        return type(self)(*(fn(x) for x in self.leaves()))

    @classmethod
    def stack(cls, items: list, dim: int = 0):
        return cls(*(torch.stack(xs, dim) for xs in zip(*(i.leaves() for i in items))))

    def to(self, *args, **kwargs):
        return self.map(lambda x: x.to(*args, **kwargs))

    def __getitem__(self, idx):
        return self.map(lambda x: x[idx])


class Pose(TensorWrapper):
    """Rigid transform: rotation (..., 3, 3) and translation (..., 3)."""

    def __init__(self, R: torch.Tensor, t: torch.Tensor):
        self.R, self.t = R, t

    def leaves(self) -> tuple:
        return self.R, self.t

    @classmethod
    def from_Rt(cls, R, t) -> "Pose":
        return cls(torch.as_tensor(R), torch.as_tensor(t))

    @classmethod
    def from_4x4mat(cls, T) -> "Pose":
        T = torch.as_tensor(T)
        return cls(T[..., :3, :3], T[..., :3, 3])

    @property
    def shape(self):
        return self.R.shape[:-2]

    def inv(self) -> "Pose":
        Rt = self.R.transpose(-1, -2)
        return Pose(Rt, -apply3(Rt, self.t[..., None, :])[..., 0, :])

    def compose(self, other: "Pose") -> "Pose":
        """self @ other: `other` first, then self."""
        t = self.t + apply3(self.R, other.t[..., None, :])[..., 0, :]
        return Pose(mat3(self.R, other.R), t)

    def __matmul__(self, other):
        return self.compose(other) if isinstance(other, Pose) else self.transform(other)

    def transform(self, p3d: torch.Tensor) -> torch.Tensor:
        """Transform (..., N, 3) points."""
        return apply3(self.R, p3d) + self.t[..., None, :]

    def __repr__(self):
        return f"Pose(batch={tuple(self.shape)}, dtype={self.R.dtype})"


class Camera(TensorWrapper):
    """Pinhole camera with optional radial distortion, packed (..., 6 | 8)."""

    eps = 1e-4

    def __init__(self, data: torch.Tensor):
        self._data = data

    def leaves(self) -> tuple:
        return (self._data,)

    @classmethod
    def from_params(cls, width, height, fx, fy, cx, cy, dist=()) -> "Camera":
        """A camera from its size, focal lengths, principal point and radial
        distortion, packed in float32."""
        return cls(torch.tensor([width, height, fx, fy, cx, cy, *dist], dtype=torch.float32))

    @classmethod
    def from_calibration_matrix(cls, K) -> "Camera":
        K = torch.as_tensor(K)
        fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
        return cls(torch.stack([2 * cx, 2 * cy, fx, fy, cx, cy], -1))

    @classmethod
    def from_colmap(cls, camera: dict) -> "Camera":
        """A COLMAP camera {"model", "width", "height", "params"} (PINHOLE,
        OPENCV, RADIAL, SIMPLE_PINHOLE, SIMPLE_RADIAL), float32."""
        model, params = camera["model"], [float(p) for p in camera["params"]]
        if model in ("OPENCV", "PINHOLE", "RADIAL"):
            fx, fy, cx, cy = params[:4]
            dist = params[4:]
        elif model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fx = fy = params[0]
            cx, cy = params[1:3]
            dist = params[3:] + ([0.0] if model == "SIMPLE_RADIAL" else [])
        else:
            raise NotImplementedError(model)
        data = [camera["width"], camera["height"], fx, fy, cx, cy, *dist]
        return cls(torch.tensor(data, dtype=torch.float64).float())

    def scale(self, scales) -> "Camera":
        """The camera of the image resized by `scales` (x, y): size, focal
        lengths and principal point times the scales."""
        s = torch.as_tensor(scales, dtype=self._data.dtype).expand(self.size.shape)
        return Camera(torch.cat([self.size * s, self.f * s, self.c * s, self.dist], -1))

    @property
    def size(self) -> torch.Tensor:
        return self._data[..., :2]

    @property
    def f(self) -> torch.Tensor:
        return self._data[..., 2:4]

    @property
    def c(self) -> torch.Tensor:
        return self._data[..., 4:6]

    @property
    def dist(self) -> torch.Tensor:
        return self._data[..., 6:]

    @property
    def shape(self):
        return self._data.shape[:-1]

    def calibration_matrix(self) -> torch.Tensor:
        d = self._data
        z, o = torch.zeros_like(d[..., 0]), torch.ones_like(d[..., 0])
        K = torch.stack([d[..., 2], z, d[..., 4], z, d[..., 3], d[..., 5], z, z, o], -1)
        return K.reshape(self.shape + (3, 3))

    def in_image(self, p2d: torch.Tensor) -> torch.Tensor:
        size = self.size[..., None, :]
        return ((p2d >= 0) & (p2d <= size - 1)).all(-1)

    def project(self, p3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = p3d[..., -1]
        valid = z > self.eps
        return p3d[..., :-1] / z.clamp(min=self.eps)[..., None], valid

    def distort(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Radial distortion (k1, k2) of normalised coordinates; the identity
        without distortion parameters."""
        if self.dist.shape[-1] == 0:
            return pts, torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
        k1 = self.dist[..., 0:1]
        k2 = self.dist[..., 1:2] if self.dist.shape[-1] > 1 else torch.zeros_like(k1)
        r2 = (pts**2).sum(-1)
        radial = 1.0 + k1 * r2 + k2 * r2**2
        return pts * radial[..., None], radial > 0

    def denormalize(self, p2d: torch.Tensor) -> torch.Tensor:
        return p2d * self.f[..., None, :] + self.c[..., None, :]

    def normalize(self, p2d: torch.Tensor) -> torch.Tensor:
        return (p2d - self.c[..., None, :]) / self.f[..., None, :]

    def cam2image(self, p3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        p2d, visible = self.project(p3d)
        p2d, dmask = self.distort(p2d)
        p2d = self.denormalize(p2d)
        return p2d, visible & dmask & self.in_image(p2d)

    def image2cam(self, p2d: torch.Tensor) -> torch.Tensor:
        """Pixels -> unit-depth rays (..., N, 3)."""
        return to_homogeneous(self.normalize(p2d))

    def __repr__(self):
        return f"Camera(batch={tuple(self.shape)}, params={self._data.shape[-1]})"


def world_points_to_image(p3d_w: torch.Tensor, pose: Pose, camera: Camera):
    """World points (..., N, 3) -> (pixels, valid) in the camera at `pose`."""
    return camera.cam2image(pose.transform(p3d_w))


__all__ = ["TensorWrapper", "Pose", "Camera", "world_points_to_image", "mat3", "apply3"]
