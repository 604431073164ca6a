"""Synthetic 3D two-view dataset: textured multi-plane scenes with exact
cameras, relative poses and dense depth (counterpart of
gluefactory_tpu/datasets/synthetic_two_view.py), the data of the
depth-supervised fine-tuning and of the `synthetic_pose` benchmark.

A scene is an infinite back plane and 2-4 finite front planes, all
fronto-parallel and textured; each plane maps to a view by an exact
homography, so images, depth maps and poses agree. Every draw of a sample
comes from one `RandomState(seed + idx + 10_000 * (split != "train"))` in
the JAX order, so the port and the JAX package give the same samples: the
rendering is the same float64 numpy, the texture taps are OpenCV 5's
bilinear remap (`image_ops.remap_linear`), and the rotations come from
`so3exp_map` in float32, as the JAX package makes them. Samples: numpy
images (H, W, 1) and depths (H, W), float32; the `Camera` and the `Pose`s
as CPU float32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.utils import so3exp_map
from ..geometry.wrappers import Camera, Pose
from .base_dataset import BaseDataset
from .homographies import generate_texture_image
from .image_ops import remap_linear


def _plane_homography(K, R, t, d):
    """Plane coordinates (X, Y) at world z = d -> image pixels:
    p ~ K [r1 r2 (d r3 + t)] [X Y 1]^T."""
    return K @ np.stack([R[:, 0], R[:, 1], d * R[:, 2] + t], axis=1)


def render_view(K, R, t, planes, size):
    """Image (h, w, 1), depth (h, w) and coverage of fronto-parallel planes
    seen by the camera (R, t) (world -> camera); `planes` lists (texture,
    depth, rect or None), back to front."""
    w, h = size
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], -1)
    image = np.zeros((h, w), np.float32)
    depth = np.zeros((h, w), np.float32)
    filled = np.zeros((h, w), bool)
    for texture, d, rect in planes:  # later planes overwrite
        plane_pts = pix @ np.linalg.inv(_plane_homography(K, R, t, d)).T
        Z = plane_pts[..., 2]
        valid = np.abs(Z) > 1e-9
        X = np.where(valid, plane_pts[..., 0] / np.where(valid, Z, 1), 0)
        Y = np.where(valid, plane_pts[..., 1] / np.where(valid, Z, 1), 0)
        if rect is not None:
            x0, y0, x1, y1 = rect
            inside = (X >= x0) & (X < x1) & (Y >= y0) & (Y < y1)
        else:
            inside = np.ones_like(valid)
        z_cam = ((np.stack([X, Y, np.full_like(X, d)], -1) @ R.T) + t)[..., 2].astype(np.float32)
        vis = valid & inside & (z_cam > 0.1)
        th, tw = texture.shape[:2]
        # texture pixels clamped, not wrapped: tiling would repeat patterns
        u = np.clip(X * 60.0 + tw / 2, 0, tw - 1)
        v = np.clip(Y * 60.0 + th / 2, 0, th - 1)
        vals = remap_linear(texture[..., 0], u.astype(np.float32), v.astype(np.float32))
        image = np.where(vis, vals, image)
        depth = np.where(vis, z_cam, depth)
        filled |= vis
    return image[..., None], depth, filled


class _SynthSplit:
    def __init__(self, parent, n, split):
        self.parent, self.n, self.split = parent, n, split

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        conf = self.parent.conf
        rng = np.random.RandomState(conf.seed + idx + (10_000 if self.split != "train" else 0))
        w, h = conf.image_size
        f = 0.9 * max(w, h)
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
        planes = [(generate_texture_image(rng, (1024, 1024)), 6.0 + rng.rand() * 2, None)]
        for _ in range(rng.randint(2, 5)):
            d = 2.5 + rng.rand() * 2.5
            cx, cy = rng.uniform(-1.5, 1.5, 2)
            sx, sy = rng.uniform(0.8, 2.0, 2)
            planes.append((generate_texture_image(rng, (512, 512)), d,
                           (cx - sx / 2, cy - sy / 2, cx + sx / 2, cy + sy / 2)))
        planes.sort(key=lambda p: -p[1])  # back to front

        views, poses = [], []
        for scale in (0.5, 1.0):
            aa = rng.randn(3) * 0.05 * scale
            R = so3exp_map(torch.from_numpy(aa.astype(np.float32))).numpy().astype(np.float64)
            t = rng.randn(3) * np.array([0.4, 0.25, 0.15]) * scale
            img, depth, _ = render_view(K, R, t, planes, (w, h))
            views.append({"image": img.astype(np.float32), "depth": depth})
            poses.append(Pose.from_Rt(torch.from_numpy(R.astype(np.float32)),
                                      torch.from_numpy(t.astype(np.float32))))
        T_0to1 = poses[1] @ poses[0].inv()
        cam = Camera.from_calibration_matrix(torch.from_numpy(K.astype(np.float32)))
        size = np.array([w, h], np.float32)
        return {
            "name": f"synth3d/{self.split}/{idx}",
            "idx": idx,
            **{f"view{i}": {**v, "camera": cam, "image_size": size} for i, v in enumerate(views)},
            "T_0to1": T_0to1,
            "T_1to0": T_0to1.inv(),
        }


class SyntheticTwoViewDataset(BaseDataset):
    default_conf = {
        "name": "synthetic_two_view",
        "image_size": [640, 480],
        "train_size": 100,
        "val_size": 10,
        "test_size": 20,
        "test_batch_size": 1,
    }

    def get_dataset(self, split):
        return _SynthSplit(self, int(self.conf.get(f"{split}_size")), split)


__main_dataset__ = SyntheticTwoViewDataset
