"""ETH3D two-view dataset with COLMAP ground truth and depth (counterpart of
gluefactory_tpu/datasets/eth3d.py), the ETH3D matching-AP benchmark's data.

The layout is the undistorted ETH3D package's (nothing is downloaded):

    <data_dir>/<scene>/
        images/dslr_images_undistorted/<name>.JPG
        ground_truth_depth/undistorted_depth/<name>.png   # uint16, depth * 256
        dslr_calibration_undistorted/cameras.txt          # COLMAP text
        dslr_calibration_undistorted/images.txt           # poses + observed 3D ids

Pairs are the image pairs of a scene that see at least `min_covisibility`
common 3D points, most first (a stable sort, as the JAX package sorts),
`max_pairs_per_scene` of them. Each image is resized to its own long side
over `downsize_factor` (area); its camera is keyed by the CAMERA_ID column
and scaled by the resize's `scales`, as the JAX package does. The depth PNG
(`read_image_anydepth`) / 256, resized by nearest (OpenCV's INTER_NEAREST)
to the image when the shapes differ.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ..geometry.wrappers import Camera, Pose
from ..settings import DATA_PATH
from .base_dataset import BaseDataset
from .utils import ImagePreprocessor, read_image, read_image_anydepth, resize_image

logger = logging.getLogger(__name__)


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
    ])


def read_colmap_cameras_text(path: Path) -> dict:
    """COLMAP cameras.txt -> {camera_id: {model, width, height, params}}."""
    cameras = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        cameras[int(parts[0])] = {"model": parts[1], "width": int(parts[2]),
                                  "height": int(parts[3]),
                                  "params": [float(p) for p in parts[4:]]}
    return cameras


def read_colmap_images_text(path: Path) -> dict:
    """COLMAP images.txt -> {image_id: (name, camera_id, qvec, tvec,
    point3D ids)}: a pose line, then a POINTS2D line whose every third
    element is a POINT3D_ID (-1 unobserved)."""
    images = {}
    lines = [line for line in Path(path).read_text().splitlines()
             if line.strip() and not line.startswith("#")]
    for meta, pts in zip(lines[::2], lines[1::2]):
        parts = meta.split()
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        p3d_ids = np.array([int(x) for x in pts.split()[2::3]] or [-1])
        images[int(parts[0])] = (parts[9], int(parts[8]), qvec, tvec, p3d_ids)
    return images


def read_eth3d_depth(path: Path) -> np.ndarray:
    """A uint16 depth PNG -> float32 metric depth (pixel / 256); 0 means no
    ground truth."""
    depth = read_image_anydepth(path)
    if depth is None:
        raise FileNotFoundError(path)
    return depth.astype(np.float32) / 256.0


class _ETH3DSplit:
    def __init__(self, parent):
        self.parent = parent

    def __len__(self):
        return len(self.parent.items)

    def _view(self, meta, image_id):
        conf = self.parent.conf
        name, cam_id, qvec, tvec, _ = meta["images"][image_id]
        img = read_image(meta["image_dir"] / name, conf.grayscale)
        h, w = img.shape[:2]
        resize = int(max(max(h, w) // conf.downsize_factor, 8))
        d = ImagePreprocessor({"resize": resize, "side": "long",
                               "grayscale": conf.grayscale})(img)
        cam = Camera.from_colmap(meta["cameras"][cam_id]).scale(d["scales"])
        T = Pose.from_Rt(torch.from_numpy(qvec2rotmat(qvec).astype(np.float32)),
                         torch.from_numpy(tvec.astype(np.float32)))
        out = {**d, "camera": cam, "T_w2cam": T, "name": name}
        depth_path = meta["depth_dir"] / (Path(name).stem + ".png")
        if depth_path.exists():
            depth = read_eth3d_depth(depth_path)
            ph, pw = d["image"].shape[:2]
            if depth.shape != (ph, pw):
                depth, _ = resize_image(depth, (pw, ph), interp="nearest")
            out["depth"] = depth
        return out

    def __getitem__(self, idx):
        scene, id0, id1, n_covis = self.parent.items[idx]
        meta = self.parent.scenes[scene]
        v0, v1 = self._view(meta, id0), self._view(meta, id1)
        T_0to1 = v1.pop("T_w2cam") @ v0.pop("T_w2cam").inv()
        return {
            "name": f"{scene}/{Path(v0.pop('name')).stem}_{Path(v1.pop('name')).stem}",
            "idx": idx,
            "scene": scene,
            "view0": v0,
            "view1": v1,
            "T_0to1": T_0to1,
            "T_1to0": T_0to1.inv(),
            "n_covisible_points": n_covis,
        }


class ETH3DDataset(BaseDataset):
    default_conf = {
        "name": "eth3d",
        "data_dir": "ETH3D_undistorted",  # under DATA_PATH, or absolute
        "downsize_factor": 8,
        "min_covisibility": 500,
        "grayscale": True,
        "test_batch_size": 1,
        "max_pairs_per_scene": 50,
    }

    def _init(self, conf):
        root = Path(DATA_PATH) / conf.data_dir
        if not root.exists():
            raise FileNotFoundError(
                f"ETH3D not found at {root}: put the undistorted package there or set "
                "GLUEFACTORY_TPU_TORCH_DATA")
        self.scenes, self.items = {}, []
        for scene_dir in sorted(p for p in root.iterdir() if p.is_dir()):
            calib = scene_dir / "dslr_calibration_undistorted"
            if not (calib / "images.txt").exists():
                continue
            images = read_colmap_images_text(calib / "images.txt")
            self.scenes[scene_dir.name] = {
                "cameras": read_colmap_cameras_text(calib / "cameras.txt"),
                "images": images,
                "image_dir": scene_dir / "images" / "dslr_images_undistorted",
                "depth_dir": scene_dir / "ground_truth_depth" / "undistorted_depth",
            }
            ids = sorted(images)
            visible = {a: set(images[a][4][images[a][4] >= 0].tolist()) for a in ids}
            pairs = []
            for i, a in enumerate(ids):
                for b in ids[i + 1:]:
                    covis = len(visible[a] & visible[b])
                    if covis >= conf.min_covisibility:
                        pairs.append((scene_dir.name, a, b, covis))
            pairs.sort(key=lambda p: -p[3])
            self.items.extend(pairs[: conf.max_pairs_per_scene])
        logger.info("ETH3D: %d pairs from %d scenes", len(self.items), len(self.scenes))

    def get_dataset(self, split):
        return _ETH3DSplit(self)


__main_dataset__ = ETH3DDataset
