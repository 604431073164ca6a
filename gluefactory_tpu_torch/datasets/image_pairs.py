"""Image pairs from a pairs file (counterpart of
gluefactory_tpu/datasets/image_pairs.py), the MegaDepth-1500 benchmark's
dataset.

Each line is `name0 name1`, optionally followed by a 3 x 3 homography (11
fields) or by two 3 x 3 calibration matrices and the 4 x 4 relative pose
T_0to1 (36 fields, `pairs_calibrated.txt`). Both views go through the
preprocessor; a calibration follows the resize (`scale_intrinsics`) and a
homography too (`scale_homography`). Images are read with `read_image`
(JPEG, PNG or PPM). `metadata(idx)` gives the item without its images, from
the image headers, for the evaluation phase.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..geometry.wrappers import Camera, Pose
from ..settings import DATA_PATH
from .base_dataset import BaseDataset
from .utils import (
    ImagePreprocessor,
    read_image,
    read_image_size,
    scale_homography,
    scale_intrinsics,
)


def names_to_pair(name0, name1, separator="/"):
    return separator.join((name0.replace("/", "-"), name1.replace("/", "-")))


def parse_camera(params) -> Camera:
    K = np.asarray([float(x) for x in params], np.float32).reshape(3, 3)
    return Camera.from_calibration_matrix(torch.from_numpy(K))


def parse_relative_pose(params) -> Pose:
    T = np.asarray([float(x) for x in params], np.float32).reshape(4, 4)
    return Pose.from_4x4mat(torch.from_numpy(T))


class _PairsSplit:
    def __init__(self, parent):
        self.parent = parent

    def __len__(self):
        return len(self.parent.items)

    def _item(self, idx, view):
        line = self.parent.items[idx]
        name0, name1 = line[0], line[1]

        def load_view(name, cam=None):
            d = view(self.parent.root / name)
            d["name"] = name
            if cam is not None:
                K = scale_intrinsics(cam.calibration_matrix().numpy(), d["scales"])
                d["camera"] = Camera.from_calibration_matrix(torch.from_numpy(K))
            return d

        data = {}
        if len(line) == 2:
            data["view0"], data["view1"] = load_view(name0), load_view(name1)
        elif len(line) == 11:  # name0 name1 H (3 x 3)
            data["view0"], data["view1"] = load_view(name0), load_view(name1)
            H = np.asarray([float(x) for x in line[2:]], np.float32).reshape(3, 3)
            data["H_0to1"] = scale_homography(H, data["view0"]["scales"],
                                              data["view1"]["scales"])
        elif len(line) == 36:  # name0 name1 K0 (9) K1 (9) T_0to1 (16): calibrated
            cam0, cam1 = parse_camera(line[2:11]), parse_camera(line[11:20])
            T = parse_relative_pose(line[20:36])
            data["view0"], data["view1"] = load_view(name0, cam0), load_view(name1, cam1)
            data["T_0to1"] = T
            data["T_1to0"] = T.inv()
        else:
            raise ValueError(f"Unknown pair format with {len(line)} fields")
        data["name"] = names_to_pair(name0, name1)
        data["idx"] = idx
        return data

    def __getitem__(self, idx):
        pre = self.parent.preprocessor
        return self._item(idx, lambda path: pre(read_image(path, False)))

    def metadata(self, idx):
        """The item without its images: each view's image_size and scales
        (and camera) from the image headers, and the pair's ground truth."""
        pre = self.parent.preprocessor
        return self._item(idx, lambda path: pre.metadata(*read_image_size(path)))


class ImagePairs(BaseDataset):
    default_conf = {
        "name": "image_pairs",
        "pairs": None,  # the pairs file, under DATA_PATH (or absolute)
        "root": None,  # the image root, under DATA_PATH (or absolute)
        "preprocessing": ImagePreprocessor.default_conf,
        "test_batch_size": 1,
    }

    def _init(self, conf):
        pairs_path = Path(DATA_PATH) / conf.pairs
        if not pairs_path.exists():
            raise FileNotFoundError(
                f"{pairs_path} missing: put the pairs file there or set GLUEFACTORY_TPU_TORCH_DATA")
        self.root = Path(DATA_PATH) / conf.root
        self.items = [line.split() for line in pairs_path.read_text().strip().split("\n")]
        self.preprocessor = ImagePreprocessor(conf.preprocessing)

    def get_dataset(self, split):
        return _PairsSplit(self)


__main_dataset__ = ImagePairs
