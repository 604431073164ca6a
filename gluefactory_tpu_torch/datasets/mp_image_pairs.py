"""Multispectral pairs in the two-view format (counterpart of
gluefactory_tpu/datasets/mp_image_pairs.py): view0 is the optical image,
view1 the thermal one, H_0to1 = H_thermal @ inv(H_optical) in the JAX
package's float32 numpy. Each view carries `is_optical`, which collates to a
(B,) bool array: MultiPoint and XPoint pick their encoder by it."""

from __future__ import annotations

import numpy as np

from ..multipoint.datasets.image_pair_dataset import ImagePairDataset
from .base_dataset import BaseDataset


class _MPBridgeSplit:
    def __init__(self, inner, size):
        self.inner = inner
        self.size = np.asarray(size, np.float32)

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch: int):
        self.inner.set_epoch(epoch)

    def __getitem__(self, idx):
        s = self.inner[idx]
        H_opt_inv = np.linalg.inv(s["optical"]["homography"])
        H_0to1 = (s["thermal"]["homography"] @ H_opt_inv).astype(np.float32)
        return {
            "name": s["name"],
            "idx": idx,
            "H_0to1": H_0to1,
            "view0": {
                "image": s["optical"]["image"],
                "image_size": self.size.copy(),
                "is_optical": True,
            },
            "view1": {
                "image": s["thermal"]["image"],
                "image_size": self.size.copy(),
                "is_optical": False,
            },
        }


class MPImagePairs(BaseDataset):
    default_conf = {
        "name": "mp_image_pairs",
        "mp": ImagePairDataset.default_conf,
        "test_batch_size": 1,
    }

    def _init(self, conf):
        self.inner = ImagePairDataset(dict(conf.mp))

    def get_dataset(self, split):
        inner = self.inner.get_dataset(split)
        probe = inner[0]
        h, w = probe["optical"]["image"].shape[:2]
        return _MPBridgeSplit(inner, (w, h))


__main_dataset__ = MPImagePairs
