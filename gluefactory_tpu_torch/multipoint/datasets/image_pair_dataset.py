"""Multispectral (optical / thermal) image-pair dataset (counterpart of
gluefactory_tpu/multipoint/datasets/image_pair_dataset.py).

The synthetic source fabricates aligned pairs: the optical image is a
procedural texture (`generate_texture_image`), the thermal one its blurred
inversion with emissive blobs and noise (`synthetic_thermal`), both drawn
from one `RandomState(seed + <pair number>)`. Each modality then takes its
own homography (`sample_homography_corners`, warped as `cv2.warpPerspective`
does, with the warped ones mask thresholded at 0.999) and the photometric
augmentation, in the JAX order. The val and test splits draw those from
`RandomState(seed + idx)` as the JAX package does; its train split draws
them unseeded, where the port seeds `seed + idx + 1_000_003 * (epoch + 1)`
(`set_epoch`), the rule of the homography dataset. The HDF5 source
(`filename`, under DATA_PATH) holds one group a pair with aligned `optical`
and `thermal` images, read by the port's own HDF5 reader (`utils/hdf5.py`);
its pairs are the file's top-level groups, sorted.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...datasets.augmentations import augmentations
from ...datasets.base_dataset import BaseDataset
from ...datasets.homographies import generate_texture_image
from ...datasets.image_ops import fill_circle, gaussian_blur, warp_perspective_cv
from ...geometry.homography import sample_homography_corners
from ...settings import DATA_PATH
from ...utils import hdf5


def synthetic_thermal(optical: np.ndarray, rng) -> np.ndarray:
    """Fake thermal modality: blurred inversion + emissive blobs + noise."""
    t = 1.0 - optical[..., 0]
    t = gaussian_blur(t, (0, 0), 2.0)
    h, w = t.shape
    for _ in range(rng.randint(2, 6)):
        cx, cy = rng.randint(0, w), rng.randint(0, h)
        r = rng.randint(8, max(min(h, w) // 4, 10))
        blob = fill_circle(np.zeros_like(t), (cx, cy), r, 1.0)
        blob = gaussian_blur(blob, (0, 0), r / 2)
        t = np.clip(t + 0.5 * blob, 0, 1)
    t = np.clip(t + rng.randn(h, w).astype(np.float32) * 0.02, 0, 1)
    return t[..., None].astype(np.float32)


class _MPSplit:
    def __init__(self, parent, split, names):
        self.parent = parent
        self.split = split
        self.names = names
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.names)

    def _load_pair(self, name):
        if self.parent.h5_path is not None:
            with hdf5.File(self.parent.h5_path, "r") as f:
                grp = f[name]
                optical = np.asarray(grp["optical"], np.float32)
                thermal = np.asarray(grp["thermal"], np.float32)
            return (optical[..., None] if optical.ndim == 2 else optical,
                    thermal[..., None] if thermal.ndim == 2 else thermal)
        r = np.random.RandomState(self.parent.conf.seed + int(name.split("/")[-1]))
        optical = generate_texture_image(r, tuple(self.parent.conf.synthetic.size))
        return optical, synthetic_thermal(optical, r)

    def __getitem__(self, idx):
        parent = self.parent
        conf = parent.conf
        seed = conf.seed + idx
        if self.split == "train":
            seed += 1_000_003 * (self.epoch + 1)
        rng = np.random.RandomState(seed % (2**31))
        optical, thermal = self._load_pair(self.names[idx])
        h, w = optical.shape[:2]

        out = {"name": str(self.names[idx]), "idx": idx}
        for key, img in (("optical", optical), ("thermal", thermal)):
            H = np.eye(3, dtype=np.float32)
            valid = np.ones(img.shape[:2], np.float32)
            if conf.augmentation.homographic.enable:
                H, *_ = sample_homography_corners(
                    (w, h), (w, h), rng=rng, **dict(conf.augmentation.homographic.params))
                # one set of coordinates for the image and its ones mask
                warped = warp_perspective_cv(np.concatenate([img, valid[..., None]], -1), H,
                                             (w, h))
                img, valid = warped[..., :-1], warped[..., -1]
                H = H.astype(np.float32)
            if conf.augmentation.photometric.enable:
                img = parent.photo_aug(img, rng)
            out[key] = {
                "image": img.astype(np.float32),
                "homography": H,
                "valid_mask": (valid > 0.999).astype(np.float32),
            }
        return out


class ImagePairDataset(BaseDataset):
    default_conf = {
        "name": "mp_image_pair",
        "filename": None,  # an HDF5 file under DATA_PATH; None: synthetic pairs
        "synthetic": {"pool": 64, "size": [320, 256]},
        "train_fraction": 0.9,
        "augmentation": {
            "photometric": {"enable": True, "name": "dark"},
            "homographic": {
                "enable": False,
                "params": {"difficulty": 0.5, "translation": 0.3, "max_angle": 30},
            },
        },
    }

    def _init(self, conf):
        self.photo_aug = augmentations[conf.augmentation.photometric.get("name", "dark")]()
        if conf.filename:
            self.h5_path = Path(DATA_PATH) / conf.filename
            with hdf5.File(self.h5_path, "r") as f:
                names = sorted(f.keys())
        else:
            self.h5_path = None
            names = [f"synthetic/{i:05d}" for i in range(int(conf.synthetic.pool))]
        n_train = int(len(names) * conf.train_fraction)
        self._splits = {"train": names[:n_train], "val": names[n_train:],
                        "test": names[n_train:]}

    def get_dataset(self, split):
        return _MPSplit(self, split, self._splits[split])


__main_dataset__ = ImagePairDataset
