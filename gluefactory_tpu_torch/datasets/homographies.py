"""Synthetic homography-pair training dataset (counterpart of
gluefactory_tpu/datasets/homographies.py).

Each sample warps one source image by two random convex-patch homographies
into a fixed patch shape, applies photometric augmentation to the second
view, and gives the pair homography H_0to1 = H1 @ H0^-1 as supervision.
Samples are numpy, (H, W, C) float32 in [0, 1], static shapes.

Sources: procedurally generated textures (`synthetic.do`) or a local image
folder (`data_dir` / `image_dir` under the data root) of binary PPM / PGM
files; other image formats raise (there is no JPEG or PNG decoder without
cv2 or PIL). Every draw of a sample comes from one `RandomState` seeded
`seed + idx + 1_000_003 * (epoch + 1)` on the train split and `seed + idx`
on the others, in the JAX order, so the port and the JAX package give the
same samples. The cached-feature modes (`features.do`) are not ported
(ROADMAP Queue 1 item 2); the training configuration does not use them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..geometry.homography import sample_homography_corners
from ..settings import DATA_PATH
from .augmentations import augmentations
from .base_dataset import BaseDataset
from .image_ops import fill_poly, gaussian_blur, resize_cubic, warp_perspective
from .utils import read_image


_TEXTURES: dict = {}  # (seed, width, height) -> texture


def generate_texture_image(rng, size=(960, 720)) -> np.ndarray:
    """Procedural textured image: random polygons over blurred noise, (H, W, 1)
    float32. Gives detectors repeatable corners without downloaded data."""
    w, h = size
    noise = rng.rand(h // 4, w // 4).astype(np.float32)
    img = resize_cubic(noise, (w, h)) * 0.3 + 0.35
    n_shapes = rng.randint(20, 40)
    for _ in range(n_shapes):
        n_pts = rng.randint(3, 7)
        cx, cy = rng.randint(0, w), rng.randint(0, h)
        radius = rng.randint(10, max(min(w, h) // 6, 12))
        ang = rng.rand(n_pts) * 2 * np.pi
        rad = radius * (0.4 + 0.6 * rng.rand(n_pts))
        pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1).astype(np.int32)
        color = float(rng.rand())
        fill_poly(img, [pts], color)
    img = gaussian_blur(img, (0, 0), 1.0)
    return np.clip(img, 0, 1)[..., None].astype(np.float32)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """OpenCV's float colour -> grey: 0.114 B + 0.587 G + 0.299 R in float32."""
    r, g, b = (img[..., i] for i in range(3))
    return (b * np.float32(0.114) + g * np.float32(0.587) + r * np.float32(0.299))[..., None]


class _HomographySplit:
    def __init__(self, parent: "HomographyDataset", names, split: str):
        self.parent = parent
        self.names = names
        self.split = split
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx: int) -> dict:
        conf = self.parent.conf
        # fresh augmentations every epoch on the train split, deterministic
        # in (seed, epoch, idx)
        seed = conf.seed + idx + (1_000_003 * (self.epoch + 1) if self.split == "train" else 0)
        rng = np.random.RandomState(seed % (2**31))
        img = self.parent.read_image(self.names[idx], rng)
        h, w = img.shape[:2]
        ps = tuple(conf.homography.patch_shape)

        def view(difficulty_scale=1.0, photometric=True):
            hconf = conf.homography
            difficulty = hconf.difficulty
            if hconf.difficulty_range is not None:
                lo, hi = hconf.difficulty_range
                difficulty = float(rng.uniform(lo, hi))
            H, _, _, _ = sample_homography_corners(
                (w, h), ps, difficulty=difficulty * difficulty_scale,
                translation=hconf.translation, n_angles=hconf.n_angles,
                max_angle=hconf.max_angle, min_convexity=hconf.min_convexity, rng=rng)
            warped = warp_perspective(img, H, ps)
            if photometric and rng.rand() < conf.photometric.p:
                warped = self.parent.photo_aug(warped, rng)
            return {"image": warped.astype(np.float32),
                    "image_size": np.array(ps, np.float32)}, H

        left_scale = 0.0 if conf.right_only else 1.0
        data0, H0 = view(left_scale, photometric=False)
        data1, H1 = view(1.0, photometric=True)
        sample = {
            "name": f"{self.names[idx]}",
            "idx": idx,
            "H_0to1": (H1 @ np.linalg.inv(H0)).astype(np.float32),
            "view0": data0,
            "view1": data1,
        }
        if conf.triplet:
            data2, H2 = view(1.0, photometric=True)
            sample["view2"] = data2
            sample["H_0to2"] = (H2 @ np.linalg.inv(H0)).astype(np.float32)
            sample["H_1to2"] = (H2 @ np.linalg.inv(H1)).astype(np.float32)
        return sample


class HomographyDataset(BaseDataset):
    default_conf = {
        "name": "homographies",
        "data_dir": "revisitop1m",
        "image_dir": "jpg/",
        "glob": ["*.jpg", "*.png", "*.jpeg", "*.JPG", "*.PNG"],
        "train_size": 100,
        "val_size": 10,
        "grayscale": True,
        "triplet": False,
        "right_only": False,
        "synthetic": {"do": False, "size": [960, 720], "pool": 64},
        "homography": {
            "difficulty": 0.8,
            # [lo, hi]: each view draws its difficulty from U(lo, hi)
            "difficulty_range": None,
            "translation": 1.0,
            "max_angle": 60,
            "n_angles": 10,
            "patch_shape": [640, 480],
            "min_convexity": 0.05,
        },
        "photometric": {"name": "lg", "p": 0.75},
        "features": {"do": False, "per_view": False, "name": "sift", "max_num_keypoints": 512,
                     "keep_images": False, "desc_noise": 0.05, "jitter": 0.3, "dropout": 0.1,
                     "conf": {}},
    }

    def _init(self, conf):
        if conf.features.do:
            raise NotImplementedError(
                "features.do (cached-feature and per-view extraction modes) is not ported yet "
                "(ROADMAP Queue 1 item 2)")
        self.photo_aug = augmentations[conf.photometric.name]()
        if conf.synthetic.do:
            pool = int(conf.synthetic.pool)
            self.image_names = [f"synthetic/{i:05d}" for i in range(pool)]
        else:
            image_dir = Path(DATA_PATH) / conf.data_dir / conf.image_dir
            if not image_dir.exists():
                raise FileNotFoundError(
                    f"{image_dir} not found; set synthetic.do=True for hermetic data")
            images = []
            for g in conf.glob:
                images += [p.relative_to(image_dir).as_posix() for p in image_dir.glob("**/" + g)]
            self.image_names = sorted(images)
            self.image_dir = image_dir
        n_train, n_val = int(conf.train_size), int(conf.val_size)
        rng = np.random.RandomState(conf.seed)
        order = rng.permutation(len(self.image_names))
        n_src = len(self.image_names)
        if conf.synthetic.do and n_train + n_val > n_src:
            # oversample the pool: every index draws fresh random warps
            train_names = [self.image_names[order[i % max(n_src - n_val, 1)]]
                           for i in range(n_train)]
            val_names = [self.image_names[i] for i in order[n_src - n_val:]]
            self.splits = {"train": train_names, "val": val_names}
        else:
            self.splits = {
                "train": [self.image_names[i] for i in order[:n_train]],
                "val": [self.image_names[i] for i in order[n_train:n_train + n_val]],
            }
        self.splits["test"] = self.splits["val"]

    def read_image(self, name: str, rng) -> np.ndarray:
        if self.conf.synthetic.do:
            # a texture depends on its seed and size only: one cache for the
            # process, shared by every dataset (a resumed run, a benchmark)
            key = (self.conf.seed + int(name.split("/")[-1]), *self.conf.synthetic.size)
            if key not in _TEXTURES:
                _TEXTURES[key] = generate_texture_image(np.random.RandomState(key[0]), key[1:])
            return _TEXTURES[key]
        img = read_image(self.image_dir / name)  # RGB, float32 in [0, 1]; raises unless PNM
        if img is None:
            return np.zeros((1024, 1024, 1), np.float32)
        return rgb_to_gray(img) if self.conf.grayscale else img

    def get_dataset(self, split: str):
        return _HomographySplit(self, self.splits[split], split)


__main_dataset__ = HomographyDataset
