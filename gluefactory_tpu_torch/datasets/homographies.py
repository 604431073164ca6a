"""Synthetic homography-pair training dataset (counterpart of
gluefactory_tpu/datasets/homographies.py).

Each sample warps one source image by two random convex-patch homographies
into a fixed patch shape, applies photometric augmentation to the second
view, and gives the pair homography H_0to1 = H1 @ H0^-1 as supervision.
Samples are numpy, (H, W, C) float32 in [0, 1], static shapes.

Sources: procedurally generated textures (`synthetic.do`) or a local image
folder (`data_dir` / `image_dir` under the data root) of JPEG, PNG or
binary PPM / PGM files, read by `read_image` with the port's own decoders;
other formats, and the JPEG / PNG variants that `image_codecs` refuses,
raise. Every draw of a sample comes from one `RandomState` seeded
`seed + idx + 1_000_003 * (epoch + 1)` on the train split and `seed + idx`
on the others, in the JAX order, so the port and the JAX package give the
same samples.

`features.do` puts the features of an extractor with no parameters (the JAX
package runs it with none) into each view's `cache`, for a pipeline whose
extractor is null: with `per_view` the extractor runs on each warped view;
otherwise it detects once on each source image (kept in memory) and each
view takes those keypoints warped by its homography, with `jitter`,
`dropout` and `desc_noise` drawn from the sample's `RandomState` in the JAX
order. The extractor is `sift_tpu`; it runs on the dataset's `device` (the
trainer passes its own), inside the loader's threads, which reach the card.
`features.name: sift`, the host OpenCV SIFT, raises: it is not portable.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..geometry.homography import sample_homography_corners, warp_points_np
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

    def _cached_features(self, feats: dict, rng, views, ps) -> None:
        """Each view's cache from the source image's features: the keypoints
        warped by the view's homography and jittered, those outside the
        patch or dropped masked, the descriptors perturbed and renormalised."""
        fc = self.parent.conf.features
        for d, H in views:
            kpts = warp_points_np(feats["keypoints"], H)
            if fc.jitter > 0:
                kpts = kpts + rng.randn(*kpts.shape) * fc.jitter
            inside = ((kpts[:, 0] >= 0) & (kpts[:, 0] < ps[0])
                      & (kpts[:, 1] >= 0) & (kpts[:, 1] < ps[1]))
            mask = feats["keypoint_mask"] & inside
            if fc.dropout > 0:
                mask = mask & (rng.rand(len(mask)) > fc.dropout)
            desc = feats["descriptors"]
            if fc.desc_noise > 0:
                desc = desc + rng.randn(*desc.shape).astype(np.float32) * fc.desc_noise
                desc = desc / np.maximum(np.linalg.norm(desc, axis=-1, keepdims=True), 1e-8)
            d["cache"] = {
                "keypoints": kpts.astype(np.float32),
                "keypoint_scores": np.where(mask, feats["keypoint_scores"], 0.0).astype(np.float32),
                "descriptors": desc.astype(np.float32),
                "keypoint_mask": mask,
            }
            if not fc.keep_images:
                d.pop("image")

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
        if conf.features.do and conf.features.per_view:
            for d in (data0, data1):
                d["cache"] = self.parent.extract_image(d["image"])
                if not conf.features.keep_images:
                    d.pop("image")
        elif conf.features.do:
            self._cached_features(self.parent.get_features(self.names[idx], img), rng,
                                  ((data0, H0), (data1, H1)), ps)
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
        self._feature_cache: dict = {}
        self._extractor = None
        if conf.features.do:
            self._extractor = self._build_extractor(conf.features)
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
        img = read_image(self.image_dir / name)  # RGB, float32 in [0, 1]
        if img is None:
            return np.zeros((1024, 1024, 1), np.float32)
        return rgb_to_gray(img) if self.conf.grayscale else img

    def _build_extractor(self, fc):
        if fc.name == "sift":
            raise NotImplementedError(
                "features.name 'sift' is the host OpenCV SIFT, which is not portable (cv2); "
                "use 'sift_tpu', the DoG SIFT on the device")
        from ..models import get_model
        from ..models.base_model import resolve_device

        extractor = get_model(fc.name)({"max_num_keypoints": fc.max_num_keypoints, **fc.conf},
                                       device=resolve_device(self.device))
        if any(True for _ in extractor.parameters()):
            raise ValueError(f"features.do needs an extractor without parameters, as the JAX "
                             f"package runs it with none; {fc.name!r} has some")
        return extractor.eval()

    def extract_image(self, img: np.ndarray) -> dict:
        """The extractor's features of one (H, W, C) image, unbatched numpy."""
        import torch

        image = torch.from_numpy(np.ascontiguousarray(img[None])).to(self._extractor.device)
        pred = self._extractor({"image": image})
        return {k: pred[k][0].cpu().numpy()
                for k in ("keypoints", "keypoint_scores", "descriptors", "keypoint_mask")}

    def get_features(self, name: str, img: np.ndarray) -> dict:
        """The source image's features, extracted once and kept."""
        if name not in self._feature_cache:
            self._feature_cache[name] = self.extract_image(img)
        return self._feature_cache[name]

    def get_dataset(self, split: str):
        return _HomographySplit(self, self.splits[split], split)


__main_dataset__ = HomographyDataset
