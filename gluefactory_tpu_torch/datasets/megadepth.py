"""MegaDepth training and validation dataset (counterpart of
gluefactory_tpu/datasets/megadepth.py).

Each scene has a `scene_info/<scene>.npz` in the reference schema (image and
depth paths, with None for views that lack one, intrinsics, world-to-camera
poses, the overlap matrix). Pairs are drawn per scene within the overlap
window, in `num_overlap_bins` bins of `<split>_num_per_scene` pairs, and
re-drawn each epoch (`sample_new_items`); `views: 3` draws triplets. Every
draw is the JAX package's, from the same `np.random.RandomState` calls, so
the two packages give the same items for a seed. A bin is kept only if it
holds at least twice its share (`num // num_bins`) of pairs: at the
configurations' 300 pairs in 3 bins, a scene whose bins all hold fewer than
200 pairs gives none (the reference's rule, ROADMAP Queue 3a).

A view is its image (`read_image`, the port's decoders), preprocessed
(`ImagePreprocessor`, `square_pad` included), its `Camera` with the
intrinsics scaled to the processed image and its pose; its depth (`/depth`
of an HDF5 file, read by the port's own reader) is resized to the valid
region by OpenCV's INTER_NEAREST rule and zero-padded where the image is.
With `load_features.do`, each view carries `cache`, the features that
`scripts/export_megadepth.py` wrote for it. The tree lives under
DATA_PATH/megadepth; nothing is downloaded.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..geometry.wrappers import Camera, Pose
from ..models.cache_loader import CacheLoader
from ..settings import DATA_PATH
from ..utils import hdf5
from .base_dataset import BaseDataset
from .utils import ImagePreprocessor, read_image, resize_image, scale_intrinsics

logger = logging.getLogger(__name__)

scene_lists_path = Path(__file__).parent / "megadepth_scene_lists"


def sample_n(data, num, seed=None):
    if len(data) > num:
        sel = np.random.RandomState(seed).choice(len(data), num, replace=False)
        return data[sel]
    return data


def read_depth(path) -> np.ndarray:
    """The `/depth` dataset of a MegaDepth depth file, float32."""
    with hdf5.File(path, "r") as f:
        return np.asarray(f["/depth"], np.float32)


class _PairDataset:
    def __init__(self, conf, split, parent):
        self.root = Path(DATA_PATH) / conf.data_dir
        assert self.root.exists(), self.root
        self.conf = conf
        self.split = split
        self.parent = parent

        split_conf = conf.get(f"{split}_split")
        if split_conf and (scene_lists_path / split_conf).exists():
            scenes = (scene_lists_path / split_conf).read_text().rstrip("\n").split("\n")
        else:
            scenes = sorted(p.stem for p in (self.root / conf.info_dir).glob("*.npz"))

        self.images, self.depths = {}, {}
        self.poses, self.intrinsics = {}, {}
        self.info_dir = self.root / conf.info_dir
        for scene in scenes:
            path = self.info_dir / (scene + ".npz")
            if not path.exists():
                continue
            info = np.load(str(path), allow_pickle=True)
            self.images[scene] = info["image_paths"]
            self.depths[scene] = info["depth_paths"]
            self.poses[scene] = info["poses"]
            self.intrinsics[scene] = info["intrinsics"]
        self.scenes = [s for s in scenes if s in self.images]
        self.preprocessor = ImagePreprocessor(dict(conf.preprocessing))

        self.feature_loader = None
        if conf.load_features.do:
            self.feature_loader = CacheLoader({
                "path": conf.load_features.path,
                "data_keys": conf.load_features.data_keys,
                "padding_length": conf.load_features.padding_length,
            })

        self.sample_new_items(conf.seed)

    def _scene_overlaps(self, scene):
        """(indices of the views with an image and a depth, their overlap matrix)."""
        info = np.load(str(self.info_dir / (scene + ".npz")), allow_pickle=True)
        valid = np.array([p is not None for p in self.images[scene]]) & np.array(
            [p is not None for p in self.depths[scene]])
        return np.where(valid)[0], info["overlap_matrix"][valid][:, valid]

    def sample_new_items(self, seed: int):
        """Overlap-binned pair (re)sampling, the JAX package's draws."""
        conf = self.conf
        self.items = []
        num = conf.get(f"{self.split}_num_per_scene")
        for scene in self.scenes:
            ind, mat = self._scene_overlaps(scene)
            if num is not None:
                num_bins = max(int(conf.num_overlap_bins), 1)
                bin_width = (conf.max_overlap - conf.min_overlap) / num_bins
                pairs_all = []
                for k in range(num_bins):
                    bin_min = conf.min_overlap + k * bin_width
                    bin_max = bin_min + bin_width
                    pairs_all.append(np.stack(np.where((mat > bin_min) & (mat <= bin_max)), -1))
                has_enough = [len(p) >= (num // num_bins) * 2 for p in pairs_all]
                per_bin = num // max(1, sum(has_enough))
                pairs = [sample_n(p, per_bin, seed)
                         for p, keep in zip(pairs_all, has_enough) if keep]
                pairs = np.concatenate(pairs, 0) if pairs else np.zeros((0, 2), int)
            else:
                pairs = np.stack(np.where((mat > conf.min_overlap) & (mat <= conf.max_overlap)),
                                 -1)
            self.items.extend(
                (scene, int(ind[i]), int(ind[j]), float(mat[i, j])) for i, j in pairs)
        np.random.RandomState(seed).shuffle(self.items)
        logger.info("Sampled %d %s pairs (seed %d)", len(self.items), self.split, seed)

    def _read_view(self, scene: str, idx: int) -> dict:
        conf = self.conf
        img_path = self.root / str(self.images[scene][idx])
        K = np.asarray(self.intrinsics[scene][idx], np.float32)
        T_w2cam = np.asarray(self.poses[scene][idx], np.float32)

        img = read_image(img_path, conf.grayscale)
        if img is None:
            raise IOError(f"Cannot read {img_path}")
        data = self.preprocessor(img)
        K = scale_intrinsics(K, data["scales"])

        depth = None
        if conf.read_depth:
            depth = read_depth(self.root / str(self.depths[scene][idx]))
            h, w = data["image"].shape[:2]
            if conf.preprocessing.get("pad_to") or conf.preprocessing.get("square_pad"):
                vw, vh = data["image_size"].astype(int)  # the valid region only
                dres, _ = resize_image(depth, (vw, vh), interp="nearest")
                depth = np.zeros((h, w), np.float32)
                depth[:vh, :vw] = dres
            else:
                depth, _ = resize_image(depth, (w, h), interp="nearest")

        view = {
            "name": str(self.images[scene][idx]),
            "camera": Camera.from_calibration_matrix(K),
            "T_w2cam": Pose.from_4x4mat(T_w2cam),
            **data,
        }
        if depth is not None:
            view["depth"] = depth
        if self.feature_loader is not None:
            view["cache"] = self.feature_loader({
                "scene": scene,
                "name": str(self.images[scene][idx]),
                "scales": data["scales"],
            })
        return view

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        scene, idx0, idx1, overlap = self.items[idx]
        view0 = self._read_view(scene, idx0)
        view1 = self._read_view(scene, idx1)
        T0, T1 = view0.pop("T_w2cam"), view1.pop("T_w2cam")
        T_0to1 = T1 @ T0.inv()
        return {
            "name": f"{scene}/{Path(str(view0['name'])).stem}_{Path(str(view1['name'])).stem}",
            "view0": {k: v for k, v in view0.items() if k != "name"},
            "view1": {k: v for k, v in view1.items() if k != "name"},
            "T_0to1": T_0to1,
            "T_1to0": T_0to1.inv(),
            "overlap_0to1": overlap,
            "idx": idx,
            "scene": scene,
        }


class _TripletDataset(_PairDataset):
    """Triplets for the TripletPipeline: (k, i) pairs inside the overlap
    window, then a third view j that also overlaps k, all from one seeded
    RandomState (the JAX package's draws)."""

    def sample_new_items(self, seed: int):
        conf = self.conf
        self.items = []
        num = conf.get(f"{self.split}_num_per_scene")
        rs = np.random.RandomState(seed)
        for scene in self.scenes:
            ind, mat = self._scene_overlaps(scene)
            good = (mat > conf.min_overlap) & (mat <= conf.max_overlap)
            rows = np.where(good.sum(-1) > 1)[0]  # views with two partners anchor a triplet
            pairs = np.stack(np.where(good[rows]), -1)  # (n, [row index, i])
            if num is not None and len(pairs) > num:
                pairs = pairs[rs.choice(len(pairs), num, replace=False)]
            for r, i in pairs:
                k = rows[r]
                candidates = np.where(good[k])[0]
                candidates = candidates[candidates != i]
                j = candidates[rs.randint(len(candidates))]
                self.items.append((scene, int(ind[k]), int(ind[i]), int(ind[j]),
                                   float(mat[k, i]), float(mat[k, j]), float(mat[i, j])))
        rs.shuffle(self.items)
        logger.info("Sampled %d %s triplets (seed %d)", len(self.items), self.split, seed)

    def __getitem__(self, idx):
        scene, i0, i1, i2, ov01, ov02, ov12 = self.items[idx]
        views = [self._read_view(scene, i) for i in (i0, i1, i2)]
        Ts = [v.pop("T_w2cam") for v in views]
        names = [Path(str(v["name"])).stem for v in views]
        data = {
            "name": f"{scene}/{'_'.join(names)}",
            "idx": idx,
            "scene": scene,
            "overlap_0to1": ov01,
            "overlap_0to2": ov02,
            "overlap_1to2": ov12,
        }
        for n, v in enumerate(views):
            data[f"view{n}"] = {k: x for k, x in v.items() if k != "name"}
        for a, b in ((0, 1), (0, 2), (1, 2)):
            T = Ts[b] @ Ts[a].inv()
            data[f"T_{a}to{b}"] = T
            data[f"T_{b}to{a}"] = T.inv()
        return data


class MegaDepth(BaseDataset):
    default_conf = {
        "name": "megadepth",
        "views": 2,  # 3: triplets for the TripletPipeline
        "data_dir": "megadepth/",  # under DATA_PATH, or absolute
        "depth_subpath": "depth_undistorted/",
        "image_subpath": "Undistorted_SfM/",
        "info_dir": "scene_info/",
        "train_split": "train_scenes_clean.txt",
        "train_num_per_scene": 500,
        "val_split": "valid_scenes_clean.txt",
        "val_num_per_scene": None,
        "test_split": "test_scenes_clean.txt",
        "test_num_per_scene": None,
        "min_overlap": 0.3,
        "max_overlap": 1.0,
        "num_overlap_bins": 1,
        "read_depth": True,
        "grayscale": False,
        "preprocessing": ImagePreprocessor.default_conf,
        "seed": 0,
        # cached features (scripts/export_megadepth.py): `path` is a format
        # string over {scene}, under DATA_PATH
        "load_features": {
            "do": False,
            "path": "exports/megadepth/{scene}_sift_2048.h5",
            "data_keys": None,  # None: every key of the view's group
            "padding_length": 2048,
        },
    }

    def _init(self, conf):
        if not (Path(DATA_PATH) / conf.data_dir).exists():
            raise FileNotFoundError(
                f"{Path(DATA_PATH) / conf.data_dir} is missing: the MegaDepth tree is not "
                "downloaded; place it under the data path (GLUEFACTORY_TPU_TORCH_DATA)")
        self._splits = {}

    def get_dataset(self, split):
        if split not in self._splits:
            cls = _TripletDataset if self.conf.views == 3 else _PairDataset
            self._splits[split] = cls(self.conf, split, self)
        return self._splits[split]

    def sample_new_items(self, seed):
        for ds in self._splits.values():
            ds.sample_new_items(seed)


__main_dataset__ = MegaDepth
