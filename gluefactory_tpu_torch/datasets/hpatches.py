"""HPatches homography dataset (counterpart of
gluefactory_tpu/datasets/hpatches.py).

Expects DATA_PATH/hpatches-sequences-release/<scene>/{1..6}.ppm and
H_1_{2..6} on disk (nothing is downloaded). 116 scenes after
IGNORED_SCENES, 5 pairs each (image 1 against 2..6), in sorted scene order;
both views go through the preprocessor and the ground truth follows the
resize (`scale_homography`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..settings import DATA_PATH
from .base_dataset import BaseDataset
from .utils import ImagePreprocessor, read_image, read_image_size, scale_homography

# scenes excluded for their size, as in the reference
IGNORED_SCENES = (
    "i_contruction", "i_crownnight", "i_dc", "i_pencils", "i_whitebuilding",
    "v_artisans", "v_astronautis", "v_talent",
)


class _HPatchesSplit:
    def __init__(self, parent):
        self.parent = parent
        self.items = parent.items

    def __len__(self):
        return len(self.items)

    def _item(self, idx, view):
        scene, i = self.items[idx]
        root = self.parent.root / scene
        d0, d1 = view(root / "1.ppm"), view(root / f"{i}.ppm")
        H = np.loadtxt(root / f"H_1_{i}").astype(np.float32)
        return {
            "name": f"{scene}/{i}",
            "scene": scene,
            "idx": idx,
            "H_0to1": scale_homography(H, d0["scales"], d1["scales"]),
            "view0": d0,
            "view1": d1,
        }

    def __getitem__(self, idx):
        grey, pre = self.parent.conf.grayscale, self.parent.preprocessor
        return self._item(idx, lambda path: pre(read_image(path, grey)))

    def metadata(self, idx):
        """The item without its images: name, scene, idx, H_0to1 and each
        view's image_size and scales, from the image headers."""
        return self._item(idx, lambda path: self.parent.preprocessor.metadata(
            *read_image_size(path)))


class HPatchesDataset(BaseDataset):
    default_conf = {
        "name": "hpatches",
        "data_dir": "hpatches-sequences-release",  # under DATA_PATH, or absolute
        "preprocessing": {"resize": 480, "side": "short", "grayscale": False, "pad_to": None},
        "subset": None,  # "i" (illumination) | "v" (viewpoint) | None
        "grayscale": True,
        "ignore_large_images": True,
        "test_batch_size": 1,
    }

    def _init(self, conf):
        self.root = Path(DATA_PATH) / conf.data_dir
        if not self.root.exists():
            raise FileNotFoundError(
                f"HPatches not found at {self.root}: put hpatches-sequences-release there "
                "or set GLUEFACTORY_TPU_TORCH_DATA")
        self.preprocessor = ImagePreprocessor(conf.preprocessing)
        scenes = sorted(p.name for p in self.root.iterdir() if p.is_dir())
        if conf.ignore_large_images:
            scenes = [s for s in scenes if s not in IGNORED_SCENES]
        if conf.subset:
            scenes = [s for s in scenes if s.startswith(f"{conf.subset}_")]
        self.items = [(s, i) for s in scenes for i in range(2, 7)]

    def get_dataset(self, split):
        assert split in ("test", "val")
        return _HPatchesSplit(self)


__main_dataset__ = HPatchesDataset
