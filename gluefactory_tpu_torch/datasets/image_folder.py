"""Single images from a folder or a list (counterpart of
gluefactory_tpu/datasets/image_folder.py), for feature export and one-view
inference. Images are read with `read_image` (JPEG, PNG or PPM / PGM)."""

from __future__ import annotations

from pathlib import Path

from ..settings import DATA_PATH
from .base_dataset import BaseDataset
from .utils import ImagePreprocessor, read_image


class _FolderSplit:
    def __init__(self, parent):
        self.parent = parent

    def __len__(self):
        return len(self.parent.images)

    def __getitem__(self, idx):
        path = self.parent.images[idx]
        img = read_image(path, self.parent.conf.grayscale)
        if img is None:
            raise IOError(f"Cannot read {path}")
        return {"name": str(path.name), "idx": idx, **self.parent.preprocessor(img)}


class ImageFolder(BaseDataset):
    default_conf = {
        "name": "image_folder",
        "glob": ["*.jpg", "*.png", "*.jpeg", "*.JPG", "*.PNG", "*.ppm"],
        "images": None,  # a folder (under DATA_PATH unless absolute) or a list of paths
        "root_folder": "/",
        "grayscale": False,
        "preprocessing": ImagePreprocessor.default_conf,
        "test_batch_size": 1,
    }

    def _init(self, conf):
        if isinstance(conf.images, str):
            folder = Path(conf.images)
            if not folder.is_absolute():
                folder = Path(DATA_PATH) / folder
            images = [p for g in conf.glob for p in folder.glob("**/" + g)]
            if not images:
                raise ValueError(f"No images found in {folder}")
            self.images = sorted(images)
        elif conf.images:
            self.images = [Path(i) for i in conf.images]
            for p in self.images:
                if not p.exists():
                    raise FileNotFoundError(p)
        else:
            raise ValueError("conf.images must be a directory or a list")
        self.preprocessor = ImagePreprocessor(conf.preprocessing)

    def get_dataset(self, split):
        return _FolderSplit(self)


__main_dataset__ = ImageFolder
