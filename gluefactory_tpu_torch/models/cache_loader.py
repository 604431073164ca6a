"""Cached predictions read from HDF5 by sample name (counterpart of
gluefactory_tpu/models/cache_loader.py).

`CacheLoader` opens the file that `conf.path` names (a format string over the
sample's string fields, e.g. "exports/megadepth/{scene}_sp_open_2048.h5",
under DATA_PATH unless absolute) with the port's own reader
(`utils/hdf5.py`), reads the group of the sample's `name`, casts floats to
`numeric_type`, rescales keypoints by the view's `scales`, and pads local
features to `padding_length` with a `keypoint_mask` (`pad_local_features`).
It runs on the host, in the data pipeline, and gives numpy arrays. Files stay
open (one read-only map each) for the loader's life; threads share them.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np

from ..settings import DATA_PATH
from ..utils import hdf5
from ..utils.config import Config, merge

__all__ = ["CacheLoader", "pad_local_features"]

_PADDED = ("keypoints", "descriptors", "keypoint_scores", "scales", "oris",
           "depth_keypoints", "valid_depth_keypoints")


def pad_local_features(pred: dict, n: int) -> dict:
    """Pad (or cut) keypoints, scores, descriptors and the other per-keypoint
    arrays to n, with a `keypoint_mask` of the valid slots (an existing mask
    is kept on the slots it covers)."""
    out = dict(pred)
    cur = pred["keypoints"].shape[-2]
    mask = np.zeros(n, bool)
    mask[: min(cur, n)] = True
    if "keypoint_mask" in pred:  # keep the invalid slots of an already-padded cache
        mask[: min(cur, n)] &= pred["keypoint_mask"].astype(bool)[: min(cur, n)]
    out["keypoint_mask"] = mask

    def pad(x):
        if x.shape[0] >= n:
            return x[:n]
        return np.concatenate([x, np.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)], 0)

    for key in list(out):
        if key in _PADDED:
            out[key] = pad(out[key])
    return out


class CacheLoader:
    default_conf = {
        "name": "cache_loader",
        "path": None,  # format string, e.g. "exports/{scene}.h5"
        "data_keys": None,  # subset of keys to load, None = all
        "device": None,
        "trainable": False,
        "add_data_path": True,
        "collate": True,
        "scale": ["keypoints", "lines", "orig_lines"],
        "padding_length": None,
        "numeric_type": "float32",
    }

    def __init__(self, conf=None, device=None):
        self.conf = Config(merge(self.default_conf, conf or {}))
        self._files: dict = {}
        self._lock = threading.Lock()

    def _file(self, path: str) -> hdf5.File:
        with self._lock:
            if path not in self._files:
                p = Path(path)
                if self.conf.add_data_path and not p.is_absolute():
                    p = Path(DATA_PATH) / p
                self._files[path] = hdf5.File(p, "r")
            return self._files[path]

    def __call__(self, data: dict) -> dict:
        """`data` holds the sample's `name` and the string fields of
        `conf.path`, and optionally `scales`; returns the cached arrays."""
        path = self.conf.path.format(**{k: v for k, v in data.items() if isinstance(v, str)})
        grp = self._file(path)[str(data["name"])]
        pred = {}
        for k in self.conf.data_keys or grp.keys():
            if k not in grp:
                continue
            v = np.asarray(grp[k])
            if v.dtype.kind == "f" and self.conf.numeric_type:
                v = v.astype(self.conf.numeric_type)
            pred[k] = v
        if "scales" in data:  # cached keypoints into the current view's resolution
            s = np.asarray(data["scales"])
            for k in self.conf.scale:
                if k in pred:
                    pred[k] = pred[k] * s[None, :] if pred[k].ndim == 2 else pred[k] * s
        if self.conf.padding_length:
            pred = pad_local_features(pred, int(self.conf.padding_length))
        return pred

    def close(self):
        with self._lock:
            for f in self._files.values():
                f.close()
            self._files.clear()


__main_model__ = CacheLoader
