"""Robust estimator interface and registry (counterpart of
gluefactory_tpu/estimators/base_estimator.py).

An estimator is configured with `ransac_th` and `options` and called with a
dict of matched keypoints. It runs on its device, the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import importlib
import importlib.util
from typing import Any, ClassVar

from ..models.base_model import resolve_device
from ..utils.config import Config, merge

# the JAX package's estimator names that the port serves with its own
ALIASES = {"jax_ransac": "torch_ransac"}
# estimators of the JAX package built on host libraries the card's machine
# lacks (cv2, poselib, homography_est): not portable until those exist
NOT_PORTABLE = {"opencv", "poselib", "homography_est", "hybrid_pl", "pycolmap"}


class BaseEstimator:
    base_default_conf: ClassVar[dict] = {"name": None, "ransac_th": 3.0, "options": {}}
    default_conf: ClassVar[dict] = {}
    required_data_keys: ClassVar[list] = []

    def __init__(self, conf=None, device: Any = "cuda"):
        self.conf = Config(merge(self.base_default_conf, self.default_conf, conf or {}))
        self.device = resolve_device(device)

    def __call__(self, data: dict) -> dict:
        for key in self.required_data_keys:
            assert key in data, f"Missing key {key} in data"
        return self._forward(data)

    def _forward(self, data: dict) -> dict:
        raise NotImplementedError


def load_estimator(type_: str, name: str):
    """load_estimator("homography", "jax_ransac") -> the port's estimator class."""
    if name in NOT_PORTABLE:
        raise NotImplementedError(
            f"estimator {type_}/{name} needs a host library the port does not use "
            "(ROADMAP Queue 1, not portable)")
    name = ALIASES.get(name, name)
    path = f"{__name__.rsplit('.', 1)[0]}.{type_}.{name}"
    if importlib.util.find_spec(path) is None:
        raise RuntimeError(f"Estimator {type_}/{name} not found")
    return importlib.import_module(path).__main_estimator__


__all__ = ["BaseEstimator", "load_estimator", "ALIASES"]
