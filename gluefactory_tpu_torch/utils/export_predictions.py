"""Export model predictions over a dataset (counterpart of
gluefactory_tpu/utils/export_predictions.py): one `.npz` file in place of
the HDF5 file, with one array a sample and key, named `<name>/<key>`."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from .tensor import to_numpy

logger = logging.getLogger(__name__)


def export_predictions(loader, apply_fn, output_file: Path, keys: str | list = "*",
                       optional_keys: list = ()):
    """apply_fn(batch) -> dict of batched tensors or arrays. Writes the keys
    `keys` (all with "*") plus those of `optional_keys` that the model gives;
    a 0-d value (e.g. LightGlue's `stop_layer`) is written for every sample."""
    output_file = Path(output_file)
    output_file.parent.mkdir(exist_ok=True, parents=True)
    arrays: dict = {}
    written: set = set()
    for data in loader:
        pred = apply_fn(data)
        pred = {k: to_numpy(v) for k, v in pred.items() if hasattr(v, "shape")}
        if keys != "*":
            if len(set(keys) - set(pred.keys())) > 0:
                raise ValueError(f"Missing key {set(keys) - set(pred.keys())}")
            pred = {k: v for k, v in pred.items() if k in list(keys) + list(optional_keys)}

        # The reference's rescale to the original resolution, kept as it is
        # (ROADMAP Queue 3a, "export_predictions rescale"): it looks up
        # `scales0` / `scales1` inside `view0` / `view1`, whose key is
        # `scales`, so on HPatches it never fires and the keypoints stay in
        # the processed frame of `H_0to1` and `image_size`.
        for idx_view in ("0", "1", ""):
            scales_key = f"scales{idx_view}" if idx_view else "scales"
            view = data.get(f"view{idx_view}", data if idx_view == "" else {})
            if isinstance(view, dict) and scales_key in view:
                scale = np.asarray(view[scales_key])
                kk = f"keypoints{idx_view}"
                if kk in pred:
                    pred[kk] = pred[kk] * scale[..., None, :]

        names = data["name"]
        if isinstance(names, (str, bytes)):
            names = [names]
        for b, name in enumerate(names):
            if str(name) in written:
                logger.warning("Duplicate sample name %s, skipping", name)
                continue
            written.add(str(name))
            for k, v in pred.items():
                arrays[f"{name}/{k}"] = v[b] if v.ndim else v
    np.savez(output_file, **arrays)
    logger.info("Saved predictions to %s", output_file)
    return output_file


def load_predictions(pred_file: Path) -> dict:
    """{name: {key: array}} of an exported `.npz` file."""
    out: dict = {}
    with np.load(str(pred_file)) as f:
        for full in f.files:
            name, key = full.rsplit("/", 1)
            out.setdefault(name, {})[key] = f[full]
    return out


__all__ = ["export_predictions", "load_predictions"]
