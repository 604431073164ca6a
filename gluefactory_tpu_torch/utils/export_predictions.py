"""Export model predictions over a dataset to HDF5 (counterpart of
gluefactory_tpu/utils/export_predictions.py), in the JAX package's layout:
one group a sample name (a name with "/" nests, as h5py makes it) and one
dataset a key, written by the port's own HDF5 writer (`utils/hdf5.py`).
Files written by either package read in the other.

One difference is kept: a 0-d value (LightGlue's `stop_layer`) is written
for every sample, where the JAX function's `v[b]` raises on it (ROADMAP
Queue 3a)."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from . import hdf5
from .tensor import to_numpy

logger = logging.getLogger(__name__)


def export_predictions(loader, apply_fn, output_file: Path, as_half: bool = False,
                       keys: str | list = "*", callback_fn=None, optional_keys: list = ()):
    """apply_fn(batch) -> dict of batched tensors or arrays. Writes the keys
    `keys` (all with "*") plus those of `optional_keys` that the model gives,
    with `callback_fn(pred, data)`'s entries under the model's (the model's
    win a clash); `as_half` stores float32 as float16. A repeated sample
    name is skipped with a warning."""
    output_file = Path(output_file)
    output_file.parent.mkdir(exist_ok=True, parents=True)
    written: set = set()
    with hdf5.File(output_file, "w") as hfile:
        for data in loader:
            pred = apply_fn(data)
            pred = {k: to_numpy(v) for k, v in pred.items() if hasattr(v, "shape")}
            if callback_fn is not None:
                pred = {**callback_fn(pred, data), **pred}
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

            if as_half:
                pred = {k: v.astype(np.float16) if v.dtype == np.float32 else v
                        for k, v in pred.items()}

            names = data["name"]
            if isinstance(names, (str, bytes)):
                names = [names]
            for b, name in enumerate(names):
                if str(name) in written:
                    logger.warning("Duplicate sample name %s, skipping", name)
                    continue
                written.add(str(name))
                grp = hfile.create_group(str(name))
                for k, v in pred.items():
                    grp.create_dataset(k, data=v[b] if v.ndim else v)
    logger.info("Saved predictions to %s", output_file)
    return output_file


def load_predictions(pred_file: Path) -> dict:
    """{name: {key: array}} of an exported file, nested names joined by "/"."""
    out: dict = {}

    def walk(group, prefix):
        for key in group.keys():
            node = group[key]
            if isinstance(node, hdf5.Group):
                walk(node, f"{prefix}{key}/")
            else:
                out.setdefault(prefix[:-1], {})[key] = np.asarray(node)

    with hdf5.File(pred_file, "r") as f:
        walk(f, "")
    return out


__all__ = ["export_predictions", "load_predictions"]
