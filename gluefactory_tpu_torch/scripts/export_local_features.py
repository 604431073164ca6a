"""Cache the local features of a dataset's views to HDF5 (counterpart of
gluefactory_tpu/scripts/export_local_features.py).

Runs an extractor over every batch of a split (in order) and writes one
group a sample name with the extractor's outputs of each view, suffixed by
the view (`keypoints0`, `descriptors1`, ...; none for a single-view
dataset), as float16 (`as_half`), through `utils.export_predictions`. The
port's `CacheLoader` reads the file.

    python -m gluefactory_tpu_torch.scripts.export_local_features \\
        --dataset homographies --method sp [--split train] [--n_kpts 2048] \\
        [--output FILE] [--checkpoint weights/hermetic/sp_open_lg.npz] \\
        [--device cuda|cpu] [data.key=value ...] [model.key=value ...]

The default output is `DATA_PATH/exports/{dataset}_{split}_{method}_{n_kpts}.h5`.
`--method sp` is SuperPoint-open (threshold 0) with weights initialised
from torch seed 0, or the `extractor/` weights of `--checkpoint` (the JAX
script initialises its own from PRNGKey(0) at the first batch). `--method
sift` (OpenCV SIFT on the host) is not portable and raises. `model.*`
overrides reach the extractor's configuration (e.g. `model.dtype=null`,
`model.fused_block0=true`), which the JAX script does not take.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from ..datasets import get_dataset
from ..settings import DATA_PATH
from ..utils.config import merge, parse_dotlist
from ..utils.export_predictions import export_predictions
from .export_megadepth import METHOD_CONFS, make_extractor

logger = logging.getLogger(__name__)


def export_local_features(dataset: str, method: str = "sp", split: str = "train",
                          n_kpts: int = 2048, output=None, data_conf=None, checkpoint=None,
                          device="cuda", model_conf=None) -> Path:
    """Write the feature cache of `split`; returns its path."""
    model = make_extractor(method, n_kpts, checkpoint, device, model_conf)
    data = get_dataset(dataset)(merge({"name": dataset}, data_conf or {}), device=device)
    loader = data.get_data_loader(split, shuffle=False)

    def apply_fn(batch):
        out = {}
        for v in ("view0", "view1", ""):
            view = batch.get(v, batch if v == "" else None)
            if not isinstance(view, dict) or "image" not in view:
                continue
            img = torch.as_tensor(np.asarray(view["image"]), device=model.device)
            with torch.no_grad():
                pred = model({"image": img})
            out.update({f"{k}{v[-1:]}": val for k, val in pred.items()})
        return out

    out_file = Path(output or (Path(DATA_PATH) / "exports"
                               / f"{dataset}_{split}_{method}_{n_kpts}.h5"))
    export_predictions(loader, apply_fn, out_file, as_half=True)
    logger.info("Feature cache written to %s", out_file)
    return out_file


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--method", type=str, default="sift", choices=METHOD_CONFS)
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--n_kpts", type=int, default=2048)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="an .npz whose extractor/ weights are loaded")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("dotlist", nargs="*",
                        help="data.key=value overrides of the dataset, model.key=value of the "
                             "extractor")
    args = parser.parse_intermixed_args(argv)
    overrides = parse_dotlist(args.dotlist)
    unknown = set(overrides) - {"data", "model"}
    if unknown:
        raise ValueError(f"only data.* and model.* overrides are taken, got {sorted(unknown)}")
    out = export_local_features(args.dataset, args.method, args.split, args.n_kpts, args.output,
                                overrides.get("data"), args.checkpoint, args.device,
                                overrides.get("model"))
    print(out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
