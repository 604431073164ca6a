"""Cache local features and their depths for MegaDepth training (counterpart
of gluefactory_tpu/scripts/export_megadepth.py).

Runs an extractor over every image of each MegaDepth scene (full resolution:
`preprocessing.resize: None`) and writes one HDF5 file a scene,
`{scene}_{method}_{n_kpts}.h5`, with the port's own writer: a group per image
path holding `keypoints`, `keypoint_scores`, `descriptors`, `keypoint_mask`
and, where the view has depth, `depth_keypoints` / `valid_depth_keypoints`
sampled at the keypoints (`geometry.depth.sample_depth`). The dataset's
`load_features` mode reads these files through `CacheLoader`.

    python -m gluefactory_tpu_torch.scripts.export_megadepth --method sp \\
        [--n_kpts 2048] [--splits train val] [--output DIR] \\
        [--checkpoint weights/hermetic/sp_open_lg.npz] [--device cuda|cpu] [data.key=value ...]

`--method sp` is SuperPoint-open (threshold 0) with weights initialised
from torch seed 0 (the JAX script initialises its own from PRNGKey(0)),
unless `--checkpoint` names an `.npz` whose `extractor/` weights are
loaded. `--method sift` (OpenCV SIFT on the host) is not portable and
raises. Files that exist are skipped.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from ..datasets.megadepth import MegaDepth
from ..geometry.depth import sample_depth
from ..models import get_model
from ..settings import DATA_PATH
from ..utils import hdf5
from ..utils.config import merge, parse_dotlist

logger = logging.getLogger(__name__)

METHOD_CONFS = {
    "sift": {"name": "sift", "max_num_keypoints": 2048},
    "sp": {"name": "superpoint_open", "max_num_keypoints": 2048, "detection_threshold": 0.0},
}
KEYS = ("keypoints", "keypoint_scores", "descriptors", "keypoint_mask", "scales", "oris")


def make_extractor(method: str, n_kpts: int, checkpoint=None, device="cuda"):
    if method == "sift":
        raise NotImplementedError(
            "--method sift runs OpenCV's SIFT on the host, which is outside the port (ROADMAP "
            "Queue 1, not portable); use --method sp")
    conf = {**METHOD_CONFS[method], "max_num_keypoints": n_kpts}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the same seeded weights on every call
        model = get_model(conf["name"])(conf, device=device)
    if checkpoint:
        from ..weights import load_npz

        loaded = {k[len("extractor."):]: v for k, v in load_npz(checkpoint).items()
                  if k.startswith("extractor.")}
        model.load_state_dict({**model.state_dict(), **loaded})
    return model.eval()


def export_megadepth(method: str = "sp", n_kpts: int = 2048, splits=("train", "val"),
                     output=None, data_conf=None, checkpoint=None, device="cuda") -> list:
    """Write the scene caches of `splits`; returns the files written."""
    model = make_extractor(method, n_kpts, checkpoint, device)
    out_root = Path(output or (Path(DATA_PATH) / "exports" / "megadepth"))
    out_root.mkdir(parents=True, exist_ok=True)
    # full resolution, unpadded, with no cache of its own, whatever `data_conf` says
    data_conf = merge(data_conf or {}, {"load_features": {"do": False}})
    data_conf["preprocessing"] = {"resize": None}
    dataset = MegaDepth(data_conf, device=device)
    written = []
    for split in splits:
        ds = dataset.get_dataset(split)
        for scene in ds.scenes:
            out_file = out_root / f"{scene}_{method}_{n_kpts}.h5"
            if out_file.exists():
                logger.info("Skipping cached %s", out_file)
                continue
            with hdf5.File(out_file, "w") as hfile:
                for idx, img_path in enumerate(ds.images[scene]):
                    if img_path is None:
                        continue
                    try:
                        view = ds._read_view(scene, idx)
                    except (IOError, OSError):
                        continue
                    img = torch.from_numpy(view["image"][None]).to(model.device)
                    with torch.no_grad():
                        pred = model({"image": img})
                    grp = hfile.create_group(str(img_path))
                    for k in KEYS:
                        if k in pred:
                            grp.create_dataset(k, data=pred[k][0].cpu().numpy())
                    if "depth" in view:
                        depth = torch.from_numpy(view["depth"][None]).to(model.device)
                        d, valid = sample_depth(pred["keypoints"], depth)
                        grp.create_dataset("depth_keypoints", data=d[0].cpu().numpy())
                        grp.create_dataset("valid_depth_keypoints", data=valid[0].cpu().numpy())
            written.append(out_file)
            logger.info("Wrote %s", out_file)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--method", default="sift", choices=METHOD_CONFS)
    parser.add_argument("--n_kpts", type=int, default=2048)
    parser.add_argument("--splits", nargs="+", default=["train", "val"])
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="an .npz whose extractor/ weights are loaded")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("dotlist", nargs="*", help="data.key=value overrides of the dataset")
    args = parser.parse_intermixed_args(argv)
    overrides = parse_dotlist(args.dotlist)
    unknown = set(overrides) - {"data"}
    if unknown:
        raise ValueError(f"only data.* overrides are taken, got {sorted(unknown)}")
    files = export_megadepth(args.method, args.n_kpts, args.splits, args.output,
                             overrides.get("data"), args.checkpoint, args.device)
    for f in files:
        print(f)
    return files


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
