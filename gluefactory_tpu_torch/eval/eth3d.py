"""ETH3D matching-AP benchmark (counterpart of gluefactory_tpu/eval/eth3d.py):
the two-view pipeline runs with the ground truth in its forward pass
(`depth_matcher`, `run_gt_in_forward`), the export keeps the matches, their
scores and the ground-truth matches, and the evaluation merges every pair's
true and false positives into one precision-recall curve and its AP.
`SyntheticETH3DPipeline` applies the same protocol to `synthetic_two_view`.

    python -m gluefactory_tpu_torch.eval.eth3d [--synthetic] [--conf FILE.json]
        [--checkpoint weights/hermetic/sp_open_lg.npz] [--device cuda|cpu]
        [--overwrite] [--overwrite_eval] [key=value ...]

Reads GLUEFACTORY_TPU_TORCH_DATA/ETH3D_undistorted (nothing is downloaded)
and writes to GLUEFACTORY_TPU_TORCH_EVAL/eth3d/<tag>; prints the summaries
as JSON. The predictions are the port's `.npz` (the JAX package's HDF5
holds the same content). The synthetic variant's default extractor is the
JAX package's `sift`, the host OpenCV SIFT, which is not portable: it
raises; pass `model.extractor.name=sift_tpu`.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..settings import EVAL_PATH
from ..utils.export_predictions import export_predictions, load_predictions
from .eval_pipeline import EvalPipeline
from .io import get_eval_parser, parse_eval_args
from .utils import aggregate_pr_results, get_tp_fp_pts


def eval_dataset_pr(pred_file, suffix=""):
    """One precision-recall curve and its AP over every exported pair, the
    pairs taken in the JAX package's HDF5 order (by name, level by level)."""
    results = defaultdict(list)
    results["num_pos" + suffix] = 0
    line = "line_" if suffix else ""
    key_m, key_s, key_gt = f"{line}matches0", f"{line}matching_scores0", f"gt_{line}matches0"
    preds = load_predictions(pred_file)
    for name in sorted(preds, key=lambda n: n.split("/")):
        pred = preds[name]
        if key_m not in pred:
            continue
        scores = np.asarray(pred[key_s])
        order = np.argsort(scores)[::-1]
        tp, fp, sc, num_pos = get_tp_fp_pts(np.asarray(pred[key_m])[order],
                                            np.asarray(pred[key_gt])[order], scores[order])
        results["tp" + suffix].append(tp)
        results["fp" + suffix].append(fp)
        results["scores" + suffix].append(sc)
        results["num_pos" + suffix] += num_pos
    return aggregate_pr_results(results, suffix=suffix)


class ETH3DPipeline(EvalPipeline):
    default_conf = {
        "data": {"name": "eth3d", "test_batch_size": 1},
        "model": {
            "name": "two_view_pipeline",
            "extractor": {"name": "superpoint_open", "max_num_keypoints": 1024,
                          "detection_threshold": 0.0},
            "matcher": {"name": "lightglue", "filter_threshold": 0.1},
            "ground_truth": {"name": "depth_matcher", "th_positive": 3.0},
            "run_gt_in_forward": True,
        },
        "eval": {"eval_lines": False},
    }
    export_keys = ["gt_matches0", "matches0", "matching_scores0"]
    optional_export_keys = ["gt_line_matches0", "line_matches0", "line_matching_scores0"]

    def make_dataset(self, data_conf):
        from ..datasets import get_dataset

        return get_dataset(data_conf.get("name", "eth3d"))(data_conf)

    def get_dataloader(self, data_conf=None):
        return self.make_dataset(data_conf or self.conf.data).get_data_loader("test")

    def get_eval_data(self):
        return ()  # the evaluation reads the predictions only

    def get_predictions(self, experiment_dir, model=None, overwrite=False):
        pred_file = Path(experiment_dir) / "predictions.npz"
        if pred_file.exists() and not overwrite:
            return pred_file
        from .export_helper import make_export_apply_fn

        apply_fn, _ = make_export_apply_fn(self.conf.model, live_params=model, device=self.device)
        export_predictions(self.get_dataloader(), apply_fn, pred_file, keys=self.export_keys,
                           optional_keys=self.optional_export_keys)
        return pred_file

    def run_eval(self, loader, pred_file):
        r = eval_dataset_pr(pred_file)
        if self.conf.eval.eval_lines:
            r.update(eval_dataset_pr(pred_file, suffix="_lines"))
        s = {"AP": r["AP"]}
        if "AP_lines" in r:
            s["AP_lines"] = r["AP_lines"]
        return s, {}, r


class SyntheticETH3DPipeline(ETH3DPipeline):
    """The same protocol on the synthetic 3D pairs."""

    default_conf = {
        "data": {"name": "synthetic_two_view", "test_size": 10, "image_size": [400, 300],
                 "test_batch_size": 1},
        "model": {
            "name": "two_view_pipeline",
            "extractor": {"name": "sift", "max_num_keypoints": 512},
            "matcher": {"name": "nearest_neighbor_matcher", "ratio_thresh": 0.9},
            "ground_truth": {"name": "depth_matcher", "th_positive": 3.0},
            "run_gt_in_forward": True,
        },
        "eval": {"eval_lines": False},
    }


def main(argv=None):
    parser = get_eval_parser()
    parser.add_argument("--synthetic", action="store_true")
    args = parser.parse_intermixed_args(argv)
    cls = SyntheticETH3DPipeline if args.synthetic else ETH3DPipeline
    tag, conf = parse_eval_args("eth3d", args, cls.default_conf)
    pipeline = cls(conf, device=args.device)
    summaries, _, _ = pipeline.run(Path(EVAL_PATH) / "eth3d" / tag, overwrite=args.overwrite,
                                   overwrite_eval=args.overwrite_eval)
    print(json.dumps(summaries))
    return summaries


if __name__ == "__main__":
    main()
