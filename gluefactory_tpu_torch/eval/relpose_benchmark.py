"""Shared core of the relative-pose benchmarks (counterpart of
gluefactory_tpu/eval/relpose_benchmark.py, the MegaDepth-1500 protocol).

Export: the two-view pipeline on the device, `predictions.h5` of the export
keys.
Eval, per pair, with its cameras and ground-truth pose from the data
loader: the epipolar precision of the matches, and RANSAC at `ransac_th`
pixels or, with -1, at each of 0.5 ... 3.0 (one batched estimator call for
the sweep); summaries are the medians and the
pose AUC at 5/10/20 degrees of the threshold with the best mean AUC (mAA).
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from ..utils.export_predictions import export_predictions, load_predictions
from ..utils.tensor import index_batch
from .eval_pipeline import EvalPipeline
from .utils import eval_matches_epipolar, eval_poses, eval_relative_pose_robust_sweep


class RelPoseBenchmarkPipeline(EvalPipeline):
    default_conf = {
        "data": {},
        "model": {
            "name": "two_view_pipeline",
            "extractor": {"name": "superpoint_open", "max_num_keypoints": 2048,
                          "detection_threshold": 0.0},
            "matcher": {"name": "lightglue", "filter_threshold": 0.1},
        },
        "eval": {
            "estimator": "jax_ransac",  # the port's torch_ransac
            "ransac_th": 2.0,  # -1 sweeps [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
        },
    }
    export_keys = [
        "keypoints0", "keypoints1", "keypoint_scores0", "keypoint_scores1",
        "matches0", "matches1", "matching_scores0", "matching_scores1",
    ]

    def make_dataset(self, data_conf):
        raise NotImplementedError

    def get_dataloader(self, data_conf=None):
        return self.make_dataset(data_conf or self.conf.data).get_data_loader("test")

    def get_predictions(self, experiment_dir, model=None, overwrite=False):
        pred_file = Path(experiment_dir) / "predictions.h5"
        if pred_file.exists() and not overwrite:
            return pred_file
        from .export_helper import make_export_apply_fn

        apply_fn, _ = make_export_apply_fn(self.conf.model, live_params=model, device=self.device)
        export_predictions(self.get_dataloader(), apply_fn, pred_file, keys=self.export_keys)
        return pred_file

    def run_eval(self, loader, pred_file):
        conf = self.conf.eval
        thresholds = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0] if conf.ransac_th == -1 else [conf.ransac_th]
        preds = load_predictions(pred_file)
        results = defaultdict(list)
        pose_results = defaultdict(lambda: defaultdict(list))
        for batch in loader:
            names = batch["name"]
            names = [names] if isinstance(names, (str, bytes)) else names
            for name, data_i in zip(names, index_batch(batch)):
                pred = preds[str(name)]
                results_i = eval_matches_epipolar(data_i, pred, self.device)
                sweep = eval_relative_pose_robust_sweep(
                    data_i, pred, {"estimator": conf.estimator}, thresholds, self.device)
                for th, res in zip(thresholds, sweep):
                    for k, v in res.items():
                        pose_results[th][k].append(v)
                results_i["name"] = str(name)
                for k, v in results_i.items():
                    results[k].append(v)

        summaries = {}
        for k, v in results.items():
            arr = np.array(v)
            if np.issubdtype(arr.dtype, np.number):
                summaries[f"m{k}"] = round(float(np.median(arr)), 3)
        best_s, best_th = eval_poses(pose_results, auc_ths=[5, 10, 20], key="rel_pose_error")
        results = {**results, **{f"{k}_{best_th}": v for k, v in pose_results[best_th].items()}}
        return {**summaries, **best_s}, {}, dict(results)


__all__ = ["RelPoseBenchmarkPipeline"]
