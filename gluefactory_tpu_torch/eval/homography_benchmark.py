"""Shared core of the homography benchmarks (counterpart of
gluefactory_tpu/eval/homography_benchmark.py).

Export: the two-view pipeline on the device, `predictions.h5` of the export keys
(and LightGlue's `stop_layer` where the matcher gives it). Eval, per pair,
with its ground truth read from the image headers (no pixels): match
precision, the score-weighted DLT, and RANSAC at `ransac_th` or, with -1,
at each of 0.5 ... 3.0 (one batched estimator call for the sweep);
summaries are the medians, the H-AUC at 1/3/5 px of the threshold with the
best mean AUC, and the DLT's H-AUC.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from ..datasets.base_dataset import collate
from ..utils.export_predictions import export_predictions, load_predictions
from ..utils.tensor import index_batch
from ..utils.tools import cal_error_auc
from .eval_pipeline import EvalPipeline
from .utils import (
    eval_homography_dlt,
    eval_homography_robust_sweep,
    eval_matches_homography,
    eval_poses,
)


class HomographyBenchmarkPipeline(EvalPipeline):
    default_conf = {
        "data": {},
        "model": {
            "name": "two_view_pipeline",
            "extractor": {"name": "superpoint_open", "max_num_keypoints": 1024,
                          "detection_threshold": 0.0},
            "matcher": {"name": "lightglue", "filter_threshold": 0.1},
        },
        "eval": {
            "estimator": "jax_ransac",  # the port's torch_ransac
            "ransac_th": 1.0,  # -1 sweeps [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
        },
    }
    export_keys = [
        "keypoints0", "keypoints1", "keypoint_scores0", "keypoint_scores1",
        "matches0", "matches1", "matching_scores0", "matching_scores1",
    ]
    optional_export_keys = ["stop_layer"]

    def make_dataset(self, data_conf=None):
        raise NotImplementedError

    def get_dataloader(self, data_conf=None):
        return self.make_dataset(data_conf or self.conf.data).get_data_loader("test")

    def get_eval_data(self):
        """Batches of one pair's ground truth (H_0to1, image sizes) read from
        the image headers: the eval phase needs no pixels."""
        split = self.make_dataset(self.conf.data).get_dataset("test")
        return (collate([split.metadata(i)]) for i in range(len(split)))

    def get_predictions(self, experiment_dir, model=None, overwrite=False):
        pred_file = Path(experiment_dir) / "predictions.h5"
        if pred_file.exists() and not overwrite:
            return pred_file
        from .export_helper import make_export_apply_fn

        apply_fn, _ = make_export_apply_fn(self.conf.model, live_params=model, device=self.device)
        export_predictions(self.get_dataloader(), apply_fn, pred_file, keys=self.export_keys,
                           optional_keys=self.optional_export_keys)
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
                results_i = eval_matches_homography(data_i, pred, self.device)
                results_i.update(eval_homography_dlt(data_i, pred, self.device))
                sweep = eval_homography_robust_sweep(
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
        auc_ths = [1, 3, 5]
        best_s, best_th = eval_poses(pose_results, auc_ths=auc_ths, key="H_error_ransac",
                                     unit="px")
        results = {**results, **{f"{k}_{best_th}": v for k, v in pose_results[best_th].items()}}
        summaries = {**summaries, **best_s}
        dlt_errs = np.array(results["H_error_dlt"], dtype=float)
        dlt_aucs = cal_error_auc(np.nan_to_num(dlt_errs, nan=1e6, posinf=1e6), auc_ths)
        for i, ath in enumerate(auc_ths):
            summaries[f"H_error_dlt@{ath}px"] = dlt_aucs[i]
        return summaries, {}, dict(results)


__all__ = ["HomographyBenchmarkPipeline"]
