"""Per-pair evaluation of homography and relative-pose benchmarks, and the
precision-recall AP of ground-truth-labelled matches (counterpart of
gluefactory_tpu/eval/utils.py).

Predictions come in as numpy arrays (the export file); the selection of the
matched pairs is numpy on the host, the geometry (symmetric and epipolar
errors, weighted DLT, RANSAC, corner and pose errors) runs on `device`, the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..estimators.base_estimator import load_estimator
from ..geometry.epipolar import generalized_epi_dist, relative_pose_error
from ..geometry.homography import homography_corner_error, solve_homography_dlt, sym_homography_error
from ..utils.tools import AUCMetric


def get_matches_scores(kpts0, kpts1, matches0, mscores0):
    """The matched keypoint pairs and their scores (host, numpy)."""
    kpts0, kpts1 = np.asarray(kpts0), np.asarray(kpts1)
    matches0, mscores0 = np.asarray(matches0), np.asarray(mscores0)
    m0 = matches0 > -1
    return kpts0[m0], kpts1[matches0[m0]], mscores0[m0]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _corner_error(H, data, device) -> torch.Tensor:
    """Corner errors of (..., 3, 3) homographies against the pair's ground
    truth, over view 0's image size: (...)."""
    size = np.asarray(data["view0"]["image_size"]).reshape(-1)[:2]
    return homography_corner_error(H, _f32(data["H_0to1"], device), _f32(size, device))


def eval_matches_homography(data: dict, pred: dict, device: Any = "cuda") -> dict:
    """Match precision at 1 and 3 px against the ground-truth homography."""
    kp0, kp1 = pred["keypoints0"], pred["keypoints1"]
    pts0, pts1, _ = get_matches_scores(kp0, kp1, pred["matches0"], pred["matching_scores0"])
    if len(pts0) == 0:
        err = np.zeros(0)
    else:
        err = sym_homography_error(_f32(pts0, device)[None], _f32(pts1, device)[None],
                                   _f32(data["H_0to1"], device)[None])[0].cpu().numpy()
    return {
        "prec@1px": float(np.nan_to_num((err < 1).mean() if len(err) else 0.0)),
        "prec@3px": float(np.nan_to_num((err < 3).mean() if len(err) else 0.0)),
        "num_matches": int(len(pts0)),
        "num_keypoints": (np.asarray(kp0).shape[-2] + np.asarray(kp1).shape[-2]) / 2,
    }


def eval_homography_robust(data: dict, pred: dict, conf: dict, device: Any = "cuda") -> dict:
    """Robust homography (RANSAC by default) at `conf["ransac_th"]` and its
    corner error."""
    return eval_homography_robust_sweep(data, pred, conf, [conf["ransac_th"]], device)[0]


def eval_homography_robust_sweep(data: dict, pred: dict, conf: dict, thresholds,
                                 device: Any = "cuda") -> list:
    """`eval_homography_robust` at each of `thresholds`, one estimator call
    for all of them (the same draws for every threshold, as the JAX
    package's evaluation gives them): a list of result dicts."""
    failed = {"H_error_ransac": float("inf"), "ransac_inl": 0, "ransac_inl%": 0.0}
    pts0, pts1, _ = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                       pred["matches0"], pred["matching_scores0"])
    if len(pts0) < 4:
        return [dict(failed) for _ in thresholds]
    conf = {**conf, "ransac_th": [float(t) for t in thresholds]}
    estimator = load_estimator("homography", conf.get("estimator", "jax_ransac"))(conf, device)
    est = estimator({"m_kpts0": pts0, "m_kpts1": pts1})
    err = _corner_error(torch.as_tensor(est["M_0to1"], dtype=torch.float32, device=device),
                        data, device)
    # one transfer: success, the errors and the inliers of every threshold
    success, err, inl = (torch.as_tensor(t).cpu().numpy() for t in (est["success"], err,
                                                                     est["inliers"]))
    out = []
    for ok, e, inl_t in zip(success, err, inl.astype(bool)):
        out.append({"H_error_ransac": float(e), "ransac_inl": int(inl_t.sum()),
                    "ransac_inl%": float(inl_t.mean()) if len(inl_t) else 0.0}
                   if ok else dict(failed))
    return out


def eval_homography_dlt(data: dict, pred: dict, device: Any = "cuda") -> dict:
    """Score-weighted DLT homography over all matches and its corner error."""
    pts0, pts1, scores = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                            pred["matches0"], pred["matching_scores0"])
    if len(pts0) < 4:
        return {"H_error_dlt": float("inf")}
    H = solve_homography_dlt(_f32(pts0, device)[None], _f32(pts1, device)[None],
                             _f32(scores, device)[None])[0]
    e = float(_corner_error(H, data, device))
    return {"H_error_dlt": e if np.isfinite(e) else float("inf")}


def eval_matches_epipolar(data: dict, pred: dict, device: Any = "cuda") -> dict:
    """Epipolar precision of the matches: the share whose symmetric epipolar
    distance under the ground-truth pose, in normalised units, is under
    1e-4, 5e-4 and 1e-3."""
    kp0, kp1 = pred["keypoints0"], pred["keypoints1"]
    pts0, pts1, _ = get_matches_scores(kp0, kp1, pred["matches0"], pred["matching_scores0"])
    results = {}
    if len(pts0) == 0:
        results.update({f"epi_prec@{th}": 0.0 for th in ("1e-4", "5e-4", "1e-3")})
    else:
        cam = lambda v: data[v]["camera"].to(device)
        err = generalized_epi_dist(_f32(pts0, device)[None], _f32(pts1, device)[None],
                                   cam("view0"), cam("view1"), data["T_0to1"].to(device),
                                   all_pairs=False, essential=True)[0].cpu().numpy()
        for th in ("1e-4", "5e-4", "1e-3"):
            results[f"epi_prec@{th}"] = float((err < float(th)).mean())
    results["num_matches"] = int(len(pts0))
    results["num_keypoints"] = (np.asarray(kp0).shape[-2] + np.asarray(kp1).shape[-2]) / 2
    return results


def eval_relative_pose_robust(data: dict, pred: dict, conf: dict, device: Any = "cuda") -> dict:
    """Robust relative pose (RANSAC by default) at `conf["ransac_th"]`
    pixels and its error: the larger of the rotation and translation angles
    in degrees."""
    return eval_relative_pose_robust_sweep(data, pred, conf, [conf["ransac_th"]], device)[0]


def eval_relative_pose_robust_sweep(data: dict, pred: dict, conf: dict, thresholds,
                                    device: Any = "cuda") -> list:
    """`eval_relative_pose_robust` at each of `thresholds`, one estimator
    call for all of them (the same draws for every threshold, as the JAX
    package's evaluation gives them): a list of result dicts."""
    failed = {"rel_pose_error": float("inf"), "ransac_inl": 0, "ransac_inl%": 0.0}
    pts0, pts1, _ = get_matches_scores(pred["keypoints0"], pred["keypoints1"],
                                       pred["matches0"], pred["matching_scores0"])
    if len(pts0) < 8:
        return [dict(failed) for _ in thresholds]
    conf = {**conf, "ransac_th": [float(t) for t in thresholds]}
    estimator = load_estimator("relative_pose", conf.get("estimator", "jax_ransac"))(conf, device)
    est = estimator({"m_kpts0": pts0, "m_kpts1": pts1, "camera0": data["view0"]["camera"],
                     "camera1": data["view1"]["camera"]})
    M = est["M_0to1"]
    t_err, r_err = relative_pose_error(data["T_0to1"].to(device), M.R, M.t)
    # one transfer: success, the errors and the inliers of every threshold
    success, err, inl = (t.cpu().numpy() for t in (est["success"], torch.maximum(r_err, t_err),
                                                   est["inliers"]))
    out = []
    for ok, e, inl_t in zip(success, err, inl.astype(bool)):
        out.append({"rel_pose_error": float(e), "ransac_inl": int(inl_t.sum()),
                    "ransac_inl%": float(inl_t.mean()) if len(inl_t) else 0.0}
                   if ok else dict(failed))
    return out


def eval_poses(pose_results: dict, auc_ths: list, key: str, unit: str = "°"):
    """Summarise a {threshold: {key: [per-pair errors]}} sweep: the AUC at
    each of `auc_ths` for the threshold of best mean AUC, and the medians of
    that threshold's per-pair results. Returns (summaries, best threshold)."""
    pose_aucs = {th: AUCMetric(auc_ths, results_i[key]).compute()
                 for th, results_i in pose_results.items()}
    mAAs = {k: float(np.mean(v)) for k, v in pose_aucs.items()}
    best_th = max(mAAs, key=mAAs.get)
    summaries = {}
    for i, ath in enumerate(auc_ths):
        summaries[f"{key}@{ath}{unit}"] = pose_aucs[best_th][i]
    summaries[f"{key}_mAA"] = mAAs[best_th]
    for k, v in pose_results[best_th].items():
        arr = np.array(v)
        if np.issubdtype(arr.dtype, np.number):
            summaries[f"m{k}"] = round(float(np.median(arr)), 3)
    return summaries, best_th


def get_tp_fp_pts(pred_matches, gt_matches, pred_scores, ignore_label=-2):
    """One pair's true / false positive flags and scores of its predicted
    matches, and its count of ground-truth positives; keypoints labelled
    `ignore_label` are left out."""
    pred_matches, gt_matches, pred_scores = (np.asarray(x) for x in
                                             (pred_matches, gt_matches, pred_scores))
    keep = gt_matches != ignore_label
    pred_matches, gt_matches, pred_scores = pred_matches[keep], gt_matches[keep], pred_scores[keep]
    num_pos = int(np.sum(gt_matches != -1))
    pos = pred_matches != -1
    tp = pred_matches[pos] == gt_matches[pos]
    fp = pred_matches[pos] != gt_matches[pos]
    return tp, fp, pred_scores[pos], num_pos


def AP(tp, fp):
    """Area under the interpolated precision-recall curve of cumulative
    (recall, false positives / positives)."""
    recall = tp
    precision = tp / np.maximum(tp + fp, 1e-9)
    recall = np.concatenate(([0.0], recall, [1.0]))
    precision = np.concatenate(([0.0], precision, [0.0]))
    for i in range(precision.size - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    i = np.where(recall[1:] != recall[:-1])[0]
    return float(np.sum((recall[i + 1] - recall[i]) * precision[i + 1]))


def aggregate_pr_results(results, suffix=""):
    """Every pair's flags merged into one curve by descending score: the
    curve and its AP in percent."""
    tp_list = np.concatenate(results["tp" + suffix], axis=0)
    fp_list = np.concatenate(results["fp" + suffix], axis=0)
    scores_list = np.concatenate(results["scores" + suffix], axis=0)
    n_gt = max(results["num_pos" + suffix], 1)
    idx = np.argsort(scores_list)[::-1]
    tp_vals = np.cumsum(tp_list[idx]) / n_gt
    fp_vals = np.cumsum(fp_list[idx]) / n_gt
    return {"curve_recall" + suffix: tp_vals,
            "curve_precision" + suffix: tp_vals / np.maximum(tp_vals + fp_vals, 1e-9),
            "AP" + suffix: AP(tp_vals, fp_vals) * 100}


__all__ = [
    "get_matches_scores", "eval_matches_homography", "eval_homography_robust",
    "eval_homography_robust_sweep", "eval_homography_dlt", "eval_matches_epipolar",
    "eval_relative_pose_robust", "eval_relative_pose_robust_sweep", "eval_poses",
    "get_tp_fp_pts", "AP", "aggregate_pr_results",
]
