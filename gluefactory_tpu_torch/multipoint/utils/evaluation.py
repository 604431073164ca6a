"""Detector and descriptor metrics of the multispectral models (counterpart
of gluefactory_tpu/multipoint/utils/evaluation.py): repeatability of the
detections under a known homography, localisation error and the descriptor
matching score. Numpy on the host, eval only."""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.homography import warp_points_np
from ...models.extractors.superpoint_open import simple_nms


def keypoints_from_prob(prob: np.ndarray, threshold: float = 0.015, nms: int = 4,
                        top_k: int | None = None):
    """(N, 2) xy keypoints (pixel centres) and their scores, best first, of
    an (H, W) probability map."""
    heat = simple_nms(torch.from_numpy(np.asarray(prob, np.float32))[None], nms)[0].numpy()
    ys, xs = np.where(heat > threshold)
    scores = heat[ys, xs]
    order = np.argsort(-scores)
    if top_k:
        order = order[:top_k]
    return np.stack([xs[order], ys[order]], -1).astype(np.float32) + 0.5, scores[order]


def repeatability(kpts0, kpts1, H_0to1, shape, dist_thresh: float = 3.0) -> float:
    """Share of the keypoints seen in the other image that were detected
    there within dist_thresh, both ways; `shape` is (w, h)."""
    if len(kpts0) == 0 or len(kpts1) == 0:
        return 0.0
    w, h = shape
    k0_w = warp_points_np(kpts0, H_0to1)
    vis0 = (k0_w[:, 0] >= 0) & (k0_w[:, 0] < w) & (k0_w[:, 1] >= 0) & (k0_w[:, 1] < h)
    k1_w = warp_points_np(kpts1, H_0to1, inverse=True)
    vis1 = (k1_w[:, 0] >= 0) & (k1_w[:, 0] < w) & (k1_w[:, 1] >= 0) & (k1_w[:, 1] < h)
    if vis0.sum() == 0 or vis1.sum() == 0:
        return 0.0
    d0 = np.linalg.norm(k0_w[vis0][:, None] - kpts1[None], axis=-1).min(-1)
    d1 = np.linalg.norm(k1_w[vis1][:, None] - kpts0[None], axis=-1).min(-1)
    count = (d0 <= dist_thresh).sum() + (d1 <= dist_thresh).sum()
    return float(count / (vis0.sum() + vis1.sum()))


def localization_error(kpts0, kpts1, H_0to1, dist_thresh: float = 3.0) -> float:
    """Mean distance of the re-detected keypoints (NaN without any)."""
    if len(kpts0) == 0 or len(kpts1) == 0:
        return float("nan")
    k0_w = warp_points_np(kpts0, H_0to1)
    d = np.linalg.norm(k0_w[:, None] - kpts1[None], axis=-1).min(-1)
    close = d <= dist_thresh
    return float(d[close].mean()) if close.any() else float("nan")


def matching_score(desc0, desc1, kpts0, kpts1, H_0to1, dist_thresh: float = 3.0) -> float:
    """Share of the mutual nearest-neighbour descriptor matches that land
    within dist_thresh of the warped keypoint."""
    if len(desc0) == 0 or len(desc1) == 0:
        return 0.0
    sim = desc0 @ desc1.T
    nn0 = sim.argmax(1)
    nn1 = sim.argmax(0)
    mutual = nn1[nn0] == np.arange(len(desc0))
    if mutual.sum() == 0:
        return 0.0
    k0_w = warp_points_np(kpts0[mutual], H_0to1)
    d = np.linalg.norm(k0_w - kpts1[nn0[mutual]], axis=-1)
    return float((d <= dist_thresh).mean())


__all__ = ["keypoints_from_prob", "repeatability", "localization_error", "matching_score"]
