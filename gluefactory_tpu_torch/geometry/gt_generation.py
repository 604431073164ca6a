"""Ground-truth matches for supervision from the pair homography or from
the relative pose and depth (counterpart of
gluefactory_tpu/geometry/gt_generation.py:24-174; the line variants wait
for GlueStick and the line extractors, ROADMAP Queue 1 items 3 and 5).

Labels per keypoint: the index of its match, UNMATCHED_FEATURE (-1) or
IGNORE_FEATURE (-2). Keypoint sets have a fixed size with optional validity
masks: padded entries are labelled IGNORE and taken out of the distance
matrices.
"""

from __future__ import annotations

import torch

from .depth import project, sample_depth
from .epipolar import T_to_F, sym_epipolar_distance_all
from .homography import warp_points

IGNORE_FEATURE = -2
UNMATCHED_FEATURE = -1

_INF = 1e12


def _mutual_assignment(dist, pos_th):
    """Mutual-minimum positives under the threshold from a squared-distance
    matrix (..., M, N). Returns (positive, min0, min1)."""
    m, n = dist.shape[-2:]
    min0 = dist.argmin(dim=-1)
    min1 = dist.argmin(dim=-2)
    ismin0 = torch.arange(n, device=dist.device)[None, :] == min0[..., :, None]
    ismin1 = torch.arange(m, device=dist.device)[:, None] == min1[..., None, :]
    return ismin0 & ismin1 & (dist < pos_th**2), min0, min1


def _pack_matches(positive, min0, min1, negative0, negative1, valid0, valid1):
    ignore = lambda t: torch.full_like(t, IGNORE_FEATURE)
    m0 = torch.where(positive.any(-1), min0, ignore(min0))
    m1 = torch.where(positive.any(-2), min1, ignore(min1))
    m0 = torch.where(negative0, torch.full_like(m0, UNMATCHED_FEATURE), m0)
    m1 = torch.where(negative1, torch.full_like(m1, UNMATCHED_FEATURE), m1)
    if valid0 is not None:
        m0 = torch.where(valid0, m0, ignore(m0))
    if valid1 is not None:
        m1 = torch.where(valid1, m1, ignore(m1))
    return m0.to(torch.int32), m1.to(torch.int32)


def gt_matches_from_homography(
    kp0, kp1, H, pos_th: float = 3.0, neg_th: float = 6.0, valid0=None, valid1=None, **kw
):
    """Ground-truth matches by warping the keypoints with the pair
    homography: mutual nearest neighbours under `pos_th` pixels (the larger of
    the two reprojection errors) are positives; a keypoint whose nearest
    reprojection is beyond `neg_th` is unmatched; the rest is ignored."""
    kp0_1 = warp_points(kp0, H)
    kp1_0 = warp_points(kp1, H, inverse=True)
    dist0 = ((kp0_1[..., :, None, :] - kp1[..., None, :, :]) ** 2).sum(-1)
    dist1 = ((kp0[..., :, None, :] - kp1_0[..., None, :, :]) ** 2).sum(-1)
    dist = torch.maximum(dist0, dist1)

    inf = torch.full_like(dist, _INF)
    if valid0 is not None:
        dist = torch.where(valid0[..., :, None], dist, inf)
        dist0 = torch.where(valid0[..., :, None], dist0, inf)
    if valid1 is not None:
        dist = torch.where(valid1[..., None, :], dist, inf)
        dist1 = torch.where(valid1[..., None, :], dist1, inf)

    reward = (dist < pos_th**2).float() - (dist > neg_th**2).float()
    positive, min0, min1 = _mutual_assignment(dist, pos_th)
    negative0 = dist0.amin(dim=-1) > neg_th**2
    negative1 = dist1.amin(dim=-2) > neg_th**2
    m0, m1 = _pack_matches(positive, min0, min1, negative0, negative1, valid0, valid1)
    return {
        "assignment": positive,
        "reward": reward,
        "matches0": m0,
        "matches1": m1,
        "matching_scores0": (m0 > -1).float(),
        "matching_scores1": (m1 > -1).float(),
        "proj_0to1": kp0_1,
        "proj_1to0": kp1_0,
    }


def gt_matches_from_pose_depth(
    kp0, kp1, data, pos_th: float = 3.0, neg_th: float = 5.0, epi_th: float | None = None,
    cc_th: float | None = None, valid0=None, valid1=None, **kw
):
    """Ground-truth matches by reprojecting the keypoints through their
    depths and the relative pose: mutual nearest neighbours under `pos_th`
    pixels (the larger of the two reprojection errors, among keypoints
    visible in the other view) are positives; a keypoint with depth whose
    nearest reprojection is beyond `neg_th` is unmatched; the rest is
    ignored. With `epi_th`, a keypoint without depth that is `neg_th` (in
    pixels, on the fundamental matrix) from every epipolar line of the
    other view's ignored keypoints is unmatched too; with `cc_th`, the
    reprojection must pass the cycle check of `depth.project`.

    `data` holds view0 / view1 with their `camera` (and `depth` maps, unless
    the keypoints' depths come in `kw` as depth_keypoints0/1 and
    valid_depth_keypoints0/1), T_0to1 and T_1to0. All distances are
    elementwise fp32 (no TF32)."""
    camera0, camera1 = data["view0"]["camera"], data["view1"]["camera"]
    T_0to1, T_1to0 = data["T_0to1"], data["T_1to0"]
    depth0, depth1 = data["view0"].get("depth"), data["view1"].get("depth")
    if "depth_keypoints0" in kw and "depth_keypoints1" in kw:
        d0, valid_d0 = kw["depth_keypoints0"], kw["valid_depth_keypoints0"]
        d1, valid_d1 = kw["depth_keypoints1"], kw["valid_depth_keypoints1"]
    else:
        d0, valid_d0 = sample_depth(kp0, depth0)
        d1, valid_d1 = sample_depth(kp1, depth1)
    if valid0 is not None:
        valid_d0 = valid_d0 & valid0
    if valid1 is not None:
        valid_d1 = valid_d1 & valid1

    kp0_1, visible0 = project(kp0, d0, depth1, camera0, camera1, T_0to1, valid_d0, ccth=cc_th)
    kp1_0, visible1 = project(kp1, d1, depth0, camera1, camera0, T_1to0, valid_d1, ccth=cc_th)
    dist0 = ((kp0_1[..., :, None, :] - kp1[..., None, :, :]) ** 2).sum(-1)
    dist1 = ((kp0[..., :, None, :] - kp1_0[..., None, :, :]) ** 2).sum(-1)
    dist = torch.maximum(dist0, dist1)
    dist = torch.where(visible0[..., :, None] & visible1[..., None, :], dist,
                       torch.full_like(dist, _INF))

    positive, min0, min1 = _mutual_assignment(dist, pos_th)
    negative0 = (dist0.amin(dim=-1) > neg_th**2) & valid_d0
    negative1 = (dist1.amin(dim=-2) > neg_th**2) & valid_d1
    m0, m1 = _pack_matches(positive, min0, min1, negative0, negative1, valid0, valid1)

    epi_dist = sym_epipolar_distance_all(kp0, kp1, T_to_F(camera0, camera1, T_0to1))
    if epi_th is not None:
        unmatched = lambda t: torch.full_like(t, UNMATCHED_FEATURE)
        ignore = (m0[..., :, None] == IGNORE_FEATURE) & (m1[..., None, :] == IGNORE_FEATURE)
        epi_masked = torch.where(ignore, epi_dist, torch.full_like(epi_dist, _INF))
        m0 = torch.where(~valid_d0 & (epi_masked.amin(dim=-1) > neg_th), unmatched(m0), m0)
        m1 = torch.where(~valid_d1 & (epi_masked.amin(dim=-2) > neg_th), unmatched(m1), m1)
        if valid0 is not None:
            m0 = torch.where(valid0, m0, torch.full_like(m0, IGNORE_FEATURE))
        if valid1 is not None:
            m1 = torch.where(valid1, m1, torch.full_like(m1, IGNORE_FEATURE))

    return {
        "assignment": positive,
        "reward": (dist < pos_th**2).float() - (epi_dist > neg_th).float(),
        "matches0": m0,
        "matches1": m1,
        "matching_scores0": (m0 > -1).float(),
        "matching_scores1": (m1 > -1).float(),
        "depth_keypoints0": d0,
        "depth_keypoints1": d1,
        "proj_0to1": kp0_1,
        "proj_1to0": kp1_0,
        "visible0": visible0,
        "visible1": visible1,
    }


def gt_line_matches_from_pose_depth(*args, **kwargs):
    raise NotImplementedError(
        "line ground truth from pose and depth waits for GlueStick and the line extractors "
        "(ROADMAP Queue 1 items 3 and 5)")


__all__ = ["IGNORE_FEATURE", "UNMATCHED_FEATURE", "gt_matches_from_homography",
           "gt_matches_from_pose_depth", "gt_line_matches_from_pose_depth"]
