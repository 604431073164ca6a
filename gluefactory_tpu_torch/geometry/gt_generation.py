"""Ground-truth matches for supervision from the pair homography
(counterpart of gluefactory_tpu/geometry/gt_generation.py:24-91; the
pose/depth and line variants are not ported yet).

Labels per keypoint: the index of its match, UNMATCHED_FEATURE (-1) or
IGNORE_FEATURE (-2). Keypoint sets have a fixed size with optional validity
masks: padded entries are labelled IGNORE and taken out of the distance
matrices.
"""

from __future__ import annotations

import torch

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


__all__ = ["IGNORE_FEATURE", "UNMATCHED_FEATURE", "gt_matches_from_homography"]
