"""Dense nearest-neighbour descriptor matcher (counterpart of
gluefactory_tpu/models/matchers/nearest_neighbor_matcher.py).

Dot-product similarity of L2-normalised descriptors (one `torch.matmul`),
optional ratio test and distance threshold, mutual check; padded keypoints
(`keypoint_mask0/1`) are never matched.
"""

from __future__ import annotations

import torch

from ..base_model import BaseModel

_NEG_INF = -1e9


def find_nn(sim, ratio_thresh, distance_thresh):
    """Top-1 (optionally ratio-tested) nearest neighbour of each row."""
    top2_val, top2_idx = torch.topk(sim, 2, dim=-1)
    dist_nn = 2 * (1 - top2_val)  # descriptors are L2-normalised
    mask = torch.ones(sim.shape[:-1], dtype=torch.bool, device=sim.device)
    if ratio_thresh is not None:
        mask &= dist_nn[..., 0] <= (ratio_thresh**2) * dist_nn[..., 1]
    if distance_thresh is not None:
        mask &= dist_nn[..., 0] <= distance_thresh**2
    matches = torch.where(mask, top2_idx[..., 0], -1)
    scores = torch.where(mask, (top2_val[..., 0] + 1) / 2.0, 0.0)
    return matches.to(torch.int32), scores


def mutual_check(m0, m1):
    inds0 = torch.arange(m0.shape[-1], device=m0.device)[None]
    loop = torch.gather(m1, -1, m0.clamp(min=0).long())
    return torch.where((m0 > -1) & (inds0 == loop), m0, -1)


class NearestNeighborMatcher(BaseModel):
    default_conf = {
        "name": "nearest_neighbor_matcher",
        "ratio_thresh": None,
        "distance_thresh": None,
        "mutual_check": True,
        "loss": None,
    }
    required_data_keys = ["descriptors0", "descriptors1"]

    @torch.no_grad()
    def forward(self, data):
        self.check_required_keys(data)
        conf = self.conf
        sim = torch.matmul(data["descriptors0"].float(), data["descriptors1"].float().transpose(1, 2))
        mask0, mask1 = data.get("keypoint_mask0"), data.get("keypoint_mask1")
        if mask0 is not None:
            sim = torch.where(mask0[:, :, None], sim, _NEG_INF)
        if mask1 is not None:
            sim = torch.where(mask1[:, None, :], sim, _NEG_INF)
        matches0, scores0 = find_nn(sim, conf.ratio_thresh, conf.distance_thresh)
        matches1, scores1 = find_nn(sim.transpose(-1, -2), conf.ratio_thresh, conf.distance_thresh)
        if conf.mutual_check:
            matches0 = mutual_check(matches0, matches1)
            matches1 = mutual_check(matches1, matches0)
        if mask0 is not None:
            matches0 = torch.where(mask0, matches0, -1)
            scores0 = torch.where(mask0, scores0, 0.0)
        if mask1 is not None:
            matches1 = torch.where(mask1, matches1, -1)
            scores1 = torch.where(mask1, scores1, 0.0)
        return {
            "matches0": matches0,
            "matches1": matches1,
            "matching_scores0": scores0,
            "matching_scores1": scores1,
            "similarity": sim,
        }


__main_model__ = NearestNeighborMatcher
