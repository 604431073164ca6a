"""Ground-truth "matcher" from the pair homography, the supervision
component of the two-view pipeline (counterpart of
gluefactory_tpu/models/matchers/homography_matcher.py). Points only: line
ground truth is not ported yet.
"""

from __future__ import annotations

import torch

from ...geometry.gt_generation import gt_matches_from_homography
from ..base_model import BaseModel


class HomographyMatcher(BaseModel):
    default_conf = {
        "name": "homography_matcher",
        "use_points": True,
        "use_lines": False,
        "th_positive": 3.0,
        "th_negative": 6.0,
    }
    required_data_keys = ["H_0to1"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        if self.conf.use_lines:
            raise NotImplementedError("line ground truth is not ported yet (ROADMAP Queue 1 item 5)")

    @torch.no_grad()
    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        if not self.conf.use_points:
            return {}
        gt = gt_matches_from_homography(
            data["keypoints0"], data["keypoints1"], data["H_0to1"],
            pos_th=self.conf.th_positive, neg_th=self.conf.th_negative,
            valid0=data.get("keypoint_mask0"), valid1=data.get("keypoint_mask1"),
        )
        keys = ("assignment", "matches0", "matches1", "matching_scores0",
                "matching_scores1", "proj_0to1", "proj_1to0")
        return {f"gt_{k}": gt[k] for k in keys}

    def loss(self, pred, data):
        raise NotImplementedError


__main_model__ = HomographyMatcher
