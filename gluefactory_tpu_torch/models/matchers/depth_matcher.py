"""Ground-truth "matcher" from the relative pose and depth, the supervision
component of the two-view pipeline on 3D data (counterpart of
gluefactory_tpu/models/matchers/depth_matcher.py). Points only: line ground
truth waits for the line extractors (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

from ...geometry.gt_generation import gt_matches_from_pose_depth
from ..base_model import BaseModel

_DEPTH_KEYS = ("depth_keypoints0", "valid_depth_keypoints0", "depth_keypoints1",
               "valid_depth_keypoints1")


class DepthMatcher(BaseModel):
    default_conf = {
        "name": "depth_matcher",
        "use_points": True,
        "use_lines": False,
        "th_positive": 3.0,
        "th_negative": 5.0,
        "th_epi": None,  # epipolar negatives for keypoints without depth
        "th_cc": None,  # cycle-consistency threshold (squared pixels)
    }
    required_data_keys = ["view0", "view1", "T_0to1", "T_1to0"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        if self.conf.use_lines:
            raise NotImplementedError(
                "line ground truth from pose and depth is not ported yet (ROADMAP Queue 1 item 5)")

    @torch.no_grad()
    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        if not self.conf.use_points:
            return {}
        keys = {k: data[k] for k in _DEPTH_KEYS} if "depth_keypoints0" in data else {}
        gt = gt_matches_from_pose_depth(
            data["keypoints0"], data["keypoints1"], data,
            pos_th=self.conf.th_positive, neg_th=self.conf.th_negative,
            epi_th=self.conf.th_epi, cc_th=self.conf.th_cc,
            valid0=data.get("keypoint_mask0"), valid1=data.get("keypoint_mask1"), **keys,
        )
        names = ("assignment", "matches0", "matches1", "matching_scores0", "matching_scores1",
                 "proj_0to1", "proj_1to0", "visible0", "visible1")
        return {f"gt_{k}": gt[k] for k in names}

    def loss(self, pred, data):
        raise NotImplementedError


__main_model__ = DepthMatcher
