"""Two-view sparse matching pipeline (counterpart of
gluefactory_tpu/models/two_view_pipeline.py).

extractor -> matcher -> ground_truth, each optional. The ground-truth
component (`homography_matcher` from `H_0to1`, or `depth_matcher` from the
cameras, depths and relative poses of a 3D dataset) labels the extracted
keypoints for `loss` (or already in the forward with `run_gt_in_forward`).
Filter and solver components are not ported yet and raise when configured. The extractor is frozen: it runs in
eval mode under `torch.no_grad()`, so no gradient reaches it, and a
trainable one raises. The matcher decides itself whether it records
gradients (`is_training`). Match convention: matches0[i] is the index in
image 1 of the match of keypoint i in image 0, or -1 (-2 = ignored in the
ground truth).
"""

from __future__ import annotations

import torch

from . import get_model
from .base_model import BaseModel
from ..utils.config import to_dict


class TwoViewPipeline(BaseModel):
    default_conf = {
        "name": "two_view_pipeline",
        "extractor": {"name": None, "trainable": False},
        "matcher": {"name": None},
        "filter": {"name": None},
        "solver": {"name": None},
        "ground_truth": {"name": None},
        "run_gt_in_forward": False,
        # one extractor call on both views stacked along the batch axis;
        # "auto" stacks only at batch 1, True forces it, False disables
        "batch_extraction": "auto",
    }
    required_data_keys = ["view0", "view1"]
    components = ["extractor", "matcher", "ground_truth"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        for k in ("filter", "solver"):
            if self._has(k):
                raise NotImplementedError(f"the {k} component is not ported yet (ROADMAP Queue 1)")
        if self._has("extractor") and self.conf.extractor.get("trainable", False):
            raise NotImplementedError("a trainable extractor is not ported yet (ROADMAP Queue 1)")
        self.extractor = self.matcher = self.ground_truth = None
        for k in self.components:
            if self._has(k):
                sub = to_dict(self.conf[k])
                setattr(self, k, get_model(sub["name"])(sub, device=self.device))

    def train(self, mode: bool = True):
        """The frozen extractor stays in eval mode."""
        super().train(mode)
        if self.extractor is not None:
            self.extractor.eval()
        return self

    def _has(self, k):
        sub = self.conf.get(k)
        return bool(sub and sub.get("name"))

    @torch.no_grad()
    def extract_view(self, data, i: str):
        return {} if self.extractor is None else self.extractor(data[f"view{i}"])

    def _can_batch_extract(self, data) -> bool:
        be = self.conf.batch_extraction
        if not (be and self.extractor is not None):
            return False
        img0, img1 = data["view0"].get("image"), data["view1"].get("image")
        if img0 is None or img1 is None or img0.shape != img1.shape:
            return False
        return True if be is True else img0.shape[0] == 1

    @torch.no_grad()
    def _extract_batched(self, data):
        v0, v1 = data["view0"], data["view1"]
        b = v0["image"].shape[0]
        stacked = {
            k: torch.cat([v0[k], v1[k]], dim=0)
            for k in v0
            if k in v1 and torch.is_tensor(v0[k]) and torch.is_tensor(v1[k])
            and v0[k].shape == v1[k].shape
        }
        pred = self.extractor(stacked)
        return {k: v[:b] for k, v in pred.items()}, {k: v[b:] for k, v in pred.items()}

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        if self._can_batch_extract(data):
            pred0, pred1 = self._extract_batched(data)
        else:
            pred0 = self.extract_view(data, "0")
            pred1 = self.extract_view(data, "1")
        pred = {
            **{k + "0": v for k, v in pred0.items()},
            **{k + "1": v for k, v in pred1.items()},
        }
        if self.matcher is not None:
            pred = {**pred, **self.matcher({**data, **pred})}
        if self.ground_truth is not None and self.conf.run_gt_in_forward:
            pred.update(self.ground_truth({**data, **pred}))
        return pred

    def loss(self, pred: dict, data: dict):
        """Sum of the components' losses; returns (losses, metrics), dicts of
        (B,) tensors. Components without a loss are skipped."""
        losses, metrics, total = {}, {}, 0
        if self.ground_truth is not None and not self.conf.run_gt_in_forward:
            pred = {**pred, **self.ground_truth({**data, **pred})}
        for k in self.components:
            if not self._has(k) or not self.conf[k].get("apply_loss", True):
                continue
            try:
                losses_, metrics_ = getattr(self, k).loss(pred, {**pred, **data})
            except NotImplementedError:
                continue
            losses = {**losses, **losses_}
            metrics = {**metrics, **metrics_}
            total = losses_["total"] + total
        return {**losses, "total": total}, metrics


__main_model__ = TwoViewPipeline
