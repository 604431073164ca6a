"""Two-view sparse matching pipeline (counterpart of
gluefactory_tpu/models/two_view_pipeline.py).

extractor -> matcher -> filter -> solver -> ground_truth, each optional.
The filter and the solver are plain composition: each gets the data and
the predictions so far and adds its own (the JAX package registers none).
The ground-truth component (`homography_matcher` from `H_0to1`, or
`depth_matcher` from the cameras, depths and relative poses of a 3D
dataset) labels the extracted keypoints for `loss` (or already in the
forward with `run_gt_in_forward`).

A view's `cache` (a dict of features) seeds its predictions; with
`allow_no_extract` a non-empty cache replaces the extraction. The extractor
runs its inference forward in eval mode. With `extractor.trainable: false`
(the default) it runs under `torch.no_grad()`, the counterpart of the JAX
package's `stop_gradient`, and its parameters stay out of the optimizer.
With `trainable: true` its forward records gradients (its parameters
require them and join the optimizer): BatchNorm keeps its running
statistics, and the gradient reaches the trunk through the sampled
descriptors (and the detector through the keypoint scores, where a matcher
reads them). Both settings give the same outputs. The matcher decides
itself whether it records gradients (`is_training`). Match convention:
matches0[i] is the index in image 1 of the match of keypoint i in image 0,
or -1 (-2 = ignored in the ground truth).
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
        "allow_no_extract": False,
        "run_gt_in_forward": False,
        # one extractor call on both views stacked along the batch axis;
        # "auto" stacks only at batch 1, True forces it, False disables
        "batch_extraction": "auto",
    }
    required_data_keys = ["view0", "view1"]
    components = ["extractor", "matcher", "filter", "solver", "ground_truth"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        self.extractor = self.matcher = self.filter = self.solver = self.ground_truth = None
        for k in self.components:
            if self._has(k):
                sub = to_dict(self.conf[k])
                setattr(self, k, get_model(sub["name"])(sub, device=self.device))
        if self.extractor is not None and self.conf.extractor.get("trainable", False) and not any(
                p.requires_grad for p in self.extractor.parameters()):
            raise NotImplementedError(
                f"extractor {self.conf.extractor.name!r} has no trainable inference forward "
                "(superpoint_open has one)")

    def train(self, mode: bool = True):
        """The extractor stays in eval mode (it runs its inference forward)."""
        super().train(mode)
        if self.extractor is not None:
            self.extractor.eval()
        return self

    def _has(self, k):
        sub = self.conf.get(k)
        return bool(sub and sub.get("name"))

    def _extractor_grad(self):
        """Whether the extractor records gradients: trainable, and not under
        the caller's `torch.no_grad()`."""
        return torch.set_grad_enabled(
            torch.is_grad_enabled() and bool(self.conf.extractor.get("trainable", False)))

    def extract_view(self, data, i: str):
        data_i = data[f"view{i}"]
        pred_i = dict(data_i.get("cache", {}))
        skip_extract = len(pred_i) > 0 and self.conf.allow_no_extract
        if self.extractor is not None and not skip_extract:
            with self._extractor_grad():
                pred_i = {**pred_i, **self.extractor({**data_i, **pred_i})}
        return pred_i

    def _can_batch_extract(self, data) -> bool:
        be = self.conf.batch_extraction
        if not (be and self.extractor is not None):
            return False
        v0, v1 = data["view0"], data["view1"]
        if "cache" in v0 or "cache" in v1:
            return False
        img0, img1 = v0.get("image"), v1.get("image")
        if img0 is None or img1 is None or img0.shape != img1.shape:
            return False
        return True if be is True else img0.shape[0] == 1

    def _extract_batched(self, data):
        v0, v1 = data["view0"], data["view1"]
        b = v0["image"].shape[0]
        stacked = {
            k: torch.cat([v0[k], v1[k]], dim=0)
            for k in v0
            if k in v1 and torch.is_tensor(v0[k]) and torch.is_tensor(v1[k])
            and v0[k].shape == v1[k].shape
        }
        with self._extractor_grad():
            pred = self.extractor(stacked)
        return {k: v[:b] for k, v in pred.items()}, {k: v[b:] for k, v in pred.items()}

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        return self.two_view_forward(data)

    def two_view_forward(self, data: dict) -> dict:
        """The forward on two-view data (`view0`, `view1`), unchecked."""
        if self._can_batch_extract(data):
            pred0, pred1 = self._extract_batched(data)
        else:
            pred0 = self.extract_view(data, "0")
            pred1 = self.extract_view(data, "1")
        pred = {
            **{k + "0": v for k, v in pred0.items()},
            **{k + "1": v for k, v in pred1.items()},
        }
        for k in ("matcher", "filter", "solver"):
            if self._has(k):
                pred = {**pred, **getattr(self, k)({**data, **pred})}
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
