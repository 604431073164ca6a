"""A detector's keypoints with another model's descriptors (counterpart of
gluefactory_tpu/models/extractors/mixed.py): the descriptor model runs on
the image and the detector's predictions; where it gives a dense map under
`interpolate_descriptors_from` (B, Hc, Wc, D), the descriptors are sampled
there at the keypoints (stride H / Hc, clamped bilinear taps) and
normalised, else its outputs join the detector's."""

from __future__ import annotations

from .. import get_model
from ..base_model import BaseModel
from ...utils.config import to_dict
from .aliked import _bilinear_raw


class MixedExtractor(BaseModel):
    default_conf = {
        "name": "mixed",
        "detector": {"name": None},
        "descriptor": {"name": None},
        "interpolate_descriptors_from": "dense_descriptors",
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        for part in ("detector", "descriptor"):
            sub = to_dict(self.conf[part])
            setattr(self, part, get_model(sub["name"])(sub, device=self.device))

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        pred = dict(self.detector(data))
        dpred = self.descriptor({**data, **pred})
        key = self.conf.interpolate_descriptors_from
        if key in dpred:
            dense = dpred[key]
            stride = max(data["image"].shape[1] // dense.shape[1], 1)
            kp = pred["keypoints"]
            desc = _bilinear_raw(dense, (kp[..., 0] + 0.5) / stride - 0.5,
                                 (kp[..., 1] + 0.5) / stride - 0.5)
            pred["descriptors"] = desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        else:
            pred.update({k: v for k, v in dpred.items() if k not in pred})
        return pred


__main_model__ = MixedExtractor
