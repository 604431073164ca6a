"""SuperPoint in the MagicLeap architecture, inference (counterpart of
gluefactory_tpu/models/extractors/superpoint_magicleap.py).

The original VGG trunk without BatchNorm (conv + ReLU), a 65-channel
detector head and a 256-d descriptor head, in float32. Detection: cell
softmax to full resolution, NMS, the `remove_borders` band set to -1, then
the top `max_num_keypoints` (ties to the lower flat index, as
`jax.lax.top_k`). Descriptors are sampled on the `legacy_sampling` grid of
the official weights (the default) or the corrected one, at the keypoints
before their +0.5 shift (the corrected grid is SuperPoint-open's
`sample_descriptors`), and L2-normalised. Module names follow the flax
tree (conv1a ... convDb; `weights.params_from_jax` maps it). Images are (B,
H, W, 1) or (B, H, W, 3) in [0, 1]; outputs: keypoints (B, K, 2) xy at pixel
centres, keypoint_scores, descriptors (B, K, D), keypoint_mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base_model import BaseModel
from ..utils.layers import Conv, top_k_stable
from .superpoint_open import bilinear_sample, sample_descriptors, simple_nms


def sample_descriptors_legacy(keypoints, descriptors, s: int = 8):
    """The original (slightly off) grid the official weights expect."""
    b, hc, wc, d = descriptors.shape
    kp = keypoints - s / 2 + 0.5
    kp = kp / torch.tensor([wc * s - s / 2 - 0.5, hc * s - s / 2 - 0.5],
                           dtype=kp.dtype, device=kp.device)
    kp = kp * 2 - 1  # normalised to (-1, 1)
    x = (kp[..., 0] + 1) / 2 * (wc - 1)  # align_corners=True
    y = (kp[..., 1] + 1) / 2 * (hc - 1)
    return bilinear_sample(descriptors, x, y)


_LAYERS = (("conv1a", 64, 3), ("conv1b", 64, 3), ("conv2a", 64, 3), ("conv2b", 64, 3),
           ("conv3a", 128, 3), ("conv3b", 128, 3), ("conv4a", 128, 3), ("conv4b", 128, 3))


class SuperPointMagicLeap(BaseModel):
    default_conf = {
        "name": "superpoint_magicleap",
        "descriptor_dim": 256,
        "nms_radius": 4,
        "max_num_keypoints": 1024,
        "detection_threshold": 0.005,
        "remove_borders": 4,
        "legacy_sampling": True,  # the official weights expect the legacy grid
        "dense_outputs": False,
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        cin = 1
        for name, cout, k in _LAYERS:
            self.add_module(name, Conv(cin, cout, k))
            cin = cout
        self.convPa = Conv(128, 256, 3)
        self.convPb = Conv(256, 65, 1)
        self.convDa = Conv(128, 256, 3)
        self.convDb = Conv(256, self.conf.descriptor_dim, 1)
        self.requires_grad_(False)
        self.to(self.device)

    @torch.no_grad()
    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        conf = self.conf
        image = data["image"]
        if image.shape[-1] == 3:
            gray = torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype, device=image.device)
            image = (image * gray).sum(-1, keepdim=True)
        x = image.permute(0, 3, 1, 2)
        for i, (name, _, _) in enumerate(_LAYERS):
            x = F.relu(getattr(self, name)(x))
            if i in (1, 3, 5):
                x = F.max_pool2d(x, 2, 2)

        scores = torch.softmax(self.convPb(F.relu(self.convPa(x))), dim=1)[:, :-1]
        scores = F.pixel_shuffle(scores, 8)[:, 0]  # (B, H, W)
        dense = self.convDb(F.relu(self.convDa(x)))
        dense = (dense / dense.norm(dim=1, keepdim=True).clamp(min=1e-8)).permute(0, 2, 3, 1)

        scores = simple_nms(scores, conf.nms_radius)
        b, h, w = scores.shape
        if conf.remove_borders:
            pad = conf.remove_borders
            border = torch.zeros((h, w), dtype=torch.bool, device=scores.device)
            border[pad:-pad, pad:-pad] = True
            scores = torch.where(border, scores, torch.full_like(scores, -1.0))

        topv, topi = top_k_stable(scores.reshape(b, h * w), conf.max_num_keypoints)
        keypoints = torch.stack([(topi % w).float(), (topi // w).float()], -1)
        mask = topv > conf.detection_threshold
        sampler = sample_descriptors_legacy if conf.legacy_sampling else sample_descriptors
        pred = {
            "keypoints": keypoints + 0.5,
            "keypoint_scores": torch.where(mask, topv, torch.zeros_like(topv)),
            "descriptors": sampler(keypoints, dense, 8),
            "keypoint_mask": mask,
        }
        if conf.dense_outputs:
            pred["dense_descriptors"] = dense
        return pred


__main_model__ = SuperPointMagicLeap
