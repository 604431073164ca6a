"""MultiPoint: multispectral (optical / thermal) keypoint detector and
descriptor (counterpart of gluefactory_tpu/multipoint/models/multipoint.py).

Two modality-specific VGG encoders (optical and thermal) feed shared
detector and descriptor heads. Each layer is conv -> ReLU -> BatchNorm (eps
1e-3, flax's momentum 0.99; the batch's statistics with `is_training`, the
running ones otherwise: `models.utils.layers.batch_norm`). Both encoders run on the whole
batch and are blended by `is_optical`, as the JAX model does, so that in
training the BatchNorm statistics see the whole batch.

Inputs: image (B, H, W, 1) in [0, 1] and is_optical (B,) bool (all optical
when absent). Outputs: logits (B, Hc, Wc, 65), prob (B, H, W), dense
descriptors (B, Hc, Wc, D); with `max_num_keypoints` also keypoints (B, K,
2) xy at pixel centres, keypoint_scores, keypoint_mask (score above
`detection_threshold`) and descriptors (B, K, D). Top-k ties go to the
lower flat index, as `jax.lax.top_k` breaks them. Module and parameter
names follow the flax tree (`weights.params_from_jax` maps it). `loss` is
`multipoint.utils.losses.superpoint_loss` with the configuration's cell.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...models.base_model import BaseModel
from ...models.extractors.superpoint_open import sample_descriptors, simple_nms
from ...models.utils.layers import BatchNorm, Conv, top_k_stable


class _VGGEncoder(nn.Module):
    def __init__(self, channels=(64, 64, 128, 128), cin: int = 1):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            for j in (2 * i, 2 * i + 1):
                self.add_module(f"Conv_{j}", Conv(cin, c, 3))
                self.add_module(f"BatchNorm_{j}", BatchNorm(c))
                cin = c
        self.out_dim = channels[-1]

    def forward(self, x, is_training: bool):
        for i in range(self.n):
            for j in (2 * i, 2 * i + 1):
                x = getattr(self, f"BatchNorm_{j}")(F.relu(getattr(self, f"Conv_{j}")(x)),
                                                    is_training)
            if i < self.n - 1:
                x = F.max_pool2d(x, 2, 2)
        return x


class _Head(nn.Module):
    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.Conv_0 = Conv(cin, mid, 3)
        self.BatchNorm_0 = BatchNorm(mid)
        self.Conv_1 = Conv(mid, out, 1)

    def forward(self, x, is_training: bool):
        return self.Conv_1(self.BatchNorm_0(F.relu(self.Conv_0(x)), is_training))


class MultiPoint(BaseModel):
    default_conf = {
        "name": "multipoint",
        "multispectral": True,
        "descriptor_head": True,
        "descriptor_size": 256,
        "normalize_descriptors": True,
        "channels": [64, 64, 128, 128],
        "head_channels": 256,
        "cell": 8,
        "nms_radius": 4,
        "detection_threshold": 0.015,
        "max_num_keypoints": None,  # set for fixed-size keypoint output
        "is_training": False,
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        conf = self.conf
        if conf.multispectral:
            self.encoder_optical = self._make_encoder()
            self.encoder_thermal = self._make_encoder()
            feat_dim = self.encoder_optical.out_dim
        else:
            self.encoder = self._make_encoder()
            feat_dim = self.encoder.out_dim
        self.detector_head = _Head(feat_dim, conf.head_channels, conf.cell**2 + 1)
        if conf.descriptor_head:
            self.descriptor_head = _Head(feat_dim, conf.head_channels, conf.descriptor_size)
        self.to(self.device)

    def _make_encoder(self) -> nn.Module:
        return _VGGEncoder(tuple(self.conf.channels))

    def _encode(self, image, is_optical):
        """(B, C, Hc, Wc) features of an NCHW image batch."""
        is_training = self.conf.is_training
        if not self.conf.multispectral:
            return self.encoder(image, is_training)
        fo = self.encoder_optical(image, is_training)
        ft = self.encoder_thermal(image, is_training)
        sel = is_optical.to(fo.dtype).reshape(-1, 1, 1, 1)
        return fo * sel + ft * (1.0 - sel)

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        conf = self.conf
        image = data["image"]
        b = image.shape[0]
        is_optical = data.get("is_optical")
        if is_optical is None:
            is_optical = torch.ones(b, dtype=torch.bool, device=image.device)
        is_training = conf.is_training

        feats = self._encode(image.permute(0, 3, 1, 2), is_optical)
        logits = self.detector_head(feats, is_training)  # (B, 65, Hc, Wc)
        prob = F.pixel_shuffle(torch.softmax(logits, dim=1)[:, :-1], conf.cell)[:, 0]

        pred = {"logits": logits.permute(0, 2, 3, 1), "prob": prob}
        if conf.descriptor_head:
            dense = self.descriptor_head(feats, is_training)
            if conf.normalize_descriptors:
                dense = dense / dense.norm(dim=1, keepdim=True).clamp(min=1e-8)
            pred["dense_descriptors"] = dense = dense.permute(0, 2, 3, 1)

        if conf.max_num_keypoints:
            heat = simple_nms(prob, conf.nms_radius)
            h, w = heat.shape[-2:]
            topv, topi = top_k_stable(heat.reshape(b, h * w), conf.max_num_keypoints)
            kpts = torch.stack([(topi % w).float(), (topi // w).float()], -1) + 0.5
            mask = topv > conf.detection_threshold
            pred.update({
                "keypoints": kpts,
                "keypoint_scores": torch.where(mask, topv, torch.zeros_like(topv)),
                "keypoint_mask": mask,
            })
            if conf.descriptor_head:
                pred["descriptors"] = sample_descriptors(kpts, dense, conf.cell)
        return pred

    def loss(self, pred, data):
        from ..utils.losses import superpoint_loss

        return superpoint_loss(pred, data, self.conf)


__main_model__ = MultiPoint
