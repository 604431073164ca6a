"""DISK: a U-Net keypoint detector with dense descriptors, trainable
(counterpart of gluefactory_tpu/models/extractors/disk.py).

The U-Net: `_Down` blocks (3 x 3 conv -> GroupNorm(4, flax's eps 1e-6) ->
tanh GELU, twice), 2 x 2 max pools, half-pixel
bilinear upsampling (`align_corners=False`, which equals
`jax.image.resize` when it enlarges) and skip concatenation, a 1 x 1 head
giving the heatmap and the unit dense descriptors. Inference: NMS on the
sigmoid heatmap, a static top-k (ties to the lower index), descriptors
sampled at the keypoints (+0.5) with clamped taps. With `is_training` a
paired batch (`image2`) runs both views as one batch and `loss` is the
JAX package's supervised objective: the positive-weighted BCE of the
heatmap, the cell-pooled dense hinge loss across the homography and the
keypoint-sampled InfoNCE with its deterministic tie-breaking jitter.

Parameters carry flax's automatic names (`_Down_0.Conv_0.weight`,
`_Down_0.GroupNorm_0.weight`, `Conv_0.weight`). Images are (B, H, W, C) in
[0, 1]; convolutions and products run in fp32 (`no_tf32`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..base_model import BaseModel, finish_init
from ..utils.layers import Conv, lecun_init, no_tf32, top_k_stable
from .aliked import _bilinear_raw
from .superpoint_open import simple_nms


class _Down(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.Conv_0, self.GroupNorm_0 = Conv(cin, c, 3), nn.GroupNorm(4, c, eps=1e-6)
        self.Conv_1, self.GroupNorm_1 = Conv(c, c, 3), nn.GroupNorm(4, c, eps=1e-6)

    def forward(self, x):
        x = F.gelu(self.GroupNorm_0(self.Conv_0(x)), approximate="tanh")
        return F.gelu(self.GroupNorm_1(self.Conv_1(x)), approximate="tanh")


class DISK(BaseModel):
    default_conf = {
        "name": "disk",
        "weights": None,
        "max_num_keypoints": 1024,
        "detection_threshold": 0.0,
        "nms_radius": 2,
        "descriptor_dim": 128,
        "channels": [32, 64, 128],
        "is_training": False,
        "trainable": False,
        "det_pos_weight": 50.0,
        "desc_loss_weight": 1.0,
        "cell": 8,
        "kp_desc_loss_weight": 1.0,
        "kp_desc_num": 64,
        "kp_desc_temp": 10.0,
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        c1, c2, c3 = self.conf.channels
        for i, (cin, c) in enumerate(((3, c1), (c1, c2), (c2, c3), (c3 + c2, c2), (c2 + c1, c1))):
            setattr(self, f"_Down_{i}", _Down(cin, c))
        self.Conv_0 = Conv(c1, self.conf.descriptor_dim + 1, 1)
        lecun_init(self, torch.Generator().manual_seed(0))
        finish_init(self)

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        with no_tf32():
            return self._forward(data)

    def _forward(self, data):
        conf = self.conf
        image = data["image"].float()
        paired = conf.is_training and "image2" in data
        if paired:
            image = torch.cat([image, data["image2"].float()], 0)
        if image.shape[-1] == 1:
            image = image.repeat(1, 1, 1, 3)
        b, h, w, _ = image.shape
        x = image.permute(0, 3, 1, 2)
        d1 = self._Down_0(x)
        d2 = self._Down_1(F.max_pool2d(d1, 2, 2))
        d3 = self._Down_2(F.max_pool2d(d2, 2, 2))

        def up(t, skip):
            t = F.interpolate(t, size=skip.shape[2:], mode="bilinear", align_corners=False)
            return torch.cat([t, skip], 1)

        u2 = self._Down_3(up(d3, d2))
        u1 = self._Down_4(up(u2, d1))
        out = self.Conv_0(u1).permute(0, 2, 3, 1)  # (B, H, W, 1 + D)
        heatmap = out[..., 0]
        dense = out[..., 1:]
        dense = dense / dense.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        if paired:
            bb = b // 2
            return {"heatmap": heatmap[:bb], "heatmap2": heatmap[bb:],
                    "dense_descriptors": dense[:bb], "dense_descriptors2": dense[bb:]}

        nms = simple_nms(torch.sigmoid(heatmap), conf.nms_radius)
        topv, topi = top_k_stable(nms.reshape(b, h * w), conf.max_num_keypoints)
        keypoints = torch.stack([(topi % w).float(), (topi // w).float()], -1) + 0.5
        mask = topv > conf.detection_threshold
        desc = _bilinear_raw(dense, keypoints[..., 0], keypoints[..., 1])
        desc = desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        return {
            "keypoints": keypoints,
            "keypoint_scores": torch.where(mask, topv, torch.zeros_like(topv)),
            "descriptors": desc,
            "keypoint_mask": mask,
            "heatmap": heatmap,
        }

    def loss(self, pred: dict, data: dict):
        """The supervised objective on a paired batch: the positive-weighted
        BCE of both heatmaps against keypoint_map(2) inside valid_mask(2),
        the dense hinge loss of the cell-pooled descriptors across H_0to1
        and the keypoint-sampled InfoNCE. Returns (losses, {}) of (B,).
        Predictions without a heatmap (a pipeline's) raise
        NotImplementedError, which the pipeline skips."""
        if "heatmap" not in pred:  # a pipeline's inference predictions: no loss
            raise NotImplementedError
        from ...multipoint.utils.losses import descriptor_loss

        conf = self.conf
        pw = float(conf.det_pos_weight)

        def det_bce(hm, gt, valid):
            gt = gt.float()
            per_px = -(pw * gt * F.logsigmoid(hm) + (1.0 - gt) * F.logsigmoid(-hm))
            if valid is not None:
                v = valid.float()
                return (per_px * v).sum((-1, -2)) / v.sum((-1, -2)).clamp(min=1.0)
            return per_px.mean((-1, -2))

        losses = {}
        total = losses["detector_loss"] = det_bce(pred["heatmap"], data["keypoint_map"],
                                                  data.get("valid_mask"))
        if "heatmap2" in pred:
            losses["detector_loss2"] = det_bce(pred["heatmap2"], data["keypoint_map2"],
                                               data.get("valid_mask2"))
            total = total + losses["detector_loss2"]
        if "dense_descriptors2" in pred:
            cell = int(conf.cell)

            def pool(d):
                d = F.avg_pool2d(d.permute(0, 3, 1, 2), cell, cell).permute(0, 2, 3, 1)
                return d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-8)

            dl, pd, nd = descriptor_loss(pool(pred["dense_descriptors"]),
                                         pool(pred["dense_descriptors2"]), data["H_0to1"],
                                         data.get("valid_mask2"), cell=cell)
            losses.update(descriptor_loss=dl, positive_dist=pd, negative_dist=nd)
            total = total + conf.desc_loss_weight * dl
            if conf.kp_desc_loss_weight > 0:
                losses["kp_desc_loss"] = self._kp_infonce(pred, data)
                total = total + conf.kp_desc_loss_weight * losses["kp_desc_loss"]
        losses["total"] = total
        return losses, {}

    def _kp_infonce(self, pred, data):
        """Symmetric InfoNCE over descriptors sampled at the ground-truth
        keypoints of view 0 and their warps in view 1. The keypoints are the
        top `kp_desc_num` of the keypoint map times a deterministic per-pixel
        jitter whose phase follows the batch's homography (ties in raster
        order would supervise one corner of the image every step)."""
        from ...geometry.homography import warp_points

        conf = self.conf
        km = data["keypoint_map"].float()
        b, h, w = km.shape
        k = int(conf.kp_desc_num)
        H = data["H_0to1"].float()
        pix = torch.arange(h * w, dtype=torch.float32, device=km.device)
        phase = (H.reshape(b, -1) * 37.719).sum(-1)
        jitter = 0.5 + 0.5 * torch.sin(pix[None] * 12.9898 + 78.233 + phase[:, None])
        val, idx = top_k_stable(km.reshape(b, -1) * (1.0 + jitter), k)
        kp = torch.stack([(idx % w).float(), (idx // w).float()], -1) + 0.5
        valid0 = val > 0.5
        warped = warp_points(kp, H)
        inb = ((warped[..., 0] >= 1.0) & (warped[..., 0] <= w - 2.0)
               & (warped[..., 1] >= 1.0) & (warped[..., 1] <= h - 2.0))
        valid = valid0 & inb

        def sample(dense, pts):
            d = _bilinear_raw(dense, pts[..., 0], pts[..., 1])
            return d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-8)

        d0 = sample(pred["dense_descriptors"], kp)
        d1 = sample(pred["dense_descriptors2"], warped)
        sim = torch.einsum("bkd,bqd->bkq", d0, d1) * float(conf.kp_desc_temp)
        neg_inf = -1e9
        zero = torch.zeros((), device=sim.device)
        col_mask = torch.where(valid[:, None, :], zero, torch.full_like(zero, neg_inf))
        row_mask = torch.where(valid[:, :, None], zero, torch.full_like(zero, neg_inf))
        eye = torch.eye(k, device=sim.device)[None]
        nll01 = -(F.log_softmax(sim + col_mask * (1 - eye), dim=2) * eye).sum(2)
        nll10 = -(F.log_softmax(sim + row_mask * (1 - eye), dim=1) * eye).sum(1)
        per_kp = 0.5 * (nll01 + nll10)
        vf = valid.float()
        return (per_kp * vf).sum(-1) / vf.sum(-1).clamp(min=1.0)


__main_model__ = DISK
