"""SuperPoint detector/descriptor (open architecture), inference
(counterpart of gluefactory_tpu/models/extractors/superpoint_open.py).

The plain VGG trunk: conv -> ReLU -> BatchNorm (eps 1e-3) blocks. The JAX
package's space-to-depth trunk is a TPU layout trick with the same math and
is not carried over; the convolutions go to `torch.nn.functional.conv2d`,
as the JAX package leaves them to XLA. With `fused_block0` (True, or "auto"
on a CUDA device) the first block (two 64-channel convs at full resolution
and the pool) runs as one kernel, ops/block0_conv.py, in bf16; it is off by
default, as in the JAX package. Images are (B, H, W, C) in [0, 1];
outputs: keypoints (B, K, 2) xy at pixel centers (+0.5), keypoint_scores
(B, K), descriptors (B, K, D), keypoint_mask (B, K) bool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.block0_conv import block0_fused
from ..base_model import BaseModel

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, None: None}


def simple_nms(scores: torch.Tensor, radius: int, iterations: int = 2) -> torch.Tensor:
    """Keep local maxima of a (B, H, W) score map: max-pool equality with
    `iterations` suppression rounds."""

    def max_pool(x):
        return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(iterations):
        supp_mask = max_pool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def sample_descriptors(keypoints: torch.Tensor, descriptors: torch.Tensor, s: int = 8):
    """Bilinearly sample a dense (B, Hc, Wc, D) map at (B, K, 2) xy pixel
    coordinates (align_corners=False, cell stride s); L2-normalise in fp32."""
    b, hc, wc, d = descriptors.shape
    x = (keypoints[..., 0] + 0.5) / s - 0.5
    y = (keypoints[..., 1] + 0.5) / s - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i = x0.long().clamp(0, wc - 1)
    x1i = (x0i + 1).clamp(0, wc - 1)
    y0i = y0.long().clamp(0, hc - 1)
    y1i = (y0i + 1).clamp(0, hc - 1)
    flat = descriptors.reshape(b, hc * wc, d)

    def gather(iy, ix):
        return torch.gather(flat, 1, (iy * wc + ix)[..., None].expand(-1, -1, d))

    wdt = descriptors.dtype
    w = lambda t: t.to(wdt)[..., None]
    out = (
        gather(y0i, x0i) * w((1 - wx) * (1 - wy))
        + gather(y0i, x1i) * w(wx * (1 - wy))
        + gather(y1i, x0i) * w((1 - wx) * wy)
        + gather(y1i, x1i) * w(wx * wy)
    ).float()
    return out / out.norm(dim=-1, keepdim=True).clamp(min=1e-8)


class VGGBlock(nn.Module):
    """conv -> ReLU -> inference BatchNorm, NCHW, in the compute dtype."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)
        self.relu = relu
        for name, init in (("bn_scale", torch.ones), ("bn_bias", torch.zeros),
                           ("bn_mean", torch.zeros), ("bn_var", torch.ones)):
            self.register_buffer(name, init(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = F.conv2d(x, self.conv.weight.to(dt), self.conv.bias.to(dt),
                     padding=self.conv.padding)
        if self.relu:
            x = F.relu(x)
        mul, add = self.affine()
        return x * mul.to(dt)[:, None, None] + add.to(dt)[:, None, None]

    def affine(self):
        """The inference BatchNorm folded to (mul, add), one a channel."""
        mul = self.bn_scale * torch.rsqrt(self.bn_var + 1e-3)
        return mul, self.bn_bias - self.bn_mean * mul

    def raw(self):
        """(conv kernel in HWIO layout, conv bias, mul, add): what the fused
        block-0 kernel reads."""
        return (self.conv.weight.permute(2, 3, 1, 0), self.conv.bias, *self.affine())


class SuperPoint(BaseModel):
    default_conf = {
        "name": "superpoint_open",
        "descriptor_dim": 256,
        "nms_radius": 4,
        "max_num_keypoints": 1024,
        "detection_threshold": 0.005,
        "remove_borders": 4,
        "channels": [64, 64, 128, 128, 256],
        "dense_outputs": False,
        "is_training": False,
        "dtype": "bfloat16",  # conv compute dtype; heads renormalise in fp32
        # block 0 as one kernel (ops/block0_conv.py): True, False or "auto"
        # (on when the module is on a CUDA device); H and W must then be even.
        # Slower than the cuDNN trunk today (PERF.md), hence off by default.
        "fused_block0": False,
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        conf = self.conf
        if conf.is_training:
            raise NotImplementedError("SuperPoint training is not ported yet (ROADMAP Queue 1)")
        if conf.fused_block0 not in (True, False, "auto"):
            raise ValueError(f"fused_block0 must be True, False or 'auto', got {conf.fused_block0!r}")
        ch = list(conf.channels)
        blocks, cin = [], 1
        for c in ch[:-1]:
            blocks += [VGGBlock(cin, c), VGGBlock(c, c)]
            cin = c
        stride = 2 ** (len(ch) - 2)
        blocks += [
            VGGBlock(cin, ch[-1]), VGGBlock(ch[-1], conf.descriptor_dim, 1, relu=False),
            VGGBlock(cin, ch[-1]), VGGBlock(ch[-1], stride**2 + 1, 1, relu=False),
        ]
        self.blocks = nn.ModuleList(blocks)
        self.stride = stride
        self.requires_grad_(False)
        self.to(self.device)

    @torch.no_grad()
    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        conf = self.conf
        image = data["image"]  # (B, H, W, C)
        if image.shape[-1] == 3:
            gray = torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype, device=image.device)
            image = (image * gray).sum(-1, keepdim=True)
        dtype = _DTYPES[conf.get("dtype")]
        n_trunk = 2 * (len(conf.channels) - 1)
        first = 0
        fused = conf.fused_block0 is True or (
            conf.fused_block0 == "auto" and image.device.type == "cuda")
        # the kernel takes one input channel, 64 channels and a pooled block;
        # anything else goes through the plain trunk. It raises on an odd side.
        if fused and image.shape[-1] == 1 and conf.channels[0] == 64 and n_trunk > 2:
            x = block0_fused(image.float(), *self.blocks[0].raw(), *self.blocks[1].raw())
            x = x.permute(0, 3, 1, 2)  # NCHW over channels-last memory: no copy
            if dtype != torch.bfloat16:  # the kernel computes in bf16; keep the conf's type
                x = x.float()
            first = 2
        else:
            x = image.permute(0, 3, 1, 2)
            x = x.to(dtype) if dtype is not None else x

        for i in range(first, n_trunk, 2):
            x = self.blocks[i + 1](self.blocks[i](x))
            if i < n_trunk - 2:
                x = F.max_pool2d(x, 2, 2)
        features = x

        desc_a, desc_b, det_a, det_b = self.blocks[n_trunk:]
        dense = desc_b(desc_a(features)).float()
        dense = dense / dense.norm(dim=1, keepdim=True).clamp(min=1e-8)
        if dtype is not None:
            dense = dense.to(dtype)
        logits = det_b(det_a(features)).float()

        scores = torch.softmax(logits, dim=1)[:, :-1]
        scores = F.pixel_shuffle(scores, self.stride)[:, 0]  # (B, H, W)
        if dtype is not None:
            scores = scores.to(dtype)
        scores = simple_nms(scores, conf.nms_radius)

        b, h, w = scores.shape
        if conf.remove_borders:
            pad = conf.remove_borders
            border = torch.zeros((h, w), dtype=torch.bool, device=scores.device)
            border[pad:-pad, pad:-pad] = True
            scores = torch.where(border, scores, torch.full_like(scores, -1.0))

        # exact top-k; a stable sort resolves ties to the lower flat index
        k = conf.max_num_keypoints
        topv, topi = torch.sort(scores.reshape(b, h * w), dim=1, descending=True, stable=True)
        topv, topi = topv[:, :k].float(), topi[:, :k]
        keypoints = torch.stack([(topi % w).float(), (topi // w).float()], dim=-1)
        mask = topv > conf.detection_threshold
        kp_scores = torch.where(mask, topv, torch.zeros_like(topv))

        desc = sample_descriptors(keypoints, dense.permute(0, 2, 3, 1), self.stride)
        pred = {
            "keypoints": keypoints + 0.5,
            "keypoint_scores": kp_scores,
            "descriptors": desc,
            "keypoint_mask": mask,
        }
        if conf.dense_outputs:
            pred["dense_descriptors"] = dense.permute(0, 2, 3, 1).float()
        return pred


__main_model__ = SuperPoint
