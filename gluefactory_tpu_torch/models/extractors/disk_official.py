"""The official DISK architecture (counterpart of
gluefactory_tpu/models/extractors/disk_official.py; kornia's
`DISK.from_pretrained("depth")`).

  - U-Net: down [16, 32, 64, 64, 64], up [64, 64, 64, desc_dim + 1], 5 x 5
    convs; every block but the stem is pre-activation: InstanceNorm
    without affine (eps 1e-5) -> per-channel PReLU -> conv. 2 x 2 average
    pooling down, nearest x 2 up (`nearest-exact`, `jax.image.resize`'s
    "nearest"), the upsampled map then the skip concatenated;
  - channels [:desc_dim] are the dense descriptors, [desc_dim] the heatmap;
  - the image zero-padded to a multiple of 16 at the bottom and right
    (`pad_if_not_divisible`);
  - kornia's grid NMS: one argmax per non-overlapping `nms_window_size`
    window (-inf padding), then the threshold and a global top-k (ties to
    the lower index); descriptors read at the integer keypoints, unit
    length; keypoints +0.5.

Parameters keep the flax tree's names and layout (`down_0_conv_w` HWIO,
`down_0_conv_b`, `down_1_prelu`, ...). Images are (B, H, W, C) in [0, 1];
convolutions run in fp32 (`no_tf32`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..base_model import BaseModel, finish_init
from ..utils.layers import no_tf32, top_k_stable


def _instance_norm(x, eps=1e-5):
    """InstanceNorm2d(affine=False) of NCHW: per sample and channel."""
    mean = x.mean((2, 3), keepdim=True)
    var = x.var((2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


class DISKOfficial(BaseModel):
    default_conf = {
        "name": "disk_official",
        "weights": None,  # the JAX package's converted .npz
        "max_num_keypoints": 1024,
        "desc_dim": 128,
        "nms_window_size": 5,
        "detection_threshold": 0.0,
        "down": [16, 32, 64, 64, 64],
        "up": [64, 64, 64],  # the last up block gives desc_dim + 1
        "kernel_size": 5,
        "pad_if_not_divisible": True,
        "trainable": False,
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        conf = self.conf
        ks = conf.kernel_size
        down = list(conf.down)
        up = list(conf.up) + [conf.desc_dim + 1]
        d_in = [3] + down[:-1]
        gen = torch.Generator().manual_seed(0)

        def conv(name, cin, cout):
            w = torch.randn((ks, ks, cin, cout), generator=gen) * (ks * ks * cin) ** -0.5
            self.register_parameter(name + "_w", nn.Parameter(w))
            self.register_parameter(name + "_b", nn.Parameter(torch.zeros(cout)))

        for i, (cin, cout) in enumerate(zip(d_in, down)):
            conv(f"down_{i}_conv", cin, cout)
            if i > 0:  # pre-activation PReLU on the block's input channels
                self.register_parameter(f"down_{i}_prelu", nn.Parameter(torch.full((cin,), 0.25)))
        bot = [down[-1]] + up[:-1]
        skips = down[-2::-1]
        for i, (b, s, cout) in enumerate(zip(bot, skips, up)):
            conv(f"up_{i}_conv", b + s, cout)
            self.register_parameter(f"up_{i}_prelu", nn.Parameter(torch.full((b + s,), 0.25)))
        self.n_down, self.n_up = len(down), len(up)
        finish_init(self)

    def _conv_block(self, x, name, prelu=None):
        if prelu is not None:
            x = _instance_norm(x)
            x = torch.where(x >= 0, x, prelu[None, :, None, None] * x)
        w = getattr(self, name + "_w").permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(x, w, getattr(self, name + "_b"), padding=w.shape[-1] // 2)

    def dense_forward(self, image: torch.Tensor):
        """(heatmap (B, H, W), dense descriptors (B, H, W, desc_dim)) of an
        NCHW image."""
        feats, x = [], image
        for i in range(self.n_down):
            if i > 0:
                x = self._conv_block(F.avg_pool2d(x, 2, 2), f"down_{i}_conv",
                                     getattr(self, f"down_{i}_prelu"))
            else:
                x = self._conv_block(x, "down_0_conv")
            feats.append(x)
        x = feats[-1]
        for i in range(self.n_up):
            skip = feats[-2 - i]
            x = F.interpolate(x, size=skip.shape[2:], mode="nearest-exact")
            x = self._conv_block(torch.cat([x, skip], 1), f"up_{i}_conv",
                                 getattr(self, f"up_{i}_prelu"))
        d = self.conf.desc_dim
        return x[:, d], x[:, :d].permute(0, 2, 3, 1)

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        with no_tf32():
            return self._forward(data)

    def _forward(self, data):
        conf = self.conf
        image = data["image"].float()
        if image.shape[-1] == 1:
            image = image.repeat(1, 1, 1, 3)
        b, h, w, _ = image.shape
        x = image.permute(0, 3, 1, 2)
        if conf.pad_if_not_divisible:
            x = F.pad(x, (0, (-w) % 16, 0, (-h) % 16))
        heatmap, dense = self.dense_forward(x)
        heatmap, dense = heatmap[:, :h, :w], dense[:, :h, :w]

        win = conf.nms_window_size
        hm = F.pad(heatmap, (0, (-w) % win, 0, (-h) % win), value=float("-inf"))
        gh, gw = hm.shape[1] // win, hm.shape[2] // win
        windows = hm.reshape(b, gh, win, gw, win).permute(0, 1, 3, 2, 4).reshape(b, gh * gw, -1)
        local = torch.argmax(windows, -1)  # the first maximum, as jnp.argmax
        scores = windows.gather(-1, local[..., None])[..., 0]
        dev = heatmap.device
        gy = torch.arange(gh, device=dev).repeat_interleave(gw)[None] * win + local // win
        gx = torch.arange(gw, device=dev).repeat(gh)[None] * win + local % win

        k = min(conf.max_num_keypoints, gh * gw)
        topv, topi = top_k_stable(scores, k)
        by, bx = gy.gather(1, topi), gx.gather(1, topi)
        mask = topv > conf.detection_threshold
        desc = dense[torch.arange(b, device=dev)[:, None], by, bx]
        desc = desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        return {
            "keypoints": torch.stack([bx, by], -1).float() + 0.5,
            "keypoint_scores": torch.where(mask, topv, torch.zeros_like(topv)),
            "descriptors": torch.where(mask[..., None], desc, torch.zeros_like(desc)),
            "keypoint_mask": mask,
        }


__main_model__ = DISKOfficial
