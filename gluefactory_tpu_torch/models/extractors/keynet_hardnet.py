"""KeyNet detector + HardNet patch descriptor (counterpart of
gluefactory_tpu/models/extractors/keynet_hardnet.py).

KeyNet: a handcrafted block of 10 derivative channels -> three 5 x 5 conv
+ BatchNorm (running statistics, eps 1e-5) + ReLU blocks -> a 1-channel
score, over a fixed pyramid (blur, then `jax.image.resize`'s antialiased
bilinear at ratio `pyramid_ratio`), the levels' scores resized back and
averaged; the detection level gives each keypoint its scale. Orientation:
the dominant gradient orientation of a 19 x 19 patch (36 bins, parabolic
peak refinement), off with `upright`. HardNet: seven convs on the
per-patch-normalised 32 x 32 crops -> 128-D unit descriptors.

Shared with `sift_tpu`: `_blur`, `_derivatives`, `extract_patches_laf`
(bilinear crops at rotated, scaled grids) and `dominant_orientation`.
Images are (B, H, W, C) in [0, 1]; the convolutions run on NCHW tensors in
fp32 (`no_tf32`). The top-k is `jax.lax.top_k`'s (ties to the lower index);
the JAX package's `approx_max_k` on the TPU is not carried over. Outputs:
keypoints (+0.5), keypoint_scores, descriptors, scales, oris (degrees),
lafs (B, K, 2, 3) and keypoint_mask.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..base_model import BaseModel, finish_init
from ..utils.layers import BatchNorm, Conv, gaussian_kernel1d, no_tf32, resize_jax, top_k_stable
from .superpoint_open import _gray, simple_nms

_SOBEL = np.asarray([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0


def _sep_blur(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable "SAME" (zero-padded) blur of every channel of (B, C, H, W)
    by the odd 1-D kernel `k`, rows then columns."""
    c, r = x.shape[1], len(k) // 2
    kt = torch.from_numpy(k).to(x.device, x.dtype)
    x = F.conv2d(x, kt.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(r, 0), groups=c)
    return F.conv2d(x, kt.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, r), groups=c)


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, C, H, W), radius round(3 sigma)."""
    return _sep_blur(x, gaussian_kernel1d(sigma, max(1, int(round(3.0 * sigma)))))


def _derivatives(x: torch.Tensor):
    """Sobel / 8 first derivatives (gx, gy) of (B, 1, H, W), zero-padded."""
    kx = torch.from_numpy(_SOBEL).to(x.device, x.dtype).view(1, 1, 3, 3)
    ky = torch.from_numpy(np.ascontiguousarray(_SOBEL.T)).to(x.device, x.dtype).view(1, 1, 3, 3)
    return F.conv2d(x, kx, padding=1), F.conv2d(x, ky, padding=1)


def handcrafted_features(x: torch.Tensor) -> torch.Tensor:
    """KeyNet's handcrafted block: 10 channels of 1st / 2nd-order derivative
    products of (B, 1, H, W)."""
    gx, gy = _derivatives(x)
    gxx, gxy = _derivatives(gx)
    _, gyy = _derivatives(gy)
    return torch.cat([gx, gy, gx * gy, gx * gx, gy * gy, gxx, gyy, gxx * gyy, gxy, gxy * gxy], 1)


class _KeyNetScoreHead(nn.Module):
    """3 x (conv 5 x 5 -> BatchNorm -> ReLU) + a 1-channel 5 x 5 score conv."""

    def __init__(self, channels: int = 8):
        super().__init__()
        for i, cin in enumerate((10, channels, channels)):
            setattr(self, f"conv{i}", Conv(cin, channels, 5))
            setattr(self, f"bn{i}", BatchNorm(channels, eps=1e-5))
        self.score = Conv(channels, 1, 5)

    def forward(self, feats):
        x = feats
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), False))
        return self.score(x)[:, 0]  # (B, H, W)


def extract_patches_laf(image: torch.Tensor, centers: torch.Tensor, scales: torch.Tensor,
                        oris: torch.Tensor, patch: int = 32,
                        radius_mult: float = 1.0) -> torch.Tensor:
    """Bilinear (B, K, patch, patch) crops of a (B, H, W) `image` at rotated,
    scaled grids centred on `centers` (B, K, 2) xy; `scales` is the half
    width in pixels, `oris` radians. Taps are clamped to the image."""
    b, h, w = image.shape
    k = centers.shape[1]
    dev = image.device
    lin = (torch.arange(patch, dtype=torch.float32, device=dev) + 0.5) / patch * 2.0 - 1.0
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([gx, gy], -1).reshape(-1, 2)  # (P*P, 2)
    cos, sin = torch.cos(oris), torch.sin(oris)
    rot = torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)
    r = scales * radius_mult
    pts = torch.einsum("pj,bkij->bkpi", grid, rot) * r[..., None, None]
    pts = pts + centers[:, :, None, :]  # (B, K, P*P, 2)

    x = pts[..., 0].clamp(0.0, w - 1.0)
    y = pts[..., 1].clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    flat = image.reshape(b, h * w)

    def gather(iy, ix):
        return torch.gather(flat, 1, (iy * w + ix).reshape(b, -1)).reshape(b, k, patch * patch)

    out = (gather(y0i, x0i) * ((1 - wx) * (1 - wy)) + gather(y0i, x1i) * (wx * (1 - wy))
           + gather(y1i, x0i) * ((1 - wx) * wy) + gather(y1i, x1i) * (wx * wy))
    return out.reshape(b, k, patch, patch)


def dominant_orientation(patches: torch.Tensor, num_bins: int = 36) -> torch.Tensor:
    """Dominant gradient orientation (radians) of (B, K, P, P) patches: a
    Gaussian-weighted 36-bin histogram with linear bin interpolation (a
    product with the bins' one-hot codes, as the JAX package computes it:
    a fixed order on every device, no atomics), circular smoothing and a
    parabolic peak refinement."""
    b, k, p, _ = patches.shape
    gx, gy = _derivatives(patches.reshape(b * k, 1, p, p))
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)[:, 0]
    ang = torch.atan2(gy[:, 0], gx[:, 0])
    lin = torch.linspace(-1.0, 1.0, p, device=patches.device)
    gyw, gxw = torch.meshgrid(lin, lin, indexing="ij")
    gauss = torch.exp(-(gxw**2 + gyw**2) / (2 * 0.4**2))
    wgt = (mag * gauss[None]).reshape(b * k, p * p)

    bins = (ang + math.pi) / (2 * math.pi) * num_bins
    bins = bins.reshape(b * k, p * p).clamp(0, num_bins - 1e-3)
    lo = torch.floor(bins)
    frac = bins - lo
    lo_i = lo.long() % num_bins
    hi_i = (lo_i + 1) % num_bins
    onehot = lambda i: F.one_hot(i, num_bins).to(wgt.dtype)
    hist = (torch.matmul((wgt * (1 - frac))[:, None], onehot(lo_i))
            + torch.matmul((wgt * frac)[:, None], onehot(hi_i)))[:, 0]
    hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    best = torch.argmax(hist, dim=-1)
    left = hist.gather(1, ((best - 1) % num_bins)[:, None])[:, 0]
    mid = hist.gather(1, best[:, None])[:, 0]
    right = hist.gather(1, ((best + 1) % num_bins)[:, None])[:, 0]
    denom = left - 2 * mid + right
    offset = torch.where(denom.abs() > 1e-8, 0.5 * (left - right) / denom, torch.zeros_like(denom))
    offset = offset.clamp(-0.5, 0.5)
    theta = (best + offset + 0.5) / num_bins * 2 * math.pi - math.pi
    return theta.reshape(b, k)


class _HardNet(nn.Module):
    """HardNet (7 convs, 32 x 32 x 1 -> 128, BatchNorm on running
    statistics, eps 1e-5) on per-patch-normalised crops."""

    def __init__(self, out_dim: int = 128):
        super().__init__()
        chans = [(1, 32, 1), (32, 32, 1), (32, 64, 2), (64, 64, 1), (64, 128, 2), (128, 128, 1)]
        for i, (cin, cout, stride) in enumerate(chans):
            setattr(self, f"conv{i}", Conv(cin, cout, 3, stride, bias=False))
            setattr(self, f"bn{i}", BatchNorm(cout, eps=1e-5))
        self.conv6 = Conv(128, out_dim, 8, padding="VALID", bias=False)
        self.bn6 = BatchNorm(out_dim, eps=1e-5)

    def forward(self, patches):  # (N, 1, P, P)
        mu = patches.mean(dim=(1, 2, 3), keepdim=True)
        sd = patches.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = (patches - mu) / (sd + 1e-7)
        for i in range(6):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), False))
        x = self.bn6(self.conv6(x), False).reshape(x.shape[0], -1)
        return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-8)


class KeyNetHardNet(BaseModel):
    default_conf = {
        "name": "keynet_hardnet",
        "max_num_keypoints": 1024,
        "desc_dim": 128,
        "upright": False,
        "scale_laf": 1.0,
        "num_levels": 3,
        "pyramid_ratio": 1.2,
        "nms_radius": 4,
        "detection_threshold": 0.0,
        "patch_size": 32,
        "weights": None,  # the JAX package's .npz of this model's flax tree
        "trainable": False,
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        self._KeyNetScoreHead_0 = _KeyNetScoreHead()
        self._HardNet_0 = _HardNet(self.conf.desc_dim)
        finish_init(self)

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        with no_tf32():
            return self._forward(data)

    def _forward(self, data):
        conf = self.conf
        image = _gray(data["image"]).float().permute(0, 3, 1, 2)  # (B, 1, H, W)
        b, _, h, w = image.shape
        ratio = float(conf.pyramid_ratio)
        level_score, level_sigma = [], []
        x = image
        for lvl in range(conf.num_levels):
            if lvl > 0:
                x = _blur(x, 0.8 * ratio)
                x = resize_jax(x, (max(8, int(round(h / ratio**lvl))),
                                   max(8, int(round(w / ratio**lvl)))))
            s = self._KeyNetScoreHead_0(handcrafted_features(x))
            if lvl > 0:
                s = resize_jax(s, (h, w))
            level_score.append(s)
            level_sigma.append(ratio**lvl)
        scores_all = torch.stack(level_score, -1)  # (B, H, W, L)
        scores = scores_all.mean(-1)
        best_level = torch.argmax(scores_all, -1)

        scores = simple_nms(F.relu(scores), conf.nms_radius)
        pad = 8
        border = torch.zeros((h, w), dtype=torch.bool, device=scores.device)
        border[pad:-pad, pad:-pad] = True
        scores = torch.where(border, scores, torch.zeros_like(scores))

        k = conf.max_num_keypoints
        topv, topi = top_k_stable(scores.reshape(b, h * w), k)
        keypoints = torch.stack([(topi % w).float(), (topi // w).float()], -1)
        mask = topv > conf.detection_threshold
        kp_scores = torch.where(mask, topv, torch.zeros_like(topv))
        lvl_at_kp = best_level.reshape(b, h * w).gather(1, topi)
        sigmas = torch.tensor(level_sigma, dtype=torch.float32, device=image.device)
        scales = sigmas[lvl_at_kp] * 6.0 * float(conf.scale_laf)

        img = image[:, 0]
        if conf.upright:
            oris = torch.zeros((b, k), device=image.device)
        else:
            oris = dominant_orientation(extract_patches_laf(
                img, keypoints, scales, torch.zeros((b, k), device=image.device), patch=19))
        ps = conf.patch_size
        patches = extract_patches_laf(img, keypoints, scales, oris, patch=ps)
        descs = self._HardNet_0(patches.reshape(b * k, 1, ps, ps)).reshape(b, k, conf.desc_dim)
        descs = descs * mask[..., None]
        cos, sin = torch.cos(oris), torch.sin(oris)
        lafs = torch.stack([
            torch.stack([scales * cos, -scales * sin, keypoints[..., 0]], -1),
            torch.stack([scales * sin, scales * cos, keypoints[..., 1]], -1)], -2)
        return {
            "keypoints": keypoints + 0.5,
            "keypoint_scores": kp_scores,
            "descriptors": descs,
            "scales": scales,
            "oris": torch.rad2deg(oris),
            "lafs": lafs,
            "keypoint_mask": mask,
        }


__main_model__ = KeyNetHardNet
