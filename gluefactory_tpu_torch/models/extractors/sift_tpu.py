"""DoG-SIFT as a conv pyramid on the device (counterpart of
gluefactory_tpu/models/extractors/sift_tpu.py).

All shapes are static:
  - Gaussian scale space: `num_octaves` octaves of `scales_per_octave + 3`
    images from separable depthwise blurs (radius ceil(3 sigma)); the
    difference of Gaussians of each octave;
  - extrema: the 3 x 3 x 3 max / min over the (S + 2) DoG slices with
    -inf / +inf padding (`max_pool3d`), the contrast threshold and Lowe's
    edge test on the spatial Hessian (its neighbours by `torch.roll`, which
    wraps at the borders as `jnp.roll` does), an 8-pixel margin;
  - one global top-k (ties to the lower index, `jax.lax.top_k`'s order;
    the JAX package's `approx_max_k` on the TPU is not carried over) over
    the octaves' candidates in (y, x, scale) order, decoded back to octave,
    scale and position; a fixed K and a validity mask;
  - orientation: `dominant_orientation` of a 19 x 19 patch at 4.5 sigma;
  - descriptor: an 18 x 18 patch at 6 sigma, rotated by the orientation,
    16 x 16 central-difference gradients, 8 orientation bins with linear
    interpolation, the 4 x 4 spatial cells as one product with the static
    `_spatial_weights_4x4`; L2, clip at 0.2, L2, RootSIFT.

Every convolution and product runs in fp32 (`no_tf32`): TF32 moves |DoG| by
~1e-3 relative, enough to reorder the top-k. The extractor has no
parameters. Outputs: keypoints (+0.5), keypoint_scores, scales (sigma in
pixels), oris (radians), descriptors (B, K, 128), keypoint_mask.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base_model import BaseModel
from ..utils.layers import gaussian_kernel1d, no_tf32, top_k_stable
from .keynet_hardnet import _sep_blur, dominant_orientation, extract_patches_laf
from .superpoint_open import _gray


def _blur_dw(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (B, 1, H, W), radius ceil(3 sigma)."""
    if sigma < 1e-4:
        return x
    return _sep_blur(x, gaussian_kernel1d(sigma, max(1, int(math.ceil(3.0 * sigma)))))


def _spatial_weights_4x4(p: int = 16) -> np.ndarray:
    """Static (p*p, 16) trilinear weights of each patch pixel onto the 4 x 4
    descriptor cells, times a Gaussian window (sigma half the patch)."""
    w = np.zeros((p * p, 16), np.float32)
    for iy in range(p):
        for ix in range(p):
            cy = (iy + 0.5) / p * 4.0 - 0.5
            cx = (ix + 0.5) / p * 4.0 - 0.5
            y0, x0 = int(np.floor(cy)), int(np.floor(cx))
            fy, fx = cy - y0, cx - x0
            for dy, wy in ((y0, 1 - fy), (y0 + 1, fy)):
                if not 0 <= dy < 4:
                    continue
                for dx, wx in ((x0, 1 - fx), (x0 + 1, fx)):
                    if not 0 <= dx < 4:
                        continue
                    w[iy * p + ix, dy * 4 + dx] += wy * wx
    lin = (np.arange(p) + 0.5) / p * 2 - 1
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    g = np.exp(-(gx**2 + gy**2) / (2 * 0.5**2)).reshape(-1, 1)
    return (w * g).astype(np.float32)


def sift_descriptor(patches: torch.Tensor, rootsift: bool = True, num_ori: int = 8):
    """(N, 18, 18) rotated patches -> (N, 128) SIFT descriptors."""
    p = patches.shape[-1] - 2
    gx = (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]) * 0.5
    gy = (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1]) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12).reshape(-1, p * p)
    ang = torch.atan2(gy, gx).reshape(-1, p * p)
    bins = ((ang + math.pi) / (2 * math.pi) * num_ori).clamp(0, num_ori - 1e-4)
    lo = torch.floor(bins)
    frac = bins - lo
    lo_i = lo.long() % num_ori
    hi_i = (lo_i + 1) % num_ori
    w_ori = (F.one_hot(lo_i, num_ori) * (1 - frac)[..., None]
             + F.one_hot(hi_i, num_ori) * frac[..., None])  # (N, P*P, 8)
    w_sp = torch.from_numpy(_spatial_weights_4x4(p)).to(patches.device)
    desc = torch.matmul(w_sp.T, w_ori * mag[..., None]).reshape(-1, 16 * num_ori)
    desc = torch.minimum(desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-8),
                         torch.tensor(0.2, device=desc.device))
    desc = desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    if rootsift:
        desc = torch.sqrt(desc / desc.sum(-1, keepdim=True).clamp(min=1e-8))
    return desc


class SIFTTPU(BaseModel):
    default_conf = {
        "name": "sift_tpu",
        "max_num_keypoints": 2048,
        "detection_threshold": 0.0066667,  # DoG contrast threshold
        "edge_threshold": 10.0,
        "num_octaves": 4,
        "scales_per_octave": 3,
        "sigma0": 1.6,
        "rootsift": True,
        "upright": False,
        "trainable": False,
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        self.to(self.device)

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        with no_tf32(), torch.no_grad():
            return self._forward(data)

    def _candidates(self, image: torch.Tensor):
        """Per octave: the (B, Hs * Ws * S) candidate scores in (y, x, scale)
        order and (octave, Hs, Ws)."""
        conf = self.conf
        s, sigma0 = int(conf.scales_per_octave), float(conf.sigma0)
        k_step = 2.0 ** (1.0 / s)
        inc = [sigma0 * (k_step**i) * math.sqrt(max(k_step**2 - 1.0, 1e-9)) for i in range(s + 2)]
        r = float(conf.edge_threshold)
        b = image.shape[0]
        scores, meta = [], []
        base = _blur_dw(image, sigma0)
        for o in range(int(conf.num_octaves)):
            if min(base.shape[2], base.shape[3]) < 16:
                break
            gss = [base]
            for i in range(s + 2):
                gss.append(_blur_dw(gss[-1], inc[i]))
            dogs = torch.cat([gss[i + 1] - gss[i] for i in range(s + 2)], 1)  # (B, S+2, Hs, Ws)
            mx = F.max_pool3d(dogs[:, None], 3, stride=1, padding=1)[:, 0]
            mn = -F.max_pool3d(-dogs[:, None], 3, stride=1, padding=1)[:, 0]
            d = dogs[:, 1:s + 1]
            is_ext = (d >= mx[:, 1:s + 1]) | (d <= mn[:, 1:s + 1])
            contrast = d.abs() > conf.detection_threshold
            roll = torch.roll
            dxx = roll(d, -1, 3) + roll(d, 1, 3) - 2 * d
            dyy = roll(d, -1, 2) + roll(d, 1, 2) - 2 * d
            dxy = 0.25 * (roll(roll(d, -1, 2), -1, 3) - roll(roll(d, -1, 2), 1, 3)
                          - roll(roll(d, 1, 2), -1, 3) + roll(roll(d, 1, 2), 1, 3))
            tr, det = dxx + dyy, dxx * dyy - dxy * dxy
            edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
            hs, ws = d.shape[2], d.shape[3]
            margin = torch.zeros((hs, ws), dtype=torch.bool, device=d.device)
            margin[8:-8, 8:-8] = True
            keep = is_ext & contrast & edge_ok & margin
            score = torch.where(keep, d.abs(), torch.zeros_like(d))
            scores.append(score.permute(0, 2, 3, 1).reshape(b, -1))
            meta.append((o, hs, ws))
            base = gss[s][:, :, ::2, ::2]  # the next octave's seed (sigma doubled)
        return scores, meta

    def _forward(self, data):
        conf = self.conf
        image = _gray(data["image"]).float().permute(0, 3, 1, 2)  # (B, 1, H, W)
        b = image.shape[0]
        s, sigma0 = int(conf.scales_per_octave), float(conf.sigma0)
        k_step = 2.0 ** (1.0 / s)
        scores, meta = self._candidates(image)
        k = int(conf.max_num_keypoints)
        topv, topi = top_k_stable(torch.cat(scores, 1), k)
        mask = topv > 0.0

        sizes = np.array([hs * ws * s for (_, hs, ws) in meta])
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        xs = torch.zeros_like(topv)
        ys = torch.zeros_like(topv)
        sigmas = torch.zeros_like(topv)
        for idx, (o, hs, ws) in enumerate(meta):
            local = topi - int(offsets[idx])
            in_oct = (topi >= int(offsets[idx])) & (topi < int(offsets[idx + 1]))
            yy = (local // (ws * s)).float()
            rem = local % (ws * s)
            xx = (rem // s).float()
            si = (rem % s).float()
            mult = float(2**o)
            xs = torch.where(in_oct, (xx + 0.5) * mult - 0.5, xs)
            ys = torch.where(in_oct, (yy + 0.5) * mult - 0.5, ys)
            sigmas = torch.where(in_oct, sigma0 * k_step ** (si + 1.0) * mult, sigmas)
        keypoints = torch.stack([xs, ys], -1)
        kp_scores = torch.where(mask, topv, torch.zeros_like(topv))

        img = image[:, 0]
        zeros = torch.zeros((b, k), device=image.device)
        if conf.upright:
            oris = zeros
        else:
            oris = dominant_orientation(
                extract_patches_laf(img, keypoints, 4.5 * sigmas, zeros, patch=19))
        patches = extract_patches_laf(img, keypoints, 6.0 * sigmas, oris, patch=18)
        desc = sift_descriptor(patches.reshape(b * k, 18, 18), bool(conf.rootsift))
        desc = desc.reshape(b, k, 128) * mask[..., None]
        return {
            "keypoints": keypoints + 0.5,
            "keypoint_scores": kp_scores,
            "scales": sigmas,
            "oris": oris,
            "descriptors": desc,
            "keypoint_mask": mask,
        }


__main_model__ = SIFTTPU
