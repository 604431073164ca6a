"""ALIKED: differentiable keypoints + deformable descriptors (counterpart of
gluefactory_tpu/models/extractors/aliked.py).

  - ConvBlock / ResBlock pyramid encoder with SELU and folded BatchNorm
    (a conv bias); blocks 3 and 4 use a deformable 3 x 3 conv (DCNv1,
    torchvision's [dy, dx] offset layout) written as one zero-padded
    bilinear gather of the nine taps' samples and one product (the JAX
    package loops over the taps);
  - the image padded to a multiple of 32 by edge replication, centred;
  - aggregation: 1 x 1 convs + SELU per level, align-corners bilinear
    upsampling (explicit zero-padded sampling, as the JAX package does),
    concatenation; the unit feature map and the 4-conv score head;
  - DKD: NMS, border zeroing, a static top-k (ties to the lower index), the
    temperature-0.1 soft-argmax refinement, rescoring and dispersity;
  - SDDH: the 3 x 3 feature patch at each keypoint (the reference's corner
    clamp), the offset MLP, the deformable samples, sf_conv + SELU and the
    per-position aggregation.

Parameters carry the flax names (`block3.conv1.offset_conv.weight`,
`sddh_offset0_kernel`, ...): `weights.params_from_jax` maps the JAX tree,
and `conf.weights` loads a converted `.npz`. Images are (B, H, W, C) in
[0, 1]; the convolutions and products run in fp32 (`no_tf32`). Outputs:
keypoints in pixels, keypoint_scores, score_dispersity, descriptors,
keypoint_mask, score_map.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..base_model import BaseModel, finish_init
from ..utils.layers import Conv, lecun_init, no_tf32, top_k_stable
from .superpoint_open import simple_nms

CFGS = {
    # c1, c2, c3, c4, dim, K, M
    "aliked-t16": (8, 16, 32, 64, 64, 3, 16),
    "aliked-n16": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n16rot": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n32": (16, 32, 64, 128, 128, 3, 32),
}


def _bilinear_zeros(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (B, H, W, C) at (B, ...) pixel coordinates with
    zero padding outside (grid_sample's padding_mode="zeros"): (B, ..., C)."""
    b, h, w, c = fmap.shape
    shape = x.shape
    x, y = x.reshape(b, -1), y.reshape(b, -1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = fmap.reshape(b, h * w, c)

    def tap(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = iy.long().clamp(0, h - 1) * w + ix.long().clamp(0, w - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return v * inb.to(fmap.dtype)[..., None]

    out = (tap(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
           + tap(x0 + 1, y0) * (wx * (1 - wy))[..., None]
           + tap(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
           + tap(x0 + 1, y0 + 1) * (wx * wy)[..., None])
    return out.reshape(*shape, c)


def _bilinear_raw(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (B, H, W, C) at (B, K) pixel coordinates, the taps
    clamped to the map (DISK's and `mixed`'s sampler): (B, K, C)."""
    b, h, w, c = fmap.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    flat = fmap.reshape(b, h * w, c)

    def g(iy, ix):
        return torch.gather(flat, 1, (iy * w + ix)[..., None].expand(-1, -1, c))

    return (g(y0i, x0i) * ((1 - wx) * (1 - wy))[..., None]
            + g(y0i, x1i) * (wx * (1 - wy))[..., None]
            + g(y1i, x0i) * ((1 - wx) * wy)[..., None]
            + g(y1i, x1i) * (wx * wy)[..., None])


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """Deformable 3 x 3 conv (DCNv1, stride 1, padding 1) of (B, Cin, H, W)
    with offsets (B, 2 KH KW, H, W) in torchvision's [dy_0, dx_0, dy_1, ...]
    layout over row-major taps and an OIHW `weight`; zero outside the map.
    One gather of every tap's samples, then one product over the taps and
    the input channels."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    ty, tx = torch.meshgrid(torch.arange(kh, device=x.device), torch.arange(kw, device=x.device),
                            indexing="ij")
    ty = (ty.reshape(-1) - (kh - 1) // 2).to(x.dtype)[None, :, None, None]
    tx = (tx.reshape(-1) - (kw - 1) // 2).to(x.dtype)[None, :, None, None]
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[:, None]
    xs = torch.arange(w, dtype=x.dtype, device=x.device)[None, :]
    py = ys + ty + offset[:, 0::2]  # (B, KH KW, H, W)
    px = xs + tx + offset[:, 1::2]
    v = _bilinear_zeros(x.permute(0, 2, 3, 1), px, py)  # (B, KH KW, H, W, Cin)
    v = v.permute(0, 2, 3, 1, 4).reshape(b, h, w, kh * kw * cin)
    out = torch.matmul(v, weight.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout))
    if bias is not None:
        out = out + bias
    return out.permute(0, 3, 1, 2)


class _Conv(nn.Module):
    """flax `_Conv`: one "SAME" conv named `conv`."""

    def __init__(self, cin, cout, kernel=3, bias=False):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, bias=bias)

    def forward(self, x):
        return self.conv(x)


class _DCN(nn.Module):
    """Deformable conv: offsets from a regular conv, clamped to
    +-max(h, w) / 4, then `deform_conv2d`."""

    def __init__(self, cin, cout):
        super().__init__()
        self.offset_conv = Conv(cin, 18, 3)
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        max_offset = max(x.shape[2], x.shape[3]) / 4.0
        off = self.offset_conv(x).clamp(-max_offset, max_offset)
        return deform_conv2d(x, off, self.weight, self.bias)


def _get_conv(cin, cout, conv_type):
    return _DCN(cin, cout) if conv_type == "dcn" else _Conv(cin, cout, bias=True)


class _ConvBlock(nn.Module):
    def __init__(self, cin, cout, conv_type="conv"):
        super().__init__()
        self.conv1 = _get_conv(cin, cout, conv_type)
        self.conv2 = _get_conv(cout, cout, conv_type)

    def forward(self, x):
        return F.selu(self.conv2(F.selu(self.conv1(x))))


class _ResBlock(_ConvBlock):
    def __init__(self, cin, cout, conv_type="conv"):
        super().__init__(cin, cout, conv_type)
        self.downsample = Conv(cin, cout, 1)

    def forward(self, x):
        out = self.conv2(F.selu(self.conv1(x)))
        return F.selu(out + self.downsample(x))


class ALIKED(BaseModel):
    default_conf = {
        "name": "aliked",
        "model_name": "aliked-n16",
        "max_num_keypoints": 1024,
        "detection_threshold": 0.0002,
        "nms_radius": 2,
        "force_num_keypoints": True,
        "weights": None,  # the JAX package's converted .npz
        "trainable": False,
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        c1, c2, c3, c4, dim, k, m = CFGS[self.conf.model_name]
        self.block1 = _ConvBlock(3, c1)
        self.block2 = _ResBlock(c1, c2)
        self.block3 = _ResBlock(c2, c3, "dcn")
        self.block4 = _ResBlock(c3, c4, "dcn")
        for i, c in enumerate((c1, c2, c3, c4)):
            setattr(self, f"conv{i + 1}", _Conv(c, dim // 4, 1))
        self.score1 = _Conv(dim, 8, 1)
        self.score2 = _Conv(8, 4, 3)
        self.score3 = _Conv(4, 4, 3)
        self.score4 = _Conv(4, 1, 3)
        gen = torch.Generator().manual_seed(0)
        lecun_init(self, gen)
        for blk in (self.block3, self.block4):
            for dcn in (blk.conv1, blk.conv2):
                fan_in = dcn.weight[0].numel()
                dcn.weight.data.copy_(torch.randn(dcn.weight.shape, generator=gen) * fan_in**-0.5)
        # the SDDH head, in the flax tree's layout (HWIO, (in, out))
        sddh = {"sddh_offset0_kernel": (k, k, dim, 2 * m), "sddh_offset0_bias": (2 * m,),
                "sddh_offset1_kernel": (2 * m, 2 * m), "sddh_offset1_bias": (2 * m,),
                "sddh_sf_kernel": (dim, dim)}
        for name, shape in sddh.items():
            fan_in = int(np.prod(shape[:-1]))
            val = (torch.randn(shape, generator=gen) * fan_in**-0.5 if len(shape) > 1
                   else torch.zeros(shape))
            self.register_parameter(name, nn.Parameter(val))
        self.sddh_agg_weights = nn.Parameter(torch.randn((m, dim, dim), generator=gen) * 0.5)
        finish_init(self)

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        with no_tf32():
            return self._forward(data)

    def _forward(self, data):
        conf = self.conf
        _, _, _, _, dim, K, M = CFGS[conf.model_name]
        image = data["image"].float()
        if image.shape[-1] == 1:
            image = image.repeat(1, 1, 1, 3)
        b, h, w, _ = image.shape
        ph, pw = -h % 32, -w % 32
        x = F.pad(image.permute(0, 3, 1, 2), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                  mode="replicate")

        x1 = self.block1(x)
        x2 = self.block2(F.avg_pool2d(x1, 2, 2))
        x3 = self.block3(F.avg_pool2d(x2, 4, 4))
        x4 = self.block4(F.avg_pool2d(x3, 4, 4))
        hp, wp = x1.shape[2:]

        def up(t):
            # align-corners bilinear to the padded full resolution
            th, tw = t.shape[2:]
            ys = torch.arange(hp, dtype=torch.float32, device=t.device) * ((th - 1) / max(hp - 1, 1))
            xs = torch.arange(wp, dtype=torch.float32, device=t.device) * ((tw - 1) / max(wp - 1, 1))
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            out = _bilinear_zeros(t.permute(0, 2, 3, 1), gx.reshape(1, -1).expand(b, -1),
                                  gy.reshape(1, -1).expand(b, -1))
            return out.reshape(b, hp, wp, -1).permute(0, 3, 1, 2)

        a = [F.selu(getattr(self, f"conv{i + 1}")(t)) for i, t in enumerate((x1, x2, x3, x4))]
        x1234 = torch.cat([a[0], up(a[1]), up(a[2]), up(a[3])], 1)
        s = F.selu(self.score1(x1234))
        s = F.selu(self.score2(s))
        s = F.selu(self.score3(s))
        score_map = torch.sigmoid(self.score4(s))[:, 0]
        feature_map = x1234 / x1234.norm(dim=1, keepdim=True).clamp(min=1e-12)
        score_map = score_map[:, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]
        feature_map = feature_map[:, :, ph // 2:ph // 2 + h, pw // 2:pw // 2 + w]
        feature_map = feature_map.permute(0, 2, 3, 1)  # (B, H, W, D)

        r = conf.nms_radius
        nms = simple_nms(score_map, r)
        border = torch.zeros((h, w), dtype=torch.bool, device=nms.device)
        border[r:h - r, r:w - r] = True
        nms = torch.where(border, nms, torch.zeros_like(nms))
        k = conf.max_num_keypoints
        topv, topi = top_k_stable(nms.reshape(b, h * w), k)
        thr = conf.detection_threshold if conf.detection_threshold > 0 else -1.0
        mask = topv > thr
        xs_i, ys_i = (topi % w).float(), (topi // w).float()

        # soft-argmax window (temperature 0.1)
        ks = 2 * r + 1
        gy, gx = np.meshgrid(np.linspace(-r, r, ks), np.linspace(-r, r, ks), indexing="ij")
        grid = torch.from_numpy(np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32)).to(
            nms.device)
        wy = ys_i[..., None] + grid[None, None, :, 1]
        wx = xs_i[..., None] + grid[None, None, :, 0]
        win = _bilinear_zeros(score_map[..., None], wx, wy)[..., 0]  # (B, K, ks*ks)
        max_v = win.amax(-1, keepdim=True)
        x_exp = torch.exp((win - max_v) / 0.1)
        denom = x_exp.sum(-1, keepdim=True)
        residual = torch.matmul(x_exp, grid) / denom
        dist2 = (((grid[None, None] - residual[:, :, None]) / r) ** 2).sum(-1)
        dispersity = (x_exp * dist2).sum(-1) / denom[..., 0]
        kp_xy = torch.stack([xs_i, ys_i], -1) + residual
        kptscore = _bilinear_zeros(score_map[..., None], kp_xy[..., 0], kp_xy[..., 1])[..., 0]

        desc = self._sddh(feature_map, kp_xy, dim, K, M)
        return {
            "keypoints": kp_xy,
            "keypoint_scores": torch.where(mask, kptscore, torch.zeros_like(kptscore)),
            "score_dispersity": dispersity,
            "descriptors": desc,
            "keypoint_mask": mask,
            "score_map": score_map,
        }

    def _sddh(self, fmap, kp_xy, dim, K, M):
        """Sparse deformable descriptor head on (B, H, W, D) features at
        (B, N, 2) pixel keypoints."""
        b, h, w, _ = fmap.shape
        n = kp_xy.shape[1]
        max_offset = max(h, w) / 4.0
        kp_long = torch.floor(kp_xy).long()
        corner_x = (kp_long[..., 0] - K // 2).clamp(0, w - 1 - K)
        corner_y = (kp_long[..., 1] - K // 2).clamp(0, h - 1 - K)
        gy, gx = np.meshgrid(np.arange(K), np.arange(K), indexing="ij")
        gx = torch.from_numpy(gx.reshape(-1)).to(fmap.device)
        gy = torch.from_numpy(gy.reshape(-1)).to(fmap.device)
        idx = (corner_y[..., None] + gy) * w + corner_x[..., None] + gx  # (B, N, K*K)
        patch = torch.gather(fmap.reshape(b, h * w, dim), 1,
                             idx.reshape(b, -1, 1).expand(-1, -1, dim)).reshape(b, n, K * K * dim)
        o = torch.matmul(patch, self.sddh_offset0_kernel.reshape(K * K * dim, 2 * M))
        o = F.selu(o + self.sddh_offset0_bias)
        o = (torch.matmul(o, self.sddh_offset1_kernel) + self.sddh_offset1_bias).clamp(
            -max_offset, max_offset)
        off = o.reshape(b, n, 2, M).transpose(2, 3)  # (B, N, M, 2) xy
        pos = kp_xy[:, :, None, :] + off
        feats = _bilinear_zeros(fmap, pos[..., 0], pos[..., 1])  # (B, N, M, D)
        feats = F.selu(torch.matmul(feats, self.sddh_sf_kernel))
        desc = torch.matmul(feats.reshape(b, n, M * dim), self.sddh_agg_weights.reshape(M * dim, dim))
        return desc / desc.norm(dim=-1, keepdim=True).clamp(min=1e-12)


__main_model__ = ALIKED
