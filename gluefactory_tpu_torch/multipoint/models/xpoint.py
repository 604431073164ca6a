"""XPoint: MultiPoint with an attention backbone per modality (counterpart
of gluefactory_tpu/multipoint/models/xpoint.py).

`backbone` picks the encoder as the JAX `_make_encoder` does:
  swin       SwinV2Encoder(d0 = max(dim // 2, 16), depths (p, p) with
             p = max(depth // 2, 1), heads (max(d0 // 32, 1), max(d0 // 16, 1)))
  swinir     SwinIREncoder(dim, groups max(depth // 2, 1), 2 blocks a group,
             heads max(dim // 16, 1))
  scunet     SCUNetEncoder(max(2 dim // 3, 32), out_dim dim, blocks a stage
             max(depth // 2, 1))
  swin_lite  three stride-2 "SAME" convs with GELU between them, then
             `depth` window blocks (4 heads; every other block shifted by
             window // 2 with a plain roll and no attention mask)
  cbam       three stages of two 3 x 3 convs (the first stride 2) + ReLU and
             a CBAM block (one MLP shared by the mean and max pools, a 7 x 7
             spatial gate on [channel mean, channel max]), widths
             c = min(2c, dim) from dim // 2, a 3 x 3 conv to dim
  vit        an 8 x 8 stride-8 patch conv, 2D sin-cos positions, `depth`
             pre-norm global-attention blocks (4 heads)
with `window` where it applies, feeding MultiPoint's shared detector and
descriptor heads. flax's tanh GELU and LayerNorm eps 1e-6 throughout.

`homography_head` adds the regression head of `regress_homography(f0, f1)`
(NHWC backbone features of the two views -> (B, 4, 2) corner offsets):
`True` or "pool" (the two feature means concatenated, MLP 256 -> 128 -> 8),
"srhen" (`CorrelationHomographyHead`), "ms2cahe"
(`CrossAttentionHomographyHead`), or a mapping {"type", "width"} (width
scales srhen's channels).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...models.utils.layers import Conv
from .backbones import (SCUNetEncoder, SwinIREncoder, SwinV2Encoder, gelu, layer_norm,
                        split_heads, window_merge, window_partition)
from .multipoint import MultiPoint


def _mha(q, k, v, heads: int):
    """Softmax attention of (N, L, dim) tokens in `heads` heads, the
    logits in fp32: (N, L, dim)."""
    n, l, dim = q.shape
    q, k, v = (split_heads(t, heads) for t in (q, k, v))
    attn = torch.softmax((q.float() @ k.float().transpose(-2, -1)) / (dim // heads) ** 0.5, -1)
    return (attn @ v).transpose(1, 2).reshape(n, l, dim)


class _WindowBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4, window: int = 8, shift: int = 0):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_0 = nn.Linear(dim, 3 * dim)
        self.Dense_1 = nn.Linear(dim, dim)
        self.LayerNorm_1 = layer_norm(dim)
        self.Dense_2 = nn.Linear(dim, 4 * dim)
        self.Dense_3 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        b, h, w, c = x.shape
        ws, s = self.window, self.shift
        y = self.LayerNorm_0(x)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        wins = window_partition(y, ws)
        y = self.Dense_1(_mha(*self.Dense_0(wins).chunk(3, dim=-1), self.heads))
        y = window_merge(y, ws, h, w)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        return x + self.Dense_3(gelu(self.Dense_2(self.LayerNorm_1(x))))


class _SwinLiteEncoder(nn.Module):
    def __init__(self, dim: int = 96, depth: int = 4, window: int = 8, cin: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, dim // 2, 3, stride=2)
        self.Conv_1 = Conv(dim // 2, dim, 3, stride=2)
        self.Conv_2 = Conv(dim, dim, 3, stride=2)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"_WindowBlock_{i}", _WindowBlock(
                dim, window=window, shift=0 if i % 2 == 0 else window // 2))
        self.out_dim = dim

    def forward(self, x, is_training: bool = False):
        x = self.Conv_2(gelu(self.Conv_1(gelu(self.Conv_0(x))))).permute(0, 2, 3, 1)
        for i in range(self.depth):
            x = getattr(self, f"_WindowBlock_{i}")(x)
        return x.permute(0, 3, 1, 2)


def sincos_2d(h: int, w: int, c: int, device) -> torch.Tensor:
    """(h w, 4 (c // 4)) positions [sin x, cos x, sin y, cos y] in fp32
    (SimpleViT's posemb_sincos_2d, as the JAX encoder computes it)."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    q = c // 4
    omega = 1.0 / (10000 ** (torch.arange(q, device=device, dtype=torch.float32)
                             / max(q - 1, 1)))
    py = yy.reshape(-1, 1) * omega[None]
    px = xx.reshape(-1, 1) * omega[None]
    return torch.cat([torch.sin(px), torch.cos(px), torch.sin(py), torch.cos(py)], -1)


class _ViTEncoder(nn.Module):
    def __init__(self, dim: int = 96, depth: int = 4, heads: int = 4, cin: int = 1):
        super().__init__()
        self.dim, self.depth, self.heads = dim, depth, heads
        self.Conv_0 = Conv(cin, dim, 8, stride=8, padding="VALID")
        for i in range(depth):
            self.add_module(f"LayerNorm_{2 * i}", layer_norm(dim))
            self.add_module(f"Dense_{4 * i}", nn.Linear(dim, 3 * dim))
            self.add_module(f"Dense_{4 * i + 1}", nn.Linear(dim, dim))
            self.add_module(f"LayerNorm_{2 * i + 1}", layer_norm(dim))
            self.add_module(f"Dense_{4 * i + 2}", nn.Linear(dim, 4 * dim))
            self.add_module(f"Dense_{4 * i + 3}", nn.Linear(4 * dim, dim))
        self.out_dim = dim

    def forward(self, x, is_training: bool = False):
        x = self.Conv_0(x)
        b, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        tokens = tokens + sincos_2d(h, w, c, x.device)[None, :, :c]
        for i in range(self.depth):
            norm1, norm2 = (getattr(self, f"LayerNorm_{2 * i + j}") for j in (0, 1))
            qkv, out, fc1, fc2 = (getattr(self, f"Dense_{4 * i + j}") for j in range(4))
            tokens = tokens + out(_mha(*qkv(norm1(tokens)).chunk(3, dim=-1), self.heads))
            tokens = tokens + fc2(gelu(fc1(norm2(tokens))))
        return tokens.reshape(b, h, w, self.dim).permute(0, 3, 1, 2)


class _MLP(nn.Module):
    """flax `nn.Sequential([Dense, relu, Dense, ...])` made in `setup`: the
    dense layers at their list positions `layers_0`, `layers_2`, ..., ReLU
    between them."""

    def __init__(self, *dims):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"layers_{2 * i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layers_{2 * i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return x


class _CBAMBlock(nn.Module):
    """The channel MLP's layers sit in the block's own scope (`Dense_0`,
    `Dense_1`), as flax names an `nn.Sequential` made inside a compact
    method."""

    def __init__(self, dim: int, reduction: int = 8):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, dim // reduction)
        self.Dense_1 = nn.Linear(dim // reduction, dim)
        self.Conv_0 = Conv(2, 1, 7)

    def forward(self, x):  # NCHW
        def mlp(v):
            return self.Dense_1(F.relu(self.Dense_0(v)))

        gate = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        x = x * gate[:, :, None, None]
        pooled = torch.stack([x.mean(1), x.amax(1)], 1)
        return x * torch.sigmoid(self.Conv_0(pooled))


class _CBAMEncoder(nn.Module):
    def __init__(self, dim: int = 96, depth: int = 3, cin: int = 1):
        super().__init__()
        self.depth = depth
        c = dim // 2
        for i in range(depth):
            c = min(c * 2, dim) if i else c
            self.add_module(f"Conv_{2 * i}", Conv(cin, c, 3, stride=2))
            self.add_module(f"Conv_{2 * i + 1}", Conv(c, c, 3))
            self.add_module(f"_CBAMBlock_{i}", _CBAMBlock(c))
            cin = c
        self.add_module(f"Conv_{2 * depth}", Conv(c, dim, 3))
        self.out_dim = dim

    def forward(self, x, is_training: bool = False):
        for i in range(self.depth):
            x = F.relu(getattr(self, f"Conv_{2 * i}")(x))
            x = F.relu(getattr(self, f"Conv_{2 * i + 1}")(x))
            x = getattr(self, f"_CBAMBlock_{i}")(x)
        return getattr(self, f"Conv_{2 * self.depth}")(x)


def homography_head_type(h):
    """(type, width) of a `homography_head` setting, or (None, 1.0)."""
    if not h:
        return None, 1.0
    if isinstance(h, str):
        return h, 1.0
    if hasattr(h, "get"):
        return h.get("type", "pool"), float(h.get("width", 1.0))
    return "pool", 1.0  # True: the pooled head


class XPoint(MultiPoint):
    default_conf = {
        "name": "xpoint",
        "backbone": "swin",
        "backbone_dim": 96,
        "backbone_depth": 4,
        "window": 8,
        "homography_head": False,
    }

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        self.h_type, width = homography_head_type(self.conf.homography_head)
        if self.h_type is None:
            return
        enc = self.encoder_optical if self.conf.multispectral else self.encoder
        if self.h_type == "pool":
            self.h_head = _MLP(2 * enc.out_dim, 256, 128, 8)
        elif self.h_type == "srhen":
            from .homography_net import CorrelationHomographyHead

            self.h_head = CorrelationHomographyHead(width)
        elif self.h_type == "ms2cahe":
            from .homography_net import CrossAttentionHomographyHead

            self.h_head = CrossAttentionHomographyHead(enc.out_dim)
        else:
            raise ValueError(f"unknown homography head {self.h_type}")
        self.to(self.device)

    def _make_encoder(self) -> nn.Module:
        conf = self.conf
        name = conf.backbone
        dim, depth, window = conf.backbone_dim, conf.backbone_depth, conf.window
        if name == "swin":
            # stage 1 runs at twice stage 0's width: halve it so the output is dim
            d0 = max(dim // 2, 16)
            per_stage = max(depth // 2, 1)
            return SwinV2Encoder(d0, depths=(per_stage, per_stage),
                                 heads=(max(d0 // 32, 1), max(d0 // 16, 1)), window=window)
        if name == "swinir":
            return SwinIREncoder(dim, groups=max(depth // 2, 1), depth=2,
                                 heads=max(dim // 16, 1), window=window)
        if name == "scunet":
            return SCUNetEncoder(max(dim * 2 // 3, 32), out_dim=dim,
                                 blocks_per_stage=max(depth // 2, 1), window=window)
        if name == "swin_lite":
            return _SwinLiteEncoder(dim, depth, window)
        if name == "cbam":
            return _CBAMEncoder(dim)  # three stages: 1/8 resolution
        if name == "vit":
            return _ViTEncoder(dim, depth)
        raise ValueError(f"unknown XPoint backbone '{name}'")

    def regress_homography(self, feats0: torch.Tensor, feats1: torch.Tensor) -> torch.Tensor:
        """(B, 4, 2) offsets of the pair's NHWC backbone features."""
        if self.h_type is None:
            raise ValueError("XPoint was built without a homography head (homography_head)")
        if self.h_type == "pool":
            f = torch.cat([feats0.mean(dim=(1, 2)), feats1.mean(dim=(1, 2))], -1)
            return self.h_head(f).reshape(-1, 4, 2)
        return self.h_head(feats0, feats1)


__main_model__ = XPoint
__all__ = ["XPoint", "homography_head_type", "sincos_2d"]
