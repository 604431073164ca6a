"""DINOv2 ViT backbone (counterpart of
gluefactory_tpu/models/backbones/dinov2.py): a p x p patch embedding, the
cls token, learned position embeddings on a fixed `pos_grid` resized to the
runtime grid by `jax.image.resize`'s cubic (Keys, a = -0.5; torch's bicubic
is a = -0.75), pre-norm blocks (LayerNorm eps 1e-6, exact GELU) with
LayerScale, a final LayerNorm. An image whose sides are not multiples of
the patch is first resized down to them (`allow_resize`, the antialiased
bilinear). Products are `torch.matmul` in fp32 (`no_tf32`). Outputs:
features (B, Hp, Wp, D), global_descriptor (B, D) (the cls token).
Parameters carry the flax names (`block_0.q.weight`, `pos_embed`, ...)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..base_model import BaseModel, finish_init
from ..utils.layers import Conv, lecun_init, no_tf32, resize_jax


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.q, self.k, self.v = nn.Linear(dim, dim), nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.ls1 = nn.Parameter(torch.full((dim,), 1e-5))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, mlp_ratio * dim)
        self.fc2 = nn.Linear(mlp_ratio * dim, dim)
        self.ls2 = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        b, n, d = x.shape
        dh = d // self.heads
        y = self.norm1(x)
        split = lambda t: t.reshape(b, n, self.heads, dh).transpose(1, 2)
        q, k, v = split(self.q(y)), split(self.k(y)), split(self.v(y))
        att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / dh**0.5, dim=-1)
        ctx = torch.matmul(att, v).transpose(1, 2).reshape(b, n, d)
        x = x + self.proj(ctx) * self.ls1
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + y * self.ls2


class DinoV2(BaseModel):
    default_conf = {
        "name": "dinov2",
        "weights": None,  # the JAX package's converted .npz
        "patch_size": 14,
        "embed_dim": 384,  # ViT-S/14
        "depth": 12,
        "num_heads": 6,
        "pos_grid": 37,  # the official checkpoints' native grid (518 / 14)
        "allow_resize": True,
        "trainable": False,
    }
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        conf = self.conf
        d, g = conf.embed_dim, int(conf.pos_grid)
        self.patch_embed = Conv(3, d, conf.patch_size, stride=conf.patch_size)
        for i in range(conf.depth):
            setattr(self, f"block_{i}", _Block(d, conf.num_heads))
        self.norm = nn.LayerNorm(d, eps=1e-6)
        gen = torch.Generator().manual_seed(0)
        lecun_init(self, gen)
        self.cls_token = nn.Parameter(torch.randn((1, 1, d), generator=gen) * 0.02)
        self.pos_embed = nn.Parameter(torch.randn((1, g * g + 1, d), generator=gen) * 0.02)
        finish_init(self)

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        with no_tf32():
            return self._forward(data)

    def _forward(self, data):
        conf = self.conf
        img = data["image"].float()
        if img.shape[-1] == 1:
            img = img.repeat(1, 1, 1, 3)
        b, h, w, _ = img.shape
        p = conf.patch_size
        x = img.permute(0, 3, 1, 2)
        if conf.allow_resize and (h % p or w % p):
            x = resize_jax(x, (max((h // p) * p, p), max((w // p) * p, p)))
        d = conf.embed_dim
        x = self.patch_embed(x)  # (B, D, Hp, Wp)
        hp, wp = x.shape[2:]
        tokens = x.flatten(2).transpose(1, 2)
        g = int(conf.pos_grid)
        pos = self.pos_embed
        if (hp, wp) != (g, g):
            patch_pos = pos[:, 1:].reshape(1, g, g, d).permute(0, 3, 1, 2)
            patch_pos = resize_jax(patch_pos, (hp, wp), "cubic")
            pos = torch.cat([pos[:, :1], patch_pos.flatten(2).transpose(1, 2)], 1)
        tokens = torch.cat([self.cls_token.expand(b, 1, d), tokens], 1) + pos
        for i in range(conf.depth):
            tokens = getattr(self, f"block_{i}")(tokens)
        tokens = self.norm(tokens)
        return {"features": tokens[:, 1:].reshape(b, hp, wp, d), "global_descriptor": tokens[:, 0]}


__main_model__ = DinoV2
