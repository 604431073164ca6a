"""XPoint's attention backbones (counterpart of
gluefactory_tpu/multipoint/models/backbones.py), on NHWC tensors:

  - `SwinV2Encoder`: cosine window attention with a learnable per-head
    logit scale clamped at log 100, the log-spaced continuous relative
    position bias (an MLP 2 -> 512 -> heads, 16 sigmoid), res-post-norm
    blocks, shifted windows with the boundary masks, `PatchMerging`;
  - `SwinIREncoder`: V1 window attention with a learned relative-position
    table, RSTB groups, the stride-2 "SAME" stem (flax pads (0, 1) on an
    even side);
  - `SCUNetEncoder`: blocks that split the channels into a conv branch and
    a Swin branch, 2 x 2 stride-2 "VALID" downsampling.

Each maps a (B, 1, H, W) image to (B, out_dim, H/8, W/8) features, NCHW
at the boundary as MultiPoint's VGG encoder, NHWC inside. flax's defaults
are kept: LayerNorm eps 1e-6 and the tanh GELU. Module and parameter names
follow the flax tree (`weights.params_from_jax` maps it). A map narrower
than the window runs the window cut to the map, as in the JAX blocks; the
V1 table then has the size a flax tree initialised on that map gives it
(`WindowAttentionV1`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models.utils.layers import Conv, conv_nhwc


def gelu(x):
    return F.gelu(x, approximate="tanh")


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


def window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_merge(windows, ws: int, h: int, w: int):
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def _relative_position_index(ws: int) -> np.ndarray:
    """(N, N) index into the (2ws-1)^2 table of relative offsets."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _log_coords_table(ws: int) -> np.ndarray:
    """((2ws-1)^2, 2) log-spaced relative coordinates, the log-CPB input."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    table = table / max(ws - 1, 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2)


@functools.lru_cache(maxsize=None)
def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask between the wrapped sub-windows of a
    cyclically shifted partition."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, h - ws), slice(h - ws, h - shift), slice(h - shift, h)):
        for vs in (slice(0, w - ws), slice(w - ws, w - shift), slice(w - shift, w)):
            img[hs, vs] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


_ON_DEVICE: dict = {}


def on_device(fn, device, *args) -> torch.Tensor:
    """The numpy table `fn(*args)` as a tensor on `device` (floats as float32,
    as `jnp.asarray` makes them), made once."""
    key = (fn.__name__, str(device), *args)
    if key not in _ON_DEVICE:
        table = fn(*args)
        if table.dtype.kind == "f":
            table = table.astype(np.float32)
        _ON_DEVICE[key] = torch.tensor(table, device=device)  # a copy of the cached array
    return _ON_DEVICE[key]


def split_heads(t, heads):
    nw, n, dim = t.shape
    return t.reshape(nw, n, heads, dim // heads).transpose(1, 2)


def _attend(attn, v, mask, proj):
    """Add the shift mask, softmax, weigh v, project: (nW, N, dim)."""
    nw, heads, n, _ = attn.shape
    if mask is not None:
        nm = mask.shape[0]
        attn = (attn.reshape(nw // nm, nm, heads, n, n) + mask[None, :, None]).reshape(
            nw, heads, n, n)
    out = torch.softmax(attn, dim=-1) @ v
    return proj(out.transpose(1, 2).reshape(nw, n, -1))


class WindowAttentionV2(nn.Module):
    """SwinV2 cosine window attention with the log-CPB bias."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        # fused qkv without bias (the flax param, (in, 3 dim)); q and v biases
        self.qkv = nn.Parameter(torch.randn(dim, 3 * dim) * dim**-0.5)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.full((heads, 1, 1), float(np.log(10.0))))
        self.cpb_fc1 = nn.Linear(2, 512)
        self.cpb_fc2 = nn.Linear(512, heads, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, ws: int, mask=None):
        nw, n, _ = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        q, k, v = (split_heads(t, self.heads) for t in (x @ self.qkv + bias).chunk(3, dim=-1))
        q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        k = k / k.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        scale = torch.exp(self.logit_scale.clamp(max=float(np.log(100.0))))
        attn = (q @ k.transpose(-2, -1)) * scale
        table = on_device(_log_coords_table, x.device, ws)
        bias_table = self.cpb_fc2(F.relu(self.cpb_fc1(table)))  # (T, heads)
        idx = on_device(_relative_position_index, x.device, ws).reshape(-1)
        rel_bias = bias_table[idx].reshape(n, n, self.heads).permute(2, 0, 1)
        attn = attn + 16.0 * torch.sigmoid(rel_bias)[None]
        return _attend(attn, v, mask, self.proj)


def _effective_window(h: int, w: int, window: int, shift: int):
    """A window no smaller than the map is the whole map, without a shift."""
    if min(h, w) <= window:
        return min(h, w), 0
    return window, shift


def _shifted_attention(x, attn, window, shift):
    b, h, w, c = x.shape
    ws, shift = _effective_window(h, w, window, shift)
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    mask = on_device(_shift_mask, x.device, h, w, ws, shift) if shift else None
    x = window_merge(attn(window_partition(x, ws), ws, mask), ws, h, w)
    if shift:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x


class SwinV2Block(nn.Module):
    """Res-post-norm Swin block: x + norm(attn(x)), then x + norm(mlp(x))."""

    def __init__(self, dim: int, heads: int, window: int, shift: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.attn = WindowAttentionV2(dim, heads)
        self.norm1 = layer_norm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.norm2 = layer_norm(dim)

    def forward(self, x):
        x = x + self.norm1(_shifted_attention(x, self.attn, self.window, self.shift))
        return x + self.norm2(self.mlp_fc2(gelu(self.mlp_fc1(x))))


class PatchMerging(nn.Module):
    """2 x 2 neighbourhood concat (dy, dx, c order) -> linear to out_dim ->
    LayerNorm."""

    def __init__(self, cin: int, out_dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * cin, out_dim, bias=False)
        self.norm = layer_norm(out_dim)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.norm(self.reduction(x.reshape(b, h // 2, w // 2, 4 * c)))


class SwinV2Encoder(nn.Module):
    """Stride-4 patch embedding, stage 0 at 1/4, PatchMerging, stage 1 at 1/8."""

    def __init__(self, dim: int = 96, depths=(2, 2), heads=(3, 6), window: int = 8,
                 cin: int = 1):
        super().__init__()
        self.patch_embed = Conv(cin, dim, 4, stride=4, padding="VALID")
        self.patch_norm = layer_norm(dim)
        self.depths = depths
        for s, d in enumerate((dim, 2 * dim)):
            for i in range(depths[s]):
                self.add_module(f"stage{s}_block{i}", SwinV2Block(
                    d, heads[s], window, shift=0 if i % 2 == 0 else window // 2))
            if s == 0:
                self.merge = PatchMerging(dim, 2 * dim)
        self.norm_out = layer_norm(2 * dim)
        self.out_dim = 2 * dim

    def forward(self, x, is_training: bool = False):
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        for s in range(2):
            for i in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{i}")(x)
            if s == 0:
                x = self.merge(x)
        return self.norm_out(x).permute(0, 3, 1, 2)


class WindowAttentionV1(nn.Module):
    """Swin V1 window attention: scaled dot product + a learned
    relative-position bias table of (2 ws - 1)^2 rows.

    The JAX block cuts the window to a map narrower than it and declares the
    table for the window the map gives when the model is initialised, so a
    flax tree initialised on a small map holds a smaller table. Loading a
    state dict takes the table's shape from it; the forward then runs the
    window that table was made for and refuses any other, as flax refuses a
    parameter whose declared shape differs from the stored one."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.randn((2 * window - 1) ** 2, heads) * 0.02)
        self.proj = nn.Linear(dim, dim)

    @property
    def window(self) -> int:
        return (math.isqrt(self.relative_position_bias_table.shape[0]) + 1) // 2

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        table = state_dict.get(prefix + "relative_position_bias_table")
        own = self.relative_position_bias_table
        if table is not None and table.shape != own.shape and table.dim() == 2 \
                and table.shape[1] == own.shape[1] \
                and math.isqrt(table.shape[0]) ** 2 == table.shape[0]:
            self.relative_position_bias_table = nn.Parameter(
                own.new_empty(table.shape), requires_grad=own.requires_grad)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, ws: int, mask=None):
        nw, n, c = x.shape
        if ws != self.window:
            raise ValueError(
                f"the map gives a {ws}-wide window, but the relative-position table was made "
                f"for a {self.window}-wide one: the JAX model declares the table at "
                "initialisation for the map it sees then, and flax refuses it on a map that "
                "gives another window (initialise on a map of this size)")
        q, k, v = (split_heads(t, self.heads) for t in self.qkv(x).chunk(3, dim=-1))
        attn = (q @ k.transpose(-2, -1)) * (c // self.heads) ** -0.5
        idx = on_device(_relative_position_index, x.device, ws).reshape(-1)
        rel_bias = self.relative_position_bias_table[idx].reshape(n, n, self.heads)
        return _attend(attn + rel_bias.permute(2, 0, 1)[None], v, mask, self.proj)


class SwinV1Block(nn.Module):
    """Pre-norm Swin block: x + attn(norm(x)), then x + mlp(norm(x))."""

    def __init__(self, dim: int, heads: int, window: int, shift: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttentionV1(dim, heads, window)
        self.norm2 = layer_norm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x + _shifted_attention(self.norm1(x), self.attn, self.window, self.shift)
        return x + self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))


class RSTB(nn.Module):
    """Residual Swin transformer group: V1 blocks, a 3 x 3 conv, the group
    residual."""

    def __init__(self, dim: int, depth: int, heads: int, window: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", SwinV1Block(
                dim, heads, window, shift=0 if i % 2 == 0 else window // 2))
        self.conv = Conv(dim, dim, 3)

    def forward(self, x):
        res = x
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return conv_nhwc(self.conv, x) + res


class SwinIREncoder(nn.Module):
    """Stride-8 stem of three stride-2 convs, RSTB groups, a conv after the
    body and the global residual."""

    def __init__(self, dim: int = 96, groups: int = 2, depth: int = 2, heads: int = 6,
                 window: int = 8, cin: int = 1):
        super().__init__()
        self.conv_first = Conv(cin, dim // 2, 3, stride=2)
        self.down1 = Conv(dim // 2, dim, 3, stride=2)
        self.down2 = Conv(dim, dim, 3, stride=2)
        self.groups = groups
        for g in range(groups):
            self.add_module(f"rstb{g}", RSTB(dim, depth, heads, window))
        self.conv_after_body = Conv(dim, dim, 3)
        self.out_dim = dim

    def forward(self, x, is_training: bool = False):
        x = self.down2(gelu(self.down1(gelu(self.conv_first(x))))).permute(0, 2, 3, 1)
        shallow = x
        for g in range(self.groups):
            x = getattr(self, f"rstb{g}")(x)
        return (conv_nhwc(self.conv_after_body, x) + shallow).permute(0, 3, 1, 2)


class ConvTransBlock(nn.Module):
    """SCUNet block: a 1 x 1 conv, the channels split into a residual double
    conv and a Swin (W or SW) block, rejoined by a 1 x 1 conv, residual."""

    def __init__(self, conv_dim: int, trans_dim: int, head_dim: int = 32, window: int = 8,
                 swin_type: str = "W"):
        super().__init__()
        full = conv_dim + trans_dim
        self.conv_dim = conv_dim
        self.conv1_1 = Conv(full, full, 1)
        self.cb1 = Conv(conv_dim, conv_dim, 3)
        self.cb2 = Conv(conv_dim, conv_dim, 3)
        self.trans = SwinV1Block(trans_dim, max(trans_dim // head_dim, 1), window,
                                 shift=0 if swin_type == "W" else window // 2)
        self.conv1_2 = Conv(full, full, 1)

    def forward(self, x):
        y = self.conv1_1(x.permute(0, 3, 1, 2))
        cx, tx = y[:, :self.conv_dim], y[:, self.conv_dim:]
        cx = cx + self.cb2(F.relu(self.cb1(cx)))
        tx = self.trans(tx.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + self.conv1_2(torch.cat([cx, tx], dim=1)).permute(0, 2, 3, 1)


class SCUNetEncoder(nn.Module):
    """SCUNet's downsampling half: a head conv, three stages of
    ConvTransBlocks each ending in a 2 x 2 stride-2 conv, a 1 x 1 projection."""

    def __init__(self, dim: int = 64, out_dim: int = 96, blocks_per_stage: int = 2,
                 window: int = 8, cin: int = 1):
        super().__init__()
        self.head = Conv(cin, dim, 3)
        self.blocks_per_stage = blocks_per_stage
        d = dim
        for stage in range(3):
            for i in range(blocks_per_stage):
                self.add_module(f"stage{stage}_block{i}", ConvTransBlock(
                    d // 2, d - d // 2, window=window, swin_type="W" if i % 2 == 0 else "SW"))
            d_next = min(d * 2, 4 * dim)
            self.add_module(f"down{stage}", Conv(d, d_next, 2, stride=2, padding="VALID"))
            d = d_next
        self.proj = Conv(d, out_dim, 1)
        self.out_dim = out_dim

    def forward(self, x, is_training: bool = False):
        x = self.head(x).permute(0, 2, 3, 1)
        for stage in range(3):
            for i in range(self.blocks_per_stage):
                x = getattr(self, f"stage{stage}_block{i}")(x)
            x = conv_nhwc(getattr(self, f"down{stage}"), x)
        return self.proj(x.permute(0, 3, 1, 2))


__all__ = [
    "SwinV2Encoder", "SwinIREncoder", "SCUNetEncoder",
    "SwinV2Block", "SwinV1Block", "WindowAttentionV2", "WindowAttentionV1",
    "PatchMerging", "RSTB", "ConvTransBlock", "window_partition", "window_merge",
]
