"""Torch layers with flax's semantics, shared by the models carried over from
flax trees (MultiPoint, XPoint's backbones, SuperPoint-MagicLeap): `Conv`
pads "SAME" as flax does (asymmetrically, (0, 1) for a 3 x 3 kernel at
stride 2 on an even side), `BatchNorm` is flax's (eps 1e-3, momentum 0.99, the
batch's biased variance in training),
and `top_k_stable` breaks ties as `jax.lax.top_k` does. Parameter names are
those `weights.params_from_jax` gives a flax leaf: kernel -> weight, scale
-> weight, mean / var -> running_mean / running_var.

For the extractors: `no_tf32()` runs a block's convolutions and products
in full fp32 on the card, `resize_jax` is `jax.image.resize`'s "bilinear"
(antialiased when it shrinks) and "cubic" (Keys, a = -0.5) as weight
matrices, and `gaussian_kernel1d` the sampled, normalised Gaussian."""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """(low, high) padding of one axis under flax's "SAME": (0, 1) for a
    3 x 3 kernel at stride 2 on an even side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """A flax `nn.Conv` on NCHW tensors: "SAME" (flax's asymmetric padding)
    or "VALID"."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: str = "SAME",
                 bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, bias=bias)
        self.same = padding == "SAME"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.same:
            return super().forward(x)
        k, s = self.kernel_size[0], self.stride[0]
        (top, bottom), (left, right) = (same_padding(n, k, s) for n in x.shape[-2:])
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, s, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, self.bias, s)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, is_training: bool,
               momentum: float, eps: float = 1e-3) -> torch.Tensor:
    """flax's `nn.BatchNorm` on an NCHW tensor. In training it normalises with
    the batch's mean and biased variance, E[x^2] - E[x]^2 clipped at 0 (flax's
    fast variance), both in fp32, and updates the running statistics in place
    as flax updates its `batch_stats`: r <- m r + (1 - m) stat, with no
    unbiased correction. Otherwise it normalises with the running statistics.
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias, flax's order. A caller
    that must not keep the update (a vetoed step, validation) restores the
    buffers (`train/step.py`). Across processes (a default process group of
    W > 1 ranks, each holding its slice of the global batch) E[x] and E[x^2]
    are the means over the ranks of the local ones, by an autograd-aware
    all-reduce: the global-batch moments of the JAX package's sharded jit,
    and every rank's running statistics the same. Every rank must then call
    it, as every rank runs the step."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if is_training:
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        mean, mean_sq = xf.mean(dims), (xf * xf).mean(dims)
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            from torch.distributed.nn.functional import all_reduce

            moments = all_reduce(torch.stack([mean, mean_sq])) / dist.get_world_size()
            mean, mean_sq = moments.unbind()
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean + (1 - momentum) * mean.detach())
            running_var.copy_(momentum * running_var + (1 - momentum) * var.detach())
    else:
        mean, var = running_mean, running_var
    mul = torch.rsqrt(var + eps) * scale
    y = (x - mean.reshape(shape)) * mul.reshape(shape) + bias.reshape(shape)
    return y.to(x.dtype)


class BatchNorm(nn.Module):
    """flax's `nn.BatchNorm` with its defaults (eps 1e-3 as the models set
    it, or `eps`; momentum 0.99) on NCHW tensors (`batch_norm`): weight /
    bias are flax's scale / bias, the running statistics its `batch_stats`
    mean / var."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, is_training: bool) -> torch.Tensor:
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          is_training, momentum=0.99, eps=self.eps)


def top_k_stable(scores: torch.Tensor, k: int):
    """(values, flat indices) of the k largest of each row, ties to the lower
    index (`jax.lax.top_k`'s order)."""
    values, index = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


def lecun_init(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded initialisation of every conv and linear layer of `module`:
    weights lecun-normal (N(0, 1 / fan_in), flax's default), biases zero."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan_in**-0.5)
                if m.bias is not None:
                    m.bias.zero_()


_TF32_LOCK = threading.Lock()
_TF32_DEPTH = [0, None]  # open blocks, the flags before the first


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions and cuBLAS products in fp32, not TF32, inside the
    block; the flags as they were afterwards. TF32 moves a blur by ~1e-3
    relative on the card, enough to reorder a top-k over DoG responses.
    Blocks may nest and overlap across threads (a loader thread extracting
    while the main thread trains): the flags come back when the last one
    ends."""
    with _TF32_LOCK:
        if _TF32_DEPTH[0] == 0:
            _TF32_DEPTH[1] = (torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _TF32_DEPTH[0] += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_DEPTH[0] -= 1
            if _TF32_DEPTH[0] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _TF32_DEPTH[1]


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """The normalised Gaussian on [-radius, radius], computed in float64 and
    rounded to float32."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x):
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)


def resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_out, n_in) float32 weights of `jax.image.resize` along one axis
    (`compute_weight_mat` with antialias, in float32 as JAX computes it)."""
    kernel = {"bilinear": _triangle, "cubic": _keys_cubic}[method]
    scale = np.float32(n_out / n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x.astype(np.float32))
    total = w.sum(0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32).T


def resize_jax(x: torch.Tensor, size: tuple, method: str = "bilinear") -> torch.Tensor:
    """`jax.image.resize` of the last two axes of `x` to `size` (h, w):
    "bilinear" (a triangle filter widened when it shrinks, half-pixel
    centres) or "cubic" (Keys, a = -0.5), as two products with the axes'
    weight matrices. An axis whose size does not change is left as it is."""
    h, w = size
    if x.shape[-2] != h:
        wh = torch.from_numpy(resize_weights(x.shape[-2], h, method)).to(x.device, x.dtype)
        x = torch.matmul(wh, x)
    if x.shape[-1] != w:
        ww = torch.from_numpy(resize_weights(x.shape[-1], w, method)).to(x.device, x.dtype)
        x = torch.matmul(x, ww.T)
    return x


__all__ = ["same_padding", "Conv", "conv_nhwc", "batch_norm", "BatchNorm", "top_k_stable",
           "lecun_init", "no_tf32", "gaussian_kernel1d", "resize_weights", "resize_jax"]
