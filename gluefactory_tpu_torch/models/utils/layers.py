"""Torch layers with flax's semantics, shared by the models carried over from
flax trees (MultiPoint, XPoint's backbones, SuperPoint-MagicLeap): `Conv`
pads "SAME" as flax does (asymmetrically, (0, 1) for a 3 x 3 kernel at
stride 2 on an even side), `BatchNorm` is flax's (eps 1e-3, momentum 0.99, the
batch's biased variance in training),
and `top_k_stable` breaks ties as `jax.lax.top_k` does. Parameter names are
those `weights.params_from_jax` gives a flax leaf: kernel -> weight, scale
-> weight, mean / var -> running_mean / running_var."""

from __future__ import annotations

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
    it, momentum 0.99) on NCHW tensors (`batch_norm`): weight / bias are
    flax's scale / bias, the running statistics its `batch_stats` mean /
    var."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, is_training: bool) -> torch.Tensor:
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          is_training, momentum=0.99)


def top_k_stable(scores: torch.Tensor, k: int):
    """(values, flat indices) of the k largest of each row, ties to the lower
    index (`jax.lax.top_k`'s order)."""
    values, index = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


__all__ = ["same_padding", "Conv", "conv_nhwc", "batch_norm", "BatchNorm", "top_k_stable"]
