"""Fused LightGlue log assignment: the plain PyTorch version, the wrapper of
its CUDA kernels (csrc/log_assignment.cu: sim once on the tensor cores at
fp32 accuracy, then a coalesced finish pass), and match filtering from the
row/column statistics.

Counterpart of `fused_log_assignment` and `filter_matches_from_stats` in
gluefactory_tpu/ops/pallas_assignment.py:271-323. Inputs are the projected
descriptors already scaled by d**-0.25 (fp32) and the matchability logits.
Outputs: the (B, M+1, N+1) log assignment, equal to
ops.assignment.sigmoid_log_double_softmax, and (rowmax, rowarg, colmax,
colarg) of its inner (M, N) block, argmax ties resolved to the first index.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _ext
from .assignment import _NEG_INF, _first_max, matches_from_argmax


def _masks(mask0, mask1, b, m, n, device):
    ones = lambda k: torch.ones((b, k), dtype=torch.bool, device=device)
    return (ones(m) if mask0 is None else mask0.bool(),
            ones(n) if mask1 is None else mask1.bool())


def _masked_lse(sim, pair, dim):
    x = torch.where(pair, sim, torch.full_like(sim, _NEG_INF))
    mx = torch.clamp(torch.amax(x, dim=dim, keepdim=True), min=_NEG_INF)
    e = torch.where(pair, torch.exp(x - mx), torch.zeros_like(x))
    return (torch.log(torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-30)) + mx).squeeze(dim)


def log_assignment(
    mdesc0: torch.Tensor,
    mdesc1: torch.Tensor,
    z0: torch.Tensor,
    z1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
):
    """Plain version: scores (B, M+1, N+1) and (rowmax, rowarg, colmax,
    colarg) with int32 arguments."""
    b, m, _ = mdesc0.shape
    n = mdesc1.shape[1]
    mask0, mask1 = _masks(mask0, mask1, b, m, n, mdesc0.device)
    sim = torch.einsum("bmd,bnd->bmn", mdesc0.float(), mdesc1.float())
    pair = mask0[:, :, None] & mask1[:, None, :]
    lse0 = _masked_lse(sim, pair, 2)
    lse1 = _masked_lse(sim, pair, 1)
    c0 = F.logsigmoid(z0.float()) - lse0
    c1 = F.logsigmoid(z1.float()) - lse1
    inner = 2.0 * sim + (c0[:, :, None] + c1[:, None, :])
    inner = torch.where(pair, inner, torch.full_like(inner, _NEG_INF))

    neg = lambda t: torch.full_like(t, _NEG_INF)
    bin0 = F.logsigmoid(-z0.float())
    bin1 = F.logsigmoid(-z1.float())
    scores = sim.new_zeros((b, m + 1, n + 1))
    scores[:, :m, :n] = inner
    scores[:, :m, n] = torch.where(mask0, bin0, neg(bin0))
    scores[:, m, :n] = torch.where(mask1, bin1, neg(bin1))
    rowmax, rowarg = _first_max(inner, dim=2)
    colmax, colarg = _first_max(inner, dim=1)
    return scores, rowmax, rowarg.int(), colmax, colarg.int()


def filter_matches_from_stats(rowmax, rowarg, colmax, colarg, th: float):
    """ops.assignment.filter_matches from the per-row/column statistics,
    without re-reading the (M+1, N+1) matrix."""
    return matches_from_argmax(rowmax, rowarg.long(), colarg.long(), th)


def launch_log_assignment(lib, stream, mdesc0, mdesc1, z0, z1, mask0, mask1):
    """One call of the kernels: the product with the tiles' log-sum-exp
    partials, their merge, the finish pass, the argmax merge."""
    b, m, d = mdesc0.shape
    n = mdesc1.shape[1]
    f32 = dict(dtype=torch.float32, device=mdesc0.device)
    scores = torch.empty((b, m + 1, n + 1), **f32)
    rowmax, colmax = torch.empty((b, m), **f32), torch.empty((b, n), **f32)
    rowarg = torch.empty((b, m), dtype=torch.int32, device=mdesc0.device)
    colarg = torch.empty((b, n), dtype=torch.int32, device=mdesc0.device)
    # per-tile partials of every row and column (64 x 64 tiles) and the
    # certainties: the layout of `Scratch` in csrc/log_assignment.cu
    row_tiles, col_tiles = -(-m // 64), -(-n // 64)
    scratch = torch.empty(b * (2 * col_tiles * m + 2 * row_tiles * n + m + n), **f32)
    p = lambda t: None if t is None else t.data_ptr()
    _ext.check(lib.la_log_assignment(p(mdesc0), p(mdesc1), p(z0), p(z1), p(mask0), p(mask1),
                                     p(scores), p(rowmax), p(rowarg), p(colmax), p(colarg),
                                     p(scratch), b, m, n, d, stream), "la_log_assignment")
    return scores, rowmax, rowarg, colmax, colarg


def fused_log_assignment(mdesc0, mdesc1, z0, z1, mask0=None, mask1=None):
    """`log_assignment` on the CPU; the CUDA kernels on the card."""
    if mdesc0.device.type == "cpu":
        return log_assignment(mdesc0, mdesc1, z0, z1, mask0, mask1)
    b, m, d = mdesc0.shape
    n = mdesc1.shape[1]
    shapes = ((mdesc0, (b, m, d)), (mdesc1, (b, n, d)), (z0, (b, m)), (z1, (b, n)))
    for t, shape in shapes:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != mdesc0.device:
            raise ValueError("fused_log_assignment: inputs must be contiguous float32 on one device")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_log_assignment: expected shape {shape}, got {tuple(t.shape)}")
    if d % 32:
        raise ValueError("fused_log_assignment: D must be a multiple of 32")
    masks = []
    for mk, k in ((mask0, m), (mask1, n)):
        if mk is not None and (mk.dtype != torch.bool or tuple(mk.shape) != (b, k)
                               or mk.device != mdesc0.device):
            raise ValueError(f"fused_log_assignment: masks must be bool ({b}, {k})")
        masks.append(None if mk is None else mk.contiguous())
    # the kernels copy rows in 16-byte pieces (cp.async)
    mdesc0, mdesc1 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (mdesc0, mdesc1))
    lib = _ext.load("log_assignment")
    out = launch_log_assignment(lib, torch.cuda.current_stream(mdesc0.device).cuda_stream,
                                mdesc0, mdesc1, z0, z1, *masks)
    fused_log_assignment.launches += 1
    return out


fused_log_assignment.launches = 0

__all__ = ["log_assignment", "filter_matches_from_stats", "fused_log_assignment"]
