"""Match assignment ops: sigmoid log double-softmax and match filtering
(counterpart of gluefactory_tpu/ops/assignment.py:18-91).

Padded keypoints (mask False) never receive or emit probability mass: they
get `_NEG_INF` everywhere, their dustbin entry included. These functions are
the plain version that the fused log-assignment kernel
(ops/log_assignment.py) is held against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_NEG_INF = -1e9  # finite: keeps softmax/log well-defined on padded rows


def masked_log_softmax(
    x: torch.Tensor, mask: Optional[torch.Tensor], dim: int
) -> torch.Tensor:
    """log_softmax that excludes masked entries and stays finite on empty rows."""
    if mask is None:
        return torch.log_softmax(x, dim=dim)
    x = torch.where(mask, x, torch.full_like(x, _NEG_INF))
    m = torch.amax(x, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(x - m), torch.zeros_like(x))
    lse = torch.log(torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-30)) + m
    return torch.where(mask, x - lse, torch.full_like(x, _NEG_INF))


def sigmoid_log_double_softmax(
    sim: torch.Tensor,
    z0: torch.Tensor,
    z1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Log assignment (B, M+1, N+1) from sim (B, M, N) and matchability
    logits z0 (B, M, 1), z1 (B, N, 1)."""
    b, m, n = sim.shape
    pair = None
    if mask0 is not None and mask1 is not None:
        pair = mask0[:, :, None] & mask1[:, None, :]
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)
    scores0 = masked_log_softmax(sim, pair, dim=2)
    scores1 = masked_log_softmax(sim, pair, dim=1)
    inner = scores0 + scores1 + certainties
    if pair is not None:
        inner = torch.where(pair, inner, torch.full_like(inner, _NEG_INF))

    scores = sim.new_zeros((b, m + 1, n + 1))
    scores[:, :m, :n] = inner
    bin0 = F.logsigmoid(-z0[..., 0])
    bin1 = F.logsigmoid(-z1[..., 0])
    if mask0 is not None:
        bin0 = torch.where(mask0, bin0, torch.full_like(bin0, _NEG_INF))
    if mask1 is not None:
        bin1 = torch.where(mask1, bin1, torch.full_like(bin1, _NEG_INF))
    scores[:, :-1, -1] = bin0
    scores[:, -1, :-1] = bin1
    return scores


def matches_from_argmax(
    max0: torch.Tensor, m0: torch.Tensor, m1: torch.Tensor, th: float
) -> Tuple[torch.Tensor, ...]:
    """Mutual nearest neighbours above `th` from the row max/argmax and the
    column argmax of a log assignment. Returns (m0, m1, mscores0, mscores1);
    unmatched entries are -1."""
    indices0 = torch.arange(m0.shape[1], device=m0.device)[None]
    indices1 = torch.arange(m1.shape[1], device=m1.device)[None]
    mutual0 = indices0 == torch.gather(m1, 1, m0)
    mutual1 = indices1 == torch.gather(m0, 1, m1)
    mscores0 = torch.where(mutual0, torch.exp(max0), torch.zeros_like(max0))
    mscores1 = torch.gather(mscores0, 1, m1)
    mscores1 = torch.where(mutual1, mscores1, torch.zeros_like(mscores1))
    valid0 = mutual0 & (mscores0 > th)
    valid1 = mutual1 & torch.gather(valid0, 1, m1)
    m0 = torch.where(valid0, m0, torch.full_like(m0, -1)).to(torch.int32)
    m1 = torch.where(valid1, m1, torch.full_like(m1, -1)).to(torch.int32)
    return m0, m1, mscores0, mscores1


def filter_matches(scores: torch.Tensor, th: float) -> Tuple[torch.Tensor, ...]:
    """Mutual-argmax + threshold matches from a log assignment (B, M+1, N+1).
    Argmax ties resolve to the first index, like `jnp.argmax`."""
    inner = scores[:, :-1, :-1]
    max0, m0 = _first_max(inner, dim=2)
    _, m1 = _first_max(inner, dim=1)
    return matches_from_argmax(max0, m0, m1, th)


def _first_max(x: torch.Tensor, dim: int):
    """(max, first index of the max) along `dim`."""
    mx = torch.amax(x, dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    ids = torch.arange(n, device=x.device).view(shape)
    arg = torch.where(x >= mx, ids, torch.full_like(ids, n)).amin(dim=dim)
    return mx.squeeze(dim), arg


__all__ = [
    "masked_log_softmax",
    "sigmoid_log_double_softmax",
    "filter_matches",
    "matches_from_argmax",
]
