"""Attention ops for the matcher transformer (counterpart of
gluefactory_tpu/ops/attention.py:29-58 and :171-249), packed (B, N, H*Dh)
layout, boolean masks with True = valid token.

Semantics held by the attention kernel in csrc/lightglue_block.cu:
masked keys are excluded from the softmax, a query row that is invalid or
has no valid key gets a zero context (the out-projection bias still
reaches it downstream).
"""

from __future__ import annotations

from typing import Optional

import torch


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation of rotary embeddings: (x1, x2) -> (-x2, x1)."""
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], dim=-1).flatten(-2)


def apply_rotary(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t*cos + rotate_half(t)*sin; cos/sin broadcast against t."""
    return t * cos + rotate_half(t) * sin


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_q: Optional[torch.Tensor],
    mask_k: Optional[torch.Tensor],
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """Multi-head attention on packed (B, N, H*Dh) tensors, fp32 math.

    Returns the (B, Nq, H*Dh) context in fp32; rows that are invalid or see
    no valid key are zero."""
    b, nq, d = q.shape
    nk = k.shape[1]
    dh = d // num_heads
    to_h = lambda x, n: x.float().reshape(b, n, num_heads, dh).transpose(1, 2)
    sim = torch.einsum("bhid,bhjd->bhij", to_h(q, nq), to_h(k, nk)) * scale
    if mask_k is not None:
        sim = sim.masked_fill(~mask_k[:, None, None, :], float("-inf"))
    attn = torch.softmax(sim, dim=-1)
    if mask_k is not None:
        attn = torch.nan_to_num(attn, nan=0.0)  # rows with no valid key
    out = torch.einsum("bhij,bhjd->bhid", attn, to_h(v, nk))
    out = out.transpose(1, 2).reshape(b, nq, d)
    if mask_q is not None:
        out = out * mask_q[..., None]
    return out


__all__ = ["rotate_half", "apply_rotary", "masked_attention"]
