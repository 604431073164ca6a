"""Attention ops for the matcher transformer (counterpart of
gluefactory_tpu/ops/attention.py), packed (B, N, H*Dh) layout, boolean
masks with True = valid token.

These are the plain, differentiable PyTorch versions: of the attention
inside the block kernels (csrc/lightglue_block.cu) and of the training
attention kernels (csrc/attention.cu, wrapped in ops/fused_attention.py).
Semantics, those of the JAX package's `_sdpa` (:43-58): masked keys are
excluded from the softmax and get weight exactly 0; a query row that is
invalid or has no valid key gets an exact zero context and a zero gradient
(the out-projection bias still reaches it downstream).
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


def _to_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.float().reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def _to_packed(x: torch.Tensor) -> torch.Tensor:
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def masked_softmax(sim: torch.Tensor, pair: Optional[torch.Tensor], dim: int) -> torch.Tensor:
    """Softmax of `sim` along `dim` over the entries where `pair` is True;
    the others, and whole lines without a valid entry, are exactly 0. The
    fill is finite so that such lines give zero gradients, not NaN."""
    if pair is None:
        return torch.softmax(sim, dim=dim)
    attn = torch.softmax(sim.masked_fill(~pair, torch.finfo(sim.dtype).min), dim=dim)
    return attn * pair


def _pair_mask(mask_q, mask_k, b, nq, nk, device):
    if mask_q is None and mask_k is None:
        return None
    mq = torch.ones((b, nq), dtype=torch.bool, device=device) if mask_q is None else mask_q
    mk = torch.ones((b, nk), dtype=torch.bool, device=device) if mask_k is None else mask_k
    return mq[:, None, :, None] & mk[:, None, None, :]


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
    b, nq, _ = q.shape
    nk = k.shape[1]
    sim = torch.einsum("bhid,bhjd->bhij", _to_heads(q, num_heads), _to_heads(k, num_heads))
    pair = _pair_mask(mask_q, mask_k, b, nq, nk, q.device)
    attn = masked_softmax(sim * scale, pair, dim=-1)
    return _to_packed(torch.einsum("bhij,bhjd->bhid", attn, _to_heads(v, num_heads)))


def self_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    num_heads: int = 4,
) -> torch.Tensor:
    """Multi-head attention over one keypoint set, (B, N, H*Dh) in and out;
    scale Dh**-0.5 (gluefactory_tpu/ops/attention.py:171)."""
    scale = (q.shape[-1] // num_heads) ** -0.5
    return masked_attention(q, k, v, mask, mask, num_heads, scale).to(v.dtype)


def cross_attention_bidirectional_packed(
    qk0: torch.Tensor,
    qk1: torch.Tensor,
    v0: torch.Tensor,
    v1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    num_heads: int = 4,
):
    """Both cross directions from one similarity (the projection is shared,
    so sim(1->0) = sim(0->1)^T): the row softmax gives the messages into set
    0, the column softmax those into set 1. The scale Dh**-0.5 is split as
    Dh**-0.25 a side (gluefactory_tpu/ops/attention.py:128). Returns
    (m0 (B, M, D), m1 (B, N, D))."""
    b, m, d = qk0.shape
    n = qk1.shape[1]
    s = (d // num_heads) ** -0.25
    sim = torch.einsum(
        "bhid,bhjd->bhij", _to_heads(qk0, num_heads) * s, _to_heads(qk1, num_heads) * s)
    pair = _pair_mask(mask0, mask1, b, m, n, qk0.device)  # a missing mask is all valid
    attn01 = masked_softmax(sim, pair, dim=-1)
    attn10 = masked_softmax(sim, pair, dim=-2)
    m0 = torch.einsum("bhij,bhjd->bhid", attn01, _to_heads(v1, num_heads))
    m1 = torch.einsum("bhij,bhid->bhjd", attn10, _to_heads(v0, num_heads))
    return _to_packed(m0).to(v1.dtype), _to_packed(m1).to(v0.dtype)


def cross_attention_bidirectional_stacked(
    qk: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    num_heads: int = 4,
):
    """`cross_attention_bidirectional_packed` with both sets stacked on the
    batch axis: pair i is rows i and i + B of the (2B, N, D) tensors.
    Returns (m0, m1), each (B, N, D)."""
    b = qk.shape[0] // 2
    mask0 = None if mask is None else mask[:b]
    mask1 = None if mask is None else mask[b:]
    return cross_attention_bidirectional_packed(
        qk[:b], qk[b:], v[:b], v[b:], mask0, mask1, num_heads=num_heads)


def attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask_q: Optional[torch.Tensor],
    mask_k: Optional[torch.Tensor],
    dout: torch.Tensor,
    num_heads: int,
    scale: float,
):
    """The attention backward written out (the formula of
    `_attention_bwd_kernel`, gluefactory_tpu/ops/pallas_attention.py:143),
    the plain version of the backward kernel: p is recomputed, then
    dv = p^T do, dp = do v^T, ds = p (dp - rowsum(p dp)) scale, dq = ds k,
    dk = ds^T q. Returns (dq, dk, dv) in the inputs' types."""
    b, nq, _ = q.shape
    nk = k.shape[1]
    qh, kh, vh = (_to_heads(t, num_heads) for t in (q, k, v))
    doh = _to_heads(dout, num_heads)
    sim = torch.einsum("bhid,bhjd->bhij", qh, kh) * scale
    p = masked_softmax(sim, _pair_mask(mask_q, mask_k, b, nq, nk, q.device), dim=-1)
    dv = torch.einsum("bhij,bhid->bhjd", p, doh)
    dp = torch.einsum("bhid,bhjd->bhij", doh, vh)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhij,bhjd->bhid", ds, kh)
    dk = torch.einsum("bhij,bhid->bhjd", ds, qh)
    return _to_packed(dq).to(q.dtype), _to_packed(dk).to(k.dtype), _to_packed(dv).to(v.dtype)


__all__ = [
    "rotate_half", "apply_rotary", "masked_softmax", "masked_attention",
    "self_attention_packed", "cross_attention_bidirectional_packed",
    "cross_attention_bidirectional_stacked", "attention_backward",
]
