"""Attention ops for the matcher transformers (counterpart of
gluefactory_tpu/ops/attention.py), boolean masks with True = valid token.

The `*_heads` and `*_packed` / `*_stacked` functions are the plain,
differentiable PyTorch versions: of the attention inside the block kernels
(csrc/lightglue_block.cu) and of the attention kernels (csrc/attention.cu,
wrapped in ops/fused_attention.py), on the per-head (B, H, N, Dh) and the
packed (B, N, H*Dh) layout. `self_attention`, `masked_attention` and
`cross_attention_bidirectional` are the per-head entry points that models
call: the CUDA kernels on CUDA tensors, the plain versions on CPU tensors.
Semantics, those of the JAX package's `_sdpa` (:43-58): masked keys are
excluded from the softmax and get weight exactly 0; a query row that is
invalid or has no valid key gets an exact zero context and a zero gradient
(the out-projection bias still reaches it downstream). Where the values are
bf16, the normalised probabilities are rounded to bf16 before the product
with them, as `_sdpa` rounds `attn.astype(v.dtype)` (:55-58, :140-147).
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
    return x.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def _to_packed(x: torch.Tensor) -> torch.Tensor:
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def _as_values(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The probabilities rounded to the values' type (a no-op for fp32
    values), in fp32 for the product."""
    return attn.to(v.dtype).float()


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


def attention_heads(q, k, v, mask_q, mask_k, scale: float) -> torch.Tensor:
    """Masked attention on the per-head layout, fp32 math: q (B, H, Nq, Dh),
    k, v (B, H, Nk, Dh), masks (B, Nq) / (B, Nk) bool or None. Returns the
    fp32 (B, H, Nq, Dh) context; rows that are invalid or see no valid key
    are zero. bf16 values take the probabilities rounded to bf16."""
    b, _, nq, _ = q.shape
    nk = k.shape[2]
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    pair = _pair_mask(mask_q, mask_k, b, nq, nk, q.device)
    attn = masked_softmax(sim * scale, pair, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", _as_values(attn, v), v.float())


def cross_attention_heads(qk0, qk1, v0, v1, mask0=None, mask1=None):
    """Both cross directions from one similarity on the per-head layout
    (the projection is shared, so sim(1->0) = sim(0->1)^T): the row softmax
    gives the messages into set 0, the column softmax those into set 1. The
    scale Dh**-0.5 is split as Dh**-0.25 a side
    (gluefactory_tpu/ops/attention.py:128; in fp32 here, as the Pallas
    kernels, the port's kernels and the jitted XLA path compute it: run op
    by op, the XLA path rounds qk * Dh**-0.25 to bf16 for bf16 inputs, but
    XLA's compiler drops that rounding and feeds the fp32 product to the
    einsum). bf16 values take the probabilities rounded to bf16. Returns fp32 (m0 (B, H, M, Dh),
    m1 (B, H, N, Dh))."""
    b, _, m, dh = qk0.shape
    n = qk1.shape[2]
    s = dh**-0.25
    sim = torch.einsum("bhid,bhjd->bhij", qk0.float() * s, qk1.float() * s)
    pair = _pair_mask(mask0, mask1, b, m, n, qk0.device)  # a missing mask is all valid
    attn01 = masked_softmax(sim, pair, dim=-1)
    attn10 = masked_softmax(sim, pair, dim=-2)
    m0 = torch.einsum("bhij,bhjd->bhid", _as_values(attn01, v1), v1.float())
    m1 = torch.einsum("bhij,bhid->bhjd", _as_values(attn10, v0), v0.float())
    return m0, m1


def attention_backward_heads(q, k, v, mask_q, mask_k, dout, scale: float):
    """The attention backward written out (the formula of
    `_attention_bwd_kernel`, gluefactory_tpu/ops/pallas_attention.py:143),
    the plain version of the backward kernel, on the per-head layout: p is
    recomputed, then dv = p^T do, dp = do v^T, ds = p (dp - rowsum(p dp))
    scale, dq = ds k, dk = ds^T q. Returns fp32 (dq, dk, dv)."""
    b, _, nq, _ = q.shape
    nk = k.shape[2]
    qh, kh, vh, doh = q.float(), k.float(), v.float(), dout.float()
    sim = torch.einsum("bhid,bhjd->bhij", qh, kh) * scale
    p = masked_softmax(sim, _pair_mask(mask_q, mask_k, b, nq, nk, q.device), dim=-1)
    dv = torch.einsum("bhij,bhid->bhjd", p, doh)
    dp = torch.einsum("bhid,bhjd->bhij", doh, vh)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhij,bhjd->bhid", ds, kh)
    dk = torch.einsum("bhij,bhid->bhjd", ds, qh)
    return dq, dk, dv


# ------------------------------------------------- the per-head entry points
def masked_attention(q, k, v, mask_q=None, mask_k=None):
    """Attention with separate query and key validity masks on the per-head
    layout (counterpart of gluefactory_tpu/ops/attention.py:151): q
    (B, H, Nq, Dh), k, v (B, H, Nk, Dh), scale Dh**-0.5. fp32 inside and the
    input type out; zeros at invalid query rows. The CUDA kernel on the
    card, the plain version on the CPU; differentiable."""
    from .fused_attention import fused_attention

    return fused_attention(q.float(), k.float(), v.float(), mask_q, mask_k).to(q.dtype)


def self_attention(q, k, v, mask=None):
    """Multi-head attention over one keypoint set, (B, H, N, Dh) in and out
    (counterpart of gluefactory_tpu/ops/attention.py:61)."""
    return masked_attention(q, k, v, mask, mask)


def cross_attention_bidirectional(qk0, qk1, v0, v1, mask0=None, mask1=None):
    """Bidirectional cross attention on the per-head layout (counterpart of
    gluefactory_tpu/ops/attention.py:93): qk0, v0 (B, H, M, Dh), qk1, v1
    (B, H, N, Dh). Returns (m0 (B, H, M, Dh), m1 (B, H, N, Dh)) in the input
    types. The CUDA kernel on the card, the plain version on the CPU;
    differentiable."""
    from .fused_attention import fused_cross_attention

    m0, m1 = fused_cross_attention(qk0.float(), qk1.float(), v0.float(), v1.float(),
                                   mask0, mask1)
    return m0.to(qk0.dtype), m1.to(qk1.dtype)


# ---------------------------------------------------------- the packed layout
def masked_attention_packed(
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
    return _to_packed(attention_heads(
        _to_heads(q, num_heads), _to_heads(k, num_heads), _to_heads(v, num_heads),
        mask_q, mask_k, scale))


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
    return masked_attention_packed(q, k, v, mask, mask, num_heads, scale).to(v.dtype)


def cross_attention_bidirectional_packed(
    qk0: torch.Tensor,
    qk1: torch.Tensor,
    v0: torch.Tensor,
    v1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    num_heads: int = 4,
):
    """`cross_attention_heads` on the packed layout: qk0, v0 (B, M, D), qk1,
    v1 (B, N, D). Returns (m0 (B, M, D), m1 (B, N, D))."""
    m0, m1 = cross_attention_heads(
        _to_heads(qk0, num_heads), _to_heads(qk1, num_heads), _to_heads(v0, num_heads),
        _to_heads(v1, num_heads), mask0, mask1)
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
    """`attention_backward_heads` on the packed layout. Returns (dq, dk, dv)
    in the inputs' types."""
    dq, dk, dv = attention_backward_heads(
        _to_heads(q, num_heads), _to_heads(k, num_heads), _to_heads(v, num_heads),
        mask_q, mask_k, _to_heads(dout, num_heads), scale)
    return _to_packed(dq).to(q.dtype), _to_packed(dk).to(k.dtype), _to_packed(dv).to(v.dtype)


__all__ = [
    "rotate_half", "apply_rotary", "masked_softmax", "attention_heads",
    "cross_attention_heads", "attention_backward_heads", "masked_attention",
    "self_attention", "cross_attention_bidirectional", "masked_attention_packed",
    "self_attention_packed", "cross_attention_bidirectional_packed",
    "cross_attention_bidirectional_stacked", "attention_backward",
]
