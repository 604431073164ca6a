"""The attention kernels: wrappers of the CUDA kernels in
csrc/attention.cu, with their gradients.

Counterparts of gluefactory_tpu/ops/pallas_attention.py:
  fused_attention_packed (:421)         packed self attention
  fused_cross_attention_stacked (:779)  both cross directions, stacked sets
  fused_cross_attention_packed (:815)   both cross directions, two arrays
  fused_attention (:253)                per-head attention, (B, H, N, Dh)
  fused_cross_attention (:854)          per-head, both cross directions
  _fused_attention_bwd_bhnd (:202)      the attention backward
Each is a `torch.autograd.Function`: on CUDA tensors the forward launches
its kernel and the backward launches the backward kernel (twice for the
cross attention, once a direction, summing the gradients of the shared
projection: dqk0 = dq(0<-1) + dk(1<-0)). On CPU tensors the forward runs
the plain version of ops/attention.py and the backward the plain explicit
formula `attention_backward`, so the formula itself is tested without a
card. Nothing falls back on a CUDA tensor: a kernel that fails to build or
launch raises. The backward works on either layout directly (a 3-D tensor
is packed, a 4-D one per-head); the JAX package's head transposes around
it are not carried over.

Each wrapper counts its kernel launches in `.launches`; the backward also
counts those made for a cross direction in `.cross_launches`.
"""

from __future__ import annotations

import torch

from .. import _ext
from . import attention as plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DH = 64  # head width of the kernels


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(what, num_heads, tensors, masks):
    x = tensors[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: tensors must be float32 or bfloat16, got {x.dtype}")
    if x.shape[-1] != num_heads * _DH:
        raise ValueError(f"{what}: the kernels take heads of width {_DH}, "
                         f"got {x.shape[-1]} channels for {num_heads} heads")
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype or t.ndim != 3:
            raise ValueError(f"{what}: tensors must be 3-D {x.dtype} on {x.device}")
    for t, m in masks:
        if m is not None and (m.dtype != torch.bool or m.shape != t.shape[:2]
                              or m.device != x.device):
            raise ValueError(f"{what}: a mask must be a bool {tuple(t.shape[:2])} tensor "
                             f"on {x.device}")


def _check_heads(what, tensors, masks):
    x = tensors[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: tensors must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or x.shape[-1] != _DH:
        raise ValueError(f"{what}: the kernels take (B, H, N, {_DH}) tensors, "
                         f"got {tuple(x.shape)}")
    for t in tensors:
        if (t.device != x.device or t.dtype != x.dtype or t.ndim != 4
                or t.shape[:2] != x.shape[:2] or t.shape[-1] != _DH):
            raise ValueError(f"{what}: tensors must be (B, H, N, {_DH}) {x.dtype} on "
                             f"{x.device} with one B and H")
    for t, m in masks:
        shape = (t.shape[0], t.shape[2])
        if m is not None and (m.dtype != torch.bool or tuple(m.shape) != shape
                              or m.device != x.device):
            raise ValueError(f"{what}: a mask must be a bool {shape} tensor on {x.device}")


def _c(t):
    return None if t is None else t.contiguous()


def _aligned16(t):
    """t, or a copy that starts on a 16-byte boundary: the kernels stage rows
    in 16-byte cp.async pieces."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


# ------------------------------------------------- launches through a library
def launch_attention_fwd(lib, stream, q, k, v, mask_q, mask_k, num_heads, scale):
    """(context (S, Nq, D), log-sum-exp (S, H, Nq) fp32) through `lib`."""
    q, k, v = map(_aligned16, (q, k, v))
    s, nq, d = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((s, num_heads, nq), dtype=torch.float32, device=q.device)
    _ext.check(lib.at_attn_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask_q), _ptr(mask_k), _ptr(out), _ptr(lse),
        s, nq, nk, d, num_heads, scale, _DTYPES[q.dtype], stream), "at_attn_fwd")
    return out, lse


def launch_cross_fwd_stacked(lib, stream, qk, v, mask, num_heads, scale):
    """(messages (2B, N, D): row s holds those into set s; lse (2B, H, N))."""
    qk, v = map(_aligned16, (qk, v))
    s2, n, d = qk.shape
    out = torch.empty_like(qk)
    lse = torch.empty((s2, num_heads, n), dtype=torch.float32, device=qk.device)
    _ext.check(lib.at_cross_fwd_stacked(
        _ptr(qk), _ptr(v), _ptr(mask), _ptr(out), _ptr(lse), s2 // 2, n, d, num_heads,
        scale, _DTYPES[qk.dtype], stream), "at_cross_fwd_stacked")
    return out, lse


def launch_cross_fwd_pair(lib, stream, qk0, qk1, v0, v1, mask0, mask1, num_heads, scale):
    """(m0 (B, M, D), m1 (B, N, D), lse0 (B, H, M), lse1 (B, H, N))."""
    qk0, qk1, v0, v1 = map(_aligned16, (qk0, qk1, v0, v1))
    b, m, d = qk0.shape
    n = qk1.shape[1]
    m0, m1 = torch.empty_like(qk0), torch.empty_like(qk1)
    lse0 = torch.empty((b, num_heads, m), dtype=torch.float32, device=qk0.device)
    lse1 = torch.empty((b, num_heads, n), dtype=torch.float32, device=qk0.device)
    _ext.check(lib.at_cross_fwd_pair(
        _ptr(qk0), _ptr(qk1), _ptr(v0), _ptr(v1), _ptr(mask0), _ptr(mask1), _ptr(m0),
        _ptr(m1), _ptr(lse0), _ptr(lse1), b, m, n, d, num_heads, scale,
        _DTYPES[qk0.dtype], stream), "at_cross_fwd_pair")
    return m0, m1, lse0, lse1


def launch_attention_fwd_heads(lib, stream, q, k, v, mask_q, mask_k, scale):
    """Per-head layout: (context (B, H, Nq, Dh), log-sum-exp (B, H, Nq) fp32)."""
    q, k, v = map(_aligned16, (q, k, v))
    b, h, nq, _ = q.shape
    nk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    _ext.check(lib.at_attn_fwd_heads(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask_q), _ptr(mask_k), _ptr(out), _ptr(lse),
        b, h, nq, nk, scale, _DTYPES[q.dtype], stream), "at_attn_fwd_heads")
    return out, lse


def launch_cross_fwd_heads(lib, stream, qk0, qk1, v0, v1, mask0, mask1, scale):
    """Per-head layout: (m0 (B, H, M, Dh), m1 (B, H, N, Dh), lse0 (B, H, M),
    lse1 (B, H, N))."""
    qk0, qk1, v0, v1 = map(_aligned16, (qk0, qk1, v0, v1))
    b, h, m, _ = qk0.shape
    n = qk1.shape[2]
    m0, m1 = torch.empty_like(qk0), torch.empty_like(qk1)
    lse0 = torch.empty((b, h, m), dtype=torch.float32, device=qk0.device)
    lse1 = torch.empty((b, h, n), dtype=torch.float32, device=qk0.device)
    _ext.check(lib.at_cross_fwd_heads(
        _ptr(qk0), _ptr(qk1), _ptr(v0), _ptr(v1), _ptr(mask0), _ptr(mask1), _ptr(m0),
        _ptr(m1), _ptr(lse0), _ptr(lse1), b, h, m, n, scale, _DTYPES[qk0.dtype], stream),
        "at_cross_fwd_heads")
    return m0, m1, lse0, lse1


def launch_attention_bwd(lib, stream, q, k, v, out, lse, mask_q, mask_k, dout, num_heads,
                         scale):
    """(dq, dk, dv) of one attention direction through `lib`; packed
    (S, N, D) or per-head (S, H, N, Dh) tensors."""
    heads = q.ndim == 4
    if heads:
        s, _, nq, dh = q.shape
        nk, d = k.shape[2], num_heads * dh
    else:
        s, nq, d = q.shape
        nk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    _ext.check(lib.at_attn_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(lse), _ptr(mask_q),
        _ptr(mask_k), _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv), s, nq, nk, d, num_heads,
        scale, _DTYPES[q.dtype], int(heads), stream), "at_attn_bwd")
    return dq, dk, dv


# ------------------------------------------------------------------ backward
def fused_attention_backward(q, k, v, out, lse, mask_q, mask_k, dout, num_heads: int = 4,
                             cross: bool = False):
    """(dq, dk, dv) of `out = attention(q, k, v)` given d(out): the plain
    explicit formula on the CPU (out and lse are not needed there), the
    backward kernels on the card. Packed (S, N, H*Dh) tensors, or per-head
    (S, H, N, Dh) ones (`num_heads` is then read from them). `cross` only
    says which count the launch goes to."""
    heads = q.ndim == 4
    if heads:
        num_heads = q.shape[1]
        scale = q.shape[-1] ** -0.5
    else:
        scale = (q.shape[-1] // num_heads) ** -0.5
    if q.device.type == "cpu":
        if heads:
            grads = plain.attention_backward_heads(q, k, v, mask_q, mask_k, dout, scale)
            return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
        return plain.attention_backward(q, k, v, mask_q, mask_k, dout, num_heads, scale)
    q, k, v, out, dout, lse, mask_q, mask_k = map(_c, (q, k, v, out, dout, lse, mask_q, mask_k))
    q, k, v, out, dout = map(_aligned16, (q, k, v, out, dout))
    if heads:
        _check_heads("fused_attention_backward", (q, k, v, out, dout),
                     ((q, mask_q), (k, mask_k)))
    else:
        _check("fused_attention_backward", num_heads, (q, k, v, out, dout),
               ((q, mask_q), (k, mask_k)))
    grads = launch_attention_bwd(_ext.load("attention"), _stream(q), q, k, v, out, lse,
                                 mask_q, mask_k, dout, num_heads, scale)
    fused_attention_backward.launches += 1
    fused_attention_backward.cross_launches += int(cross)
    return grads


# ------------------------------------------------------------ self attention
class _AttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask_q, mask_k, num_heads):
        ctx.num_heads = num_heads
        if q.device.type == "cpu":
            scale = (q.shape[-1] // num_heads) ** -0.5
            out = plain.masked_attention_packed(q, k, v, mask_q, mask_k, num_heads, scale).to(v.dtype)
            lse = None
        else:
            q, k, v, mask_q, mask_k = map(_c, (q, k, v, mask_q, mask_k))
            _check("fused_attention_packed", num_heads, (q, k, v), ((q, mask_q), (k, mask_k)))
            scale = _DH**-0.5
            out, lse = launch_attention_fwd(_ext.load("attention"), _stream(q), q, k, v,
                                            mask_q, mask_k, num_heads, scale)
            fused_attention_packed.launches += 1
        ctx.save_for_backward(q, k, v, out, lse, mask_q, mask_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask_q, mask_k = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, out, lse, mask_q, mask_k, dout,
                                              ctx.num_heads)
        return dq, dk, dv, None, None, None


def fused_attention_packed(q, k, v, mask_q=None, mask_k=None, num_heads: int = 4):
    """Masked multi-head attention on the packed (S, N, H*Dh) layout, scale
    Dh**-0.5; mask_q (S, Nq), mask_k (S, Nk) bool or None. Returns
    (S, Nq, H*Dh) with zeros at invalid query rows. Differentiable."""
    return _AttentionPacked.apply(q, k, v, mask_q, mask_k, num_heads)


# ----------------------------------------------------------- cross attention
def _cross_backward(qk0, qk1, v0, v1, m0, m1, lse0, lse1, mask0, mask1, g0, g1, num_heads):
    """Gradients of both directions: (dqk0, dqk1, dv0, dv1)."""
    dq0, dk1, dv1 = fused_attention_backward(qk0, qk1, v1, m0, lse0, mask0, mask1, g0, num_heads,
                                             cross=True)
    dq1, dk0, dv0 = fused_attention_backward(qk1, qk0, v0, m1, lse1, mask1, mask0, g1, num_heads,
                                             cross=True)
    return dq0 + dk0, dk1 + dq1, dv0, dv1


class _CrossAttentionStacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qk, v, mask, num_heads):
        ctx.num_heads = num_heads
        b = qk.shape[0] // 2
        if qk.device.type == "cpu":
            m0, m1 = plain.cross_attention_bidirectional_stacked(qk, v, mask, num_heads)
            out, lse = torch.cat([m0, m1], dim=0), None
        else:
            qk, v, mask = map(_c, (qk, v, mask))
            _check("fused_cross_attention_stacked", num_heads, (qk, v), ((qk, mask),))
            if qk.shape[0] % 2 or v.shape != qk.shape:
                raise ValueError("fused_cross_attention_stacked: qk and v must stack both "
                                 "sets, (2B, N, D)")
            out, lse = launch_cross_fwd_stacked(_ext.load("attention"), _stream(qk), qk, v,
                                                mask, num_heads, _DH**-0.5)
            fused_cross_attention_stacked.launches += 1
        ctx.save_for_backward(qk, v, out, lse, mask)
        return out[:b], out[b:]

    @staticmethod
    def backward(ctx, g0, g1):
        qk, v, out, lse, mask = ctx.saved_tensors
        b = qk.shape[0] // 2
        lo = lambda t: None if t is None else t[:b]
        hi = lambda t: None if t is None else t[b:]
        dqk0, dqk1, dv0, dv1 = _cross_backward(
            qk[:b], qk[b:], v[:b], v[b:], out[:b], out[b:], lo(lse), hi(lse), lo(mask),
            hi(mask), g0, g1, ctx.num_heads)
        return torch.cat([dqk0, dqk1], dim=0), torch.cat([dv0, dv1], dim=0), None, None


def fused_cross_attention_stacked(qk, v, mask=None, num_heads: int = 4):
    """Bidirectional cross attention over stacked sets: pair i is rows i and
    i + B of qk, v (2B, N, D) and mask (2B, N). Returns (m0, m1), each
    (B, N, D): the messages into set 0 and into set 1. Differentiable."""
    return _CrossAttentionStacked.apply(qk, v, mask, num_heads)


class _CrossAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qk0, qk1, v0, v1, mask0, mask1, num_heads):
        ctx.num_heads = num_heads
        if qk0.device.type == "cpu":
            m0, m1 = plain.cross_attention_bidirectional_packed(
                qk0, qk1, v0, v1, mask0, mask1, num_heads)
            lse0 = lse1 = None
        else:
            qk0, qk1, v0, v1, mask0, mask1 = map(_c, (qk0, qk1, v0, v1, mask0, mask1))
            _check("fused_cross_attention_packed", num_heads, (qk0, qk1, v0, v1),
                   ((qk0, mask0), (qk1, mask1)))
            if v0.shape != qk0.shape or v1.shape != qk1.shape or qk0.shape[0] != qk1.shape[0]:
                raise ValueError("fused_cross_attention_packed: qk0/v0 must be (B, M, D) "
                                 "and qk1/v1 (B, N, D)")
            m0, m1, lse0, lse1 = launch_cross_fwd_pair(
                _ext.load("attention"), _stream(qk0), qk0, qk1, v0, v1, mask0, mask1,
                num_heads, _DH**-0.5)
            fused_cross_attention_packed.launches += 1
        ctx.save_for_backward(qk0, qk1, v0, v1, m0, m1, lse0, lse1, mask0, mask1)
        return m0, m1

    @staticmethod
    def backward(ctx, g0, g1):
        grads = _cross_backward(*ctx.saved_tensors, g0, g1, ctx.num_heads)
        return (*grads, None, None, None)


def fused_cross_attention_packed(qk0, qk1, v0, v1, mask0=None, mask1=None, num_heads: int = 4):
    """Bidirectional cross attention on two arrays, qk0/v0 (B, M, D) and
    qk1/v1 (B, N, D), M and N free. Returns (m0 (B, M, D), m1 (B, N, D)).
    Differentiable."""
    return _CrossAttentionPacked.apply(qk0, qk1, v0, v1, mask0, mask1, num_heads)


# ------------------------------------------------------ the per-head entries
class _AttentionHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask_q, mask_k):
        if q.device.type == "cpu":
            out = plain.attention_heads(q, k, v, mask_q, mask_k, q.shape[-1] ** -0.5).to(q.dtype)
            lse = None
        else:
            q, k, v, mask_q, mask_k = map(_c, (q, k, v, mask_q, mask_k))
            _check_heads("fused_attention", (q, k, v), ((q, mask_q), (k, mask_k)))
            out, lse = launch_attention_fwd_heads(_ext.load("attention"), _stream(q), q, k, v,
                                                  mask_q, mask_k, _DH**-0.5)
            fused_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse, mask_q, mask_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask_q, mask_k = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, out, lse, mask_q, mask_k, dout)
        return dq, dk, dv, None, None


def fused_attention(q, k, v, mask_q=None, mask_k=None):
    """Masked multi-head attention on the per-head layout: q (B, H, Nq, Dh),
    k, v (B, H, Nk, Dh), scale Dh**-0.5; mask_q (B, Nq), mask_k (B, Nk) bool
    or None. Returns (B, H, Nq, Dh) with zeros at invalid query rows and at
    rows without a valid key. Differentiable."""
    return _AttentionHeads.apply(q, k, v, mask_q, mask_k)


class _CrossAttentionHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qk0, qk1, v0, v1, mask0, mask1):
        if qk0.device.type == "cpu":
            m0, m1 = plain.cross_attention_heads(qk0, qk1, v0, v1, mask0, mask1)
            m0, m1, lse0, lse1 = m0.to(v1.dtype), m1.to(v0.dtype), None, None
        else:
            qk0, qk1, v0, v1, mask0, mask1 = map(_c, (qk0, qk1, v0, v1, mask0, mask1))
            _check_heads("fused_cross_attention", (qk0, qk1, v0, v1),
                         ((qk0, mask0), (qk1, mask1)))
            if v0.shape != qk0.shape or v1.shape != qk1.shape:
                raise ValueError("fused_cross_attention: qk0/v0 must be (B, H, M, Dh) and "
                                 "qk1/v1 (B, H, N, Dh)")
            m0, m1, lse0, lse1 = launch_cross_fwd_heads(
                _ext.load("attention"), _stream(qk0), qk0, qk1, v0, v1, mask0, mask1,
                _DH**-0.5)
            fused_cross_attention.launches += 1
        ctx.save_for_backward(qk0, qk1, v0, v1, m0, m1, lse0, lse1, mask0, mask1)
        return m0, m1

    @staticmethod
    def backward(ctx, g0, g1):
        grads = _cross_backward(*ctx.saved_tensors, g0, g1, None)
        return (*grads, None, None)


def fused_cross_attention(qk0, qk1, v0, v1, mask0=None, mask1=None):
    """Bidirectional cross attention on the per-head layout, qk0/v0
    (B, H, M, Dh) and qk1/v1 (B, H, N, Dh), M and N free, scale Dh**-0.5 on
    the product. Returns (m0 (B, H, M, Dh), m1 (B, H, N, Dh)): the messages
    into set 0 and into set 1. Differentiable."""
    return _CrossAttentionHeads.apply(qk0, qk1, v0, v1, mask0, mask1)


for _fn in (fused_attention_packed, fused_cross_attention_stacked,
            fused_cross_attention_packed, fused_attention_backward, fused_attention,
            fused_cross_attention):
    _fn.launches = 0
fused_attention_backward.cross_launches = 0

__all__ = [
    "fused_attention_packed", "fused_cross_attention_stacked",
    "fused_cross_attention_packed", "fused_attention_backward", "fused_attention",
    "fused_cross_attention",
]
