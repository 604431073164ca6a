"""LightGlue self and cross blocks: plain PyTorch versions and the wrappers
of their CUDA kernels (csrc/lightglue_block.cu).

Counterparts of `fused_self_block` / `fused_cross_block` and their `_v2`
large-N variants in gluefactory_tpu/ops/pallas_lightglue_block.py (:309,
:374, :641, :698). The arguments follow those kernels, with one change: the
TPU's roll-form rotary tables (cos, sin_a, sin_b) become the plain (cos,
sin) pair of `t*cos + rotate_half(t)*sin`, given per head as (S, N, Dh)
since the encoding is the same for every head.

Rounding points (the bf16 path, and exact in fp32): q, k, v, the attention
context, the out-projected message, the GELU output and the block output
are rounded to the activation type; everything else is fp32, LayerNorm
statistics included.

`fused_self_block` / `fused_cross_block` run the plain version for CPU
tensors and launch the kernel chain for CUDA tensors; each keeps a count of
its launches in `.launches`. `self_block_steps` / `cross_block_steps` give
the chain's three launches one by one (chip_smoke.py times each).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _ext
from .attention import apply_rotary, masked_attention_packed

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _tables(cos, sin, num_heads):
    """(S, N, Dh) per-head tables -> fp32 (S, N, H*Dh)."""
    return cos.float().repeat(1, 1, num_heads), sin.float().repeat(1, 1, num_heads)


def ffn_tail(x, ctx, wout, bout, wff1, bff1, lns, lnb, wff2, bff2):
    """x + FFN([x, ctx @ wout + bout]) with fp32 LayerNorm and exact GELU."""
    cd = x.dtype
    d = x.shape[-1]
    f = lambda t: t.float()
    msg = (f(ctx) @ f(wout) + f(bout)).to(cd).float()
    h = f(x) @ f(wff1[:d]) + msg @ f(wff1[d:]) + f(bff1)
    h = F.layer_norm(h, (2 * d,), f(lns), f(lnb), eps=1e-5)
    g = F.gelu(h).to(cd).float()
    return (f(x) + (g @ f(wff2) + f(bff2))).to(cd)


def self_block(
    x, cos, sin, mask, wqkv, bqkv, wout, bout, wff1, bff1, lns, lnb, wff2, bff2,
    num_heads: int = 4, masked: bool = True,
):
    """Plain self block over stacked sets: x (S, N, D), cos/sin (S, N, Dh),
    mask (S, N) bool (ignored when masked=False). Returns (S, N, D)."""
    cd = x.dtype
    d = x.shape[-1]
    dh = d // num_heads
    y = x.float() @ wqkv.float() + bqkv.float()
    q, k, v = y.split(d, dim=-1)
    cosf, sinf = _tables(cos, sin, num_heads)
    q = (apply_rotary(q, cosf, sinf) * dh**-0.5).to(cd)
    k = apply_rotary(k, cosf, sinf).to(cd)
    m = mask.bool() if masked else None
    ctx = masked_attention_packed(q, k, v.to(cd), m, m, num_heads, 1.0).to(cd)
    return ffn_tail(x, ctx, wout, bout, wff1, bff1, lns, lnb, wff2, bff2)


def cross_block(
    x, mask, wqk, bqk, wv, bv, wout, bout, wff1, bff1, lns, lnb, wff2, bff2,
    num_heads: int = 4, masked: bool = True,
):
    """Plain bidirectional cross block: x (2B, N, D), pair i = rows (i, i+B);
    mask (2B, N) bool (ignored when masked=False). Returns (2B, N, D)."""
    cd = x.dtype
    b = x.shape[0] // 2
    dh = x.shape[-1] // num_heads
    qk = (x.float() @ wqk.float() + bqk.float()).to(cd)
    v = (x.float() @ wv.float() + bv.float()).to(cd)
    other = lambda t: torch.cat([t[b:], t[:b]], dim=0)
    m = mask.bool() if masked else None
    mo = other(m) if masked else None
    ctx = masked_attention_packed(qk, other(qk), other(v), m, mo, num_heads, dh**-0.5).to(cd)
    return ffn_tail(x, ctx, wout, bout, wff1, bff1, lns, lnb, wff2, bff2)


# ----------------------------------------------------------------- kernels
def _ptr(t, offset: int = 0):
    return t.data_ptr() + offset * t.element_size()


def _check(x, tensors, what):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: activations must be float32 or bfloat16, got {x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{what}: all tensors must be on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: weights must have the activation dtype {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        _check_aligned(t, what)
    if x.shape[-1] != 256:
        raise ValueError(f"{what}: the kernels take D = 256, got {x.shape[-1]}")


def _check_aligned(t, what):
    """The kernels copy rows in 16-byte pieces (cp.async, ldmatrix)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: every tensor must start on a 16-byte boundary")


def _check_mask(mask, shape, device, masked, what):
    if not masked:
        return None
    if mask.dtype != torch.bool or tuple(mask.shape) != tuple(shape) or mask.device != device:
        raise ValueError(f"{what}: mask must be a bool {tuple(shape)} tensor on {device}")
    mask = mask.contiguous()
    _check_aligned(mask, what)
    return mask


def _ffn_step(lib, stream, x, ctx, wout, bout, wff1, bff1, lns, lnb, wff2, bff2):
    out = torch.empty_like(x)
    rows, d = x.shape[0] * x.shape[1], x.shape[2]

    def run():
        _ext.check(lib.lg_ffn_tail(
            _ptr(x), _ptr(ctx), _ptr(wout), _ptr(bout), _ptr(wff1), _ptr(bff1),
            _ptr(lns), _ptr(lnb), _ptr(wff2), _ptr(bff2), _ptr(out), rows, d,
            _DTYPES[x.dtype], stream), "lg_ffn_tail")
        return out

    return run


def _attention_step(lib, stream, q, k, v, mask, num_heads, kv_shift, scale):
    ctx = torch.empty_like(q)
    s, n, d = q.shape

    def run():
        _ext.check(lib.lg_attention(
            _ptr(q), _ptr(k), _ptr(v), None if mask is None else _ptr(mask), _ptr(ctx),
            s, n, d, num_heads, kv_shift, scale, _DTYPES[q.dtype], stream), "lg_attention")
        return ctx

    return run, ctx


def self_block_steps(lib, stream, x, cos, sin, mask, wqkv, bqkv, wout, bout,
                     wff1, bff1, lns, lnb, wff2, bff2, num_heads):
    """The self-block chain through `lib` as its three launches (proj,
    attention, FFN tail): functions of no arguments over buffers allocated
    here, to be called in that order; the last returns the block's output."""
    s, n, d = x.shape
    dh = d // num_heads
    q, k, v = (torch.empty_like(x) for _ in range(3))

    def proj():
        _ext.check(lib.lg_proj(
            _ptr(x), s * n, d, _ptr(wqkv), _ptr(wqkv, d), _ptr(wqkv, 2 * d), 3 * d,
            _ptr(bqkv), _ptr(bqkv, d), _ptr(bqkv, 2 * d), _ptr(q), _ptr(k), _ptr(v),
            d, 3, _ptr(cos), _ptr(sin), dh, 2, dh**-0.5, _DTYPES[x.dtype], stream), "lg_proj")

    attention, ctx = _attention_step(lib, stream, q, k, v, mask, num_heads, 0, 1.0)
    return proj, attention, _ffn_step(lib, stream, x, ctx, wout, bout, wff1, bff1, lns, lnb,
                                      wff2, bff2)


def cross_block_steps(lib, stream, x, mask, wqk, bqk, wv, bv, wout, bout,
                      wff1, bff1, lns, lnb, wff2, bff2, num_heads):
    """The cross-block chain as `self_block_steps` gives the self block's
    (proj, both attention directions in one launch, FFN tail)."""
    s, n, d = x.shape
    dh = d // num_heads
    qk, v = torch.empty_like(x), torch.empty_like(x)

    def proj():
        _ext.check(lib.lg_proj(
            _ptr(x), s * n, d, _ptr(wqk), _ptr(wv), None, d, _ptr(bqk), _ptr(bv), None,
            _ptr(qk), _ptr(v), None, d, 2, None, None, dh, 0, 1.0, _DTYPES[x.dtype], stream),
            "lg_proj")

    attention, ctx = _attention_step(lib, stream, qk, qk, v, mask, num_heads, s // 2,
                                     dh**-0.5)
    return proj, attention, _ffn_step(lib, stream, x, ctx, wout, bout, wff1, bff1, lns, lnb,
                                      wff2, bff2)


def _run(steps):
    return [step() for step in steps][-1]


def launch_self_block(lib, stream, *args):
    """Run the self-block chain (proj -> attention -> FFN tail) through `lib`;
    the arguments of `self_block_steps`."""
    return _run(self_block_steps(lib, stream, *args))


def launch_cross_block(lib, stream, *args):
    """Run the cross-block chain through `lib`; the arguments of
    `cross_block_steps`."""
    return _run(cross_block_steps(lib, stream, *args))


def fused_self_block(
    x, cos, sin, mask, wqkv, bqkv, wout, bout, wff1, bff1, lns, lnb, wff2, bff2,
    num_heads: int = 4, masked: bool = True,
):
    """`self_block` on the CPU; the CUDA kernel chain on the card."""
    args = (wqkv, bqkv, wout, bout, wff1, bff1, lns, lnb, wff2, bff2)
    if x.device.type == "cpu":
        return self_block(x, cos, sin, mask, *args, num_heads=num_heads, masked=masked)
    _check(x, (x, cos, sin) + args, "fused_self_block")
    s, n, d = x.shape
    if tuple(cos.shape) != (s, n, d // num_heads) or cos.shape != sin.shape:
        raise ValueError("fused_self_block: cos/sin must be (S, N, D / num_heads)")
    mask = _check_mask(mask, (s, n), x.device, masked, "fused_self_block")
    lib = _ext.load("lightglue_block")
    out = launch_self_block(lib, torch.cuda.current_stream(x.device).cuda_stream,
                            x, cos, sin, mask, *args, num_heads)
    fused_self_block.launches += 1
    return out


def fused_cross_block(
    x, mask, wqk, bqk, wv, bv, wout, bout, wff1, bff1, lns, lnb, wff2, bff2,
    num_heads: int = 4, masked: bool = True,
):
    """`cross_block` on the CPU; the CUDA kernel chain on the card."""
    args = (wqk, bqk, wv, bv, wout, bout, wff1, bff1, lns, lnb, wff2, bff2)
    if x.device.type == "cpu":
        return cross_block(x, mask, *args, num_heads=num_heads, masked=masked)
    _check(x, (x,) + args, "fused_cross_block")
    if x.shape[0] % 2:
        raise ValueError("fused_cross_block: x must stack both sets, (2B, N, D)")
    mask = _check_mask(mask, x.shape[:2], x.device, masked, "fused_cross_block")
    lib = _ext.load("lightglue_block")
    out = launch_cross_block(lib, torch.cuda.current_stream(x.device).cuda_stream,
                             x, mask, *args, num_heads)
    fused_cross_block.launches += 1
    return out


fused_self_block.launches = 0
fused_cross_block.launches = 0

__all__ = [
    "self_block", "cross_block", "ffn_tail",
    "fused_self_block", "fused_cross_block",
]
