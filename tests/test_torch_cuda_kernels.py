"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: they skip where there is no GPU. The file imports no JAX, so
it also runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_kernels.py
Tolerances: fp32 within 1e-4 (summation order); bf16 within 0.0625 +
0.03*|plain| (a few bf16 ulps: both round at the same points, but a value
on a rounding boundary can land one ulp apart and carry on).
"""

import pytest
import torch

from gluefactory_tpu_torch.ops import attention as plain
from gluefactory_tpu_torch.ops import fused_attention as fa
from gluefactory_tpu_torch.ops import lightglue_block as lb
from gluefactory_tpu_torch.ops import log_assignment as la

pytestmark = pytest.mark.cuda
D = 256


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _weights(gen, dtype, cross):
    w = lambda din, dout: _rn(gen, din, dout, scale=din**-0.5, dtype=dtype)
    b = lambda k: _rn(gen, k, scale=0.1, dtype=dtype)
    pre = [w(D, D), b(D), w(D, D), b(D)] if cross else [w(D, 3 * D), b(3 * D)]
    ln = (1 + _rn(gen, 2 * D, scale=0.1)).to(dtype)
    return pre + [w(D, D), b(D), w(2 * D, 2 * D), b(2 * D), ln, b(2 * D), w(2 * D, D), b(D)]


def _close(out, ref, dtype):
    atol, rtol = (1e-4, 1e-5) if dtype == torch.float32 else (0.0625, 0.03)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_blocks_match_plain(gen, dtype, masked):
    s, n = 4, 200
    x = _rn(gen, s, n, D, dtype=dtype)
    angles = torch.rand(s, n, 32, generator=gen, device="cuda") * 6
    cos = torch.cos(angles).repeat_interleave(2, -1).to(dtype).contiguous()
    sin = torch.sin(angles).repeat_interleave(2, -1).to(dtype).contiguous()
    mask = torch.rand(s, n, generator=gen, device="cuda") > 0.3
    mask[1] = False
    w = _weights(gen, dtype, cross=False)
    before = lb.fused_self_block.launches
    out = lb.fused_self_block(x, cos, sin, mask, *w, masked=masked)
    assert lb.fused_self_block.launches == before + 1
    _close(out, lb.self_block(x, cos, sin, mask, *w, masked=masked), dtype)
    w = _weights(gen, dtype, cross=True)
    out = lb.fused_cross_block(x, mask, *w, masked=masked)
    _close(out, lb.cross_block(x, mask, *w, masked=masked), dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_log_assignment_matches_plain(gen, masked):
    b, m, n = 2, 150, 170
    d0, d1 = _rn(gen, b, m, D, scale=D**-0.25), _rn(gen, b, n, D, scale=D**-0.25)
    z0, z1 = _rn(gen, b, m), _rn(gen, b, n)
    masks = (torch.rand(b, m, generator=gen, device="cuda") > 0.25,
             torch.rand(b, n, generator=gen, device="cuda") > 0.25) if masked else (None, None)
    out = la.fused_log_assignment(d0, d1, z0, z1, *masks)
    ref = la.log_assignment(d0, d1, z0, z1, *masks)
    for o, r in zip(out, ref):
        if o.dtype == torch.int32:
            assert (o == r).float().mean() > 0.99
        else:
            torch.testing.assert_close(o, r, atol=1e-4, rtol=1e-5)


def _mask(gen, *shape):
    return torch.rand(*shape, generator=gen, device="cuda") > 0.3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_packed_matches_plain(gen, dtype, masked):
    """Forward against the plain version, gradients against the explicit
    backward formula (and, in fp32, autograd of the plain forward)."""
    s, nq, nk = 3, 200, 150
    q, k, v, do = (_rn(gen, s, n, D, dtype=dtype) for n in (nq, nk, nk, nq))
    mq, mk = (_mask(gen, s, nq), _mask(gen, s, nk)) if masked else (None, None)
    if masked:
        mk[1] = False
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.fused_attention_packed.launches, fa.fused_attention_backward.launches
    out = fa.fused_attention_packed(*leaves, mq, mk)
    out.backward(do)
    assert (fa.fused_attention_packed.launches, fa.fused_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    _close(out, plain.masked_attention(q, k, v, mq, mk, 4, 0.125), dtype)
    for leaf, ref in zip(leaves, plain.attention_backward(q, k, v, mq, mk, do, 4, 0.125)):
        _close(leaf.grad, ref, dtype)
    if dtype == torch.float32:
        auto = [t.clone().requires_grad_() for t in (q, k, v)]
        plain.masked_attention(*auto, mq, mk, 4, 0.125).backward(do)
        for leaf, ref in zip(leaves, auto):
            _close(leaf.grad, ref.grad, dtype)


@pytest.mark.parametrize("form", ["stacked", "packed"])
def test_cross_attention_matches_plain(gen, form):
    """Both message sets and the gradients of the shared projection, fp32,
    against autograd of the plain version."""
    b, m, n = 2, 200, 200 if form == "stacked" else 136
    if form == "stacked":
        args = [_rn(gen, 2 * b, m, D) for _ in range(2)]
        masks = (_mask(gen, 2 * b, m),)
        kern, ref = fa.fused_cross_attention_stacked, plain.cross_attention_bidirectional_stacked
    else:
        args = [_rn(gen, b, k, D) for k in (m, n, m, n)]
        masks = (_mask(gen, b, m), _mask(gen, b, n))
        kern, ref = fa.fused_cross_attention_packed, plain.cross_attention_bidirectional_packed
    g = (_rn(gen, b, m, D), _rn(gen, b, n, D))
    a = [t.clone().requires_grad_() for t in args]
    r = [t.clone().requires_grad_() for t in args]
    before = fa.fused_attention_backward.launches
    out, expect = kern(*a, *masks), ref(*r, *masks)
    torch.autograd.backward(out, g)
    torch.autograd.backward(expect, g)
    assert fa.fused_attention_backward.launches == before + 2
    for o, e in zip(out, expect):
        _close(o, e, torch.float32)
    for x, y in zip(a, r):
        _close(x.grad, y.grad, torch.float32)


def test_wrappers_check_their_inputs(gen):
    x = _rn(gen, 2, 64, D, dtype=torch.float16)
    w = _weights(gen, torch.float16, cross=True)
    with pytest.raises(TypeError):
        lb.fused_cross_block(x, None, *w, masked=False)
    with pytest.raises(ValueError):  # heads of width 32
        fa.fused_attention_packed(*(_rn(gen, 2, 64, 128) for _ in range(3)), num_heads=4)
