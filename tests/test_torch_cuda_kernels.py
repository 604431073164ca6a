"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: they skip where there is no GPU. The file imports no JAX, so
it also runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_kernels.py
Tolerances: fp32 within 1e-4 (summation order); bf16 within 0.0625 +
0.03*|plain| (a few bf16 ulps: both round at the same points, but a value
on a rounding boundary can land one ulp apart and carry on).
"""

import ctypes
import subprocess
from pathlib import Path

import pytest
import torch

from gluefactory_tpu_torch import _ext

from gluefactory_tpu_torch.ops import attention as plain
from gluefactory_tpu_torch.ops import block0_conv as b0
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
    _close(out, plain.masked_attention_packed(q, k, v, mq, mk, 4, 0.125), dtype)
    for leaf, ref in zip(leaves, plain.attention_backward(q, k, v, mq, mk, do, 4, 0.125)):
        _close(leaf.grad, ref, dtype)
    if dtype == torch.float32:
        auto = [t.clone().requires_grad_() for t in (q, k, v)]
        plain.masked_attention_packed(*auto, mq, mk, 4, 0.125).backward(do)
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


@pytest.mark.parametrize("masked", [False, True])
def test_attention_heads_matches_plain(gen, masked):
    """K7a through the per-head entry point, with its gradients (K7b on the
    per-head layout) against autograd of the plain version."""
    b, h, nq, nk = 2, 4, 200, 150
    q, k, v, do = (_rn(gen, b, h, n, 64) for n in (nq, nk, nk, nq))
    mq, mk = (_mask(gen, b, nq), _mask(gen, b, nk)) if masked else (None, None)
    if masked:
        mk[1] = False
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fa.fused_attention.launches, fa.fused_attention_backward.launches
    out = plain.masked_attention(*leaves, mq, mk)
    out.backward(do)
    assert (fa.fused_attention.launches, fa.fused_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    ref = plain.attention_heads(*auto, mq, mk, 0.125)
    ref.backward(do)
    _close(out, ref, torch.float32)
    if masked:
        assert float(out.detach().transpose(1, 2)[~mq].abs().max()) == 0.0
        assert float(out.detach()[1].abs().max()) == 0.0
    for x, y in zip(leaves, auto):
        _close(x.grad, y.grad, torch.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_heads_matches_plain(gen, masked):
    """K7c through the per-head entry point: both message sets and the
    gradients of the shared projection, M != N."""
    b, h, m, n = 2, 4, 200, 136
    args = [_rn(gen, b, h, k, 64) for k in (m, n, m, n)]
    masks = (_mask(gen, b, m), _mask(gen, b, n)) if masked else (None, None)
    g = (_rn(gen, b, h, m, 64), _rn(gen, b, h, n, 64))
    a = [t.clone().requires_grad_() for t in args]
    r = [t.clone().requires_grad_() for t in args]
    before = fa.fused_cross_attention.launches, fa.fused_attention_backward.launches
    out = plain.cross_attention_bidirectional(*a, *masks)
    expect = plain.cross_attention_heads(*r, *masks)
    torch.autograd.backward(out, g)
    torch.autograd.backward(expect, g)
    assert (fa.fused_cross_attention.launches, fa.fused_attention_backward.launches) == (
        before[0] + 1, before[1] + 2)
    for o, e in zip(out, expect):
        _close(o, e, torch.float32)
    for x, y in zip(a, r):
        _close(x.grad, y.grad, torch.float32)


def test_tf32_split_on_the_card(gen, tmp_path):
    """The warp probe of tests/cuda_emu built with nvcc: split_tf32's hi
    part is cvt.rna.tf32.f32's value (ties included), and on the tensor cores
    the 3-pass split is within 2e-6 of an fp32 matmul where one pass on the
    raw fp32 registers is not: the card does what the CPU stand-ins model."""
    probe = Path(__file__).resolve().parent / "cuda_emu" / "mma_probe.cu"
    so = tmp_path / "libmma_probe.so"
    cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, f"-I{_ext.CSRC}", "-o", str(so), str(probe)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stdout + done.stderr
    lib = ctypes.CDLL(str(so))
    lib.tf32_round_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.mma_probe_tf32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    x = torch.randn(4096, generator=gen, device="cuda") * 100
    bits = x.view(torch.int32)
    x[:1024] = ((bits[:1024] & ~0x1FFF) | 0x1000).view(torch.float32)  # ties
    hi, cvt = (torch.empty(4096, dtype=torch.int32, device="cuda") for _ in range(2))
    assert lib.tf32_round_probe(x.data_ptr(), hi.data_ptr(), cvt.data_ptr(), 4096) == 0
    torch.cuda.synchronize()
    assert torch.equal(hi, cvt)
    a, b = _rn(gen, 16, 16), _rn(gen, 16, 8)
    ref = (a.double() @ b.double()).float()
    for split in (1, 0):
        d = torch.zeros(16, 8, device="cuda")
        assert lib.mma_probe_tf32(a.data_ptr(), b.data_ptr(), d.data_ptr(), split) == 0
        torch.cuda.synchronize()
        err = float((d - ref).abs().max())
        assert err < 2e-6 if split else err > 1e-4, (split, err)


@pytest.mark.parametrize("heads", [False, True])
def test_attention_backward_is_deterministic(gen, heads):
    """K7b has no atomics: two calls on the same inputs give bit-identical
    gradients, on either layout, with ragged lengths."""
    s, nq, nk = 3, 200, 150
    shape = (lambda n: (s, 4, n, 64)) if heads else (lambda n: (s, n, D))
    q, k, v, do = (_rn(gen, *shape(n)) for n in (nq, nk, nk, nq))
    mq = torch.rand(s, nq, generator=gen, device="cuda") > 0.2
    mk = torch.rand(s, nk, generator=gen, device="cuda") > 0.2
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if heads:
        out = fa.fused_attention(*leaves, mq, mk)
    else:
        out = fa.fused_attention_packed(*leaves, mq, mk, 4)
    first = torch.autograd.grad(out, leaves, do, retain_graph=True)
    second = torch.autograd.grad(out, leaves, do)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("kernel", ["log_assignment", "attention_packed", "cross_stacked",
                                    "attention_heads", "cross_heads"])
def test_forwards_and_log_assignment_are_deterministic(gen, kernel):
    """K4 and the forward tile have no atomics: two calls on the same inputs
    give bit-identical outputs (and log-sum-exps). The keys past the first
    64 of the second set are masked, so their tiles are skipped; the fourth
    set has no valid key and gets exact zero rows with lse 0."""
    lib = _ext.load("log_assignment" if kernel == "log_assignment" else "attention")
    stream = torch.cuda.current_stream().cuda_stream
    s, nq, nk = 4, 200, 150
    mq, mk = _mask(gen, s, nq), _mask(gen, s, nk)
    mk[1, 64:] = False
    mk[3] = False
    if kernel == "log_assignment":
        args = (_rn(gen, s, nq, D, scale=D**-0.25), _rn(gen, s, nk, D, scale=D**-0.25),
                _rn(gen, s, nq), _rn(gen, s, nk), mq, mk)
        run = lambda: la.launch_log_assignment(lib, stream, *args)
    elif kernel == "attention_packed":
        q, k, v = (_rn(gen, s, n, D) for n in (nq, nk, nk))
        run = lambda: fa.launch_attention_fwd(lib, stream, q, k, v, mq, mk, 4, 0.125)
    elif kernel == "cross_stacked":
        qk, v = _rn(gen, s, nk, D), _rn(gen, s, nk, D)
        run = lambda: fa.launch_cross_fwd_stacked(lib, stream, qk, v, mk, 4, 0.125)
    elif kernel == "attention_heads":
        q, k, v = (_rn(gen, s, 4, n, 64) for n in (nq, nk, nk))
        run = lambda: fa.launch_attention_fwd_heads(lib, stream, q, k, v, mq, mk, 0.125)
    else:
        qk0, v0 = _rn(gen, s, 4, nq, 64), _rn(gen, s, 4, nq, 64)
        qk1, v1 = _rn(gen, s, 4, nk, 64), _rn(gen, s, 4, nk, 64)
        run = lambda: fa.launch_cross_fwd_heads(lib, stream, qk0, qk1, v0, v1, mq, mk, 0.125)
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    if kernel in ("attention_packed", "attention_heads"):
        out, lse = first
        assert float(out[3].abs().max()) == 0.0 and float(lse[3].abs().max()) == 0.0


@pytest.mark.parametrize("b,h,w", [(2, 64, 96), (1, 100, 76), (3, 480, 640)])
def test_block0_matches_plain(gen, b, h, w):
    """K8 against its plain version: tile-aligned, ragged and the main shape,
    with a bright border."""
    image = torch.rand(b, h, w, 1, generator=gen, device="cuda") * 0.5
    image[:, :2], image[:, -2:], image[:, :, :2], image[:, :, -2:] = 1.0, 1.0, 1.0, 1.0
    pos = lambda: torch.rand(64, generator=gen, device="cuda") + 0.5
    weights = (_rn(gen, 3, 3, 1, 64, scale=0.3), _rn(gen, 64, scale=0.1), pos(),
               _rn(gen, 64, scale=0.1), _rn(gen, 3, 3, 64, 64, scale=0.05),
               _rn(gen, 64, scale=0.1), pos(), _rn(gen, 64, scale=0.1))
    before = b0.block0_fused.launches
    out = b0.block0_fused(image, *weights)
    assert b0.block0_fused.launches == before + 1
    ref = b0.block0_plain(image, *weights)
    assert out.shape == (b, h // 2, w // 2, 64) and out.dtype == torch.bfloat16
    _close(out, ref, torch.bfloat16)
    assert float((out.float() - ref.float()).abs().mean()) < 1e-3


def test_wrappers_check_their_inputs(gen):
    x = _rn(gen, 2, 64, D, dtype=torch.float16)
    w = _weights(gen, torch.float16, cross=True)
    with pytest.raises(TypeError):
        lb.fused_cross_block(x, None, *w, masked=False)
    # two bytes off a 16-byte boundary: the kernels copy rows in 16-byte pieces
    x = _rn(gen, 2 * 64 * D + 1, dtype=torch.bfloat16)[1:].view(2, 64, D)
    with pytest.raises(ValueError):
        lb.fused_cross_block(x, None, *_weights(gen, torch.bfloat16, cross=True), masked=False)
    with pytest.raises(ValueError):  # heads of width 32
        fa.fused_attention_packed(*(_rn(gen, 2, 64, 128) for _ in range(3)), num_heads=4)
    with pytest.raises(ValueError):
        fa.fused_attention(*(_rn(gen, 2, 4, 64, 32) for _ in range(3)))
    with pytest.raises(ValueError):  # odd height
        b0.block0_fused(torch.zeros(1, 31, 32, 1, device="cuda"),
                        *(torch.zeros(s, device="cuda") for s in (
                            (3, 3, 1, 64), (64,), (64,), (64,), (3, 3, 64, 64), (64,), (64,), (64,))))
