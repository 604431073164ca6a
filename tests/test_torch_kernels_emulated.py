"""The port's CUDA kernel sources, run on the CPU through a host-compiler
emulation of the CUDA subset they use (tests/cuda_emu), against the plain
PyTorch versions.

This holds the kernels' indexing, tiling, masking and reductions without a
GPU; what it cannot hold is anything the GPU compiler or hardware decides
(that is chip_smoke.py's job). Small ragged shapes (N not a multiple of the
64-row tiles) exercise the edges. Tolerances: fp32 within 2e-5 (summation
order); bf16 within one bf16 ulp at the outputs' magnitude (atol 0.0625 +
rtol 0.02). The bf16 block kernels, block 0 and the attention backward run
their tensor-core code (bf16 and TF32 mma.sync, ldmatrix, cp.async, lane
shuffles) through the warp stand-ins of tests/cuda_emu, which two tests hold
against torch.matmul directly; the TF32 mma reads only a register's top 19
bits, as the card does, so the backward holds the fp32 bar only through its
3-pass split.
"""

import ctypes
import shutil
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

ROOT = Path(__file__).resolve().parent.parent
EMU = Path(__file__).resolve().parent / "cuda_emu"
D = 256


CSRC = ROOT / "gluefactory_tpu_torch" / "csrc"


def _emu_build(cxx, source, target):
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-include", "cuda_runtime.h",
           f"-I{EMU}", f"-I{CSRC}", "-x", "c++", str(source), "-o", str(target), "-lpthread"]
    return subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_emu")
    procs = {}
    for name in _ext.SIGNATURES:
        target = out / f"lib{name}.so"
        procs[name] = (_emu_build(cxx, CSRC / f"{name}.cu", target), target)
    loaded = {}
    for name, (proc, target) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in _ext.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def test_warp_mma_stand_in_matches_matmul(tmp_path):
    """One warp: A (16 x 16) by ldmatrix, B (16 x 16) by ldmatrix.trans, two
    mma.sync m16n8k16 and quad row sums by __shfl_xor_sync, against
    torch.matmul of the same bf16 values in fp32 (products of bf16 are exact
    in fp32; 1e-5 covers the order of the 16-term sums)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    target = tmp_path / "libmma_probe.so"
    proc = _emu_build(cxx, EMU / "mma_probe.cu", target)
    assert proc.wait() == 0, proc.stderr.read()
    lib = ctypes.CDLL(str(target))
    lib.mma_probe.argtypes = [ctypes.c_void_p] * 4
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(16, 16, generator=gen).bfloat16()
    b = torch.randn(16, 16, generator=gen).bfloat16()
    d, rowsum = torch.zeros(16, 16), torch.zeros(16)
    assert lib.mma_probe(a.data_ptr(), b.data_ptr(), d.data_ptr(), rowsum.data_ptr()) == 0
    ref = torch.matmul(a.float(), b.float())
    torch.testing.assert_close(d, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rowsum, ref.sum(1), atol=1e-4, rtol=1e-5)


def test_warp_tf32_mma_stand_in_matches_matmul(tmp_path):
    """One warp: fp32 A (16 x 16) by B (16 x 8) in two mma.sync m16n8k8 on
    TF32 registers. The stand-in reads only a register's top 19 bits, as the
    tensor core does, so the 3-pass split (hi = x rounded to TF32, lo = x -
    hi; lo.hi + hi.lo + hi.hi) is within 2e-6 of an fp32 matmul, and one pass
    on the raw fp32 values is not (it keeps about three decimal digits)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    target = tmp_path / "libmma_probe.so"
    proc = _emu_build(cxx, EMU / "mma_probe.cu", target)
    assert proc.wait() == 0, proc.stderr.read()
    lib = ctypes.CDLL(str(target))
    lib.mma_probe_tf32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    gen = torch.Generator().manual_seed(6)
    a, b = torch.randn(16, 16, generator=gen), torch.randn(16, 8, generator=gen)
    ref = (a.double() @ b.double()).float()
    for split in (1, 0):
        d = torch.zeros(16, 8)
        assert lib.mma_probe_tf32(a.data_ptr(), b.data_ptr(), d.data_ptr(), split) == 0
        err = float((d - ref).abs().max())
        assert err < 2e-6 if split else err > 1e-4, (split, err)


def _weights(gen, dtype, cross):
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dtype)
    w = lambda din, dout: rn(din, dout, scale=din**-0.5)
    b = lambda k: rn(k, scale=0.1)
    pre = [w(D, D), b(D), w(D, D), b(D)] if cross else [w(D, 3 * D), b(3 * D)]
    ln = (1 + torch.randn(2 * D, generator=gen) * 0.1).to(dtype)
    return pre + [w(D, D), b(D), w(2 * D, 2 * D), b(2 * D), ln, b(2 * D), w(2 * D, D), b(D)]


def _close(out, ref, dtype):
    atol, rtol = (2e-5, 1e-5) if dtype == torch.float32 else (0.0625, 0.02)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,masked", [(torch.float32, True), (torch.bfloat16, True),
                                          (torch.bfloat16, False), (torch.float32, False)])
def test_block_kernels_match_plain(libs, dtype, masked):
    gen = torch.Generator().manual_seed(int(masked) + 2 * (dtype == torch.bfloat16))
    s, n = 2, 72
    x = torch.randn(s, n, D, generator=gen).to(dtype)
    angles = torch.rand(s, n, 32, generator=gen) * 6
    cos = torch.cos(angles).repeat_interleave(2, -1).to(dtype).contiguous()
    sin = torch.sin(angles).repeat_interleave(2, -1).to(dtype).contiguous()
    mask = torch.rand(s, n, generator=gen) > 0.3
    mask[1] = False  # a set with no valid token
    kmask = mask if masked else None
    lib = libs["lightglue_block"]

    w = _weights(gen, dtype, cross=False)
    out = lb.launch_self_block(lib, None, x, cos, sin, kmask, *w, 4)
    _close(out, lb.self_block(x, cos, sin, mask, *w, masked=masked), dtype)

    w = _weights(gen, dtype, cross=True)
    out = lb.launch_cross_block(lib, None, x, kmask, *w, 4)
    _close(out, lb.cross_block(x, mask, *w, masked=masked), dtype)


@pytest.mark.parametrize("masked", [False, True, "padded"])
def test_log_assignment_kernels_match_plain(libs, masked):
    """K4 at a ragged (M, N), two 64 x 64 tiles each way; "padded": batch
    element 1 has no valid row past 63 (a row tile half padded) and batch
    element 0 no valid column. Two calls give bit-identical outputs."""
    gen = torch.Generator().manual_seed(7 + (masked is True))
    b, m, n, d = 2, 70, 90, 64
    d0 = torch.randn(b, m, d, generator=gen) / d**0.25
    d1 = torch.randn(b, n, d, generator=gen) / d**0.25
    z0, z1 = torch.randn(b, m, generator=gen), torch.randn(b, n, generator=gen)
    masks = (torch.rand(b, m, generator=gen) > 0.25,
             torch.rand(b, n, generator=gen) > 0.25) if masked else (None, None)
    if masked == "padded":
        masks[0][1, 64:] = False
        masks[1][0] = False
    out = la.launch_log_assignment(libs["log_assignment"], None, d0, d1, z0, z1, *masks)
    ref = la.log_assignment(d0, d1, z0, z1, *masks)
    for o, r in zip(out, ref):
        if o.dtype == torch.int32:
            torch.testing.assert_close(o, r, atol=0, rtol=0)
        else:
            torch.testing.assert_close(o, r, atol=2e-5, rtol=1e-5)
    again = la.launch_log_assignment(libs["log_assignment"], None, d0, d1, z0, z1, *masks)
    assert all(torch.equal(o, a) for o, a in zip(out, again))


# ----------------------------------------------------- training attention
AD, AH, SCALE = 128, 2, 0.125  # two heads of width 64


def _attn_inputs(dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen).to(dtype)
    mask = lambda *s: torch.rand(*s, generator=gen) > 0.3
    return gen, rn, mask


@pytest.mark.parametrize("dtype,masked", [(torch.float32, True), (torch.float32, False),
                                          (torch.bfloat16, True)])
def test_attention_forward_and_backward_kernels_match_plain(libs, dtype, masked):
    """Separate query and key sets (the cross form of the backward), ragged
    lengths, one set without a valid key."""
    _, rn, mask = _attn_inputs(dtype, 20 + masked)
    s, nq, nk = 2, 70, 90
    q, k, v, do = rn(s, nq, AD), rn(s, nk, AD), rn(s, nk, AD), rn(s, nq, AD)
    mq, mk = (mask(s, nq), mask(s, nk)) if masked else (None, None)
    if masked:
        mk[1] = False
    lib = libs["attention"]
    out, lse = fa.launch_attention_fwd(lib, None, q, k, v, mq, mk, AH, SCALE)
    _close(out, plain.masked_attention_packed(q, k, v, mq, mk, AH, SCALE), dtype)
    if masked:
        assert float(out[~mq].float().abs().max()) == 0.0
        assert float(out[1].float().abs().max()) == 0.0
    grads = fa.launch_attention_bwd(lib, None, q, k, v, out, lse, mq, mk, do, AH, SCALE)
    for g, ref in zip(grads, plain.attention_backward(q, k, v, mq, mk, do, AH, SCALE)):
        _close(g, ref, dtype)
    if dtype == torch.float32:  # and against autograd of the plain forward
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        plain.masked_attention_packed(*leaves, mq, mk, AH, SCALE).backward(do)
        for g, leaf in zip(grads, leaves):
            _close(g, leaf.grad, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_kernels_match_plain(libs, dtype):
    _, rn, mask = _attn_inputs(dtype, 30)
    lib = libs["attention"]
    b, n = 2, 70
    qk, v, m = rn(2 * b, n, AD), rn(2 * b, n, AD), mask(2 * b, n)
    for mk in (m, None):
        out, _ = fa.launch_cross_fwd_stacked(lib, None, qk, v, mk, AH, SCALE)
        m0, m1 = plain.cross_attention_bidirectional_stacked(qk, v, mk, AH)
        _close(out[:b], m0, dtype)
        _close(out[b:], m1, dtype)
    mm, nn = 70, 100  # M != N, on either side of a tile edge
    qk0, v0, qk1, v1 = rn(b, mm, AD), rn(b, mm, AD), rn(b, nn, AD), rn(b, nn, AD)
    mask0, mask1 = mask(b, mm), mask(b, nn)
    o0, o1, _, _ = fa.launch_cross_fwd_pair(lib, None, qk0, qk1, v0, v1, mask0, mask1, AH, SCALE)
    m0, m1 = plain.cross_attention_bidirectional_packed(qk0, qk1, v0, v1, mask0, mask1, AH)
    _close(o0, m0, dtype)
    _close(o1, m1, dtype)


def _lse_reference(q, k, mq, mk, scale):
    """Log-sum-exp of the scaled logits over the valid keys, per-head layout
    (S, H, N, 64); 0 for an invalid query row and for a set without a valid
    key, as the forward kernels write it."""
    logits = torch.einsum("shid,shjd->shij", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits.masked_fill(~mk[:, None, None, :], float("-inf")), -1)
    live = mq[:, None, :] & mk.any(-1)[:, None, None]
    return torch.where(live, lse, torch.zeros_like(lse))


def _padded_keys(mask, sets, n):
    """A ~70% valid mask whose second-last set has no valid key past 63 (its
    later key tiles hold none) and whose last set has none at all."""
    m = mask(sets, n)
    m[-2, 64:] = False
    m[-1] = False
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["attention_packed", "cross_stacked", "cross_pair",
                                    "attention_heads", "cross_heads", "block"])
def test_forward_kernels_skip_key_tiles_without_a_valid_key(libs, kernel, dtype):
    """Every forward of the tile (K5, K6b, K6a, K7a, K7c, the block
    attention) with whole key tiles masked: 150 keys, so three 64-key tiles,
    of which a set's last two, or all three, hold no valid key and are
    skipped. Against the plain versions; queries that see no valid key get
    exact zero rows, and (K5, K7a) lse 0."""
    _, rn, mask = _attn_inputs(dtype, 70)
    lib = libs["attention"]
    nq, nk = 70, 150
    if kernel in ("attention_packed", "attention_heads"):
        shape = (lambda n: (2, AH, n, 64)) if kernel == "attention_heads" else (lambda n: (2, n, AD))
        q, k, v = rn(*shape(nq)), rn(*shape(nk)), rn(*shape(nk))
        mq, mk = mask(2, nq), _padded_keys(mask, 2, nk)
        if kernel == "attention_heads":
            out, lse = fa.launch_attention_fwd_heads(lib, None, q, k, v, mq, mk, SCALE)
            _close(out, plain.attention_heads(q, k, v, mq, mk, SCALE), dtype)
            heads = lambda t: t
        else:
            out, lse = fa.launch_attention_fwd(lib, None, q, k, v, mq, mk, AH, SCALE)
            _close(out, plain.masked_attention_packed(q, k, v, mq, mk, AH, SCALE), dtype)
            heads = lambda t: t.reshape(2, -1, AH, 64).transpose(1, 2)
        _close(lse, _lse_reference(heads(q), heads(k), mq, mk, SCALE), torch.float32)
        assert float(out[1].float().abs().max()) == 0.0 and float(lse[1].abs().max()) == 0.0
        return
    if kernel in ("cross_stacked", "block"):  # two pairs: sets (0, 2) and (1, 3)
        qk, v, m = rn(4, nk, AD), rn(4, nk, AD), _padded_keys(mask, 4, nk)
        if kernel == "block":
            run, out = lb._attention_step(libs["lightglue_block"], None, qk, qk, v, m, AH, 2,
                                          SCALE)
            run()
        else:
            out, _ = fa.launch_cross_fwd_stacked(lib, None, qk, v, m, AH, SCALE)
        partner = [2, 3, 0, 1]
        ref = plain.masked_attention_packed(qk, qk[partner], v[partner], m, m[partner], AH,
                                            SCALE)
        _close(out, ref, dtype)
        assert float(out[1].float().abs().max()) == 0.0  # its partner, set 3, has no key
        return
    heads = kernel == "cross_heads"
    shape = (lambda n: (2, AH, n, 64)) if heads else (lambda n: (2, n, AD))
    qk0, v0, qk1, v1 = rn(*shape(nq)), rn(*shape(nq)), rn(*shape(nk)), rn(*shape(nk))
    mask0, mask1 = mask(2, nq), _padded_keys(mask, 2, nk)
    if heads:
        o0, o1, _, _ = fa.launch_cross_fwd_heads(lib, None, qk0, qk1, v0, v1, mask0, mask1,
                                                 SCALE)
        m0, m1 = plain.cross_attention_heads(qk0, qk1, v0, v1, mask0, mask1)
    else:
        o0, o1, _, _ = fa.launch_cross_fwd_pair(lib, None, qk0, qk1, v0, v1, mask0, mask1, AH,
                                                SCALE)
        m0, m1 = plain.cross_attention_bidirectional_packed(qk0, qk1, v0, v1, mask0, mask1, AH)
    _close(o0, m0, dtype)
    _close(o1, m1, dtype)
    assert float(o0[1].float().abs().max()) == 0.0


# ------------------------------------------------------ the per-head entries
@pytest.mark.parametrize("dtype,masked", [(torch.float32, True), (torch.float32, False),
                                          (torch.bfloat16, True)])
def test_attention_heads_kernels_match_plain(libs, dtype, masked):
    """K7a and the backward on the per-head layout: Nq != Nk, ragged lengths,
    one batch element without a valid key."""
    _, rn, mask = _attn_inputs(dtype, 40 + masked)
    b, h, nq, nk, dh = 2, 2, 70, 90, 64
    q, k, v, do = rn(b, h, nq, dh), rn(b, h, nk, dh), rn(b, h, nk, dh), rn(b, h, nq, dh)
    mq, mk = (mask(b, nq), mask(b, nk)) if masked else (None, None)
    if masked:
        mk[1] = False
    lib = libs["attention"]
    out, lse = fa.launch_attention_fwd_heads(lib, None, q, k, v, mq, mk, SCALE)
    _close(out, plain.attention_heads(q, k, v, mq, mk, SCALE), dtype)
    if masked:
        assert float(out.transpose(1, 2)[~mq].float().abs().max()) == 0.0
        assert float(out[1].float().abs().max()) == 0.0
    grads = fa.launch_attention_bwd(lib, None, q, k, v, out, lse, mq, mk, do, h, SCALE)
    for g, ref in zip(grads, plain.attention_backward_heads(q, k, v, mq, mk, do, SCALE)):
        _close(g, ref, dtype)
    if dtype == torch.float32:  # and against autograd of the plain forward
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        plain.attention_heads(*leaves, mq, mk, SCALE).backward(do)
        for g, leaf in zip(grads, leaves):
            _close(g, leaf.grad, dtype)


@pytest.mark.parametrize("heads", [False, True])
def test_attention_backward_kernels_ragged_tiles(libs, heads):
    """K7b with five 32-row query tiles (both buffers of its double-buffered
    loop, each more than once) and fewer keys than one 64-row tile, fp32, on
    either layout."""
    _, rn, mask = _attn_inputs(torch.float32, 60 + heads)
    s, nq, nk = 1, 130, 47
    shape = (lambda n: (s, AH, n, 64)) if heads else (lambda n: (s, n, AD))
    q, k, v, do = rn(*shape(nq)), rn(*shape(nk)), rn(*shape(nk)), rn(*shape(nq))
    mq, mk = mask(s, nq), mask(s, nk)
    lib = libs["attention"]
    if heads:
        out, lse = fa.launch_attention_fwd_heads(lib, None, q, k, v, mq, mk, SCALE)
    else:
        out, lse = fa.launch_attention_fwd(lib, None, q, k, v, mq, mk, AH, SCALE)
    grads = fa.launch_attention_bwd(lib, None, q, k, v, out, lse, mq, mk, do, AH, SCALE)
    ref = (plain.attention_backward_heads(q, k, v, mq, mk, do, SCALE) if heads
           else plain.attention_backward(q, k, v, mq, mk, do, AH, SCALE))
    for g, r in zip(grads, ref):
        _close(g, r, torch.float32)


@pytest.mark.parametrize("masked", [True, False])
def test_cross_attention_heads_kernel_matches_plain(libs, masked):
    """K7c: both message sets from one launch, M != N on either side of a tile
    edge."""
    _, rn, mask = _attn_inputs(torch.float32, 50 + masked)
    b, h, m, n, dh = 2, 2, 70, 100, 64
    qk0, v0, qk1, v1 = rn(b, h, m, dh), rn(b, h, m, dh), rn(b, h, n, dh), rn(b, h, n, dh)
    mask0, mask1 = (mask(b, m), mask(b, n)) if masked else (None, None)
    o0, o1, _, _ = fa.launch_cross_fwd_heads(libs["attention"], None, qk0, qk1, v0, v1,
                                             mask0, mask1, SCALE)
    m0, m1 = plain.cross_attention_heads(qk0, qk1, v0, v1, mask0, mask1)
    _close(o0, m0, torch.float32)
    _close(o1, m1, torch.float32)


# ----------------------------------------------------- SuperPoint's block 0
def _block0_weights(gen):
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=gen) * scale
    pos = lambda: torch.rand(64, generator=gen) + 0.5
    return (rn(3, 3, 1, 64, scale=0.3), rn(64, scale=0.1), pos(), rn(64, scale=0.1),
            rn(3, 3, 64, 64, scale=0.05), rn(64, scale=0.1), pos(), rn(64, scale=0.1))


@pytest.mark.parametrize("b,h,w,blocks", [(1, 36, 44, 4), (2, 16, 18, 132), (1, 20, 52, 2)])
def test_block0_kernel_matches_plain(libs, b, h, w, blocks):
    """K8 on images whose pooled size is no multiple of the 8 x 8 tile, with a
    bright border (a halo that is not zeroed at the image edge shows there),
    a block walking over several tiles (the last case: four a block, so both
    of its double buffers are taken twice, and W / 2 = 26)."""
    gen = torch.Generator().manual_seed(h + w)
    image = torch.rand(b, h, w, 1, generator=gen) * 0.5
    image[:, :2], image[:, -2:], image[:, :, :2], image[:, :, -2:] = 1.0, 1.0, 1.0, 1.0
    weights = _block0_weights(gen)
    out = b0.launch_block0(libs["block0_conv"], None, image, *weights, blocks=blocks)
    ref = b0.block0_plain(image, *weights)
    assert out.shape == ref.shape == (b, h // 2, w // 2, 64) and out.dtype == torch.bfloat16
    _close(out, ref, torch.bfloat16)
    assert float((out.float() - ref.float()).abs().mean()) < 1e-3
