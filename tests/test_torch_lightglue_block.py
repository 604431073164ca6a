"""Parity of the port's plain LightGlue blocks (ops/lightglue_block.py) with
the JAX package's whole-block Pallas kernels, run in interpret mode on the
CPU: fused_self_block / fused_cross_block (N <= 1024) and their _v2
variants (1024 < N <= 2048).

Tolerance in fp32, atol 5e-3: the Pallas side normalises the softmax with
an approximate reciprocal and computes GELU with a polynomial erf; the port
uses exact division and erf. In bf16 (one case each for self and cross) the
plain version is what the card holds the tensor-core kernels against, so its
rounding points are held to the TPU kernel's here: both round q, k, v, the
context, the message, the GELU output and the block output to bf16; the
TPU kernel also rounds the unnormalised softmax weights for P V. Bars: the
card's kernel bar, atol 0.0625 + rtol 0.03 (a value on a rounding boundary
lands one bf16 ulp apart, 0.03125 at |y| in [4, 8)), and a mean absolute
error under 2e-3 (a rounding point moved shifts every entry).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.ops import pallas_lightglue_block as jblk
from gluefactory_tpu_torch.ops import lightglue_block as tblk

D, H = 256, 4


def _weights(rng, cross):
    def w(din, dout):
        return (rng.randn(din, dout) / np.sqrt(din)).astype(np.float32)

    def b(k):
        return (0.1 * rng.randn(k)).astype(np.float32)

    pre = [w(D, D), b(D), w(D, D), b(D)] if cross else [w(D, 3 * D), b(3 * D)]
    ln_scale = (1.0 + 0.1 * rng.randn(2 * D)).astype(np.float32)
    return pre + [w(D, D), b(D), w(2 * D, 2 * D), b(2 * D), ln_scale, b(2 * D),
                  w(2 * D, D), b(D)]


def _inputs(seed, s, n, masked):
    rng = np.random.RandomState(seed)
    x = rng.randn(s, n, D).astype(np.float32)
    angles = rng.rand(s, n, D // H // 2).astype(np.float32) * 6.0
    cos = np.repeat(np.cos(angles), 2, axis=-1)
    sin = np.repeat(np.sin(angles), 2, axis=-1)
    mask = np.ones((s, n), bool)
    if masked:
        mask[0, -n // 4:] = False
        mask[-1, -n // 3:] = False
    return rng, x, cos, sin, mask


# the same values on both sides: numpy fp32 arrays, cast to bf16 when asked
_JT = {False: jnp.asarray, True: lambda a: jnp.asarray(a).astype(jnp.bfloat16)}
_TT = {False: torch.from_numpy, True: lambda a: torch.from_numpy(a).bfloat16()}


def _self(seed, s, n, masked, v2, bf16=False):
    rng, x, cos, sin, mask = _inputs(seed, s, n, masked)
    w = _weights(rng, cross=False)
    jt, tt = _JT[bf16], _TT[bf16]
    enc = jnp.asarray(np.stack([cos, sin]))
    dt = jnp.bfloat16 if bf16 else jnp.float32
    if v2:
        jc, ja, jb = jblk.rotary_tables(enc, dt)
        ref = jblk.fused_self_block_v2(
            jt(x), jc, ja, jb, jnp.asarray(mask.astype(np.int32)),
            *map(jt, w), num_heads=H, block_q=128, interpret=True, masked=masked)
    else:
        jc, ja, jb = jblk.rotary_tables(jnp.tile(enc, (1, 1, 1, H)), dt)
        ref = jblk.fused_self_block(
            jt(x), jc, ja, jb, jnp.asarray(mask.astype(np.int32)),
            *map(jt, w), num_heads=H, interpret=True, masked=masked)
    out = tblk.fused_self_block(
        tt(x), tt(cos), tt(sin), torch.from_numpy(mask), *map(tt, w), num_heads=H,
        masked=masked)
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


def _cross(seed, s, n, masked, v2, bf16=False):
    rng, x, _, _, mask = _inputs(seed, s, n, masked)
    w = _weights(rng, cross=True)
    jt, tt = _JT[bf16], _TT[bf16]
    # the model runs the v2 kernels with block_q=128 (lightglue.py:557, :576)
    fn, bq = (jblk.fused_cross_block_v2, 128) if v2 else (jblk.fused_cross_block, 512)
    ref = fn(jt(x), jnp.asarray(mask.astype(np.int32)), *map(jt, w),
             num_heads=H, block_q=bq, interpret=True, masked=masked)
    out = tblk.fused_cross_block(
        tt(x), torch.from_numpy(mask), *map(tt, w), num_heads=H, masked=masked)
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


def _close_bf16(out, ref):
    np.testing.assert_allclose(out, ref, atol=0.0625, rtol=0.03)
    assert np.abs(out - ref).mean() < 2e-3


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("masked", [False, True])
def test_self_block_matches_pallas(n, masked):
    out, ref = _self(n + masked, 4, n, masked, v2=False)
    np.testing.assert_allclose(out, ref, atol=5e-3)


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_block_matches_pallas(n, masked):
    out, ref = _cross(n + masked, 4, n, masked, v2=False)
    np.testing.assert_allclose(out, ref, atol=5e-3)


@pytest.mark.parametrize("block", ["self", "cross"])
def test_block_matches_pallas_bf16(block):
    fn = _self if block == "self" else _cross
    out, ref = fn(128 + (block == "cross"), 4, 128, True, v2=False, bf16=True)
    _close_bf16(out, ref)


def test_self_block_matches_pallas_v2_large_n():
    out, ref = _self(11, 2, 1152, True, v2=True)
    np.testing.assert_allclose(out, ref, atol=5e-3)


def test_cross_block_matches_pallas_v2_large_n():
    out, ref = _cross(12, 2, 1152, True, v2=True)
    np.testing.assert_allclose(out, ref, atol=5e-3)


def test_cuda_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain version and launch nothing."""
    rng, x, cos, sin, mask = _inputs(3, 2, 64, True)
    w = [torch.from_numpy(a) for a in _weights(rng, cross=False)]
    t = [torch.from_numpy(a) for a in (x, cos, sin, mask)]
    before = tblk.fused_self_block.launches
    out = tblk.fused_self_block(*t, *w)
    assert tblk.fused_self_block.launches == before
    torch.testing.assert_close(out, tblk.self_block(*t, *w), atol=0, rtol=0)
