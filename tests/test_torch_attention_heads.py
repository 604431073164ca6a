"""The port's per-head attention entries (`ops.attention.self_attention`,
`masked_attention`, `cross_attention_bidirectional`) against the JAX package
on the CPU.

The JAX side runs its Pallas kernels `fused_attention` and
`fused_cross_attention` in interpret mode (what they select off the TPU) and
its XLA path (`impl="xla"`); gradients are `jax.grad` of a weighted sum, so
the Pallas side runs its backward kernel in interpret mode. The port runs on
CPU tensors: the plain forward and the plain explicit backward formula,
through the same `torch.autograd.Function`s that launch the CUDA kernels on
the card. Tolerances: forward 2e-5 abs, gradients 1e-4 abs (fp32, summation
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.ops import attention as jattn
from gluefactory_tpu.ops import pallas_attention as jpallas
from gluefactory_tpu_torch.ops import attention as tattn
from gluefactory_tpu_torch.ops import fused_attention as fa

B, H, DH = 2, 2, 64
FWD, BWD = 2e-5, 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _mask(rng, n, kind):
    """None, a ~70% valid mask, or one whose last batch element is all
    invalid ("empty")."""
    if kind == "none":
        return None
    mask = rng.rand(B, n) > 0.3
    mask[:, 0] = True
    if kind == "empty":
        mask[-1] = False
    return mask


def _close(out, ref, atol):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=0)


jm = lambda m: None if m is None else jnp.asarray(m)
tm = lambda m: None if m is None else torch.from_numpy(m)


@pytest.mark.parametrize("nq,nk,kq,kk", [
    (48, 48, "none", "none"),
    (40, 56, "masked", "masked"),   # Nq != Nk, a query row masked out
    (40, 56, "masked", "empty"),    # a batch element with no valid key
    (56, 40, "none", "masked"),     # only the keys are masked
])
def test_masked_attention_forward_and_gradients(nq, nk, kq, kk):
    rng = np.random.RandomState(nq + 2 * nk + len(kq) + 3 * len(kk))
    q, k, v, g = (rng.randn(B, H, n, DH).astype(np.float32) for n in (nq, nk, nk, nq))
    mq, mk = _mask(rng, nq, kq), _mask(rng, nk, kk)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v))

    def weighted(fn):
        return lambda *a: jnp.sum(fn(*a) * jnp.asarray(g))

    pallas = lambda q, k, v: jpallas.fused_attention(q, k, v, jm(mq), jm(mk))
    xla = lambda q, k, v: jattn.masked_attention(q, k, v, jm(mq), jm(mk), impl="xla")
    ref, ref_xla = pallas(*jargs), xla(*jargs)
    grads = jax.grad(weighted(pallas), argnums=(0, 1, 2))(*jargs)
    grads_xla = jax.grad(weighted(xla), argnums=(0, 1, 2))(*jargs)

    tin = [_t(a, True) for a in (q, k, v)]
    out = tattn.masked_attention(*tin, tm(mq), tm(mk))
    assert out.dtype == torch.float32 and out.shape == (B, H, nq, DH)
    _close(out, ref, FWD)
    _close(out, ref_xla, FWD)
    if mq is not None:  # zeros at invalid query rows
        assert float(out.detach().transpose(1, 2)[~tm(mq)].abs().max()) == 0.0
    if kk == "empty":  # ... and where no key is valid
        assert float(out.detach()[-1].abs().max()) == 0.0
    (out * _t(g)).sum().backward()
    for t, rg, rx in zip(tin, grads, grads_xla):
        _close(t.grad, rg, BWD)
        _close(t.grad, rx, BWD)
    # the explicit backward against torch.autograd of the plain forward
    ain = [_t(a, True) for a in (q, k, v)]
    (tattn.attention_heads(*ain, tm(mq), tm(mk), DH**-0.5) * _t(g)).sum().backward()
    for t, a in zip(tin, ain):
        _close(t.grad, a.grad.numpy(), BWD)
        assert torch.isfinite(a.grad).all()


@pytest.mark.parametrize("kind", ["none", "masked", "empty"])
def test_self_attention_matches_jax(kind):
    rng = np.random.RandomState(len(kind))
    n = 48
    q, k, v = (rng.randn(B, H, n, DH).astype(np.float32) for _ in range(3))
    mask = _mask(rng, n, kind)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    out = tattn.self_attention(_t(q), _t(k), _t(v), tm(mask))
    _close(out, jattn.self_attention(*jargs, jm(mask), impl="pallas"), FWD)
    _close(out, jattn.self_attention(*jargs, jm(mask), impl="xla"), FWD)


@pytest.mark.parametrize("m,n,kind", [(48, 48, "none"), (56, 40, "masked"), (40, 72, "empty")])
def test_cross_attention_bidirectional_forward_and_gradients(m, n, kind):
    rng = np.random.RandomState(m + n + len(kind))
    qk0, v0, g0 = (rng.randn(B, H, m, DH).astype(np.float32) for _ in range(3))
    qk1, v1, g1 = (rng.randn(B, H, n, DH).astype(np.float32) for _ in range(3))
    m0, m1 = _mask(rng, m, kind), _mask(rng, n, kind)
    jargs = tuple(jnp.asarray(a) for a in (qk0, qk1, v0, v1))

    def weighted(fn):
        def total(*a):
            o0, o1 = fn(*a)
            return jnp.sum(o0 * jnp.asarray(g0)) + jnp.sum(o1 * jnp.asarray(g1))
        return total

    pallas = lambda *a: jpallas.fused_cross_attention(*a, jm(m0), jm(m1))
    xla = lambda *a: jattn.cross_attention_bidirectional(*a, jm(m0), jm(m1), impl="xla")
    ref, ref_xla = pallas(*jargs), xla(*jargs)
    grads = jax.grad(weighted(pallas), argnums=(0, 1, 2, 3))(*jargs)
    grads_xla = jax.grad(weighted(xla), argnums=(0, 1, 2, 3))(*jargs)

    tin = [_t(a, True) for a in (qk0, qk1, v0, v1)]
    out = tattn.cross_attention_bidirectional(*tin, tm(m0), tm(m1))
    for o, r, x in zip(out, ref, ref_xla):
        _close(o, r, FWD)
        _close(o, x, FWD)
    ((out[0] * _t(g0)).sum() + (out[1] * _t(g1)).sum()).backward()
    for t, rg, rx in zip(tin, grads, grads_xla):
        _close(t.grad, rg, BWD)
        _close(t.grad, rx, BWD)
    ain = [_t(a, True) for a in (qk0, qk1, v0, v1)]
    a0, a1 = tattn.cross_attention_heads(*ain, tm(m0), tm(m1))
    ((a0 * _t(g0)).sum() + (a1 * _t(g1)).sum()).backward()
    for t, a in zip(tin, ain):
        _close(t.grad, a.grad.numpy(), BWD)
        assert torch.isfinite(a.grad).all()


def test_entries_keep_the_input_type():
    rng = np.random.RandomState(9)
    x = [torch.from_numpy(rng.randn(B, H, 32, DH).astype(np.float32)).bfloat16()
         for _ in range(4)]
    assert tattn.masked_attention(*x[:3]).dtype == torch.bfloat16
    m0, m1 = tattn.cross_attention_bidirectional(*x)
    assert m0.dtype == m1.dtype == torch.bfloat16
    # fp32 inside: the bf16 result is the fp32 one rounded once
    ref = fa.fused_attention(*(t.float() for t in x[:3]))
    assert torch.equal(tattn.masked_attention(*x[:3]), ref.bfloat16())
