"""The port's training attention (packed self attention, bidirectional cross
attention, attention backward) against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode (what
`fused_attention_packed` etc. select off the TPU) and, for the forward,
also its XLA path; `jax.vjp` of the Pallas functions runs the backward
kernel in interpret mode. The port runs on CPU tensors: the plain forward
and the plain explicit backward formula, through the same
`torch.autograd.Function`s that launch the CUDA kernels on the card; the
explicit backward is also held against `torch.autograd` of the plain
forward. Tolerances: fp32 forward 1e-5 abs, backward 1e-4 abs (summation
order); bf16 forward 2e-2 against the Pallas kernels (inputs rounded to
bf16 on both sides, softmax in fp32; the JAX kernels round the unnormalised
probabilities to bf16 before the second product, the port's plain version
rounds the normalised ones, as the JAX package's XLA path does, which it
matches bit for bit but for the order of its fp32 sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.ops import attention as jattn
from gluefactory_tpu.ops import pallas_attention as jpallas
from gluefactory_tpu_torch.ops import attention as plain
from gluefactory_tpu_torch.ops import fused_attention as fa

H, D = 2, 64
FWD, BWD = 1e-5, 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _masks(rng, b, n, kind):
    if kind == "none":
        return None
    mask = rng.rand(b, n) > 0.3
    mask[:, 0] = True
    if kind == "empty_set":
        mask[-1] = False  # a set with no valid token: zero rows, zero gradients
    return mask


def _close(out, ref, atol):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("nq,nk,kind", [(64, 64, "none"), (48, 48, "masked"),
                                        (40, 56, "masked"), (48, 48, "empty_set")])
def test_self_attention_forward_and_backward(nq, nk, kind):
    rng = np.random.RandomState(nq + nk + len(kind))
    b = 2
    q, k, v, g = (rng.randn(b, n, D).astype(np.float32) for n in (nq, nk, nk, nq))
    mq, mk = _masks(rng, b, nq, kind), _masks(rng, b, nk, kind)
    if nq == nk:
        mk = mq
    elif mk is not None:
        mk[0] = False  # valid queries that see no valid key
    jm = lambda m: None if m is None else jnp.asarray(m)
    tm = lambda m: None if m is None else torch.from_numpy(m)

    ref, vjp = jax.vjp(lambda q, k, v: jpallas.fused_attention_packed(q, k, v, jm(mq), jm(mk), H),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(g))

    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = fa.fused_attention_packed(tq, tk, tv, tm(mq), tm(mk), H)
    _close(out, ref, FWD)
    if nq == nk:  # the XLA path takes one mask for queries and keys
        _close(out, jattn.self_attention_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm(mq), num_heads=H, impl="xla"), FWD)
    if mq is not None:
        assert float(out.detach()[~tm(mq)].abs().max()) == 0.0

    # the explicit backward (through the autograd.Function) against the JAX kernel
    out.backward(_t(g))
    for grad, rg in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        _close(grad, rg, BWD)
    # ... and against torch.autograd of the plain forward
    aq, ak, av = _t(q, True), _t(k, True), _t(v, True)
    plain.masked_attention_packed(aq, ak, av, tm(mq), tm(mk), H, (D // H) ** -0.5).backward(_t(g))
    for grad, auto in zip((tq.grad, tk.grad, tv.grad), (aq.grad, ak.grad, av.grad)):
        _close(grad, auto.numpy(), BWD)
        assert torch.isfinite(auto).all()


@pytest.mark.parametrize("m,n,kind", [(48, 48, "none"), (56, 40, "masked"),
                                      (40, 72, "empty_set")])
def test_cross_attention_packed_forward_and_backward(m, n, kind):
    rng = np.random.RandomState(m + n + len(kind))
    b = 2
    qk0, v0, g0 = (rng.randn(b, m, D).astype(np.float32) for _ in range(3))
    qk1, v1, g1 = (rng.randn(b, n, D).astype(np.float32) for _ in range(3))
    m0, m1 = _masks(rng, b, m, kind), _masks(rng, b, n, kind)
    jm = lambda x: None if x is None else jnp.asarray(x)
    tm = lambda x: None if x is None else torch.from_numpy(x)

    args = tuple(jnp.asarray(a) for a in (qk0, qk1, v0, v1))
    ref, vjp = jax.vjp(
        lambda *a: jpallas.fused_cross_attention_packed(*a, jm(m0), jm(m1), H), *args)
    ref_grads = vjp((jnp.asarray(g0), jnp.asarray(g1)))
    xla = jattn.cross_attention_bidirectional_packed(*args, jm(m0), jm(m1), num_heads=H, impl="xla")

    tin = [_t(a, True) for a in (qk0, qk1, v0, v1)]
    out = fa.fused_cross_attention_packed(*tin, tm(m0), tm(m1), H)
    for o, r, x in zip(out, ref, xla):
        _close(o, r, FWD)
        _close(o, x, FWD)
    torch.autograd.backward(out, (_t(g0), _t(g1)))
    for t, rg in zip(tin, ref_grads):
        _close(t.grad, rg, BWD)

    ain = [_t(a, True) for a in (qk0, qk1, v0, v1)]
    aout = plain.cross_attention_bidirectional_packed(*ain, tm(m0), tm(m1), H)
    torch.autograd.backward(aout, (_t(g0), _t(g1)))
    for t, a in zip(tin, ain):
        _close(t.grad, a.grad.numpy(), BWD)
        assert torch.isfinite(a.grad).all()


@pytest.mark.parametrize("kind", ["none", "masked", "empty_set"])
def test_cross_attention_stacked_forward_and_backward(kind):
    rng = np.random.RandomState(len(kind))
    b, n = 2, 48
    qk, v = (rng.randn(2 * b, n, D).astype(np.float32) for _ in range(2))
    g0, g1 = (rng.randn(b, n, D).astype(np.float32) for _ in range(2))
    mask = _masks(rng, 2 * b, n, kind)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)

    ref, vjp = jax.vjp(lambda qk, v: jpallas.fused_cross_attention_stacked(qk, v, jmask, H),
                       jnp.asarray(qk), jnp.asarray(v))
    ref_grads = vjp((jnp.asarray(g0), jnp.asarray(g1)))
    xla = jattn.cross_attention_bidirectional_stacked(
        jnp.asarray(qk), jnp.asarray(v), jmask, num_heads=H, impl="xla")

    tqk, tv = _t(qk, True), _t(v, True)
    out = fa.fused_cross_attention_stacked(tqk, tv, tmask, H)
    for o, r, x in zip(out, ref, xla):
        _close(o, r, FWD)
        _close(o, x, FWD)
    torch.autograd.backward(out, (_t(g0), _t(g1)))
    _close(tqk.grad, ref_grads[0], BWD)
    _close(tv.grad, ref_grads[1], BWD)

    aqk, av = _t(qk, True), _t(v, True)
    torch.autograd.backward(
        plain.cross_attention_bidirectional_stacked(aqk, av, tmask, H), (_t(g0), _t(g1)))
    _close(tqk.grad, aqk.grad.numpy(), BWD)
    _close(tv.grad, av.grad.numpy(), BWD)


@pytest.mark.parametrize("op", ["self", "stacked", "packed"])
def test_bf16_forward(op):
    rng = np.random.RandomState(3)
    b, n = 2, 48
    x = [rng.randn(2 * b if op == "stacked" else b, n, D).astype(np.float32) for _ in range(4)]
    mask = _masks(rng, 2 * b if op == "stacked" else b, n, "masked")
    jx = [jnp.asarray(a, jnp.bfloat16) for a in x]
    tx = [torch.from_numpy(a).bfloat16() for a in x]
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    if op == "self":
        ref = [jpallas.fused_attention_packed(*jx[:3], jmask, jmask, H)]
        out = [fa.fused_attention_packed(*tx[:3], tmask, tmask, H)]
    elif op == "stacked":
        ref = jpallas.fused_cross_attention_stacked(*jx[:2], jmask, H)
        out = fa.fused_cross_attention_stacked(*tx[:2], tmask, H)
    else:
        ref = jpallas.fused_cross_attention_packed(*jx, jmask, jmask, H)
        out = fa.fused_cross_attention_packed(*tx, tmask, tmask, H)
    for o, r in zip(out, ref):
        assert o.dtype == torch.bfloat16
        _close(o, np.asarray(r.astype(jnp.float32)), 2e-2)


def test_masked_rows_and_keys_are_exact_zeros():
    rng = np.random.RandomState(5)
    q, k, v = (_t(rng.randn(1, 16, D).astype(np.float32), True) for _ in range(3))
    mask = torch.ones(1, 16, dtype=torch.bool)
    mask[0, 5:] = False
    out = fa.fused_attention_packed(q, k, v, mask, mask, H)
    assert float(out.detach()[0, 5:].abs().max()) == 0.0
    out.sum().backward()
    # masked keys get weight exactly 0: no gradient reaches them
    for t in (q, k, v):
        assert float(t.grad[0, 5:].abs().max()) == 0.0


@pytest.mark.parametrize("op", ["self", "cross"])
def test_plain_bf16_attention_rounds_where_the_xla_path_does(op):
    """The port's plain bf16 attention (the path of `matcher.flash: False`
    and the reference of the bf16 kernels) against the JAX package's XLA
    path on the same bf16 inputs: ragged sets of 70 and 150 rows, masks, a
    set without a valid key. The self form against `self_attention_packed`
    (impl="xla"); each direction of the cross form against `masked_attention`
    (impl="xla") with the other set's keys and values, the function each
    direction is (the XLA cross form, `cross_attention_bidirectional`, run
    op by op also rounds qk * Dh**-0.25 to bf16 before its product,
    :128-131; jitted, as the JAX package's training step runs it, XLA's
    compiler drops that rounding, as the Pallas kernels and the port
    never make it). Both round the normalised
    probabilities to bf16 before the product with the values (:55-58); what
    is left is the order of the fp32 sums, which moves a probability across
    a bf16 rounding boundary now and then. So at least 99% of the outputs are
    bit-equal and none is more than 2**-7 (a bf16 ulp in [1, 2)) apart.
    Measured: 0.02% of the self form's outputs differ (max 2**-12) and none
    of the cross form's; with the probabilities kept in fp32, 14.8% of the
    self form's and 15.1% and 13.9% of the cross form's two (max 2**-8)."""
    rng = np.random.RandomState(11)
    b, m, n = 2, 70, 150
    mask0, mask1 = _masks(rng, b, m, "masked"), _masks(rng, b, n, "empty_set")
    heads = lambda a: a.reshape(b, -1, H, D).transpose(0, 2, 1, 3)
    packed = lambda a: a.transpose(0, 2, 1, 3).reshape(b, -1, H * D)
    if op == "self":
        x = [rng.randn(b, n, H * D).astype(np.float32) for _ in range(3)]
        jx = [jnp.asarray(a, jnp.bfloat16) for a in x]
        ref = [jattn.self_attention_packed(*jx, jnp.asarray(mask1), H, impl="xla")]
        out = [plain.self_attention_packed(*(torch.from_numpy(a).bfloat16() for a in x),
                                           torch.from_numpy(mask1), H)]
    else:
        x = [rng.randn(b, r, H * D).astype(np.float32) for r in (m, n, m, n)]
        qk0, qk1, v0, v1 = (heads(jnp.asarray(a, jnp.bfloat16)) for a in x)
        jm0, jm1 = jnp.asarray(mask0), jnp.asarray(mask1)
        ref = [packed(jattn.masked_attention(qk0, qk1, v1, jm0, jm1, impl="xla")),
               packed(jattn.masked_attention(qk1, qk0, v0, jm1, jm0, impl="xla"))]
        out = plain.cross_attention_bidirectional_packed(
            *(torch.from_numpy(a).bfloat16() for a in x), torch.from_numpy(mask0),
            torch.from_numpy(mask1), H)
    for o, r in zip(out, ref):
        assert o.dtype == torch.bfloat16
        diff = np.abs(o.float().numpy() - np.asarray(r.astype(jnp.float32)))
        assert float((diff == 0).mean()) >= 0.99, float((diff == 0).mean())
        assert float(diff.max()) <= 2.0**-7, float(diff.max())
