"""Parity of the port's assignment ops (gluefactory_tpu_torch/ops/assignment.py,
ops/log_assignment.py) with the JAX package on the CPU.

The JAX side runs `fused_log_assignment` in Pallas interpret mode, as the
JAX package's own tests do; the port runs its plain versions (CPU tensors).
Cases follow tests/test_pallas_kernels.py:378-411. Tolerances: scores
within 5e-5 (fp32, different summation order); matches exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.ops import assignment as jassign
from gluefactory_tpu.ops.pallas_assignment import (
    filter_matches_from_stats as j_filter_stats,
    fused_log_assignment as j_fused,
)
from gluefactory_tpu_torch.ops import assignment as tassign
from gluefactory_tpu_torch.ops.log_assignment import (
    filter_matches_from_stats,
    fused_log_assignment,
    log_assignment,
)


def _inputs(seed, b, m, n, d, masked):
    rng = np.random.RandomState(seed)
    d0 = (rng.randn(b, m, d) / d**0.25).astype(np.float32)
    d1 = (rng.randn(b, n, d) / d**0.25).astype(np.float32)
    z0 = rng.randn(b, m).astype(np.float32)
    z1 = rng.randn(b, n).astype(np.float32)
    mask0 = rng.rand(b, m) > 0.25 if masked else None
    mask1 = rng.rand(b, n) > 0.25 if masked else None
    return d0, d1, z0, z1, mask0, mask1


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("masked", [False, True])
def test_sigmoid_log_double_softmax_and_filter(masked):
    d0, d1, z0, z1, mask0, mask1 = _inputs(1, 2, 40, 30, 32, masked)
    sim = np.einsum("bmd,bnd->bmn", d0, d1)
    ref = jassign.sigmoid_log_double_softmax(
        _j(sim), _j(z0[..., None]), _j(z1[..., None]), _j(mask0), _j(mask1))
    out = tassign.sigmoid_log_double_softmax(
        _t(sim), _t(z0[..., None]), _t(z1[..., None]), _t(mask0), _t(mask1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5, rtol=1e-5)
    for th in (0.0, 0.1):
        rm = jassign.filter_matches(ref, th)
        tm = tassign.filter_matches(out, th)
        np.testing.assert_array_equal(tm[0].numpy(), np.asarray(rm[0]))
        np.testing.assert_array_equal(tm[1].numpy(), np.asarray(rm[1]))
        np.testing.assert_allclose(tm[2].numpy(), np.asarray(rm[2]), atol=1e-5)
        np.testing.assert_allclose(tm[3].numpy(), np.asarray(rm[3]), atol=1e-5)


@pytest.mark.parametrize("m,n,masked", [(96, 96, False), (200, 130, True), (300, 260, True)])
def test_log_assignment_matches_pallas(m, n, masked):
    d0, d1, z0, z1, mask0, mask1 = _inputs(m + n, 2, m, n, 64, masked)
    ref = j_fused(_j(d0), _j(d1), _j(z0), _j(z1), _j(mask0), _j(mask1))
    out = fused_log_assignment(_t(d0), _t(d1), _t(z0), _t(z1), _t(mask0), _t(mask1))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), atol=5e-5, rtol=1e-4)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("th", [0.0, 0.1])
def test_filter_matches_from_stats(th):
    d0, d1, z0, z1, mask0, mask1 = _inputs(7, 2, 180, 140, 64, True)
    _, *jstats = j_fused(_j(d0), _j(d1), _j(z0), _j(z1), _j(mask0), _j(mask1))
    ref = j_filter_stats(*jstats, th)
    _, *stats = log_assignment(_t(d0), _t(d1), _t(z0), _t(z1), _t(mask0), _t(mask1))
    out = filter_matches_from_stats(*stats, th)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), atol=1e-5)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), atol=1e-5)
    # the stats path and the full-matrix path agree inside the port too
    scores = log_assignment(_t(d0), _t(d1), _t(z0), _t(z1), _t(mask0), _t(mask1))[0]
    full = tassign.filter_matches(scores, th)
    np.testing.assert_array_equal(full[0].numpy(), out[0].numpy())
    np.testing.assert_array_equal(full[1].numpy(), out[1].numpy())
