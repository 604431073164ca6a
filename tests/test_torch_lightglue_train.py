"""LightGlue in training mode: the port against the JAX model on the CPU,
with the JAX model's random initialisation carried across through
weights.params_from_jax and the same numpy batch.

Small sizes: 3 layers, D = 64, 2 heads, 48 keypoints, batch 2. The JAX side
runs its XLA attention (what it selects off the TPU); the port runs the
plain versions through the autograd Functions of ops/fused_attention.py,
whose backward is the explicit formula. Tolerances: training-mode
descriptors and log assignment 1e-4 abs; every loss entry 1e-5 relative;
every parameter's gradient max|diff| <= 1e-3 * max|g| + 1e-7 against
`jax.grad` of the mean total loss.

`mp: True` in training (bf16 activations, fp32 parameters; checkpointed,
masked, m == n, the stacked path) against the JAX model's bf16 step: the
bar is the JAX package's own bf16 gap. Per parameter, the port's bf16
gradient differs from the JAX bf16 gradient by at most twice the JAX bf16
gradient's difference from the JAX fp32 gradient (max abs over the leaf;
measured up to 1.63x), and each per-pair loss entry within 2^-8 relative
(one bf16 rounding) of the JAX bf16 one (measured up to 4e-4: a per-pair
sum can land nearer fp32 in one package by cancellation, so the JAX gap of
a single entry is no bar). The two
packages round to bf16 at different points (ROADMAP Queue 3a), so the
port's numbers are not the JAX bf16 numbers, but they are as close to them
as those are to fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu_torch.geometry.gt_generation import gt_matches_from_homography
from gluefactory_tpu_torch.geometry.homography import warp_points
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.weights import params_from_jax

BASE = {"n_layers": 3, "descriptor_dim": 64, "input_dim": 64, "num_heads": 2,
        "filter_threshold": 0.1}


def _batch(seed, m, n, masked, b=2):
    """Descriptors, keypoints related by a homography, and their labels."""
    rng = np.random.RandomState(seed)
    H = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    H[:, :2, 2] = rng.uniform(-15, 15, (b, 2))
    kp0 = rng.uniform(20, 380, (b, m, 2)).astype(np.float32)
    kp1 = rng.uniform(20, 380, (b, n, 2)).astype(np.float32)
    k = n // 2
    kp1[:, :k] = warp_points(torch.from_numpy(kp0), torch.from_numpy(H)).numpy()[:, :k]
    kp1[:, :k] += rng.uniform(-1, 1, (b, k, 2)).astype(np.float32)
    data = {
        "keypoints0": kp0, "keypoints1": kp1,
        "descriptors0": rng.randn(b, m, 64).astype(np.float32),
        "descriptors1": rng.randn(b, n, 64).astype(np.float32),
        "view0": {"image_size": np.full((b, 2), 400.0, np.float32)},
        "view1": {"image_size": np.full((b, 2), 400.0, np.float32)},
    }
    v0 = v1 = None
    if masked:
        v0, v1 = np.ones((b, m), bool), np.ones((b, n), bool)
        v0[:, -m // 4:] = False
        v1[:, -n // 5:] = False
        data["keypoint_mask0"], data["keypoint_mask1"] = v0, v1
    t = lambda a: None if a is None else torch.from_numpy(a)
    gt = gt_matches_from_homography(t(kp0), t(kp1), t(H), 3.0, 3.0, t(v0), t(v1))
    for key in ("assignment", "matches0", "matches1"):
        data[f"gt_{key}"] = gt[key].numpy()
    assert (data["gt_matches0"] >= 0).sum() > 10
    return data


def _convert(data, fn):
    return {k: _convert(v, fn) if isinstance(v, dict) else fn(v) for k, v in data.items()}


def _both(conf, data, seed=0):
    jm = jax_model("lightglue").from_conf(conf)
    jdata = _convert(data, jnp.asarray)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), jdata)
    tm = get_model("lightglue")(conf, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    return jm, variables, jdata, tm, _convert(data, lambda a: torch.from_numpy(np.array(a)))


@pytest.mark.parametrize("m,n,masked,checkpointed", [
    (48, 48, False, False), (48, 48, True, True), (48, 40, True, False), (48, 40, False, True)])
def test_training_forward_loss_and_gradients(m, n, masked, checkpointed):
    conf = {**BASE, "is_training": True, "checkpointed": checkpointed}
    data = _batch(m + n + masked, m, n, masked)
    jm, variables, jdata, tm, tdata = _both(conf, data)

    def jloss(params):
        pred = jm.apply({"params": params}, jdata)
        losses, metrics = jm.apply({"params": params}, pred, jdata, method="loss")
        return losses["total"].mean(), (pred, losses, metrics)

    (_, (rpred, rlosses, rmetrics)), rgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(variables["params"])

    pred = tm(tdata)
    assert pred["log_assignment"].requires_grad
    for key in ("ref_descriptors0", "ref_descriptors1", "log_assignment"):
        np.testing.assert_allclose(pred[key].detach().numpy(), np.asarray(rpred[key]), atol=1e-4)
    assert pred["ref_descriptors0"].shape == (2, 3, m, 64)
    np.testing.assert_array_equal(pred["matches0"].numpy(), np.asarray(rpred["matches0"]))

    losses, metrics = tm.loss(pred, tdata)
    assert metrics == {} and rmetrics == {}
    assert set(losses) == set(rlosses)
    for key in losses:
        np.testing.assert_allclose(losses[key].detach().numpy(), np.asarray(rlosses[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert not losses["last"].requires_grad

    losses["total"].mean().backward()
    for name, p in tm.named_parameters():
        ref = np.asarray(rgrads[name])
        assert p.grad is not None, name
        bound = 1e-3 * np.abs(ref).max() + 1e-7
        assert np.abs(p.grad.numpy() - ref).max() <= bound, name


def test_inference_loss_reports_metrics():
    conf = {**BASE}
    data = _batch(5, 48, 48, True)
    jm, variables, jdata, tm, tdata = _both(conf, data)
    def reference(v, d):
        pred = jm.apply(v, d)
        return pred, jm.apply(v, pred, d, method="loss")

    rpred, (rlosses, rmetrics) = jax.jit(reference)(variables, jdata)
    pred = tm(tdata)
    assert not pred["log_assignment"].requires_grad  # inference records no graph
    losses, metrics = tm.loss(pred, tdata)
    assert set(metrics) == set(rmetrics) and len(metrics) == 4
    for key in metrics:
        np.testing.assert_allclose(metrics[key].numpy(), np.asarray(rmetrics[key]), atol=1e-5)
    # without is_training the confidence term is reported but not added
    np.testing.assert_allclose(losses["total"].detach().numpy(), np.asarray(rlosses["total"]),
                               rtol=1e-4)


def test_inference_sees_updated_weights():
    """The cache of cast block weights must not outlive a parameter update."""
    data = _convert(_batch(6, 48, 48, False), lambda a: torch.from_numpy(np.array(a)))
    tm = get_model("lightglue")({**BASE, "mp": True}, device="cpu")
    before = tm(data)["log_assignment"]
    with torch.no_grad():
        tm.self_Wqkv_w.mul_(0.5)
    after = tm(data)["log_assignment"]
    assert float((before - after).abs().max()) > 1e-3


@pytest.mark.parametrize("m,n", [(48, 48), (48, 40)])
def test_flash_off_takes_the_plain_attention_with_the_same_gradients(m, n):
    """`flash: False` runs the plain attention under torch.autograd;
    `flash: True` the autograd Functions with the explicit backward. The
    absolute term covers gradients that are sums of cancelling terms (the
    conditional encoding's, about 1e-6 in all)."""
    data = _convert(_batch(7, m, n, True), lambda a: torch.from_numpy(np.array(a)))
    grads = []
    for flash in (True, False):
        tm = get_model("lightglue")({**BASE, "is_training": True, "flash": flash}, device="cpu")
        losses, _ = tm.loss(tm(data), data)
        losses["total"].mean().backward()
        grads.append({k: p.grad for k, p in tm.named_parameters()})
    for k, g in grads[0].items():
        assert float((g - grads[1][k]).abs().max()) <= 1e-4 * float(g.abs().max()) + 5e-6, k


def test_mp_training_step_within_the_jax_bf16_gap():
    data = _batch(8, 48, 48, True)
    conf = {**BASE, "is_training": True, "checkpointed": True, "mp": True}
    jm, variables, jdata, tm, tdata = _both(conf, data)

    def jax_step(mp):
        model = jax_model("lightglue").from_conf({**conf, "mp": mp})

        def jloss(params):
            losses, _ = model.apply({"params": params}, model.apply({"params": params}, jdata),
                                    jdata, method="loss")
            return losses["total"].mean(), losses

        (_, losses), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            variables["params"])
        return jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, grads)

    (l16, g16), (l32, g32) = jax_step(True), jax_step(False)
    pred = tm(tdata)
    assert pred["ref_descriptors0"].dtype == torch.bfloat16
    losses, _ = tm.loss(pred, tdata)
    for key, v in losses.items():
        np.testing.assert_allclose(v.detach().float().numpy(), l16[key], rtol=2**-8, atol=1e-6,
                                   err_msg=key)
    losses["total"].mean().backward()
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        gap = np.abs(g16[name] - g32[name]).max()
        assert gap > 0, name  # the JAX step does run in bf16
        assert np.abs(p.grad.numpy() - g16[name]).max() <= 2 * gap, name
