"""Ground-truth generation, the assignment NLL and the match metrics of the
port against the JAX package on the CPU, same numpy inputs. Labels are
integers and must be equal; losses and metrics to 1e-6 (fp32, same order of
operations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry import gt_generation as jgt
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.utils import losses as jlosses
from gluefactory_tpu.models.utils.metrics import matcher_metrics as jmetrics
from gluefactory_tpu_torch.geometry import gt_generation as tgt
from gluefactory_tpu_torch.geometry.homography import warp_points
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.utils import losses as tlosses
from gluefactory_tpu_torch.models.utils.metrics import matcher_metrics as tmetrics


def _homographies(rng, b):
    H = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    ang = rng.uniform(-0.3, 0.3, b)
    H[:, 0, 0], H[:, 0, 1] = np.cos(ang), -np.sin(ang)
    H[:, 1, 0], H[:, 1, 1] = np.sin(ang), np.cos(ang)
    H[:, :2, 2] = rng.uniform(-20, 20, (b, 2))
    H[:, 2, :2] = rng.uniform(-1e-4, 1e-4, (b, 2))
    return H


def _scene(seed, b=2, m=60, n=50):
    """Keypoints in image 0, and in image 1 a mix of their warps (some with
    noise around the thresholds) and unrelated points."""
    rng = np.random.RandomState(seed)
    H = _homographies(rng, b)
    kp0 = rng.uniform(0, 400, (b, m, 2)).astype(np.float32)
    warped = warp_points(torch.from_numpy(kp0), torch.from_numpy(H)).numpy()
    kp1 = rng.uniform(0, 400, (b, n, 2)).astype(np.float32)
    k = n // 2
    noise = rng.uniform(-4, 4, (b, k, 2)).astype(np.float32)
    kp1[:, :k] = warped[:, :k] + noise
    perm = rng.permutation(n)
    return kp0, kp1[:, perm].copy(), H, rng


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("neg_th", [3.0, 6.0])
def test_gt_matches_from_homography_labels_equal(masked, neg_th):
    kp0, kp1, H, rng = _scene(int(masked) + int(neg_th))
    v0 = v1 = None
    if masked:
        v0, v1 = rng.rand(*kp0.shape[:2]) > 0.2, rng.rand(*kp1.shape[:2]) > 0.2
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    ref = jgt.gt_matches_from_homography(j(kp0), j(kp1), j(H), 3.0, neg_th, j(v0), j(v1))
    out = tgt.gt_matches_from_homography(t(kp0), t(kp1), t(H), 3.0, neg_th, t(v0), t(v1))
    assert set(out) == set(ref)
    for key in ("matches0", "matches1"):
        assert out[key].dtype == torch.int32
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    np.testing.assert_array_equal(out["assignment"].numpy(), np.asarray(ref["assignment"]))
    np.testing.assert_array_equal(out["reward"].numpy(), np.asarray(ref["reward"]))
    for key in ("proj_0to1", "proj_1to0"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-3)
    labels = out["matches0"].numpy()
    assert (labels >= 0).sum() > 5 and (labels == -1).sum() > 5  # all three kinds occur
    if masked:
        assert (labels[~v0] == tgt.IGNORE_FEATURE).all()


def test_homography_matcher_component():
    kp0, kp1, H, rng = _scene(7)
    v0 = rng.rand(*kp0.shape[:2]) > 0.2
    data = {"keypoints0": kp0, "keypoints1": kp1, "H_0to1": H, "keypoint_mask0": v0}
    conf = {"th_positive": 3.0, "th_negative": 3.0}
    jm = jax_model("homography_matcher").from_conf(conf)
    ref = jm.apply({}, {k: jnp.asarray(v) for k, v in data.items()})
    out = get_model("homography_matcher")(conf, device="cpu")(
        {k: torch.from_numpy(v) for k, v in data.items()})
    assert set(out) == set(ref)
    for key in ("gt_matches0", "gt_matches1", "gt_assignment"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    with pytest.raises(NotImplementedError):
        get_model("homography_matcher")({"use_lines": True}, device="cpu")


def _labelled(seed, b=2, m=60, n=50):
    kp0, kp1, H, rng = _scene(seed, b, m, n)
    gt = tgt.gt_matches_from_homography(
        torch.from_numpy(kp0), torch.from_numpy(kp1), torch.from_numpy(H), 3.0, 3.0)
    data = {f"gt_{k}": gt[k].numpy() for k in ("assignment", "matches0", "matches1")}
    la = np.log(rng.dirichlet(np.ones(n + 1), (b, m + 1))).astype(np.float32)
    return data, la, rng


@pytest.mark.parametrize("balancing", [0.5, 0.3])
def test_nll_loss_and_weights(balancing):
    data, la, _ = _labelled(11)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    rnll, rw, rmet = jlosses.nll_loss({"log_assignment": jnp.asarray(la)}, jdata,
                                      nll_balancing=balancing)
    tla = torch.from_numpy(la).requires_grad_()
    nll, w, met = tlosses.nll_loss({"log_assignment": tla}, tdata, nll_balancing=balancing)
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(rnll), rtol=1e-6, atol=1e-6)
    assert set(met) == set(rmet)
    for k in met:
        np.testing.assert_allclose(met[k].detach().numpy(), np.asarray(rmet[k]), rtol=1e-6,
                                   atol=1e-6)
    nll.sum().backward()  # differentiable in the log assignment
    assert torch.isfinite(tla.grad).all() and float(tla.grad.abs().sum()) > 0
    # given weights are reused as they are
    nll2, w2, _ = tlosses.nll_loss({"log_assignment": tla.detach() * 2}, tdata, weights=w,
                                   nll_balancing=balancing)
    assert w2 is w
    np.testing.assert_allclose(nll2.numpy(), 2 * nll.detach().numpy(), rtol=1e-6)


def test_matcher_metrics():
    data, _, rng = _labelled(13)
    b, m = data["gt_matches0"].shape
    n = data["gt_matches1"].shape[1]
    pred_m = data["gt_matches0"].copy()
    flip = rng.rand(b, m) < 0.3
    pred_m[flip] = rng.randint(-1, n, flip.sum())
    pred = {"matches0": pred_m.astype(np.int32),
            "matching_scores0": rng.permutation(b * m).reshape(b, m).astype(np.float32) / (b * m)}
    ref = jmetrics({k: jnp.asarray(v) for k, v in pred.items()},
                   {k: jnp.asarray(v) for k, v in data.items()})
    out = tmetrics({k: torch.from_numpy(v) for k, v in pred.items()},
                   {k: torch.from_numpy(v) for k, v in data.items()})
    assert set(out) == set(ref)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6)
