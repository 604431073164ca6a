"""The port's homography RANSAC against the JAX package's on the CPU.

Both draw their hypotheses from Gumbel noise; the port's core takes the
noise as input, so it is fed the JAX draws (the same key splits as
`gluefactory_tpu.estimators.ransac.ransac_homography`) and the two must
choose the same model. Inputs: 256 correspondences (16 of them padding)
under a known homography with 0.5 px noise and 20%, 50% or 70% outliers,
made from numpy seeds; thresholds 1 and 3 px.

Bars: the final H within 0.05 px mean corner error of JAX's (640 x 480),
inlier masks equal on >= 99.5% of entries, `success` equal. Two refined
candidates of near-equal score can swap places on fp32 noise: in a sweep of
48 draws (8 seeds x these 6 cases) none did, in one other draw (70%
outliers, th 1) the final H moved by 0.085 px; the cases here use key 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.estimators.ransac import homography_residuals as jres
from gluefactory_tpu.estimators.ransac import ransac_homography_jit
from gluefactory_tpu_torch.estimators import load_estimator
from gluefactory_tpu_torch.estimators.homography.torch_ransac import (
    TorchRansacHomography,
    pad_to_bucket,
)
from gluefactory_tpu_torch.estimators.ransac import (
    _msac_score,
    homography_residuals,
    ransac_homography,
    ransac_homography_core,
)
from gluefactory_tpu_torch.geometry.homography import homography_corner_error

H_TRUE = np.array([[1.02, 0.05, 12], [-0.03, 0.98, -7], [2e-5, -1e-5, 1.0]])
SIZE = torch.tensor([640.0, 480.0], dtype=torch.float64)


def _data(seed, n, outliers, noise=0.5):
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(0, [640, 480], (n, 2))
    h = np.c_[p0, np.ones(n)] @ H_TRUE.T
    p1 = h[:, :2] / h[:, 2:] + rng.randn(n, 2) * noise
    k = int(outliers * n)
    p1[:k] = rng.uniform(0, [640, 480], (k, 2))
    valid = np.ones(n, bool)
    valid[n - 16:] = False
    return p0.astype(np.float32), p1.astype(np.float32), valid


def _jax_noise(key, k, n, rounds=2):
    """The Gumbel draws of JAX's ransac_homography for `key`, round by round."""
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, (k, n)))))
    return out


def _corner_diff(a, b):
    as64 = lambda x: torch.as_tensor(np.array(x, np.float64))
    return float(homography_corner_error(as64(a), as64(b), SIZE))


@pytest.mark.parametrize("th", [1.0, 3.0])
@pytest.mark.parametrize("outliers", [0.2, 0.5, 0.7])
def test_core_fed_jax_noise_chooses_jax_model(outliers, th):
    p0, p1, valid = _data(int(outliers * 10 + th), 256, outliers)
    key = jax.random.PRNGKey(0)
    ref = ransac_homography_jit(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), key,
                                th=jnp.float32(th))
    out = ransac_homography_core(torch.from_numpy(p0), torch.from_numpy(p1),
                                 torch.from_numpy(valid), _jax_noise(key, 1024, 256), th)
    assert _corner_diff(out.model, ref.model) < 0.05
    assert (out.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.995
    assert bool(out.success) == bool(ref.success)
    assert float(out.score) == float(out.inliers.sum())
    assert not out.inliers[~torch.from_numpy(valid)].any()
    assert _corner_diff(out.model, H_TRUE) < 1.0  # and it is the right model


def test_residuals_and_score_match_jax():
    p0, p1, valid = _data(1, 64, 0.3)
    H = np.stack([H_TRUE, H_TRUE @ np.diag([1.0, 1.0, 1.001])]).astype(np.float32)
    ref = np.asarray(jres(jnp.asarray(p0)[None], jnp.asarray(p1)[None], jnp.asarray(H)))
    out = homography_residuals(torch.from_numpy(p0)[None], torch.from_numpy(p1)[None],
                               torch.from_numpy(H))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)
    score = _msac_score(out, 3.0, torch.from_numpy(valid).float())
    ref_score = (np.clip(1 - (ref / 3.0) ** 2, 0, None) * valid).sum(-1)
    np.testing.assert_allclose(score.numpy(), ref_score, rtol=1e-4)
    # a singular model scores nothing, with finite residuals
    bad = homography_residuals(torch.from_numpy(p0)[None], torch.from_numpy(p1)[None],
                               torch.zeros(1, 3, 3))
    assert torch.isfinite(bad).all() and float(_msac_score(bad, 3.0, 1.0).sum()) == 0.0


def test_estimator_registry_bucket_and_seed():
    assert load_estimator("homography", "jax_ransac") is TorchRansacHomography
    assert load_estimator("homography", "torch_ransac") is TorchRansacHomography
    for name in ("opencv", "poselib", "homography_est"):
        with pytest.raises(NotImplementedError, match="not portable"):
            load_estimator("homography", name)
    p0, p1, _ = _data(2, 300, 0.5)
    k0, k1, v = pad_to_bucket(torch.from_numpy(p0), torch.from_numpy(p1),
                              torch.ones(300, dtype=torch.bool))
    assert k0.shape == (512, 2) and int(v.sum()) == 300 and not v[300:].any()
    est = load_estimator("homography", "jax_ransac")({"ransac_th": 2.0}, device="cpu")
    mask = np.ones(300, bool)
    mask[:20] = False
    out = est({"m_kpts0": p0, "m_kpts1": p1, "match_mask": mask})
    again = est({"m_kpts0": p0, "m_kpts1": p1, "match_mask": mask})
    assert out["inliers"].shape == (300,) and bool(out["success"])
    assert not out["inliers"][:20].any()
    assert torch.equal(out["M_0to1"], again["M_0to1"])  # the seed fixes the draw
    assert _corner_diff(out["M_0to1"], H_TRUE) < 1.0


def test_public_entry_draws_from_generator():
    p0, p1, valid = _data(3, 256, 0.5)
    args = (torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(valid))
    gen = lambda s: torch.Generator().manual_seed(s)
    a = ransac_homography(*args, gen(0), th=3.0)
    b = ransac_homography(*args, gen(0), th=3.0)
    assert torch.equal(a.model, b.model) and torch.equal(a.inliers, b.inliers)
    assert _corner_diff(a.model, H_TRUE) < 1.0
    one = ransac_homography(*args, gen(1), th=3.0, num_hypotheses=256, guided_rounds=0)
    assert bool(one.success) and _corner_diff(one.model, H_TRUE) < 1.0


def test_estimator_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchRansacHomography()


def test_threshold_sweep_is_one_call_a_threshold():
    """The batched sweep gives each threshold the result of a call with it
    alone (the same draws), through the estimator as through the core."""
    from gluefactory_tpu_torch.estimators.ransac import gumbel

    p0, p1, valid = _data(4, 256, 0.5)
    args = (torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(valid))
    noise = [gumbel((1024, 256), torch.Generator().manual_seed(s), "cpu") for s in (0, 1)]
    ths = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
    sweep = ransac_homography_core(*args, noise, ths)
    assert sweep.model.shape == (6, 3, 3) and sweep.inliers.shape == (6, 256)
    for i, th in enumerate(ths):
        one = ransac_homography_core(*args, noise, th)
        assert _corner_diff(sweep.model[i], one.model) < 1e-3
        assert torch.equal(sweep.inliers[i], one.inliers)
        assert bool(sweep.success[i]) == bool(one.success)
    est = TorchRansacHomography({"ransac_th": ths}, device="cpu")
    out = est({"m_kpts0": p0[:240], "m_kpts1": p1[:240]})
    assert out["M_0to1"].shape == (6, 3, 3) and out["inliers"].shape == (6, 240)
    single = TorchRansacHomography({"ransac_th": 2.0}, device="cpu")({"m_kpts0": p0[:240],
                                                                     "m_kpts1": p1[:240]})
    assert _corner_diff(out["M_0to1"][3], single["M_0to1"]) < 1e-3
