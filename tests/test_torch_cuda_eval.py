"""The evaluation slice's geometry on the card against the CPU: the
weighted DLT and the RANSAC core fed the same Gumbel noise.

Marked `cuda`: they skip where there is no GPU. The file imports no JAX:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_eval.py
Bars: DLT H within 1e-4 relative (fp32 geometry around a float64 9x9
solve: cuSOLVER on the card, LAPACK on the CPU); RANSAC's final H within
0.05 px mean corner error, inlier masks equal on >= 99.5%, success equal.
"""

import numpy as np
import pytest
import torch

from gluefactory_tpu_torch.estimators.homography.torch_ransac import TorchRansacHomography
from gluefactory_tpu_torch.estimators.ransac import gumbel, ransac_homography_core
from gluefactory_tpu_torch.geometry.homography import homography_corner_error, solve_homography_dlt

pytestmark = pytest.mark.cuda
H_TRUE = np.array([[1.02, 0.05, 12], [-0.03, 0.98, -7], [2e-5, -1e-5, 1.0]])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(seed, n, outliers, noise=0.5):
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(0, [640, 480], (n, 2))
    h = np.c_[p0, np.ones(n)] @ H_TRUE.T
    p1 = h[:, :2] / h[:, 2:] + rng.randn(n, 2) * noise
    k = int(outliers * n)
    p1[:k] = rng.uniform(0, [640, 480], (k, 2))
    return torch.from_numpy(p0).float(), torch.from_numpy(p1).float()


@pytest.mark.parametrize("n", [4, 200])
def test_dlt_card_matches_cpu(card, n):
    """6 sets; a minimal sample has one point near each image corner (on a
    near-collinear random sample fp32 solves are off the true H by pixels)."""
    rng = np.random.RandomState(n)
    if n == 4:
        corners = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
        q = (0.1 + 0.8 * corners + rng.uniform(-0.1, 0.1, (6, 4, 2))) * [640, 480]
    else:
        q = rng.uniform(0, [640, 480], (6, n, 2))
    h = np.concatenate([q, np.ones((6, n, 1))], -1) @ H_TRUE.T
    p0 = torch.from_numpy(q).float()
    p1 = torch.from_numpy(h[..., :2] / h[..., 2:] + rng.randn(6, n, 2) * (n > 4) * 0.3).float()
    w = torch.rand(6, n, generator=torch.Generator().manual_seed(n)) + 0.05
    for weights in (None, w):
        cpu = solve_homography_dlt(p0, p1, weights)
        dev = solve_homography_dlt(p0.to(card), p1.to(card),
                                   None if weights is None else weights.to(card)).cpu()
        rel = (dev - cpu).abs().amax((-1, -2)) / cpu.abs().amax((-1, -2))
        assert float(rel.max()) < 1e-4, rel


@pytest.mark.parametrize("outliers", [0.2, 0.5, 0.7])
def test_ransac_core_card_matches_cpu(card, outliers):
    p0, p1 = _data(int(outliers * 10), 512, outliers)
    valid = torch.ones(512, dtype=torch.bool)
    valid[500:] = False
    gen = torch.Generator().manual_seed(0)
    noise = [gumbel((1024, 512), gen, "cpu") for _ in range(2)]
    size = torch.tensor([640.0, 480.0], dtype=torch.float64)
    for th in (1.0, 3.0):
        cpu = ransac_homography_core(p0, p1, valid, noise, th)
        dev = ransac_homography_core(p0.to(card), p1.to(card), valid.to(card),
                                     [g.to(card) for g in noise], th)
        diff = homography_corner_error(dev.model.cpu().double(), cpu.model.double(), size)
        assert float(diff) < 0.05
        assert float((dev.inliers.cpu() == cpu.inliers).float().mean()) >= 0.995
        assert bool(dev.success) == bool(cpu.success)
        truth = homography_corner_error(dev.model.cpu().double(), torch.from_numpy(H_TRUE), size)
        assert float(truth) < 1.0


def test_estimator_runs_on_the_card(card):
    p0, p1 = _data(9, 300, 0.5)
    out = TorchRansacHomography({"ransac_th": 3.0})({"m_kpts0": p0, "m_kpts1": p1})
    assert out["M_0to1"].device.type == "cuda" and out["inliers"].shape == (300,)
    assert bool(out["success"])
