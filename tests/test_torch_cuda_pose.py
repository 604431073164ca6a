"""The pose slice on the card against the CPU: the pose + depth ground
truth, the relative-pose RANSAC core fed the same Gumbel noise, and a
synthetic 3D batch through the depth-supervised two-view pipeline.

Marked `cuda`: they skip where there is no GPU. The file imports no JAX:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_pose.py
Bars: labels equal (the distances are elementwise fp32, no TF32);
RANSAC: `success` equal, inlier masks >= 95% equal, R within 0.05 degrees
on at least 2 of 3 cases (the estimate is not continuous at fp32 precision
where near-equal candidates compete; see tests/test_torch_relpose.py).
"""

import numpy as np
import pytest
import torch

from gluefactory_tpu_torch.datasets.base_dataset import collate
from gluefactory_tpu_torch.datasets.synthetic_two_view import SyntheticTwoViewDataset
from gluefactory_tpu_torch.estimators.ransac import gumbel, ransac_relative_pose_core
from gluefactory_tpu_torch.geometry.gt_generation import gt_matches_from_pose_depth
from gluefactory_tpu_torch.geometry.utils import angle_error_mat, so3exp_map
from gluefactory_tpu_torch.utils.tensor import batch_to_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(n=2):
    ds = SyntheticTwoViewDataset({"image_size": [320, 240]}).get_dataset("test")
    return collate([ds[i] for i in range(n)])


def test_depth_ground_truth_card_matches_cpu(card):
    batch = _batch()
    rng = np.random.RandomState(0)
    kps = [torch.from_numpy(rng.uniform(0, [320, 240], (2, 512, 2)).astype(np.float32))
           for _ in range(2)]
    for epi_th, cc_th in ((None, None), (5.0, None), (5.0, 4.0)):
        cpu = gt_matches_from_pose_depth(*kps, batch_to_device(batch, "cpu"), epi_th=epi_th,
                                         cc_th=cc_th)
        dev = gt_matches_from_pose_depth(*(k.to(card) for k in kps), batch_to_device(batch, card),
                                         epi_th=epi_th, cc_th=cc_th)
        for k in ("matches0", "matches1", "assignment", "visible0", "visible1"):
            assert torch.equal(dev[k].cpu(), cpu[k]), k


def test_relative_pose_core_card_matches_cpu(card):
    same = 0
    for seed in range(3):
        rng = np.random.RandomState(seed)
        X = np.c_[rng.uniform(-2, 2, (512, 2)), rng.uniform(4, 8, 512)]
        R = so3exp_map(torch.from_numpy(rng.randn(3).astype(np.float32) * 0.1)).double().numpy()
        X1 = X @ R.T + rng.randn(3) * [0.5, 0.2, 0.1]
        p0 = torch.from_numpy((X[:, :2] / X[:, 2:] + rng.randn(512, 2) * 1e-3).astype(np.float32))
        p1 = torch.from_numpy((X1[:, :2] / X1[:, 2:] + rng.randn(512, 2) * 1e-3).astype(np.float32))
        p1[:150] = torch.from_numpy(rng.uniform(-0.6, 0.6, (150, 2)).astype(np.float32))
        valid = torch.ones(512, dtype=torch.bool)
        noise = [gumbel((8192, 512), torch.Generator().manual_seed(seed), "cpu") for _ in range(2)]
        cpu = ransac_relative_pose_core(p0, p1, valid, noise, 2e-3, refine_iters=4)
        dev = ransac_relative_pose_core(p0.to(card), p1.to(card), valid.to(card),
                                        [g.to(card) for g in noise], 2e-3, refine_iters=4)
        assert bool(dev.success) == bool(cpu.success)
        assert (dev.inliers.cpu() == cpu.inliers).float().mean() >= 0.95
        same += float(angle_error_mat(dev.R.cpu().double(), cpu.R.double())) < 0.05
    assert same >= 2


def test_depth_pipeline_batch_on_card(card):
    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.weights import load_hermetic

    conf = {"extractor": {"name": "superpoint_open", "max_num_keypoints": 512,
                          "detection_threshold": 0.005, "dtype": None},
            "matcher": {"name": "lightglue", "filter_threshold": 0.1, "is_training": True},
            "ground_truth": {"name": "depth_matcher", "th_epi": 5.0}}
    pipe = get_model("two_view_pipeline")(conf, device=card)
    pipe.load_state_dict(load_hermetic(device=card), strict=True)
    data = batch_to_device(_batch(), card)
    losses, _ = pipe.loss(pipe(data), data)
    assert torch.isfinite(losses["total"]).all() and float(losses["num_matchable"].min()) > 10
