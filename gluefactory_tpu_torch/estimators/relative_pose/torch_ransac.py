"""The port's relative-pose estimator (counterpart of
gluefactory_tpu/estimators/relative_pose/jax_ransac.py, which the JAX eval
configurations name "jax_ransac": that name resolves here).

Data: m_kpts0 / m_kpts1 (N, 2) matched pixel keypoints (numpy or tensors),
camera0 / camera1 (`Camera`), an optional match_mask (N,) and an optional
`generator` on the estimator's device. `ransac_th` is in pixels and is
divided by the mean focal length of the two cameras, as the JAX package
does. Returns, on the device: success (bool tensor), M_0to1 (a `Pose` with a
unit translation), inliers (N,); with a list of T thresholds as
`ransac_th`, all T from the same draws in one call, each output with a
leading T axis.
"""

from __future__ import annotations

import torch

from ...geometry.wrappers import Pose
from ..base_estimator import BaseEstimator
from ..homography.torch_ransac import pad_to_bucket
from ..ransac import ransac_relative_pose


class TorchRansacRelativePose(BaseEstimator):
    default_conf = {
        "name": "torch_ransac",
        "ransac_th": 2.0,
        "options": {"num_hypotheses": 8192, "refine_iters": 4, "seed": 0, "guided_rounds": 1},
    }
    required_data_keys = ["m_kpts0", "m_kpts1", "camera0", "camera1"]

    def _forward(self, data):
        as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=self.device)
        kpts0 = as_t(data["m_kpts0"], torch.float32)
        kpts1 = as_t(data["m_kpts1"], torch.float32)
        n = kpts0.shape[0]
        valid = data.get("match_mask")
        valid = torch.ones(n, dtype=torch.bool, device=self.device) if valid is None \
            else as_t(valid, torch.bool)
        kpts0, kpts1, valid = pad_to_bucket(kpts0, kpts1, valid)
        cam0, cam1 = data["camera0"].to(self.device), data["camera1"].to(self.device)
        p0n = cam0.normalize(kpts0[None])[0]
        p1n = cam1.normalize(kpts1[None])[0]
        f_mean = (cam0.f.mean() + cam1.f.mean()) / 2.0
        th = self.conf.ransac_th
        th = [float(t) for t in th] if isinstance(th, (list, tuple)) else float(th)
        gen = data.get("generator")
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(int(self.conf.options.seed))
        opts = self.conf.options
        result = ransac_relative_pose(
            p0n, p1n, valid, gen, th=torch.as_tensor(th, dtype=torch.float32,
                                                     device=self.device) / f_mean,
            num_hypotheses=int(opts.num_hypotheses), refine_iters=int(opts.refine_iters),
            guided_rounds=int(opts.get("guided_rounds", 1)),
        )
        t = result.t / torch.linalg.vector_norm(result.t, dim=-1, keepdim=True).clamp(min=1e-9)
        return {"success": result.success, "M_0to1": Pose(result.R, t),
                "inliers": result.inliers[..., :n]}


__main_estimator__ = TorchRansacRelativePose
