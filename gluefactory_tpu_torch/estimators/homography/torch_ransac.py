"""The port's homography estimator (counterpart of
gluefactory_tpu/estimators/homography/jax_ransac.py, which the JAX eval
configurations name "jax_ransac": that name resolves here).

Data: m_kpts0 / m_kpts1 (N, 2) matched keypoints (numpy or tensors), an
optional match_mask (N,) and an optional `generator` on the estimator's
device. Returns, on the device: success (bool tensor), M_0to1 (3, 3),
inliers (N,); with a list of T thresholds as `ransac_th`, all T from the same
draws in one call, each output with a leading T axis.
"""

from __future__ import annotations

import torch

from ..base_estimator import BaseEstimator
from ..ransac import ransac_homography


def pad_to_bucket(kpts0, kpts1, valid, bucket: int = 256):
    """Pad the match count to a multiple of `bucket` with invalid entries, so
    that every pair's arrays have one of a few shapes."""
    n = kpts0.shape[0]
    pad = -(-max(n, 1) // bucket) * bucket - n
    if pad == 0:
        return kpts0, kpts1, valid
    pad2 = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
    return pad2(kpts0), pad2(kpts1), torch.nn.functional.pad(valid, (0, pad))


class TorchRansacHomography(BaseEstimator):
    default_conf = {
        "name": "torch_ransac",
        "ransac_th": 3.0,
        "options": {"num_hypotheses": 1024, "refine_iters": 3, "seed": 0},
    }
    required_data_keys = ["m_kpts0", "m_kpts1"]

    def _forward(self, data):
        as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=self.device)
        kpts0 = as_t(data["m_kpts0"], torch.float32)
        kpts1 = as_t(data["m_kpts1"], torch.float32)
        n = kpts0.shape[0]
        valid = data.get("match_mask")
        valid = torch.ones(n, dtype=torch.bool, device=self.device) if valid is None \
            else as_t(valid, torch.bool)
        kpts0, kpts1, valid = pad_to_bucket(kpts0, kpts1, valid)
        gen = data.get("generator")
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(int(self.conf.options.seed))
        th = self.conf.ransac_th
        th = [float(t) for t in th] if isinstance(th, (list, tuple)) else float(th)
        result = ransac_homography(
            kpts0, kpts1, valid, gen, th=th,
            num_hypotheses=int(self.conf.options.num_hypotheses),
            refine_iters=int(self.conf.options.refine_iters),
        )
        return {"success": result.success, "M_0to1": result.model,
                "inliers": result.inliers[..., :n]}


__main_estimator__ = TorchRansacHomography
