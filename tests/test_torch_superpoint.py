"""SuperPoint-open of the port against the JAX model on the CPU, both in
dtype float32 with the same random weights (carried by
weights.params_from_jax, BatchNorm statistics included).

Bars: keypoints equal on at least 99% of entries (top-k among equal scores
may order differently); on keypoints both select, descriptors within 1e-4
and scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from torch_jax_init import jit_o0
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors.superpoint_open import simple_nms
from gluefactory_tpu_torch.weights import params_from_jax


def _image(seed, b, h, w):
    rng = np.random.RandomState(seed)
    img = np.stack([gaussian_filter(rng.rand(h, w), 1.5) for _ in range(b)])
    img = (img - img.min()) / (img.max() - img.min())
    return img[..., None].astype(np.float32)


def _random_stats(variables, seed):
    """Non-trivial BatchNorm statistics so the bridge's stats are exercised."""
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for blk in stats.values():
        bn = blk["BatchNorm_0"]
        bn["mean"] = (0.1 * rng.randn(*bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1.0 + 0.2 * rng.rand(*bn["var"].shape)).astype(np.float32)
    return {**variables, "batch_stats": stats}


def test_superpoint_matches_jax():
    conf = {"max_num_keypoints": 200, "dtype": "float32"}
    img = _image(0, 2, 120, 160)
    jm = jax_model("superpoint_open").from_conf(conf)
    variables = _random_stats(jit_o0(jm.init)(jax.random.PRNGKey(0), {"image": jnp.asarray(img)}), 1)
    ref = jax.tree.map(np.asarray, jit_o0(jm.apply)(variables, {"image": jnp.asarray(img)}))

    tm = get_model("superpoint_open")(conf, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    out = {k: v.numpy() for k, v in tm({"image": torch.from_numpy(img)}).items()}

    same = (out["keypoints"] == ref["keypoints"]).all(-1)
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(out["keypoint_mask"][same], ref["keypoint_mask"][same])
    np.testing.assert_allclose(out["descriptors"][same], ref["descriptors"][same], atol=1e-4)
    np.testing.assert_allclose(out["keypoint_scores"][same], ref["keypoint_scores"][same],
                               atol=1e-5)
    assert ref["keypoint_mask"].sum() > 50  # the image has real detections


def test_simple_nms_matches_jax():
    from gluefactory_tpu.models.extractors.superpoint_open import simple_nms as jnms

    rng = np.random.RandomState(3)
    scores = rng.rand(2, 40, 48).astype(np.float32)
    scores[:, 10:20, 10:20] = 0.5  # a plateau of equal scores
    ref = np.asarray(jnms(jnp.asarray(scores), 4))
    np.testing.assert_array_equal(simple_nms(torch.from_numpy(scores), 4).numpy(), ref)
