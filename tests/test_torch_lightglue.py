"""Full-depth LightGlue (9 layers x 256) of the port against the JAX model on
the CPU, with the JAX model's random initialisation carried across through
weights.params_from_jax.

The JAX side runs its XLA path (fused_layer False) or its Pallas block
kernels in interpret mode (fused_layer True); the port runs its plain
versions. The bar is the repo's own (tests/test_pallas_lightglue_block.py:
79-82): log_assignment within 5e-3 and at least 99% of matches0 equal, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.weights import params_from_jax


def _data(seed, b, m, n, masked):
    rng = np.random.RandomState(seed)
    data = {
        "keypoints0": (rng.rand(b, m, 2) * 400).astype(np.float32),
        "keypoints1": (rng.rand(b, n, 2) * 400).astype(np.float32),
        "descriptors0": rng.randn(b, m, 256).astype(np.float32),
        "descriptors1": rng.randn(b, n, 256).astype(np.float32),
        "view0": {"image_size": np.full((b, 2), 400.0, np.float32)},
        "view1": {"image_size": np.full((b, 2), 400.0, np.float32)},
    }
    if masked:
        m0 = np.ones((b, m), bool)
        m1 = np.ones((b, n), bool)
        m0[:, -m // 4:] = False
        m1[:, -n // 3:] = False
        data["keypoint_mask0"], data["keypoint_mask1"] = m0, m1
    return data


def _convert(data, fn):
    return {k: _convert(v, fn) if isinstance(v, dict) else fn(v) for k, v in data.items()}


def _run_both(data, conf, seed):
    jm = jax_model("lightglue").from_conf(conf)
    jdata = _convert(data, jnp.asarray)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), jdata)
    ref = jax.jit(jm.apply)(variables, jdata)
    port_conf = {k: v for k, v in conf.items() if k != "fused_layer"}
    tm = get_model("lightglue")(port_conf, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    out = tm(_convert(data, lambda a: torch.from_numpy(np.array(a))))
    return ref, out


@pytest.mark.parametrize(
    "m,n,masked,fused",
    [(128, 128, False, False), (256, 256, True, True), (128, 96, True, False),
     (128, 128, True, True)],
)
def test_matcher_matches_jax(m, n, masked, fused):
    data = _data(m + n + masked, 2, m, n, masked)
    conf = {"fused_layer": fused, "filter_threshold": 0.1}
    ref, out = _run_both(data, conf, seed=m + n)
    np.testing.assert_allclose(
        out["log_assignment"].numpy(), np.asarray(ref["log_assignment"]), atol=5e-3)
    assert (out["matches0"].numpy() == np.asarray(ref["matches0"])).mean() >= 0.99
    assert (out["matches1"].numpy() == np.asarray(ref["matches1"])).mean() >= 0.99
    if masked:  # padded keypoints are never matched
        assert (out["matches0"].numpy()[~data["keypoint_mask0"]] == -1).all()
        assert (out["matches1"].numpy()[~data["keypoint_mask1"]] == -1).all()


def test_matcher_mixed_precision_matches_jax():
    """mp: True runs the stack in bf16 on both sides. bf16 rounds at other
    places in the two frameworks (the JAX XLA path rounds every dense output
    and the rotary product; the port rounds only at the block boundaries of
    its kernels), and the differences grow over 9 layers, so the bar is 95%
    of matches0 equal on the valid keypoints instead of 99%."""
    data = _data(5, 2, 128, 128, True)
    ref, out = _run_both(data, {"mp": True, "fused_layer": False, "filter_threshold": 0.1}, 9)
    valid = data["keypoint_mask0"]
    same = out["matches0"].numpy()[valid] == np.asarray(ref["matches0"])[valid]
    assert same.mean() >= 0.95
    assert (out["matches0"].numpy()[~valid] == -1).all()


def test_collect_layers_and_outputs():
    data = _data(2, 1, 64, 64, False)
    tm = get_model("lightglue")({"n_layers": 3}, device="cpu")
    out = tm(_convert(data, torch.from_numpy))
    assert out["ref_descriptors0"].shape == (1, 3, 64, 256)
    tm = get_model("lightglue")({"n_layers": 3, "collect_layers": False}, device="cpu")
    out = tm(_convert(data, torch.from_numpy))
    assert out["ref_descriptors0"].shape == (1, 1, 64, 256)
    assert out["log_assignment"].shape == (1, 65, 65)
    assert int(out["stop_layer"]) == 2


@pytest.mark.parametrize("conf", [{"add_scale_ori": True}])
def test_unported_modes_raise(conf):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        get_model("lightglue")(conf, device="cpu")
