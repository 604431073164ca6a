"""SuperGlue of the port against the JAX model on the CPU: the JAX model
initialised from a seed, its parameters carried across by
weights.superglue_from_flax, masked inputs with m != n at a small size
(3 layer pairs, 64 wide, 2 heads, 20 Sinkhorn iterations). The JAX model
runs its XLA attention, the port its plain per-head attention (what
`ops.attention.masked_attention` takes for CPU tensors). Bars: fp32,
`log_assignment` within 1e-3 (20 log-sum-exp sweeps over ~30 entries a line
carry summation-order noise of ~1e-5), `matches0` / `matches1` equal on at
least 99% of entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.matchers import superglue as jsg
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.matchers import superglue as tsg
from gluefactory_tpu_torch.weights import superglue_from_flax

CONF = {"GNN_layers": 3, "descriptor_dim": 64, "input_dim": 64, "num_heads": 2,
        "sinkhorn_iterations": 20, "keypoint_encoder": [16, 32]}


def _data(seed, b, m, n, masked, scores=True, sizes=False):
    rng = np.random.RandomState(seed)
    data = {
        "keypoints0": (rng.rand(b, m, 2) * 400).astype(np.float32),
        "keypoints1": (rng.rand(b, n, 2) * 400).astype(np.float32),
        "descriptors0": rng.randn(b, m, 64).astype(np.float32),
        "descriptors1": rng.randn(b, n, 64).astype(np.float32),
    }
    if scores:
        data["keypoint_scores0"] = rng.rand(b, m).astype(np.float32)
        data["keypoint_scores1"] = rng.rand(b, n).astype(np.float32)
    if sizes:
        data["view0"] = {"image_size": np.full((b, 2), 400.0, np.float32)}
        data["view1"] = {"image_size": np.asarray([[400.0, 300.0]] * b, np.float32)}
    if masked:
        m0, m1 = np.ones((b, m), bool), np.ones((b, n), bool)
        m0[:, -m // 4:] = False
        m1[0, -n // 3:] = False
        data["keypoint_mask0"], data["keypoint_mask1"] = m0, m1
    return data


def _convert(data, fn):
    return {k: _convert(v, fn) if isinstance(v, dict) else fn(v) for k, v in data.items()}


@pytest.mark.parametrize("m,n,masked,scores,sizes", [
    (40, 28, True, True, False),    # masked, m != n, frame from the valid keypoints
    (32, 32, False, False, True),   # unmasked, default scores, image sizes given
    (24, 40, True, False, True),
])
def test_superglue_matches_jax(m, n, masked, scores, sizes):
    data = _data(m + n, 2, m, n, masked, scores, sizes)
    jm = jax_model("superglue").from_conf(CONF)
    jdata = _convert(data, jnp.asarray)
    variables = jm.init(jax.random.PRNGKey(m), jdata)
    # the dustbin score away from its initial 1, so that the bridge carries it
    variables = {"params": {**variables["params"], "bin_score": jnp.asarray(0.7)}}
    ref = jax.tree.map(np.asarray, jm.apply(variables, jdata))

    tm = get_model("superglue")(CONF, device="cpu")
    tm.load_state_dict(superglue_from_flax(variables), strict=True)
    out = tm(_convert(data, lambda a: torch.from_numpy(np.array(a))))

    np.testing.assert_allclose(out["log_assignment"].numpy(), ref["log_assignment"], atol=1e-3)
    assert (out["matches0"].numpy() == ref["matches0"]).mean() >= 0.99
    assert (out["matches1"].numpy() == ref["matches1"]).mean() >= 0.99
    np.testing.assert_allclose(out["matching_scores0"].numpy(), ref["matching_scores0"], atol=1e-3)
    if masked:  # padded keypoints are never matched
        assert (out["matches0"].numpy()[~data["keypoint_mask0"]] == -1).all()
        assert (out["matches1"].numpy()[~data["keypoint_mask1"]] == -1).all()


def test_superglue_bridge_is_strict_and_complete():
    data = _data(0, 1, 16, 16, False)
    jm = jax_model("superglue").from_conf(CONF)
    variables = jm.init(jax.random.PRNGKey(0), _convert(data, jnp.asarray))
    state = superglue_from_flax(variables)
    assert len(state) == len(jax.tree.leaves(variables))
    tm = get_model("superglue")(CONF, device="cpu")
    assert set(state) == set(tm.state_dict())
    # a Dense kernel (in, out) arrives as nn.Linear's (out, in)
    kernel = np.asarray(variables["params"]["cross_1"]["Dense_2"]["kernel"])
    np.testing.assert_array_equal(state["gnn.3.v.weight"].numpy(), kernel.T)
    # flat "a/b/c" keys, without the "params" level, map the same way
    flat = {"self_0/_MLP_0/LayerNorm_0/scale": np.ones(128, np.float32)}
    assert list(superglue_from_flax(flat)) == ["gnn.0.mlp.norm.0.weight"]


def test_normalisation_and_transport_match_jax():
    rng = np.random.RandomState(1)
    kpts = (rng.rand(2, 12, 2) * 300).astype(np.float32)
    mask = np.ones((2, 12), bool)
    mask[:, 9:] = False
    size = np.asarray([[320.0, 240.0]] * 2, np.float32)
    for sz, mk in ((size, None), (None, mask), (None, None)):
        ref = jsg.normalize_keypoints_superglue(
            jnp.asarray(kpts), None if sz is None else jnp.asarray(sz),
            None if mk is None else jnp.asarray(mk))
        out = tsg.normalize_keypoints_superglue(
            torch.from_numpy(kpts), None if sz is None else torch.from_numpy(sz),
            None if mk is None else torch.from_numpy(mk))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    scores = rng.randn(2, 12, 10).astype(np.float32)
    mask1 = np.ones((2, 10), bool)
    mask1[1, 6:] = False
    for m0, m1 in ((None, None), (mask, mask1)):
        ref = jsg.log_optimal_transport(
            jnp.asarray(scores), jnp.asarray(1.0), 30,
            None if m0 is None else jnp.asarray(m0), None if m1 is None else jnp.asarray(m1))
        out = tsg.log_optimal_transport(
            torch.from_numpy(scores), torch.tensor(1.0), 30,
            None if m0 is None else torch.from_numpy(m0),
            None if m1 is None else torch.from_numpy(m1))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_superglue_training_raises():
    with pytest.raises(NotImplementedError):
        get_model("superglue")({**CONF, "is_training": True}, device="cpu")
    with pytest.raises(NotImplementedError):
        get_model("superglue")(CONF, device="cpu").loss({}, {})
