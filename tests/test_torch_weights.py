"""Weight bridge of the port (gluefactory_tpu_torch/weights.py): the committed
hermetic npz and a freshly initialised JAX pipeline both map onto the port's
two-view pipeline, leaf for leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_jax_init import jit_o0
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.weights import (
    HERMETIC, load_hermetic, params_from_jax, params_to_jax, port_key)

CONF = {
    "extractor": {"name": "superpoint_open", "max_num_keypoints": 32, "dtype": "float32"},
    "matcher": {"name": "lightglue"},
}


def test_hermetic_round_trip_all_keys():
    state = load_hermetic(device="cpu")
    with np.load(str(HERMETIC)) as flat:
        assert len(flat.files) == 103
        assert len(state) == 103
        for key in flat.files:
            ref = flat[key].astype(np.float32)
            if key.endswith("Conv_0/kernel"):
                ref = ref.transpose(3, 2, 0, 1)
            got = state[port_key(key)]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), ref)
    pipe = get_model("two_view_pipeline")(CONF, device="cpu")
    pipe.load_state_dict(state, strict=True)
    assert pipe.extractor.blocks[0].conv.weight.shape == (64, 1, 3, 3)
    assert pipe.matcher.self_Wqkv_w.shape == (9, 256, 768)


def test_params_from_fresh_jax_pipeline():
    rng = np.random.RandomState(0)
    img = jnp.asarray(rng.rand(1, 64, 64, 1), jnp.float32)
    data = {"view0": {"image": img}, "view1": {"image": img}}
    model = jax_model("two_view_pipeline").from_conf(CONF)
    variables = jit_o0(model.init)(jax.random.PRNGKey(1), data)
    state = params_from_jax(variables)
    pipe = get_model("two_view_pipeline")(CONF, device="cpu")
    pipe.load_state_dict(state, strict=True)
    kernel = np.asarray(variables["params"]["extractor"]["VGGBlock_4"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(
        pipe.extractor.blocks[4].conv.weight.numpy(), kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        pipe.matcher.cross_ffn1_w.detach().numpy(),
        np.asarray(variables["params"]["matcher"]["cross_ffn1_w"]))
    mean = np.asarray(variables["batch_stats"]["extractor"]["VGGBlock_11"]["BatchNorm_0"]["mean"])
    np.testing.assert_array_equal(pipe.extractor.blocks[11].bn_mean.numpy(), mean)


def test_params_to_jax_inverts_params_from_jax():
    """Every one of the 103 leaves comes back under its flax path, in the
    flax layout, bit for bit."""
    tree = params_to_jax(load_hermetic(device="cpu"))
    assert set(tree) == {"params", "batch_stats"}
    with np.load(str(HERMETIC)) as flat:
        for key in flat.files:
            node = tree
            for part in key.split("/"):
                node = node[part]
            np.testing.assert_array_equal(node, flat[key].astype(np.float32), err_msg=key)
    back = params_from_jax(tree)
    for key, value in load_hermetic(device="cpu").items():
        assert torch.equal(back[key], value), key
