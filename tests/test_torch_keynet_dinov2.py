"""The port's KeyNet-HardNet, grid extractor, mixed extractor and DINOv2
backbone against the JAX package on the CPU: each initialised by the JAX
package (seeded) and carried across by `weights.params_from_jax`, on the
same numpy-seeded images, at narrow sizes (2 KeyNet levels; DINOv2 at depth
2, width 64).

Bars (measured, then fixed): KeyNet's keypoints shared (>= 99%) with
scales equal, scores within 1e-5, oris within 1e-2 degrees (1e-4 rad) on
99%, descriptors and LAFs within 1e-4 on the shared ones; the grid exactly;
`mixed` within 1e-4 (both of its branches: a dense map sampled at the
detector's keypoints, and the descriptor model's outputs joined);
DINOv2's features and global descriptor within 1e-5 of max|ref| (with
O(1) LayerScale, so that each block's body counts; measured within 6.4e-7,
and a tanh GELU in place of the exact one misses it at 1.4e-4) on the
native position grid, on a grid that must be interpolated (Keys cubic) and
on an image that must first be resized to a multiple of 14; the flax trees
back through `weights.params_to_jax` bit for bit. Every extractor of the
slice resolves through `get_model` and defaults to the card.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.weights import params_from_jax, params_to_jax


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, b, h, w, c=1):
    rng = np.random.RandomState(seed)
    img = gaussian_filter(rng.rand(b, h, w, c), (0, 1.5, 1.5, 0))
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def _run(name, conf, img, seed=0, tweak=None):
    """(JAX variables, JAX outputs, the port's model with them, its outputs).
    `tweak` rewrites the seeded variables (numpy) before both models run."""
    jm = jax_model(name).from_conf(conf)
    data = {"image": jnp.asarray(img)}

    def init_apply(key, data):
        variables = jm.init(key, data)
        return variables, jm.apply(variables, data)

    if tweak is None:
        variables, ref = jax.jit(init_apply)(jax.random.PRNGKey(seed), data)
        variables = jax.tree.map(np.asarray, variables)
    else:
        variables = tweak(jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed), data)))
        ref = jax.jit(jm.apply)(variables, data)
    tm = get_model(name)(conf, device="cpu")
    if variables:
        tm.load_state_dict(params_from_jax(variables), strict=True)
    out = {k: v.numpy() for k, v in tm({"image": _t(img)}).items()}
    return variables, jax.tree.map(np.asarray, ref), tm, out


def _assert_round_trip(tm, variables):
    back = dict(_flat(params_to_jax(tm.state_dict())))
    flat = dict(_flat(variables))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


KEYNET = {"max_num_keypoints": 64, "num_levels": 2}


@pytest.fixture(scope="module")
def keynet():
    return _run("keynet_hardnet", KEYNET, _images(0, 2, 64, 96))


def test_keynet_keypoints_scales_scores(keynet):
    _, ref, _, out = keynet
    assert ref["keypoint_mask"].sum() > 40
    for b in range(2):
        valid = np.where(ref["keypoint_mask"][b])[0]
        d = np.abs(ref["keypoints"][b][valid][:, None] - out["keypoints"][b][None]).max(-1)
        j = d.argmin(1)
        ok = d[np.arange(len(valid)), j] == 0
        assert ok.mean() >= 0.99
        i, j = valid[ok], j[ok]
        np.testing.assert_array_equal(out["scales"][b][j], ref["scales"][b][i])
        np.testing.assert_allclose(out["keypoint_scores"][b][j], ref["keypoint_scores"][b][i],
                                   atol=1e-5)
        close = np.abs(out["oris"][b][j] - ref["oris"][b][i]) <= 1e-2  # degrees
        assert close.mean() >= 0.99
        keep = j[close], i[close]
        np.testing.assert_allclose(out["descriptors"][b][keep[0]], ref["descriptors"][b][keep[1]],
                                   atol=1e-4)
        np.testing.assert_allclose(out["lafs"][b][keep[0]], ref["lafs"][b][keep[1]], atol=1e-4)


def test_keynet_bridge_round_trip(keynet):
    variables, ref, tm, out = keynet
    _assert_round_trip(tm, variables)
    assert set(out) == set(ref)
    assert "batch_stats" in variables  # KeyNet's and HardNet's BatchNorms


def test_keynet_upright():
    conf = {**KEYNET, "upright": True, "max_num_keypoints": 32}
    _, ref, _, out = _run("keynet_hardnet", conf, _images(1, 1, 48, 64), seed=1)
    assert (out["oris"] == 0).all() and (ref["oris"] == 0).all()
    np.testing.assert_allclose(out["descriptors"], ref["descriptors"], atol=1e-4)


def test_grid_extractor_matches_jax():
    for cs in (14, 8):
        _, ref, _, out = _run("grid_extractor", {"cell_size": cs}, _images(2, 2, 64, 90))
        for k, v in ref.items():
            np.testing.assert_array_equal(out[k], v)


@pytest.mark.parametrize("case", ["dense_descriptors", "joined"])
def test_mixed_matches_jax(case):
    det = {"name": "sift_tpu", "max_num_keypoints": 48}
    if case == "dense_descriptors":
        desc = {"name": "superpoint_open", "dtype": "float32", "dense_outputs": True,
                "channels": [8, 8, 16, 16, 32], "descriptor_dim": 32, "max_num_keypoints": 16}
    else:
        desc = {"name": "disk", "channels": [8, 16, 16], "max_num_keypoints": 16}
    conf = {"detector": det, "descriptor": desc,
            "interpolate_descriptors_from": "dense_descriptors"}
    img = _images(3, 1, 64, 96)
    jm = jax_model("mixed").from_conf(conf)
    data = {"image": jnp.asarray(img)}
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(4), data))
    ref = jax.tree.map(np.asarray, jax.jit(jm.apply)(variables, data))
    tm = get_model("mixed")(conf, device="cpu")
    sub = {col: tree["descriptor"] for col, tree in variables.items()}
    tm.descriptor.load_state_dict(params_from_jax(sub), strict=True)
    out = {k: v.numpy() for k, v in tm({"image": _t(img)}).items()}
    assert set(out) == set(ref)
    same = (out["keypoints"] == ref["keypoints"]).all(-1)
    assert same.mean() >= 0.99
    for k in ("descriptors", "keypoint_scores"):
        np.testing.assert_allclose(out[k][same], ref[k][same], atol=1e-4)
    if case == "joined":
        np.testing.assert_allclose(out["heatmap"], ref["heatmap"], atol=1e-4)


DINO = {"depth": 2, "embed_dim": 64, "num_heads": 2}


def _layer_scale(variables):
    """O(1) LayerScale in place of the seeded 1e-5, so that each block's body
    reaches the outputs (with 1e-5 a wrong or missing block body passes)."""
    rng = np.random.RandomState(6)
    for name, block in variables["params"].items():
        if name.startswith("block_"):
            for k in ("ls1", "ls2"):
                block[k] = (1 + 0.5 * rng.randn(*block[k].shape)).astype(np.float32)
    return variables


def _dinov2_err(out, ref):
    return max(np.abs(out[k] - v).max() / np.abs(v).max() for k, v in ref.items())


@pytest.mark.parametrize("case,grid,shape", [
    ("native_grid", 4, (2, 56, 56)), ("interpolated_grid", 5, (1, 42, 70)),
    ("resized_image", 5, (2, 64, 90))])
def test_dinov2_matches_jax(case, grid, shape):
    conf = {**DINO, "pos_grid": grid}
    variables, ref, tm, out = _run("backbones.dinov2", conf, _images(5, *shape, 3),
                                   tweak=_layer_scale)
    hp, wp = shape[1] // 14, shape[2] // 14
    assert out["features"].shape == (shape[0], hp, wp, 64)
    for k, v in ref.items():
        assert np.abs(out[k] - v).max() <= 1e-5 * np.abs(v).max(), k
    if case == "native_grid":
        _assert_round_trip(tm, variables)


def test_dinov2_bar_sees_the_block_body(monkeypatch):
    """The bar above fails for a block with the tanh GELU (flax's default,
    where DINOv2 asks for the exact one)."""
    from gluefactory_tpu_torch.models.backbones import dinov2

    conf = {**DINO, "pos_grid": 4}
    img = _images(5, 2, 56, 56, 3)
    _, ref, tm, out = _run("backbones.dinov2", conf, img, tweak=_layer_scale)
    assert _dinov2_err(out, ref) <= 1e-5
    monkeypatch.setattr(dinov2, "F", types.SimpleNamespace(
        gelu=lambda x: torch.nn.functional.gelu(x, approximate="tanh")))
    tanh = {k: v.numpy() for k, v in tm({"image": _t(img)}).items()}
    assert _dinov2_err(tanh, ref) > 1e-5


@pytest.mark.parametrize("name", ["sift_tpu", "aliked", "disk", "disk_official", "keynet_hardnet",
                                  "grid_extractor", "mixed", "backbones.dinov2"])
def test_registry_and_the_card_default(name, monkeypatch):
    conf = {"detector": {"name": "grid_extractor"}, "descriptor": {"name": "grid_extractor"}}
    model = get_model(name)(conf if name == "mixed" else {}, device="cpu")
    assert type(model).__module__.startswith("gluefactory_tpu_torch.models.")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(name)(conf if name == "mixed" else {})
