"""The port's on-device SIFT (`sift_tpu`), its helpers, LightGlue's
`add_scale_ori` and the homography dataset's `features.do` against the JAX
package on the CPU, on numpy-seeded inputs.

Bars (measured, then fixed): `jax.image.resize` (bilinear, antialiased,
and Keys cubic) within 1e-5; the blurs, derivatives, `extract_patches_laf`
and `dominant_orientation` within 1e-5 (the ramps of
tests/test_extractors.py too); `sift_tpu`: at least 99% of the valid
keypoints shared in (x, y, scale) (a tie in the global top-k may order
either way), scores within 1e-5 relative, `oris` within 1e-4 rad on 99% of
the shared ones. Descriptors: RootSIFT's input (the squared descriptor,
the clipped L1 histogram) within 1e-5 and its raw bins within 1e-4 where
their square exceeds 1e-4, and with `rootsift: False` the descriptors
within 1e-4. RootSIFT's square root is not Lipschitz at 0: a
bin that holds only the 1e-12-regularised magnitude of flat pixels (~1e-9)
moves by ~1e-4 under the last-ulp differences of cos / sin between the
frameworks' libms (measured: up to 5.5e-4 on 4% of keypoints of the
textures, the squares within 4.5e-7). LightGlue with `add_scale_ori` on
`sift_tpu` features: the bars of tests/test_torch_lightglue.py
(log_assignment within 5e-3, >= 99% of matches0) at inference, in the
adaptive loop and in training. `features.do`
sample for sample against the JAX `HomographyDataset` (`sift_tpu`): the
cached mode's warps, jitter, dropout and noise within 1e-5 and masks equal
on the same source features; the port's own features as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.datasets.homographies import HomographyDataset as JaxDataset
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.extractors import keynet_hardnet as jk
from gluefactory_tpu.models.extractors import sift_tpu as js
from gluefactory_tpu_torch.datasets.homographies import HomographyDataset
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors import keynet_hardnet as tk
from gluefactory_tpu_torch.models.extractors import sift_tpu as ts
from gluefactory_tpu_torch.models.utils.layers import resize_jax
from gluefactory_tpu_torch.weights import params_from_jax, params_to_jax


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, b, h, w, c=1):
    """Smooth random images in [0, 1] with some flat patches."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    img = gaussian_filter(rng.rand(b, h, w, c), (0, 1.5, 1.5, 0))
    img = (img - img.min()) / (img.max() - img.min())
    img[:, h // 3:h // 2, w // 4:w // 2] = 0.5
    return img.astype(np.float32)


def shared(ref, out, b, tol=1e-4):
    """(ref indices, out indices, share) of the valid keypoints of image b
    that both sides give at the same (x, y, scale)."""
    key = lambda p: np.concatenate([p["keypoints"][b], p["scales"][b][:, None]], -1)
    valid = np.where(ref["keypoint_mask"][b])[0]
    r, o = key(ref)[valid], key(out)
    d = np.abs(r[:, None] - o[None]).max(-1) + np.where(out["keypoint_mask"][b], 0, 1e9)[None]
    j = d.argmin(1)
    ok = d[np.arange(len(r)), j] < tol
    return valid[ok], j[ok], ok.mean()


@pytest.mark.parametrize("method,shape,size", [
    ("bilinear", (2, 3, 50, 61), (42, 51)), ("bilinear", (1, 4, 20, 30), (40, 60)),
    ("cubic", (1, 5, 37, 37), (9, 13)), ("cubic", (1, 4, 5, 5), (6, 8))])
def test_resize_matches_jax_image_resize(method, shape, size):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), shape[:2] + size, method))
    np.testing.assert_allclose(resize_jax(_t(x), size, method).numpy(), ref, atol=1e-5)


def test_blur_and_derivatives_match_jax():
    img = _images(1, 2, 40, 56)
    x = jnp.asarray(img)
    t = _t(img).permute(0, 3, 1, 2)
    for sigma in (0.96, 1.6, 2.3):
        np.testing.assert_allclose(tk._blur(t, sigma).permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jk._blur(x, sigma)), atol=1e-5)
        np.testing.assert_allclose(ts._blur_dw(t, sigma).permute(0, 2, 3, 1).numpy(),
                                   np.asarray(js._blur_dw(x, sigma)), atol=1e-5)
    np.testing.assert_allclose(tk.handcrafted_features(t).permute(0, 2, 3, 1).numpy(),
                               np.asarray(jk.handcrafted_features(x)), atol=1e-5)


@pytest.mark.parametrize("patch,mult", [(19, 1.0), (32, 1.5)])
def test_extract_patches_laf_matches_jax(patch, mult):
    rng = np.random.RandomState(patch)
    img = _images(2, 2, 60, 80)
    c = (rng.rand(2, 40, 2) * [80, 60]).astype(np.float32)  # some near and past the border
    s = (rng.rand(2, 40) * 10 + 1).astype(np.float32)
    o = (rng.rand(2, 40) * 6.2 - 3.1).astype(np.float32)
    ref = jax.jit(lambda *a: jk.extract_patches_laf(*a, patch=patch, radius_mult=mult))(
        jnp.asarray(img), c, s, o)
    out = tk.extract_patches_laf(_t(img[..., 0]), _t(c), _t(s), _t(o), patch, mult)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _ramp(p=19):
    return np.tile(np.linspace(0, 1, p)[None, :], (p, 1)).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "ramp_x", "ramp_y"])
def test_dominant_orientation_matches_jax(case):
    if case == "random":
        patches = _images(3, 2, 19, 19 * 30)[..., 0].reshape(2, 19, 30, 19).transpose(0, 2, 1, 3)
    else:
        ramp = _ramp() if case == "ramp_x" else _ramp().T
        patches = np.ascontiguousarray(ramp)[None, None]
    ref = np.asarray(jax.jit(jk.dominant_orientation)(jnp.asarray(patches)))
    out = tk.dominant_orientation(_t(patches)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    if case != "random":  # tests/test_extractors.py's ramp bars
        assert abs(out[0, 0] - (0.0 if case == "ramp_x" else np.pi / 2)) < 0.2


def test_sift_descriptor_matches_jax():
    patches = _images(4, 1, 18, 18 * 64)[0, ..., 0].reshape(18, 64, 18).transpose(1, 0, 2)
    for rootsift in (True, False):
        ref = np.asarray(jax.jit(lambda p: js.sift_descriptor(p, rootsift))(jnp.asarray(patches)))
        out = ts.sift_descriptor(_t(patches), rootsift).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)


RAW_FLOOR = 1e-4  # the squared value above which RootSIFT's raw bins are held
SIFT_CASES = {
    "gray": ({"max_num_keypoints": 128}, (2, 96, 128, 1)),
    "rgb_three_octaves": ({"max_num_keypoints": 96, "num_octaves": 3}, (1, 80, 112, 3)),
    "upright_plain_sift": ({"max_num_keypoints": 128, "upright": True, "rootsift": False},
                           (2, 96, 128, 1)),
}


@pytest.fixture(scope="module", params=list(SIFT_CASES))
def sift_pair(request):
    conf, shape = SIFT_CASES[request.param]
    img = _images(5, *shape[:3], shape[3])
    jm = jax_model("sift_tpu").from_conf(conf)
    ref = jax.tree.map(np.asarray, jax.jit(jm.apply)({}, {"image": jnp.asarray(img)}))
    out = {k: v.numpy() for k, v in get_model("sift_tpu")(conf, device="cpu")(
        {"image": _t(img)}).items()}
    matched = [shared(ref, out, b) for b in range(shape[0])]
    return conf, ref, out, matched


def test_sift_keypoints_shared(sift_pair):
    _, ref, out, matched = sift_pair
    assert ref["keypoint_mask"].sum() > 20
    for b, (_, _, share) in enumerate(matched):
        assert share >= 0.99, (b, share)
    assert abs(int(out["keypoint_mask"].sum()) - int(ref["keypoint_mask"].sum())) <= 2


def test_sift_scores_and_oris(sift_pair):
    conf, ref, out, matched = sift_pair
    for b, (i, j, _) in enumerate(matched):
        np.testing.assert_allclose(out["keypoint_scores"][b][j], ref["keypoint_scores"][b][i],
                                   rtol=1e-5)
        close = np.abs(out["oris"][b][j] - ref["oris"][b][i]) <= 1e-4
        assert close.mean() >= 0.99
        if conf.get("upright"):
            assert (out["oris"] == 0).all()


def hold_descriptors(d_out, d_ref, rootsift=True):
    """RootSIFT: its input (the squared descriptor) within 1e-5, and the raw
    descriptors within 1e-4 on the bins whose square exceeds RAW_FLOOR (a
    wrong orientation or spatial weight moves those); plain SIFT: the raw
    descriptors within 1e-4."""
    if rootsift:
        np.testing.assert_allclose(d_out**2, d_ref**2, atol=1e-5)
        full = d_ref**2 > RAW_FLOOR
        assert full.mean() > 0.1
        np.testing.assert_allclose(d_out[full], d_ref[full], atol=1e-4)
    else:
        np.testing.assert_allclose(d_out, d_ref, atol=1e-4)


def test_sift_descriptors(sift_pair):
    conf, ref, out, matched = sift_pair
    for b, (i, j, _) in enumerate(matched):
        d_out, d_ref = out["descriptors"][b][j], ref["descriptors"][b][i]
        hold_descriptors(d_out, d_ref, conf.get("rootsift", True))
        invalid = ~out["keypoint_mask"][b]
        assert (out["descriptors"][b][invalid] == 0).all()


def test_sift_outputs_and_registry(sift_pair):
    conf, ref, out, _ = sift_pair
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape and out[k].dtype == ref[k].dtype, k
    assert list(get_model("sift_tpu")(conf, device="cpu").parameters()) == []


# ------------------------------------------------------------ add_scale_ori
LG_MODES = {
    "inference": {},
    "adaptive": {"depth_confidence": 0.95, "width_confidence": 0.9},
    "training": {"is_training": True, "n_layers": 3},
}


@pytest.fixture(scope="module")
def sift_features():
    """sift_tpu features (JAX's) of a pair: one image and the same scene
    shifted by (9, 5) pixels, 128 keypoints each, input_dim 128."""
    img = _images(6, 1, 101, 137)
    views = (img[:, :96, :128], img[:, 5:, 9:])
    jm = jax_model("sift_tpu").from_conf({"max_num_keypoints": 128})
    f = jax.jit(jm.apply)
    data = {}
    for i, v in enumerate(views):
        pred = jax.tree.map(np.asarray, f({}, {"image": jnp.asarray(np.ascontiguousarray(v))}))
        for k in ("keypoints", "descriptors", "keypoint_mask", "scales", "oris"):
            data[f"{k}{i}"] = pred[k]
        data[f"view{i}"] = {"image_size": np.array([[128.0, 96.0]], np.float32)}
    return data


@pytest.mark.parametrize("mode", list(LG_MODES))
def test_lightglue_add_scale_ori_matches_jax(sift_features, mode):
    conf = {"add_scale_ori": True, "input_dim": 128, **LG_MODES[mode]}
    jm = jax_model("lightglue").from_conf(conf)
    conv = lambda d, fn: {k: conv(v, fn) if isinstance(v, dict) else fn(v) for k, v in d.items()}
    jdata = conv(sift_features, jnp.asarray)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), jdata)
    assert variables["params"]["posenc_Wr"].shape == (4, 32)
    ref = jax.tree.map(np.asarray, jax.jit(jm.apply)(variables, jdata))
    tm = get_model("lightglue")(conf, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    out = {k: v.detach().numpy() for k, v in tm(conv(sift_features, _t)).items()}
    np.testing.assert_allclose(out["log_assignment"], ref["log_assignment"], atol=5e-3)
    assert (out["matches0"] == ref["matches0"]).mean() >= 0.99
    assert (out["matches1"] == ref["matches1"]).mean() >= 0.99
    if mode == "inference":
        assert (out["matches0"] >= 0).sum() > 10


# --------------------------------------------------------------- features.do
FD_CONF = {"synthetic": {"do": True, "pool": 3, "size": [160, 120]}, "train_size": 4,
           "val_size": 1, "homography": {"patch_shape": [96, 72], "difficulty": 0.5},
           "features": {"do": True, "name": "sift_tpu", "max_num_keypoints": 64}}


class _Jitted:
    """The JAX dataset's extractor with its `apply` jitted (the dataset calls
    `apply({}, data)`): the same function, compiled once."""

    def __init__(self, model):
        self.apply = jax.jit(model.apply)


def _datasets(per_view):
    conf = {**FD_CONF, "features": {**FD_CONF["features"], "per_view": per_view}}
    jds = JaxDataset(conf)
    jds._extractor = _Jitted(jax_model("sift_tpu").from_conf({"max_num_keypoints": 64}))
    return jds, HomographyDataset(conf, device="cpu")


def test_features_do_cached_matches_jax():
    """The cached mode on the JAX source features: warps, jitter, dropout and
    noise drawn in the JAX order; then the port's own source features."""
    jds, tds = _datasets(False)
    jsplit, tsplit = jds.get_dataset("train"), tds.get_dataset("train")
    for idx in range(3):
        ref = jsplit[idx]
        name = jsplit.names[idx]
        tds._feature_cache[name] = jds._feature_cache[name]
        out = tsplit[idx]
        np.testing.assert_allclose(out["H_0to1"], ref["H_0to1"], rtol=1e-6)
        for v in ("view0", "view1"):
            assert "image" not in out[v] and set(out[v]["cache"]) == set(ref[v]["cache"])
            for k, a in ref[v]["cache"].items():
                b = out[v]["cache"][k]
                assert b.dtype == a.dtype and b.shape == a.shape, k
                if a.dtype == bool:
                    np.testing.assert_array_equal(b, a)
                else:
                    np.testing.assert_allclose(b, a, atol=1e-5)
            assert (out[v]["cache"]["keypoint_mask"]).sum() > 10
    for name, feats in jds._feature_cache.items():
        own = tds.extract_image(tds.read_image(name, None))
        _check_features({k: v[None] for k, v in feats.items()},
                        {k: v[None] for k, v in own.items()})


def _check_features(ref, out):
    """Keypoints shared (by position), scores within 1e-5, descriptors as
    `hold_descriptors` holds them."""
    valid = np.where(ref["keypoint_mask"][0])[0]
    r, o = ref["keypoints"][0][valid], out["keypoints"][0]
    d = np.abs(r[:, None] - o[None]).max(-1) + np.where(out["keypoint_mask"][0], 0, 1e9)[None]
    j = d.argmin(1)
    ok = d[np.arange(len(r)), j] < 1e-4
    assert ok.mean() >= 0.99
    i, j = valid[ok], j[ok]
    np.testing.assert_allclose(out["keypoint_scores"][0][j], ref["keypoint_scores"][0][i],
                               rtol=1e-5)
    hold_descriptors(out["descriptors"][0][j], ref["descriptors"][0][i])


def test_features_do_per_view_matches_jax():
    jds, tds = _datasets(True)
    jsplit, tsplit = jds.get_dataset("train"), tds.get_dataset("train")
    for idx in range(2):
        ref, out = jsplit[idx], tsplit[idx]
        for v in ("view0", "view1"):
            assert "image" not in out[v]
            rc, oc = ref[v]["cache"], out[v]["cache"]
            assert set(oc) == set(rc)
            _check_features({k: a[None] for k, a in rc.items()},
                            {k: a[None] for k, a in oc.items()})


def test_features_do_refuses_host_sift_and_parameters():
    with pytest.raises(NotImplementedError, match="not portable"):
        HomographyDataset({**FD_CONF, "features": {"do": True}}, device="cpu")
    with pytest.raises(ValueError, match="without parameters"):
        HomographyDataset({**FD_CONF, "features": {"do": True, "name": "superpoint_open"}},
                          device="cpu")


def test_features_do_feeds_the_pipeline():
    """A loader batch of the cached mode through a two-view pipeline with no
    extractor: LightGlue (input_dim 128) reads the cache."""
    tds = HomographyDataset({**FD_CONF, "train_batch_size": 2}, device="cpu")
    batch = next(iter(tds.get_data_loader("train")))
    from gluefactory_tpu_torch.utils.tensor import batch_to_device

    data = batch_to_device(batch, "cpu")
    pipe = get_model("two_view_pipeline")({
        "extractor": {"name": None}, "matcher": {"name": "lightglue", "input_dim": 128,
                                                 "n_layers": 2},
        "ground_truth": {"name": "homography_matcher"}, "run_gt_in_forward": True},
        device="cpu")
    pred = pipe(data)
    assert pred["matches0"].shape == (2, 64) and torch.isfinite(pred["log_assignment"]).all()
    assert pred["gt_matches0"].shape == (2, 64)


def test_posenc_with_scale_ori_through_the_bridge():
    tm = get_model("lightglue")({"add_scale_ori": True, "input_dim": 128}, device="cpu")
    assert tuple(tm.posenc_Wr.shape) == (4, 32)
    tree = params_to_jax(tm.state_dict())
    assert tree["params"]["posenc_Wr"].shape == (4, 32)
    back = params_from_jax(tree)
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())


# ------------------------------------------------------------ configurations
NEW_CONFIGS = ["sift_tpu+lightglue_homography", "aliked+lightglue_homography",
               "disk+lightglue_homography", "aliked+NN", "disk+NN"]


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_json_config_equals_the_jax_yaml(name):
    from pathlib import Path

    from gluefactory_tpu.utils.config import load_yaml
    from gluefactory_tpu_torch.utils.config import load_conf

    root = Path(__file__).resolve().parent.parent
    assert load_conf(name) == load_yaml(root / "gluefactory_tpu" / "configs" / f"{name}.yaml")


@pytest.mark.parametrize("name,extractor", [
    ("sift_tpu+lightglue_homography", {}),
    ("aliked+lightglue_homography", {}),
    ("disk+lightglue_homography", {"channels": [8, 16, 16]})])
def test_training_recipes_step_on_the_cpu(name, extractor):
    """Each recipe through the trainer at a tiny size: two finite steps,
    the extractor frozen, LightGlue (input_dim 128) moving."""
    from gluefactory_tpu_torch.train.trainer import Trainer
    from gluefactory_tpu_torch.utils.config import load_conf, merge

    conf = merge(load_conf(name), {
        "data": {"batch_size": 2, "train_size": 4, "val_size": 2, "num_workers": 0,
                 "synthetic": {"pool": 4, "size": [200, 150]},
                 "homography": {"patch_shape": [128, 96]}},
        "model": {"extractor": {"max_num_keypoints": 48, **extractor},
                  "matcher": {"n_layers": 2}}})
    trainer = Trainer(conf, None, None, device="cpu")
    trainer.build()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    losses = trainer.train_steps(trainer.dataset.get_data_loader("train"), 2)
    assert len(losses) == 2 and all(np.isfinite(v) for step in losses for v in step.values())
    after = trainer.model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert "matcher.input_proj_w" in moved
    assert not any(k.startswith("extractor.") for k in moved)
