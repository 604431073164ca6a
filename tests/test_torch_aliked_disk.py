"""The port's ALIKED, DISK (with its training loss) and DISK-official against
the JAX package on the CPU: each initialised by the JAX package (seeded) and
carried across by `weights.params_from_jax`, on the same numpy-seeded
images, at narrow widths (`aliked-t16`, DISK channels [8, 16, 16]).

Bars (measured, then fixed): dense maps (ALIKED's score map, DISK's
heatmap, DISK-official's heatmap and dense descriptors) within 1e-4 of
their max|ref|; at least 99% of the valid keypoints shared (ALIKED's
refined sub-pixel positions within 1e-4 px), scores within 1e-5 (ALIKED's
dispersity too), descriptors within 1e-4 on the shared ones; DISK's loss
terms within 1e-5 relative and every parameter's gradient within 1e-3 of
its own max|g| of `jax.value_and_grad`; `deform_conv2d` within 1e-5; the
flax trees back through `weights.params_to_jax` bit for bit, and
`conf.weights` (the JAX package's converted `.npz`) loads them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.extractors import aliked as ja
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.extractors import aliked as ta
from gluefactory_tpu_torch.weights import params_from_jax, params_to_jax

CASES = {
    "aliked_t16": ("aliked", {"model_name": "aliked-t16", "max_num_keypoints": 64}, (2, 64, 96)),
    "aliked_t16_unpadded_size": ("aliked", {"model_name": "aliked-t16", "max_num_keypoints": 48,
                                            "detection_threshold": 0.0}, (1, 70, 100)),
    "disk": ("disk", {"channels": [8, 16, 16], "max_num_keypoints": 64}, (2, 64, 96)),
    "disk_official": ("disk_official", {"max_num_keypoints": 64, "down": [8, 8, 16, 16, 16],
                                        "up": [16, 16, 16], "desc_dim": 32}, (2, 70, 90)),
}
DENSE = {"aliked": ["score_map"], "disk": ["heatmap"], "disk_official": []}


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, b, h, w):
    rng = np.random.RandomState(seed)
    img = gaussian_filter(rng.rand(b, h, w, 3), (0, 1.5, 1.5, 0))
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


_INITS = {}  # (model, model_name): the JAX variables of PRNGKey(1)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    name, conf, shape = CASES[request.param]
    img = _images(len(request.param), *shape)
    jm = jax_model(name).from_conf(conf)
    data = {"image": jnp.asarray(img)}

    def init_apply(key, data):
        variables = jm.init(key, data)
        return variables, jm.apply(variables, data)

    # one architecture's PRNGKey(1) init does not depend on the keypoint settings or the
    # image size: a second case of it applies the first's variables
    arch = (name, conf.get("model_name"))
    if arch in _INITS:
        variables = _INITS[arch]
        ref = jax.jit(jm.apply)(variables, data)
    else:
        variables, ref = jax.jit(init_apply)(jax.random.PRNGKey(1), data)
        variables = _INITS[arch] = jax.tree.map(np.asarray, variables)
    tm = get_model(name)(conf, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)
    out = {k: v.numpy() for k, v in tm({"image": _t(img)}).items()}
    extra = {}
    if name == "disk_official":  # the dense maps
        h, dense = jax.jit(lambda v, x: jm.apply(v, x, method="dense_forward"))(
            variables, jnp.asarray(np.pad(img, ((0, 0), (0, 10), (0, 6), (0, 0)))))
        th, tdense = tm.dense_forward(
            torch.nn.functional.pad(_t(img).permute(0, 3, 1, 2), (0, 6, 0, 10)))
        extra = {"ref": (np.asarray(h), np.asarray(dense)), "out": (th.numpy(), tdense.numpy())}
    return name, conf, variables, jax.tree.map(np.asarray, ref), out, tm, extra


def _shared(ref, out, b, tol=1e-4):
    valid = np.where(ref["keypoint_mask"][b])[0]
    r, o = ref["keypoints"][b][valid], out["keypoints"][b]
    d = np.abs(r[:, None] - o[None]).max(-1) + np.where(out["keypoint_mask"][b], 0, 1e9)[None]
    j = d.argmin(1)
    ok = d[np.arange(len(r)), j] < tol
    return valid[ok], j[ok], ok.mean()


def test_dense_maps(pair):
    name, _, _, ref, out, _, extra = pair
    for k in DENSE[name]:
        scale = np.abs(ref[k]).max()
        assert np.abs(out[k] - ref[k]).max() <= 1e-4 * scale, k
    if extra:
        for r, o in zip(extra["ref"], extra["out"]):
            assert np.abs(o - r).max() <= 1e-4 * np.abs(r).max()


def test_keypoints_and_scores(pair):
    name, _, _, ref, out, _, _ = pair
    assert ref["keypoint_mask"].sum() > 20
    for b in range(ref["keypoints"].shape[0]):
        i, j, share = _shared(ref, out, b)
        assert share >= 0.99, (b, share)
        np.testing.assert_allclose(out["keypoint_scores"][b][j], ref["keypoint_scores"][b][i],
                                   atol=1e-5)
        if "score_dispersity" in ref:
            np.testing.assert_allclose(out["score_dispersity"][b][j],
                                       ref["score_dispersity"][b][i], atol=1e-5)


def test_descriptors(pair):
    _, _, _, ref, out, _, _ = pair
    for b in range(ref["keypoints"].shape[0]):
        i, j, _ = _shared(ref, out, b)
        np.testing.assert_allclose(out["descriptors"][b][j], ref["descriptors"][b][i], atol=1e-4)
    assert set(out) == set(ref)


def test_bridge_round_trip_and_npz_weights(pair, tmp_path):
    name, conf, variables, ref, out, tm, _ = pair
    back = dict(_flat(params_to_jax(tm.state_dict())))
    flat = dict(_flat(variables))
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    np.savez(tmp_path / "w.npz", **flat)  # the layout of scripts/convert_weights.py
    loaded = get_model(name)({**conf, "weights": str(tmp_path / "w.npz")}, device="cpu")
    for k, v in tm.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not any(p.requires_grad for p in loaded.parameters())


def test_deform_conv2d_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, 5).astype(np.float32)
    off = (rng.randn(2, 9, 11, 18) * 2).astype(np.float32)  # taps past every border
    kernel = rng.randn(3, 3, 5, 7).astype(np.float32)
    bias = rng.randn(7).astype(np.float32)
    ref = np.asarray(jax.jit(ja.deform_conv2d)(x, off, kernel, bias))
    out = ta.deform_conv2d(_t(x).permute(0, 3, 1, 2), _t(off).permute(0, 3, 1, 2),
                           _t(kernel).permute(3, 2, 0, 1), _t(bias))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)
    px = (rng.rand(2, 30) * 13 - 1).astype(np.float32)
    py = (rng.rand(2, 30) * 11 - 1).astype(np.float32)
    ref = np.asarray(ja._bilinear_raw(jnp.asarray(x), px, py))
    np.testing.assert_allclose(ta._bilinear_raw(_t(x), _t(px), _t(py)).numpy(), ref, atol=1e-6)


# ------------------------------------------------------------------ DISK loss
DISK_TRAIN = {"channels": [8, 16, 16], "is_training": True, "kp_desc_num": 16, "cell": 8}


@pytest.fixture(scope="module")
def disk_loss_pair():
    rng = np.random.RandomState(7)
    b, h, w = 2, 32, 48
    img = _images(8, b, h, w)
    img2 = np.roll(img, (2, 3), axis=(1, 2))
    km = (rng.rand(b, h, w) < 0.04).astype(np.float32)
    H = np.stack([np.array([[1, 0.02, 3.0], [0.01, 1, 2.0], [1e-4, 0, 1]], np.float32),
                  np.array([[0.98, 0, -1.5], [0, 1.01, 1.0], [0, 2e-4, 1]], np.float32)])
    valid = np.ones((b, h, w), np.float32)
    valid[:, :4] = 0
    data = {"image": img, "image2": img2, "keypoint_map": km,
            "keypoint_map2": np.roll(km, (2, 3), axis=(1, 2)), "valid_mask": valid,
            "valid_mask2": valid, "H_0to1": H}
    jm = jax_model("disk").from_conf(DISK_TRAIN)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(2), jdata)

    def loss(params, d):
        pred = jm.apply({"params": params}, d)
        losses, _ = jm.apply({"params": params}, pred, d, method="loss")
        return losses["total"].mean(), losses

    (_, ref_losses), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], jdata)
    tm = get_model("disk")(DISK_TRAIN, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    tdata = {k: _t(v) for k, v in data.items()}
    losses, _ = tm.loss(tm(tdata), tdata)
    losses["total"].mean().backward()
    grads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    ref_grads = params_from_jax({"params": jax.tree.map(np.asarray, ref_grads)})
    return jax.tree.map(np.asarray, ref_losses), losses, ref_grads, grads


def test_disk_loss_matches_jax(disk_loss_pair):
    ref, out, _, _ = disk_loss_pair
    assert set(out) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(out[k].detach().numpy(), v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(ref["kp_desc_loss"].min()) > 0  # the InfoNCE saw valid keypoints


def test_disk_gradients_match_jax(disk_loss_pair):
    _, _, ref, grads = disk_loss_pair
    assert set(grads) == set(ref)
    ref = {k: g.numpy() for k, g in ref.items()}
    top = max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        # each leaf against its own max|g|; a leaf that is zero in exact
        # arithmetic against the module's
        leaf = float(np.abs(g).max())
        scale = leaf if leaf > 1e-6 * top else top
        assert np.abs(grads[k] - g).max() <= 1e-3 * scale, k


def test_disk_in_a_pipeline_has_no_loss():
    """An inference DISK in a two-view pipeline: its loss is skipped."""
    pipe = get_model("two_view_pipeline")({
        "extractor": {"name": "disk", "channels": [8, 16, 16], "max_num_keypoints": 32},
        "matcher": {"name": "nearest_neighbor_matcher"}}, device="cpu")
    img = _images(9, 1, 48, 64)
    data = {v: {"image": _t(img)} for v in ("view0", "view1")}
    pred = pipe(data)
    assert (pred["matches0"] == torch.arange(32)).float().mean() > 0.9  # the same image
    with pytest.raises(NotImplementedError):
        pipe.extractor.loss(pred, data)
