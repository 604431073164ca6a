"""The port's multispectral models against the JAX package on the CPU:
MultiPoint, XPoint (swin, swinir, scunet, at dim 32, window 4, depth 2) and SuperPoint-MagicLeap, each initialised by the JAX package (seeded) and
carried across by `weights.params_from_jax`, on the same numpy-seeded
images.

Bars: logits, prob, dense descriptors, sampled descriptors and keypoint
scores within 1e-4 (measured <= 7.1e-6, scunet's logits); keypoints equal
where the scores are separated (no neighbour in the ranking within twice
the largest score difference between the packages: ties and near-ties may
order either way, and the seeded detectors score most pixels near 1/65);
the flax tree back through `params_to_jax` bit for bit. XPoint's swin_lite,
cbam and vit encoders the same way; its homography heads (pool, srhen at
width 0.5 and 1, ms2cahe) on a pair of feature maps within 1e-4, their
trees back bit for bit. XPoint's swinir on a
16 x 48 image, whose feature map is narrower than the window, within 1e-4
of the JAX model initialised on that image (its window cut to the map, its
relative-position table declared for the cut window); a table made for
another window refused, as flax refuses it. Routing: the thermal view goes through the
thermal encoder, also when the two-view pipeline stacks both views into one
extractor call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_init import jit_o0
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.utils.layers import same_padding
from gluefactory_tpu_torch.weights import params_from_jax, params_to_jax

MP_JAX = "gluefactory_tpu.multipoint.models."
MP = "gluefactory_tpu_torch.multipoint.models."
NARROW = {"head_channels": 32, "descriptor_size": 32, "max_num_keypoints": 32}
XP = {"backbone_dim": 32, "backbone_depth": 2, "window": 4, **NARROW}
MODELS = {
    "multipoint": ("multipoint", {"channels": [8, 8, 16, 16], **NARROW}),
    "xpoint-swin": ("xpoint", {"backbone": "swin", **XP}),
    "xpoint-swinir": ("xpoint", {"backbone": "swinir", **XP}),
    "xpoint-scunet": ("xpoint", {"backbone": "scunet", **XP}),
    "xpoint-swin_lite": ("xpoint", {"backbone": "swin_lite", **XP}),
    "xpoint-cbam": ("xpoint", {"backbone": "cbam", **XP}),
    "xpoint-vit": ("xpoint", {"backbone": "vit", **XP}),
    "magicleap": ("superpoint_magicleap", {"max_num_keypoints": 64, "dense_outputs": True}),
    "magicleap-fixed": ("superpoint_magicleap", {"max_num_keypoints": 64,
                                                 "legacy_sampling": False}),
}


def _names(key):
    name = MODELS[key][0]
    if name == "superpoint_magicleap":
        return name, name
    return MP_JAX + name, MP + name


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return rng.rand(2, 64, 96, 1).astype(np.float32), np.array([True, False])


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request, inputs):
    """(JAX variables, JAX outputs, the port's model with them, its outputs)."""
    key = request.param
    jname, tname = _names(key)
    conf = MODELS[key][1]
    img, opt = inputs
    jm = jax_model(jname).from_conf(conf)
    data = {"image": jnp.asarray(img), "is_optical": jnp.asarray(opt)}

    def init_apply(key, data):  # one compile for both
        variables = jm.init(key, data)
        return variables, jm.apply(variables, data)

    variables, ref = jit_o0(init_apply)(jax.random.PRNGKey(0), data)
    ref = jax.tree.map(np.asarray, ref)
    model = get_model(tname)(conf, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    with torch.no_grad():
        out = model({"image": torch.from_numpy(img), "is_optical": torch.from_numpy(opt)})
    return key, variables, ref, model, {k: v.numpy() for k, v in out.items()}


def test_outputs_match_jax(pair):
    key, _, ref, _, out = pair
    for k in ("logits", "prob", "dense_descriptors", "descriptors", "keypoint_scores"):
        if k in ref:
            np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-4, err_msg=f"{key} {k}")
    np.testing.assert_array_equal(out["keypoint_mask"], ref["keypoint_mask"])


def test_keypoints_match_jax_where_scores_are_separated(pair):
    key, _, ref, _, out = pair
    scores = ref["keypoint_scores"]
    # rounding moves each score by at most `err`: neighbours further apart
    # than twice that keep their order
    err = np.abs(out["keypoint_scores"] - scores).max()
    gap = np.abs(np.diff(scores, axis=1))
    separated = np.ones_like(scores, bool)
    separated[:, 1:] &= gap > 2 * err + 1e-9
    separated[:, :-1] &= gap > 2 * err + 1e-9
    assert separated.any(), key
    np.testing.assert_array_equal(out["keypoints"][separated], ref["keypoints"][separated])


def test_weights_round_trip_to_the_flax_tree(pair):
    _, variables, _, model, _ = pair
    ref = dict(_flat(jax.tree.map(np.asarray, variables)))
    back = dict(_flat(params_to_jax(model.state_dict())))
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


@pytest.mark.parametrize("key", ["multipoint", "xpoint-swinir"])
def test_thermal_view_uses_the_thermal_encoder(key, inputs):
    _, tname = _names(key)
    model = get_model(tname)(MODELS[key][1], device="cpu").eval()
    img = torch.from_numpy(inputs[0])
    with torch.no_grad():
        mixed = model({"image": img, "is_optical": torch.tensor([True, False])})["logits"]
        thermal = model.detector_head(model.encoder_thermal(img.permute(0, 3, 1, 2), False),
                                      False).permute(0, 2, 3, 1)
        optical = model.detector_head(model.encoder_optical(img.permute(0, 3, 1, 2), False),
                                      False).permute(0, 2, 3, 1)
        default = model({"image": img})["logits"]
    torch.testing.assert_close(mixed[1], thermal[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(mixed[0], optical[0], rtol=0, atol=1e-6)
    assert (thermal[1] - optical[1]).abs().max() > 1e-3
    torch.testing.assert_close(default, optical)  # all optical without the flag


def test_batched_extraction_routes_the_thermal_view(inputs):
    """The two-view pipeline's one extractor call on both views carries
    is_optical (a (B,) bool tensor of each view) into the stacked batch."""
    conf = {"extractor": {"name": MP + "multipoint", **MODELS["multipoint"][1]},
            "batch_extraction": True}
    pipe = get_model("two_view_pipeline")(conf, device="cpu").eval()
    img = torch.from_numpy(inputs[0])
    data = {"view0": {"image": img[:1], "is_optical": torch.tensor([True])},
            "view1": {"image": img[1:], "is_optical": torch.tensor([False])}}
    assert pipe._can_batch_extract(data)
    with torch.no_grad():
        out = pipe(data)
        alone = pipe.extractor(data["view1"])
        as_optical = pipe.extractor({"image": img[1:]})
    torch.testing.assert_close(out["logits1"], alone["logits"], rtol=0, atol=1e-6)
    assert (out["logits1"] - as_optical["logits"]).abs().max() > 1e-3


@pytest.mark.parametrize("size,kernel,stride,pad", [
    (64, 3, 2, (0, 1)), (63, 3, 2, (1, 1)), (64, 3, 1, (1, 1)), (64, 1, 1, (0, 0)),
    (64, 4, 4, (0, 0)), (64, 2, 2, (0, 0))])
def test_same_padding_is_flax(size, kernel, stride, pad):
    assert same_padding(size, kernel, stride) == pad


def _hold_regression(conf, h_type):
    """XPoint's `regress_homography` on a pair of (2, 8, 12, 32) NHWC feature
    maps (the encoders' output at XP on a 64 x 96 image) against the JAX
    model's, the head initialised by the JAX package and carried over; the
    head's tree back bit for bit."""
    rng = np.random.RandomState(9)
    feats = [rng.randn(2, 8, 12, XP["backbone_dim"]).astype(np.float32) for _ in range(2)]
    jm = jax_model(MP_JAX + "xpoint").from_conf(conf)

    def init_apply(key, f0, f1):
        variables = jm.init(key, f0, f1, method="regress_homography")
        return variables, jm.apply(variables, f0, f1, method="regress_homography")

    variables, ref = jax.tree.map(np.asarray, jit_o0(init_apply)(
        jax.random.PRNGKey(0), *map(jnp.asarray, feats)))
    model = get_model(MP + "xpoint")(conf, device="cpu")
    missing, unexpected = model.load_state_dict(params_from_jax(variables), strict=False)
    assert not unexpected and not [k for k in missing if k.startswith("h_head.")]
    with torch.no_grad():
        out = model.regress_homography(*map(torch.from_numpy, feats)).numpy()
    assert model.h_type == h_type and out.shape == (2, 4, 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    head = {k: v for k, v in model.state_dict().items() if k.startswith("h_head.")}
    back = dict(_flat(params_to_jax(head)))
    ref_tree = dict(_flat(variables))
    assert set(back) == set(ref_tree)
    for k, v in ref_tree.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_unported_parts_raise():
    """`homography_head: True` is the pooled head (concatenated feature means,
    MLP 256 -> 128 -> 8): it regresses as the JAX model does and its tree
    round-trips; an unknown backbone or head still raises."""
    _hold_regression({"homography_head": True, **XP}, "pool")
    with pytest.raises(ValueError, match="unknown XPoint backbone"):
        get_model(MP + "xpoint")({"backbone": "resnet", **XP}, device="cpu")
    with pytest.raises(ValueError, match="unknown homography head"):
        get_model(MP + "xpoint")({"homography_head": "dlt", **XP}, device="cpu")


@pytest.fixture(scope="module")
def swinir_small():
    """XPoint swinir (window 4) initialised by the JAX package on a 16 x 48
    image, whose 2 x 6 feature map cuts the window to 2: the JAX blocks
    declare the 3 x 3-entry relative-position table of that window."""
    conf = {"backbone": "swinir", **XP}
    img = np.random.RandomState(7).rand(2, 16, 48, 1).astype(np.float32)
    jm = jax_model(MP_JAX + "xpoint").from_conf(conf)
    data = {"image": jnp.asarray(img)}

    def init_apply(key, data):
        variables = jm.init(key, data)
        return variables, jm.apply(variables, data)

    variables, ref = jax.tree.map(np.asarray, jit_o0(init_apply)(jax.random.PRNGKey(0), data))
    return conf, img, variables, ref


def test_swinir_window_cut_to_a_small_map_matches_jax(swinir_small):
    conf, img, variables, ref = swinir_small
    table = variables["params"]["encoder_optical"]["rstb0"]["block0"]["attn"]
    assert table["relative_position_bias_table"].shape == (9, 2)
    model = get_model(MP + "xpoint")(conf, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        out = {k: v.numpy() for k, v in model({"image": torch.from_numpy(img)}).items()}
    for k in ("logits", "prob", "dense_descriptors"):
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-4, err_msg=k)
    back = dict(_flat(params_to_jax(model.state_dict())))
    for k, v in _flat(variables):
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["small table, large map", "large table, small map"])
def test_swinir_refuses_a_table_of_another_window(case, swinir_small, inputs):
    """flax refuses a stored table whose shape differs from the one the
    map declares (ScopeParamShapeError); the port says why."""
    conf, small, variables, _ = swinir_small
    model = get_model(MP + "xpoint")(conf, device="cpu")
    if case == "small table, large map":
        model.load_state_dict(params_from_jax(variables), strict=True)
        img = inputs[0]
    else:
        img = small
    with torch.no_grad(), pytest.raises(ValueError, match="relative-position table"):
        model({"image": torch.from_numpy(img)})


@pytest.mark.parametrize("backbone,head,h_type", [
    ("swin_lite", {"type": "srhen", "width": 0.5}, "srhen"),
    ("cbam", "srhen", "srhen"),
    ("vit", "ms2cahe", "ms2cahe")], ids=["swin_lite", "cbam", "vit"])
def test_unported_backbones_raise(backbone, head, h_type):
    """XPoint with each of its other encoders builds with one of the other
    heads: the correlation head (SRHEN, width 0.5 and 1; its first conv
    sized by the map it sees) and the cross-attention head (MS2CAHE, flax's
    Dense_0 ... Dense_9) regress as the JAX model's do (the encoders
    themselves: `test_outputs_match_jax`)."""
    _hold_regression({"backbone": backbone, "homography_head": head, **XP}, h_type)


@pytest.mark.parametrize("name", ["multipoint", "xpoint", "superpoint_magicleap"])
def test_models_default_to_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = name if name == "superpoint_magicleap" else MP + name
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(path)()
