"""The port's homography parts against the JAX package on the CPU:
`h_to_4pt`, HomographyNet (forward with running and with batch statistics,
loss, gradients, the weight bridge), the bilinear warp and homographic
adaptation, and the XPoint homography overfit of tests/test_multipoint.py.

Inputs come from numpy seeds; the JAX side runs under `jax.jit` in module
fixtures, and its variables reach the port through `weights.params_from_jax`.

Bars: `h_to_4pt` within 1e-5 relative; HomographyNet's outputs within 1e-4
of max|ref|, its loss within 1e-5 relative, each gradient within 1e-4 of
its own leaf's max|ref|; the warp within 1e-5 with the same coverage; the
sampled homographies equal and the aggregated maps within 1e-4; the flax
trees back bit for bit; the overfit at the JAX test's own bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_init import jit_o0
from gluefactory_tpu.geometry.homography import sample_homography_corners as jax_sample
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.multipoint.models.homography_net import h_to_4pt as jax_h_to_4pt
from gluefactory_tpu.multipoint.utils import homographies as jax_homographies
from gluefactory_tpu_torch.geometry.homography import sample_homography_corners
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.multipoint.models.homography_net import h_to_4pt
from gluefactory_tpu_torch.multipoint.utils.homographies import (homographic_adaptation,
                                                                 warp_image_bilinear)
from gluefactory_tpu_torch.weights import params_from_jax, params_to_jax

HNET = "gluefactory_tpu_torch.multipoint.models.homography_net"
HNET_CONF = {"channels": [8, 8, 16, 16], "fc_dim": 16}
HCONF = {"difficulty": 0.5, "translation": 0.2, "max_angle": 20}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def _homographies(rng, n):
    H = np.tile(np.eye(3), (n, 1, 1)) + rng.randn(n, 3, 3) * [[0.05, 0.05, 3], [0.05, 0.05, 3],
                                                                 [1e-4, 1e-4, 0]]
    return H.astype(np.float32)


def test_h_to_4pt_matches_jax():
    H = _homographies(np.random.RandomState(0), 4)
    ref = np.asarray(jax_h_to_4pt(jnp.asarray(H), (96, 64)))
    out = h_to_4pt(torch.from_numpy(H), (96, 64)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


# ----------------------------------------------------------------- HomographyNet
def _hnet_data(rng, b=2, h=32, w=48, c=3):
    return {"view0": {"image": rng.rand(b, h, w, c).astype(np.float32)},
            "view1": {"image": rng.rand(b, h, w, c).astype(np.float32)},
            "H_0to1": _homographies(rng, b)}


@pytest.fixture(scope="module")
def hnet():
    """JAX HomographyNet: variables, eval and batch-statistics outputs, the
    loss and the gradients of the mean total loss, all in one compile."""
    data = _hnet_data(np.random.RandomState(3))
    jm = jax_model("gluefactory_tpu.multipoint.models.homography_net").from_conf(HNET_CONF)
    jt = jax_model("gluefactory_tpu.multipoint.models.homography_net").from_conf(
        {**HNET_CONF, "is_training": True})
    jdata = jax.tree.map(jnp.asarray, data)

    def run(key, d):
        variables = jm.init(key, d)
        # running statistics away from their init, so that eval mode tests them
        variables = {"params": variables["params"], "batch_stats": jax.tree.map(
            lambda s: s + 0.1 * jnp.arange(s.shape[0]) / s.shape[0], variables["batch_stats"])}
        pred = jm.apply(variables, d)
        losses, metrics = jm.apply(variables, pred, d, method="loss")

        def total(params):
            p, new = jt.apply({"params": params, "batch_stats": variables["batch_stats"]}, d,
                              mutable=["batch_stats"])
            losses, _ = jt.apply({"params": params, **new}, p, d, method="loss")
            return losses["total"].mean(), (p, new)

        (_, (ptrain, new)), grads = jax.value_and_grad(total, has_aux=True)(
            variables["params"])
        return variables, pred, losses, metrics, ptrain, new, grads

    out = jax.tree.map(np.asarray, jit_o0(run)(jax.random.PRNGKey(0), jdata))
    return data, out


def _port_hnet(variables, **conf):
    model = get_model(HNET)({**HNET_CONF, **conf}, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def _torch_data(data):
    return {"view0": {"image": torch.from_numpy(data["view0"]["image"])},
            "view1": {"image": torch.from_numpy(data["view1"]["image"])},
            "H_0to1": torch.from_numpy(data["H_0to1"])}


@pytest.mark.parametrize("mode", ["running statistics", "batch statistics"])
def test_homography_net_forward_matches_jax(hnet, mode):
    data, (variables, pred, _, _, ptrain, new, _) = hnet
    training = mode == "batch statistics"
    model = _port_hnet(variables, is_training=training)
    with torch.no_grad():
        out = model(_torch_data(data))["h_4pt"].numpy()
    ref = ptrain["h_4pt"] if training else pred["h_4pt"]
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    if training:  # flax's running-average update of the batch statistics
        stats = dict(_flat(params_to_jax(model.state_dict())["batch_stats"]))
        for k, v in _flat(new["batch_stats"]):
            np.testing.assert_allclose(stats[k], v, rtol=0, atol=1e-6, err_msg=k)


def test_homography_net_loss_matches_jax(hnet):
    data, (variables, pred, losses, metrics, *_) = hnet
    model = _port_hnet(variables)
    tdata = _torch_data(data)
    with torch.no_grad():
        out_l, out_m = model.loss({"h_4pt": torch.from_numpy(pred["h_4pt"])}, tdata)
    for k in ("h4pt", "total"):
        np.testing.assert_allclose(out_l[k].numpy(), losses[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(out_m["corner_error"].numpy(), metrics["corner_error"],
                               rtol=1e-5)


def test_homography_net_gradients_match_jax(hnet):
    data, (variables, *_, grads) = hnet
    model = _port_hnet(variables, is_training=True)
    tdata = _torch_data(data)
    losses, _ = model.loss(model(tdata), tdata)
    losses["total"].mean().backward()
    ref = params_from_jax({"params": grads})
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    for k, g in ref.items():
        scale = g.abs().max().item()
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_homography_net_weights_round_trip(hnet):
    _, (variables, *_) = hnet
    back = dict(_flat(params_to_jax(_port_hnet(variables).state_dict())))
    ref = dict(_flat(variables))
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


# ---------------------------------------------------- the warp and the adaptation
def test_warp_image_bilinear_matches_jax():
    rng = np.random.RandomState(5)
    img = rng.rand(3, 40, 56, 2).astype(np.float32)
    H = _homographies(rng, 3)
    H[0] = np.eye(3)  # the identity: every pixel samples itself
    ref = np.asarray(jit_o0(jax_homographies.warp_image_bilinear)(jnp.asarray(img),
                                                                    jnp.asarray(H)))
    out = warp_image_bilinear(torch.from_numpy(img), torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[0], img[0], rtol=0, atol=1e-6)
    ones = np.ones_like(img[..., :1])
    inside_ref = np.asarray(jax_homographies.warp_image_bilinear(jnp.asarray(ones),
                                                                 jnp.asarray(H)))
    inside = warp_image_bilinear(torch.from_numpy(ones), torch.from_numpy(H)).numpy()
    np.testing.assert_array_equal(inside > 0, inside_ref > 0)
    assert 0.05 < (inside == 0).mean() < 0.95  # the warps leave the image in part


def test_sampled_homographies_match_jax():
    a, b = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(8):
        np.testing.assert_array_equal(sample_homography_corners((48, 40), (48, 40), rng=a,
                                                                **HCONF)[0],
                                      jax_sample((48, 40), (48, 40), rng=b, **HCONF)[0])


def _blobs():
    base = np.zeros((2, 40, 48, 1), np.float32)
    for i, (x, y) in enumerate([(12, 10), (30, 22), (20, 30), (38, 12)]):
        base[i % 2, y - 1:y + 2, x - 1:x + 2, 0] = 1.0
    return base


@pytest.fixture
def jitted_jax_warp(monkeypatch):
    """The JAX adaptation's warps under jit (one compile a shape, not one an
    op), patched into its module's namespace for the test."""
    monkeypatch.setattr(jax_homographies, "warp_image_bilinear",
                        jit_o0(jax_homographies.warp_image_bilinear))


@pytest.mark.parametrize("aggregation", ["mean", "max"])
def test_homographic_adaptation_matches_jax(aggregation, jitted_jax_warp):
    img = _blobs()
    ref = np.asarray(jax_homographies.homographic_adaptation(
        lambda x: jnp.clip(x[..., 0], 0, 1), jnp.asarray(img), num=6, aggregation=aggregation,
        rng=np.random.RandomState(0), hconf=HCONF))
    out = homographic_adaptation(lambda x: x[..., 0].clamp(0, 1), torch.from_numpy(img), num=6,
                                 aggregation=aggregation, rng=np.random.RandomState(0),
                                 hconf=HCONF).numpy()
    assert out.shape == (2, 40, 48)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert out[0, 9:12, 11:14].max() > 0.3 and out[0, 35:, 40:].max() < 0.15


def test_homographic_adaptation_of_superpoint_open_matches_jax(jitted_jax_warp):
    """The detector's probability (the training forward's logits, whose
    BatchNorm normalises by each call's batch in both packages) of
    SuperPoint-open on JAX-initialised weights."""
    conf = {"channels": [8, 8, 16, 16, 32], "descriptor_dim": 16, "is_training": True,
            "dtype": None}
    img = np.random.RandomState(2).rand(2, 32, 48, 1).astype(np.float32)
    jm = jax_model("superpoint_open").from_conf(conf)
    variables = jit_o0(jm.init)(jax.random.PRNGKey(0), {"image": jnp.asarray(img)})

    @jax.jit
    def jax_prob(x):
        logits = jm.apply(variables, {"image": x}, mutable=["batch_stats"])[0]["logits"]
        p = jax.nn.softmax(logits, -1)[..., :-1]
        b, hc, wc, _ = p.shape
        return p.reshape(b, hc, wc, 8, 8).transpose(0, 1, 3, 2, 4).reshape(b, hc * 8, wc * 8)

    model = get_model("superpoint_open")(conf, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables)), strict=True)

    def port_prob(x):
        logits = model({"image": x})["logits"].permute(0, 3, 1, 2)
        return torch.nn.functional.pixel_shuffle(torch.softmax(logits, 1)[:, :-1], 8)[:, 0]

    ref = np.asarray(jax_homographies.homographic_adaptation(
        jax_prob, jnp.asarray(img), num=4, rng=np.random.RandomState(1), hconf=HCONF))
    with torch.no_grad():
        out = homographic_adaptation(port_prob, torch.from_numpy(img), num=4,
                                     rng=np.random.RandomState(1), hconf=HCONF).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


# ------------------------------------------------------------- the XPoint overfit
def test_overfit_translation_pairs():
    """tests/test_multipoint.py::TestXPointHomographyOverfit on the port:
    XPoint (swin) with the pooled head, Adam at 3e-3 for 150 steps on two
    translation pairs; the loss falls five-fold, the offsets within 2 px."""
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    model = get_model("gluefactory_tpu_torch.multipoint.models.xpoint")(
        {"backbone": "swin", "backbone_dim": 32, "backbone_depth": 2, "window": 4,
         "head_channels": 16, "descriptor_size": 16, "multispectral": False,
         "homography_head": "pool"}, device="cpu")
    img0 = torch.from_numpy(rng.rand(2, 32, 32, 1).astype(np.float32))
    shifts = [(4, 2), (-6, 3)]
    img1 = torch.stack([torch.roll(img0[i], (s[1], s[0]), dims=(0, 1))
                        for i, s in enumerate(shifts)])
    H = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    for i, (dx, dy) in enumerate(shifts):
        H[i, 0, 2], H[i, 1, 2] = dx, dy
    gt = h_to_4pt(torch.from_numpy(H), (32, 32))

    def fwd():
        ones = torch.ones(2, dtype=torch.bool)
        f0 = model._encode(img0.permute(0, 3, 1, 2), ones).permute(0, 2, 3, 1)
        f1 = model._encode(img1.permute(0, 3, 1, 2), ones).permute(0, 2, 3, 1)
        return model.regress_homography(f0, f1)

    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    first = None
    for _ in range(150):
        opt.zero_grad()
        loss = ((fwd() - gt) ** 2).mean()
        loss.backward()
        opt.step()
        first = float(loss) if first is None else first
    assert float(loss) < first / 5, (first, float(loss))
    with torch.no_grad():
        assert (fwd() - gt).abs().mean() < 2.0
