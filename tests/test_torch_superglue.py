"""SuperGlue of the port against the JAX model on the CPU: the JAX model
initialised from a seed, its parameters carried across by
weights.superglue_from_flax, masked inputs with m != n at a small size
(3 layer pairs, 64 wide, 2 heads, 20 Sinkhorn iterations). The JAX model
runs its XLA attention, the port its plain per-head attention (what
`ops.attention.masked_attention` takes for CPU tensors). Bars: fp32,
`log_assignment` within 1e-3 (20 log-sum-exp sweeps over ~30 entries a line
carry summation-order noise of ~1e-5), `matches0` / `matches1` equal on at
least 99% of entries.

Training, at tests/test_superglue.py's model (64-D, 1 layer pair, 2 heads,
20 Sinkhorn iterations, `is_training`) on its matching data: the loss
within 1e-5 relative of `jax.value_and_grad`, every gradient within 1e-4 of
its leaf's max|g| (of the model's for a leaf that is zero in exact
arithmetic, below 1e-6 of it: the key bias, which the softmax cancels);
its 15 Adam steps (lr 1e-3) lower the port's loss by more than 0.2, as the
JAX test asks of the JAX model; and a `Trainer` step with SuperGlue as the
matcher of the tiny training configuration.
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
    variables = jax.jit(jm.init)(jax.random.PRNGKey(m), jdata)
    # the dustbin score away from its initial 1, so that the bridge carries it
    variables = {"params": {**variables["params"], "bin_score": jnp.asarray(0.7)}}
    ref = jax.tree.map(np.asarray, jax.jit(jm.apply)(variables, jdata))

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
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), _convert(data, jnp.asarray))
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
    """Training is ported: an inference SuperGlue trains nothing and records
    no gradient, a training one does both; its loss raises only for want of
    the ground-truth labels."""
    data = _convert(_data(0, 1, 16, 12, True), torch.from_numpy)
    frozen = get_model("superglue")(CONF, device="cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    assert not frozen(data)["log_assignment"].requires_grad
    model = get_model("superglue")({**CONF, "is_training": True}, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    pred = model(data)
    assert pred["log_assignment"].requires_grad
    with pytest.raises(KeyError, match="gt_assignment"):
        model.loss(pred, data)


TRAIN = {"descriptor_dim": 64, "input_dim": 64, "GNN_layers": 1, "num_heads": 2,
         "sinkhorn_iterations": 20, "is_training": True}  # tests/test_superglue.py's model


def _train_data():
    """tests/test_superglue.py's matching data and labels, as numpy."""
    from gluefactory_tpu.geometry.gt_generation import gt_matches_from_homography
    from test_models import make_matching_data

    data, _, _ = make_matching_data(np.random.RandomState(0), b=2, n=32, d=64)
    gt = gt_matches_from_homography(data["keypoints0"], data["keypoints1"], data["H_0to1"],
                                    pos_th=3)
    data = {**data, "gt_assignment": gt["assignment"], "gt_matches0": gt["matches0"],
            "gt_matches1": gt["matches1"]}
    return _convert(data, np.asarray)


def test_superglue_loss_and_gradients_match_jax():
    data = _train_data()
    jdata = _convert(data, jnp.asarray)
    jm = jax_model("superglue").from_conf(TRAIN)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jdata)

    def loss_fn(p):
        losses, _ = jm.apply(p, jm.apply(p, jdata), jdata, method="loss")
        return losses["total"].mean()

    ref_loss, ref = jax.jit(jax.value_and_grad(loss_fn))(variables)
    ref = superglue_from_flax(ref)

    tm = get_model("superglue")(TRAIN, device="cpu")
    tm.load_state_dict(superglue_from_flax(variables), strict=True)
    tdata = _convert(data, lambda a: torch.from_numpy(np.array(a)))
    losses, metrics = tm.loss(tm(tdata), tdata)
    assert metrics == {} and {"total", "assignment_nll", "nll_pos", "nll_neg"} <= set(losses)
    loss = losses["total"].mean()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    params = dict(tm.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert set(grads) == set(ref)
    top = max(float(r.abs().max()) for r in ref.values())
    for k, r in ref.items():
        leaf = float(r.abs().max())
        scale = leaf if leaf > 1e-6 * top else top
        np.testing.assert_allclose(grads[k].numpy(), r.numpy(), atol=1e-4 * scale, rtol=0,
                                   err_msg=k)


def test_superglue_overfit_loss_decreases():
    from gluefactory_tpu_torch.train.step import TrainState, make_optimizer, make_train_step

    data = _convert(_train_data(), lambda a: torch.from_numpy(np.array(a)))
    model = get_model("superglue")(TRAIN, device="cpu")
    params = dict(model.named_parameters())
    # optax.adam(1e-3), as the JAX test: no clipping
    state = TrainState(0, params, make_optimizer({"lr": 1e-3, "grad_clip": float("inf")}, params))
    step = make_train_step(model)
    losses = []
    for _ in range(15):
        state, out = step(state, data)
        losses.append(float(out["total"]))
    assert losses[-1] < losses[0] - 0.2, losses


def test_superglue_as_the_trained_matcher():
    from scipy.ndimage import gaussian_filter

    from gluefactory_tpu_torch.train.trainer import Trainer

    rng = np.random.RandomState(3)
    big = gaussian_filter(rng.rand(2, 100, 135), (0, 1.5, 1.5)).astype(np.float32)
    big = (big - big.min()) / (big.max() - big.min())
    H = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    H[:, 0, 2], H[:, 1, 2] = -7, -4
    batch = {"view0": {"image": torch.from_numpy(big[:, :96, :128, None].copy())},
             "view1": {"image": torch.from_numpy(big[:, 4:, 7:, None].copy())},
             "H_0to1": torch.from_numpy(H)}
    conf = {"model": {
        "name": "two_view_pipeline",
        "extractor": {"name": "superpoint_open", "channels": [8, 8, 16, 16, 32],
                      "descriptor_dim": 64, "max_num_keypoints": 32,
                      "detection_threshold": 0.0, "dtype": "float32"},
        "matcher": {"name": "superglue", **TRAIN},
        "ground_truth": {"name": "homography_matcher", "th_positive": 3.0}},
        "train": {"lr": 1e-3}}
    trainer = Trainer(conf, device="cpu")
    assert all(k.startswith("matcher.") for k in trainer.state.params)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    out = trainer.train_steps([batch, batch])
    assert [o["skipped_nonfinite"] for o in out] == [0.0, 0.0]
    assert all(np.isfinite(o["total"]) for o in out) and out[0]["num_matchable"] > 0
    after = trainer.model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved == {k for k in before if k.startswith("matcher.")}
