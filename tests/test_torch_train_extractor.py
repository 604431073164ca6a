"""The two-view pipeline with a trainable extractor, and its composition
slots, against the JAX package on the CPU.

  - the tiny pipeline (SuperPoint-open [8, 8, 16, 16, 32] with 32-D
    descriptors and 32 keypoints, fp32; LightGlue 2 x 32; the homography
    ground truth) from the JAX model's seeded initialisation, carried across
    by `weights.params_from_jax`, on two 96 x 128 pairs: with
    `extractor.trainable: true` the loss within 1e-5 relative of
    `jax.value_and_grad` of the JAX pipeline, and each extractor and matcher
    gradient within 1e-4 of its leaf's max|g| (of its module's max|g| for
    the leaves that are zero in exact arithmetic, below 1e-6 of it: the
    conditional encoding's phase, which the rotary attention cancels);
  - `trainable: false` gives the same outputs, no gradient to the extractor
    and keeps its parameters out of the trainer's optimizer; the trainable
    extractor's parameters join it and move in a step, its running
    statistics do not;
  - `fused_block0: True` with a trainable extractor raises (K8 has no
    backward); an extractor without a trainable forward raises;
  - `cache` / `allow_no_extract` as the JAX pipeline's `extract_view`, and
    the filter and solver slots as plain composition, with a component
    defined here (the JAX package registers none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from torch_jax_init import jit_o0
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.train.trainer import Trainer
from gluefactory_tpu_torch.weights import params_from_jax

CONF = {
    "name": "two_view_pipeline",
    "extractor": {"name": "superpoint_open", "channels": [8, 8, 16, 16, 32], "descriptor_dim": 32,
                  "max_num_keypoints": 32, "detection_threshold": 0.0, "dtype": "float32",
                  "trainable": True},
    "matcher": {"name": "lightglue", "n_layers": 2, "descriptor_dim": 32, "input_dim": 32,
                "num_heads": 2, "is_training": True},
    "ground_truth": {"name": "homography_matcher", "th_positive": 3.0, "th_negative": 3.0},
}


def _pairs(seed, b=2, h=96, w=128, dx=7, dy=4):
    """Smooth random images and the same scenes shifted by (dx, dy)."""
    rng = np.random.RandomState(seed)
    big = np.stack([gaussian_filter(rng.rand(h + dy, w + dx), 1.5) for _ in range(b)])
    big = ((big - big.min()) / (big.max() - big.min())).astype(np.float32)
    H = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    H[:, 0, 2], H[:, 1, 2] = -dx, -dy
    return {"view0": {"image": big[:, :h, :w, None].copy()},
            "view1": {"image": big[:, dy:, dx:, None].copy()}, "H_0to1": H}


def _convert(data, fn):
    return {k: _convert(v, fn) if isinstance(v, dict) else fn(v) for k, v in data.items()}


def _with(trainable, **extractor):
    return {**CONF, "extractor": {**CONF["extractor"], "trainable": trainable, **extractor}}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX pipeline's seeded variables, its loss and gradients."""
    data = _convert(_pairs(0), jnp.asarray)
    jm = jax_model("two_view_pipeline").from_conf(CONF)
    variables = jit_o0(jm.init)(jax.random.PRNGKey(0), data)

    def loss_fn(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        losses, _ = jm.apply(v, jm.apply(v, data), data, method="loss")
        return losses["total"].mean()

    loss, grads = jit_o0(jax.value_and_grad(loss_fn))(variables["params"])
    state = params_from_jax(jax.tree.map(np.asarray, variables))
    return state, float(loss), params_from_jax({"params": jax.tree.map(np.asarray, grads)})


def _port(state, trainable, **extractor):
    model = get_model("two_view_pipeline")(_with(trainable, **extractor), device="cpu")
    model.load_state_dict(state, strict=True)
    return model.train()


def test_trainable_extractor_loss_and_gradients_match_jax(jax_run):
    state, ref_loss, ref_grads = jax_run
    model = _port(state, True)
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    assert set(params) == set(ref_grads)  # the extractor's parameters train too
    data = _convert(_pairs(0), torch.from_numpy)
    losses, _ = model.loss(model(data), data)
    loss = losses["total"].mean()
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=1e-5)
    # the detector head reaches only the keypoint scores, which LightGlue
    # does not read: no gradient (zero in JAX)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), (
        torch.autograd.grad(loss, list(params.values()), allow_unused=True)))}
    for module in ("extractor", "matcher"):
        top = max(float(g.abs().max()) for k, g in ref_grads.items() if k.startswith(module))
        for k, r in ref_grads.items():
            if not k.startswith(module):
                continue
            leaf = float(r.abs().max())
            scale = leaf if leaf > 1e-6 * top else top
            np.testing.assert_allclose(grads[k].numpy(), r.numpy(), atol=1e-4 * scale, rtol=0,
                                       err_msg=k)
    assert float(grads["extractor.blocks.0.conv.weight"].abs().max()) > 0


def test_frozen_extractor_gives_the_same_outputs_and_no_gradient(jax_run):
    state = jax_run[0]
    data = _convert(_pairs(1), torch.from_numpy)
    outs = []
    for trainable in (True, False):
        model = _port(state, trainable)
        pred = model(data)
        losses, _ = model.loss(pred, data)
        frozen = [p for k, p in model.named_parameters() if k.startswith("extractor.")]
        assert all(p.requires_grad == trainable for p in frozen)
        assert pred["descriptors0"].requires_grad == trainable
        outs.append((pred, losses))
    for k, v in outs[0][0].items():
        torch.testing.assert_close(outs[1][0][k], v.detach(), rtol=0, atol=0, msg=k)
    torch.testing.assert_close(outs[1][1]["total"], outs[0][1]["total"].detach(), rtol=0, atol=0)
    # under the caller's no_grad the trainable extractor records nothing either
    with torch.no_grad():
        assert not _port(state, True)(data)["descriptors0"].requires_grad


@pytest.mark.parametrize("trainable", [True, False])
def test_trainer_steps_the_extractor_only_when_trainable(jax_run, trainable):
    conf = {"model": _with(trainable), "train": {"lr": 1e-3}}
    trainer = Trainer(conf, device="cpu")
    trainer.load_weights(jax_run[0])
    assert any(k.startswith("extractor.") for k in trainer.state.params) == trainable
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    out = trainer.train_steps([_convert(_pairs(2), torch.from_numpy)])[0]
    assert out["skipped_nonfinite"] == 0.0 and np.isfinite(out["total"])
    after = trainer.model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert ("extractor.blocks.0.conv.weight" in moved) == trainable
    assert "matcher.self_Wqkv_w" in moved
    # the extractor runs its inference forward: its running statistics stay
    assert not any(k.endswith(("bn_mean", "bn_var")) for k in moved)


def test_trainable_extractor_refuses_what_has_no_backward():
    with pytest.raises(ValueError, match="K8"):
        get_model("two_view_pipeline")(_with(True, fused_block0=True), device="cpu")
    pipe = get_model("two_view_pipeline")(_with(True, fused_block0="auto"), device="cpu")
    assert pipe.extractor.conf.fused_block0 == "auto"  # takes the cuDNN block 0 on the card
    with pytest.raises(NotImplementedError, match="no trainable inference forward"):
        get_model("two_view_pipeline")({**CONF, "extractor": {
            "name": "superpoint_magicleap", "trainable": True}}, device="cpu")


COMPONENT = '''
import torch
from gluefactory_tpu_torch.models.base_model import BaseModel


class Tag(BaseModel):
    """Adds `<key>` (the number of matches, plus `shift`) to the predictions."""
    default_conf = {"key": None, "shift": 0}
    required_data_keys = ["matches0"]

    def forward(self, data):
        self.check_required_keys(data)
        return {self.conf.key: (data["matches0"] >= 0).sum(-1) + self.conf.shift
                + data.get("filtered", 0)}


__main_model__ = Tag
'''


def test_cache_and_filter_solver_slots(jax_run, tmp_path, monkeypatch):
    (tmp_path / "tag_component.py").write_text(COMPONENT)
    monkeypatch.syspath_prepend(str(tmp_path))
    conf = {**_with(False), "matcher": {**CONF["matcher"], "is_training": False},
            "filter": {"name": "tag_component", "key": "filtered", "shift": 1},
            "solver": {"name": "tag_component", "key": "solved", "shift": 10}}
    make = lambda **over: get_model("two_view_pipeline")({**conf, **over}, device="cpu")
    model = make()
    model.load_state_dict(jax_run[0], strict=True)
    data = _convert(_pairs(3), torch.from_numpy)
    pred = model(data)
    count = (pred["matches0"] >= 0).sum(-1)
    torch.testing.assert_close(pred["filtered"], count + 1)
    # the solver sees what the filter added
    torch.testing.assert_close(pred["solved"], count + 10 + count + 1)

    # a view's cache seeds the predictions; allow_no_extract skips the extractor
    cached = {k: v for k, v in pred.items() if k.endswith("0") and k[:-1] in (
        "keypoints", "keypoint_scores", "descriptors", "keypoint_mask")}
    cache0 = {k[:-1]: v for k, v in cached.items()}
    data_c = {**data, "view0": {**data["view0"], "cache": {**cache0, "marker": torch.ones(2)}}}
    for allow in (False, True):
        model = make(allow_no_extract=allow, batch_extraction=True)
        model.load_state_dict(jax_run[0], strict=True)
        calls = []
        model.extractor.register_forward_hook(lambda *a: calls.append(1))
        out = model(data_c)
        assert torch.equal(out["marker0"], torch.ones(2))
        assert len(calls) == (1 if allow else 2)  # no stacked extraction with a cache
        for k, v in cached.items():
            torch.testing.assert_close(out[k], v)
