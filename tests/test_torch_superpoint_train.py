"""The detector's pretraining in the port against the JAX package on the
CPU: the repaired BatchNorm, the losses, SuperPoint-open's paired training
forward and its gradients, MultiPoint's loss, box NMS, the trainer on a
bare extractor (its step against the JAX `Trainer`, the non-finite veto and
validation leaving the running statistics alone), the stage-1 -> stage-2
graft and both configurations.

Bars:
  - `layers.batch_norm` against `flax.linen.BatchNorm` at momentum 0.9 and
    0.99: output within 1e-6, running mean and variance within 1e-6
    relative (the parent's layer, torch's unbiased running variance, missed
    by 4%);
  - MultiPoint's running statistics after one training forward against
    flax's mutable `batch_stats` (channels [8, 8, 16, 16]): the variances
    within 1e-6 relative (measured <= 1.2e-7; the parent missed by 4%), the
    means within 2e-5 relative (measured <= 1.2e-5: a mean carries the
    rounding of the convolutions before it, XLA's against torch's, 8e-7
    already after the first);
  - the losses (detector, descriptor, superpoint) within 1e-5 relative of
    JAX, with and without valid masks; box NMS and the keypoint map equal;
  - SuperPoint-open (channels [8, 8, 16, 16, 32], 32-D descriptors, two
    64 x 80 views): every loss within 1e-5 relative, the logits and dense
    descriptors within 1e-4, each gradient within 1e-4 max|g| of
    `jax.value_and_grad` (max over the leaf; over the model for the four
    leaves whose gradient is zero in exact arithmetic, a conv bias or a
    BatchNorm bias that a BatchNorm follows, below 1e-7 max|g| in JAX), the
    running statistics after the step as MultiPoint's, with 1e-7 absolute
    for the means of the two 1 x 1 head layers, which are zero in exact
    arithmetic (their inputs have zero batch means). The weights go across
    by `weights.params_from_jax`, the gradients back by
    `weights.params_to_jax`;
  - one `Trainer` step of 8 pairs and a validation of the stage-1
    configuration cut to 48 x 64 images rendered at 96 x 128 and the narrow
    model, at lr 1e-4 (rounding noise decides the sign of Adam's first
    update of a parameter that a BatchNorm cancels: +-lr), against the JAX
    `Trainer` from the same initial parameters: the step's losses within
    1e-4 relative, the validation's after it within 1e-4 relative or 1e-4
    absolute (the mean dot products), the parameters after the step within
    5e-4 and the running statistics within 1e-5 relative;
  - a vetoed step and a validation leave the parameters and the running
    statistics bit for bit; the graft copies stage 1's parameters and
    running statistics into stage 2's extractor bit for bit.
"""

import copy
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gluefactory_tpu.settings as jax_settings
import gluefactory_tpu.utils.experiments as jax_exps
import gluefactory_tpu_torch.utils.experiments as exps
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.multipoint.utils import losses as jl
from gluefactory_tpu.multipoint.utils import utils as ju
from gluefactory_tpu.train.trainer import Trainer as JaxTrainer
from gluefactory_tpu.utils.config import load_yaml
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.utils.layers import batch_norm
from gluefactory_tpu_torch.multipoint.utils import losses as tl
from gluefactory_tpu_torch.multipoint.utils import utils as tu
from gluefactory_tpu_torch.train.trainer import Trainer
from gluefactory_tpu_torch.utils.config import load_conf, merge
from gluefactory_tpu_torch.weights import params_from_jax, params_to_jax

ROOT = Path(__file__).resolve().parent.parent
NARROW = {"channels": [8, 8, 16, 16, 32], "descriptor_dim": 32, "is_training": True,
          "dtype": None, "s2d": False, "fused_block0": False}
STAGE1 = "superpoint-open_synthetic_pretrain"
STAGE2 = "superpoint-open-trained+lightglue_homography"


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


def _rel_close(got, ref, rtol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max(), err_msg=what)


def _pair_data(seed, b=2, h=64, w=80):
    """Two seeded views, sparse keypoint maps, valid masks with invalid
    borders and a homography near the identity."""
    from gluefactory_tpu_torch.geometry.homography import sample_homography_corners

    rng = np.random.RandomState(seed)
    img = rng.rand(b, h, w, 1).astype(np.float32)
    img2 = rng.rand(b, h, w, 1).astype(np.float32)
    kmap = (rng.rand(b, h, w) < 0.01).astype(np.float32)
    kmap2 = (rng.rand(b, h, w) < 0.01).astype(np.float32)
    valid = np.ones((b, h, w), np.float32)
    valid[:, :5] = 0
    valid2 = np.ones((b, h, w), np.float32)
    valid2[:, :, -9:] = 0
    H = np.stack([sample_homography_corners((w, h), (w, h), difficulty=0.3, translation=0.2,
                                            max_angle=20, rng=rng)[0] for _ in range(b)])
    return {"image": img, "image2": img2, "keypoint_map": kmap, "keypoint_map2": kmap2,
            "valid_mask": valid, "valid_mask2": valid2, "H_0to1": H.astype(np.float32)}


# --------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_batch_norm_matches_flax(momentum):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 3, 4) * 1.5 + 0.3).astype(np.float32)  # NHWC, as flax takes it
    scale, bias = rng.rand(4).astype(np.float32) + 0.5, rng.randn(4).astype(np.float32)
    bn = flax.linen.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-3)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}}
    ref, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    mean, var = torch.zeros(4), torch.ones(4)
    out = batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(scale),
                     torch.from_numpy(bias), mean, var, True, momentum)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-6)
    _rel_close(mean.numpy(), upd["batch_stats"]["mean"], 1e-6, "mean")
    _rel_close(var.numpy(), upd["batch_stats"]["var"], 1e-6, "var")
    # inference on the running statistics
    ref = flax.linen.BatchNorm(use_running_average=True, epsilon=1e-3).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    out = batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(scale),
                     torch.from_numpy(bias), mean, var, False, momentum)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-6)


def test_multipoint_running_statistics_match_flax():
    conf = {"channels": [8, 8, 16, 16], "head_channels": 16, "descriptor_size": 16,
            "is_training": True}
    rng = np.random.RandomState(1)
    img = rng.rand(2, 32, 48, 1).astype(np.float32)
    opt = np.array([True, False])
    data = {"image": jnp.asarray(img), "is_optical": jnp.asarray(opt)}
    jm = jax_model("gluefactory_tpu.multipoint.models.multipoint").from_conf(conf)

    def init_apply(key, data):
        variables = jm.init(key, data)
        pred, upd = jm.apply(variables, data, mutable=["batch_stats"])
        return variables, pred, upd

    variables, ref, upd = jax.tree.map(np.asarray, jax.jit(init_apply)(jax.random.PRNGKey(0), data))
    model = get_model("gluefactory_tpu_torch.multipoint.models.multipoint")(conf, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    out = model({"image": torch.from_numpy(img), "is_optical": torch.from_numpy(opt)})
    np.testing.assert_allclose(out["logits"].detach().numpy(), ref["logits"], atol=1e-4)
    expect = params_from_jax({"batch_stats": upd["batch_stats"]})
    state = model.state_dict()
    assert len(expect) == 2 * (2 * 8 + 2)  # two encoders of 8 layers, two heads
    for k, v in expect.items():
        # the mean follows the convolutions' rounding (XLA's against torch's)
        _rel_close(state[k].numpy(), v.numpy(), 1e-6 if k.endswith("var") else 2e-5, k)
    # the loss of a single view is the detector loss alone
    t = {k: torch.from_numpy(v) for k, v in _pair_data(2, h=32, w=48).items()}
    losses, _ = model.loss(out, t)
    assert set(losses) == {"detector_loss", "total"}
    torch.testing.assert_close(losses["total"], losses["detector_loss"])


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("valid", [True, False])
def test_losses_match_jax(valid):
    rng = np.random.RandomState(3)
    b, h, w, d = 2, 32, 48, 16
    data = _pair_data(4, b, h, w)
    if not valid:
        data = {k: v for k, v in data.items() if not k.startswith("valid")}
    logits = rng.randn(b, h // 8, w // 8, 65).astype(np.float32)
    logits2 = rng.randn(b, h // 8, w // 8, 65).astype(np.float32)
    desc = rng.randn(2, b, h // 8, w // 8, d).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    pred = {"logits": logits, "logits2": logits2, "dense_descriptors": desc[0],
            "dense_descriptors2": desc[1]}
    ref, _ = jl.superpoint_loss({k: jnp.asarray(v) for k, v in pred.items()},
                                {k: jnp.asarray(v) for k, v in data.items()}, {"cell": 8})
    out, _ = tl.superpoint_loss({k: torch.from_numpy(v) for k, v in pred.items()},
                                {k: torch.from_numpy(v) for k, v in data.items()}, {"cell": 8})
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == (b,), k
        _rel_close(out[k].numpy(), np.asarray(ref[k]), 1e-5, k)
    np.testing.assert_array_equal(tl.space_to_depth(torch.from_numpy(data["keypoint_map"]), 8),
                                  np.asarray(jl.space_to_depth(jnp.asarray(data["keypoint_map"]), 8)))


def test_box_nms_and_keypoint_map_match_jax():
    rng = np.random.RandomState(5)
    prob = rng.rand(2, 24, 32).astype(np.float32) ** 4
    prob[:, 5:9, 5:9] = 0.5  # a plateau
    for kw in ({}, {"keep_top_k": 10}, {"size": 2, "min_prob": 0.2}):
        ref = np.asarray(ju.box_nms(jnp.asarray(prob), **kw))
        np.testing.assert_array_equal(tu.box_nms(torch.from_numpy(prob), **kw).numpy(), ref)
    np.testing.assert_array_equal(tu.box_nms(torch.from_numpy(prob[0])).numpy(),
                                  np.asarray(ju.box_nms(jnp.asarray(prob[0]))))
    kpts = (rng.rand(2, 20, 2) * [40, 30] - 3).astype(np.float32)
    mask = rng.rand(2, 20) < 0.7
    ref = np.asarray(ju.keypoint_map_from_points(jnp.asarray(kpts), jnp.asarray(mask), (24, 32)))
    out = tu.keypoint_map_from_points(torch.from_numpy(kpts), torch.from_numpy(mask), (24, 32))
    np.testing.assert_array_equal(out.numpy(), ref)


# ----------------------------------------------------- SuperPoint training
def test_superpoint_training_step_matches_jax_grad():
    data = _pair_data(0)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jm = jax_model("superpoint_open").from_conf(NARROW)

    def init_and_grad(key, data):
        variables = jm.init(key, data)

        def loss_fn(params):
            v = {"params": params, "batch_stats": variables["batch_stats"]}
            pred, upd = jm.apply(v, data, mutable=["batch_stats"])
            losses, _ = jm.apply(v, pred, data, method="loss")
            return jnp.mean(losses["total"]), (losses, pred, upd["batch_stats"])

        out, grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
        return variables, out, grads

    variables, (_, (losses, pred, stats)), grads = jax.tree.map(
        np.asarray, jax.jit(init_and_grad)(jax.random.PRNGKey(0), jdata))

    model = get_model("superpoint_open")(NARROW, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    out = model(tdata)
    tlosses, _ = model.loss(out, tdata)
    tlosses["total"].mean().backward()

    for k in ("logits", "logits2", "dense_descriptors", "dense_descriptors2"):
        np.testing.assert_allclose(out[k].detach().numpy(), pred[k], rtol=0, atol=1e-4, err_msg=k)
    assert set(tlosses) == set(losses)
    for k in losses:
        _rel_close(tlosses[k].detach().numpy(), losses[k], 1e-5, k)
    tgrads = params_to_jax({k: p.grad for k, p in model.named_parameters()})["params"]
    ref, got = dict(_flat(grads)), dict(_flat(tgrads))
    assert set(got) == set(ref) and len(ref) == 4 * 12
    gmax = max(np.abs(g).max() for g in ref.values())
    zero = 0
    for k, g in ref.items():
        scale = np.abs(g).max()
        if scale < 1e-7 * gmax:  # zero in exact arithmetic: a BatchNorm follows
            scale, zero = gmax, zero + 1
        np.testing.assert_allclose(got[k], g, rtol=0, atol=1e-4 * scale, err_msg=k)
    assert zero == 4
    expect = dict(_flat(stats))
    back = dict(_flat(params_to_jax(model.state_dict())["batch_stats"]))
    assert set(back) == set(expect)
    for k, v in expect.items():
        # the two 1 x 1 heads take zero-mean inputs: their means are 1e-8 noise
        np.testing.assert_allclose(back[k], v, rtol=1e-6 if k.endswith("var") else 2e-5,
                                   atol=1e-7, err_msg=k)


def test_inference_extractor_trains_nothing():
    model = get_model("superpoint_open")({**NARROW, "is_training": False}, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    names = {k for k, _ in model.named_parameters()}
    assert "blocks.0.bn_scale" in names and "blocks.0.bn_mean" not in names
    with pytest.raises(NotImplementedError):
        model.loss({"keypoints": None}, {})


# ----------------------------------------------------------------- trainer
SHAPES = {"length": 4, "val_length": 2, "image_size": [48, 64], "generation_size": [96, 128],
          "train_batch_size": 2, "val_batch_size": 2, "num_workers": 0}
MODEL = {k: NARROW[k] for k in ("channels", "descriptor_dim")}


def stage1_conf(batch: int = 2):
    """The stage-1 configuration cut to 48 x 64 images, two steps of `batch`
    pairs and 2 val pairs, the narrow model, one epoch."""
    data = {**SHAPES, "length": 2 * batch, "train_batch_size": batch}
    return merge(load_conf(STAGE1), {"data": data, "model": MODEL, "train": {
        "epochs": 1, "eval_every_iter": -1, "save_every_iter": -1, "log_every_iter": 1}})


@pytest.fixture(scope="module")
def stage1_runs(tmp_path_factory):
    """One epoch of the cut stage-1 configuration through the JAX Trainer
    and the port's, from the same initial parameters."""
    root = tmp_path_factory.mktemp("stage1")
    # one step of 8 pairs (the JAX trainer splits a batch over its 8-device
    # mesh). lr 1e-4: Adam's first update is lr sign(g), so a parameter whose
    # gradient is rounding noise (zero in exact arithmetic: a bias that a
    # BatchNorm cancels) moves by +-lr in either package; at the
    # configuration's 1e-3 the next step's losses part by 3e-4
    conf = merge(stage1_conf(8), {"data": {"length": 8}, "train": {"lr": 1e-4}})
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_settings, jax_exps):
            mp.setattr(mod, "TRAINING_PATH", root / "jax")
        model_cls = type(jax_model("superpoint_open").from_conf(conf["model"]))
        mp.setattr(model_cls, "init", lambda self, *a, **k: jax.jit(
            functools.partial(flax.linen.Module.init, self))(*a, **k))
        jt = JaxTrainer(conf, "s1", root / "jax" / "s1")
        jt.build()
        init = params_from_jax(jax.tree.map(np.asarray, {"params": jt.state.params,
                                                          "batch_stats": jt.state.batch_stats}))
        jt.train()
        jax_state = jax.tree.map(np.asarray, {"params": jt.state.params,
                                              "batch_stats": jt.state.batch_stats})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exps, "TRAINING_PATH", root / "port")
        pt = Trainer(conf, "s1", root / "port" / "s1", device="cpu")
        pt.build()
        pt.load_weights(init)
        pt.train()
    read = lambda p: [json.loads(line) for line in p.read_text().splitlines()]
    return {"jax": read(root / "jax" / "s1" / "events.jsonl"), "jax_state": jax_state,
            "port": read(root / "port" / "s1" / "events.jsonl"), "trainer": pt}


@pytest.mark.parametrize("key", ["total", "detector_loss", "detector_loss2", "descriptor_loss",
                                 "positive_dist", "negative_dist", "skipped_nonfinite"])
def test_stage1_trainer_losses_match_jax(stage1_runs, key):
    series = lambda run, k: [r[k] for r in stage1_runs[run] if k in r]
    ref, got = series("jax", f"train/loss/{key}"), series("port", f"train/loss/{key}")
    assert len(ref) == len(got) == 1
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=key)
    ref, got = series("jax", f"val/loss/{key}"), series("port", f"val/loss/{key}")
    if key != "skipped_nonfinite":  # after the step: mean dot products within 1e-4
        assert len(ref) == len(got) == 1
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4, err_msg=key)


def test_stage1_trainer_state_matches_jax(stage1_runs):
    tree = params_to_jax(stage1_runs["trainer"].model.state_dict())
    ref = stage1_runs["jax_state"]
    got, want = dict(_flat(tree["params"])), dict(_flat(ref["params"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-4, rtol=0, err_msg=k)
    got, want = dict(_flat(tree["batch_stats"])), dict(_flat(ref["batch_stats"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_veto_and_validation_leave_the_running_statistics(tmp_path, monkeypatch):
    monkeypatch.setattr(exps, "TRAINING_PATH", tmp_path)
    trainer = Trainer(stage1_conf(), "s1", tmp_path / "s1", device="cpu")
    trainer.build()
    batch = next(iter(trainer.dataset.get_data_loader("train")))
    trainer.train_steps([batch])  # running statistics away from their initial values
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    bad = copy.deepcopy(batch)
    bad["image"][0, 3, 4, 0] = np.nan
    out = trainer.train_steps([bad])[0]
    assert out["skipped_nonfinite"] == 1.0 and trainer.state.step == 2
    assert trainer.state.optimizer.count == 1
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    results = trainer.do_evaluation(0, 2)
    assert np.isfinite(results["loss/total"])
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # a finite step moves the running statistics (so the checks above can fail)
    trainer.train_steps([batch])
    assert not torch.equal(trainer.model.state_dict()["blocks.0.bn_mean"],
                           before["blocks.0.bn_mean"])


@pytest.mark.parametrize("name", [STAGE1, STAGE2])
def test_json_config_equals_the_jax_yaml(name):
    ref = load_yaml(ROOT / "gluefactory_tpu" / "configs" / f"{name}.yaml")
    path = ROOT / "gluefactory_tpu_torch" / "configs" / f"{name}.json"
    assert json.loads(path.read_text()) == ref


def _cli(args, env):
    out = subprocess.run([sys.executable, "-m", "gluefactory_tpu_torch.train", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def test_stage1_then_stage2_on_the_command_line(tmp_path):
    """Stage 1 and stage 2 by their command lines on the CPU, cut to tiny
    sizes; stage 2 resolves `train.load_experiment: sp_open_synth` under
    GLUEFACTORY_TPU_TORCH_TRAINING and grafts stage 1's best checkpoint
    into its frozen extractor: every parameter and running statistic of
    stage 1 bit for bit."""
    env = {**os.environ, "OMP_NUM_THREADS": "2", "GLUEFACTORY_TPU_TORCH_TRAINING": str(tmp_path),
           "PYTHONPATH": str(ROOT)}
    dot = lambda tree: [f"{k}={json.dumps(v)}" for k, v in tree.items()]
    _cli(["sp_open_synth", "--conf", STAGE1, "--device", "cpu",
          *dot({"data.length": 4, "data.val_length": 2, "data.image_size": [48, 64],
                "data.generation_size": [96, 128], "data.train_batch_size": 2,
                "data.val_batch_size": 2, "data.num_workers": 0, "train.epochs": 1,
                "model.channels": MODEL["channels"], "model.descriptor_dim": 32})], env)
    _cli(["sp_open_lg", "--conf", STAGE2, "--device", "cpu",
          *dot({"data.synthetic": {"do": True, "pool": 4, "size": [160, 120]},
                "data.train_size": 4, "data.val_size": 2, "data.train_batch_size": 2,
                "data.val_batch_size": 2, "data.num_workers": 0,
                "data.homography.patch_shape": [80, 64], "train.epochs": 1,
                "model.extractor.channels": MODEL["channels"],
                "model.extractor.descriptor_dim": 32, "model.extractor.max_num_keypoints": 32,
                "model.matcher.n_layers": 1, "model.matcher.descriptor_dim": 32,
                "model.matcher.input_dim": 32, "model.matcher.num_heads": 2,
                "train.load_experiment": "sp_open_synth"})], env)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exps, "TRAINING_PATH", tmp_path)
        s1, _ = exps.load_checkpoint(exps.get_best_checkpoint("sp_open_synth"))
        s2, meta = exps.load_checkpoint(exps.get_last_checkpoint("sp_open_lg"))
    assert meta["iter"] == 2 and s2["step"] == 2
    extractor = {k[len("extractor."):]: v for k, v in s2["model"].items()
                 if k.startswith("extractor.")}
    assert set(extractor) == set(s1["model"]) and len(extractor) == 12 * 6
    for k, v in s1["model"].items():
        assert torch.equal(extractor[k], v), k
    assert not torch.equal(s1["model"]["blocks.0.bn_var"], torch.ones(8))
