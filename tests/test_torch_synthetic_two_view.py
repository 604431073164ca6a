"""The port's synthetic 3D two-view dataset and depth-supervised training
against the JAX package (and OpenCV) on the CPU.

Bars: `remap_linear` equal to `cv2.remap(..., INTER_LINEAR)` bit for bit
(OpenCV 5 interpolates float32 maps without the 1/32 px tables of OpenCV 4:
each lerp one fused multiply-add); a sample at 160 x 120 against the JAX
one: images within 1e-4 on >= 99.9% of pixels, depths within 1e-5
relative, poses within 1e-6, K exact; one LightGlue training step (2 layers
at width 64) on `depth_matcher` labels: labels equal, every loss entry
within 1e-5 relative, every gradient within 1e-3 max|g| + 1e-7.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.datasets.synthetic_two_view import SyntheticTwoViewDataset as JDataset
from gluefactory_tpu.geometry.wrappers import Camera as JCamera
from gluefactory_tpu.geometry.wrappers import Pose as JPose
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu_torch.datasets import get_dataset
from gluefactory_tpu_torch.datasets.image_ops import remap_linear
from gluefactory_tpu_torch.datasets.synthetic_two_view import SyntheticTwoViewDataset
from gluefactory_tpu_torch.geometry.depth import project, sample_depth
from gluefactory_tpu_torch.geometry.wrappers import Camera, Pose
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.train.trainer import Trainer
from gluefactory_tpu_torch.utils.config import load_conf, merge
from gluefactory_tpu_torch.weights import params_from_jax

SIZE = [160, 120]


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 2.0)])
def test_remap_linear_equals_cv2(lo, hi):
    """Maps inside [0, W-1] x [0, H-1] (the dataset's clipped maps, edges
    included) and maps reaching 2 px past every border."""
    rng = np.random.RandomState(int(hi))
    src = rng.rand(70, 90).astype(np.float32)
    x = rng.uniform(lo * 2 if lo else 0, 89 + (2 if lo else 0), (100, 130)).astype(np.float32)
    y = rng.uniform(lo * 2 if lo else 0, 69 + (2 if lo else 0), (100, 130)).astype(np.float32)
    x[0, :40], y[1, :40], x[2, :20] = 89.0, 69.0, 0.0
    out = remap_linear(src, x, y)
    assert out.dtype == np.float32 and out.shape == x.shape
    np.testing.assert_array_equal(out, cv2.remap(src, x, y, cv2.INTER_LINEAR))


@pytest.mark.parametrize("split,idx", [("test", 0), ("train", 3)])
def test_sample_matches_jax(split, idx):
    ref = JDataset({"image_size": SIZE}).get_dataset(split)[idx]
    split_ = SyntheticTwoViewDataset({"image_size": SIZE}).get_dataset(split)
    out = split_[idx]
    assert out["name"] == ref["name"] and out["idx"] == idx
    for v in ("view0", "view1"):
        img, rimg = out[v]["image"], ref[v]["image"]
        assert img.shape == rimg.shape == (120, 160, 1) and img.dtype == np.float32
        assert (np.abs(img - rimg) <= 1e-4).mean() >= 0.999
        np.testing.assert_allclose(out[v]["depth"], ref[v]["depth"], rtol=1e-5, atol=0)
        assert (out[v]["depth"] > 0).mean() > 0.9
        np.testing.assert_array_equal(out[v]["camera"]._data.numpy(),
                                      np.asarray(ref[v]["camera"]._data))
        np.testing.assert_array_equal(out[v]["image_size"], ref[v]["image_size"])
    for k in ("T_0to1", "T_1to0"):
        np.testing.assert_allclose(out[k].R.numpy(), np.asarray(ref[k].R), rtol=0, atol=1e-6)
        np.testing.assert_allclose(out[k].t.numpy(), np.asarray(ref[k].t), rtol=0, atol=1e-6)


def test_loader_batches_wrappers_and_registry():
    assert get_dataset("synthetic_two_view") is SyntheticTwoViewDataset
    ds = SyntheticTwoViewDataset({"image_size": [64, 48], "val_size": 2, "val_batch_size": 2})
    batch = next(iter(ds.get_data_loader("val")))
    assert isinstance(batch["T_0to1"], Pose) and batch["T_0to1"].shape == (2,)
    assert isinstance(batch["view0"]["camera"], Camera) and batch["view0"]["camera"].shape == (2,)
    assert batch["view1"]["depth"].shape == (2, 48, 64)
    assert batch["name"] == ["synth3d/val/0", "synth3d/val/1"]


LG = {"n_layers": 2, "descriptor_dim": 64, "input_dim": 64, "num_heads": 2,
      "filter_threshold": 0.1, "is_training": True}
GT = {"th_positive": 3.0, "th_negative": 5.0, "th_epi": 5.0}


def _depth_batch(m=48, n=40):
    """Two test pairs at 160 x 120: keypoints of view 1 are view 0's
    reprojected with 0.8 px noise (the first 24) or random; random
    descriptors; the last keypoints of pair 0 are padding."""
    ds = SyntheticTwoViewDataset({"image_size": SIZE}).get_dataset("test")
    from gluefactory_tpu_torch.datasets import collate

    batch = collate([ds[0], ds[1]])
    rng = np.random.RandomState(0)
    kp0 = torch.from_numpy(rng.uniform(4, [156, 116], (2, m, 2)).astype(np.float32))
    d0, v0 = sample_depth(kp0, torch.from_numpy(batch["view0"]["depth"]))
    cam = batch["view0"]["camera"]
    proj, vis = project(kp0, d0, None, cam, batch["view1"]["camera"], batch["T_0to1"], v0)
    kp1 = torch.from_numpy(rng.uniform(4, [156, 116], (2, n, 2)).astype(np.float32))
    near = proj[:, :24] + torch.from_numpy(rng.randn(2, 24, 2).astype(np.float32)) * 0.8
    kp1[:, :24] = torch.where(vis[:, :24, None], near, kp1[:, :24])
    mask0, mask1 = np.ones((2, m), bool), np.ones((2, n), bool)
    mask0[0, -6:] = False
    data = {
        "keypoints0": kp0.numpy(), "keypoints1": kp1.numpy(),
        "descriptors0": rng.randn(2, m, 64).astype(np.float32),
        "descriptors1": rng.randn(2, n, 64).astype(np.float32),
        "keypoint_mask0": mask0, "keypoint_mask1": mask1,
    }
    views = {v: {"image_size": batch[v]["image_size"], "depth": batch[v]["depth"]}
             for v in ("view0", "view1")}
    return data, views, batch


def test_training_step_on_depth_labels_matches_jax():
    data, views, batch = _depth_batch()
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    for v in ("view0", "view1"):
        jdata[v] = {"image_size": jnp.asarray(views[v]["image_size"]),
                    "depth": jnp.asarray(views[v]["depth"]),
                    "camera": JCamera(jnp.asarray(batch[v]["camera"]._data.numpy()))}
        tdata[v] = {"image_size": torch.from_numpy(views[v]["image_size"]),
                    "depth": torch.from_numpy(views[v]["depth"]), "camera": batch[v]["camera"]}
    for k in ("T_0to1", "T_1to0"):
        jdata[k] = JPose(jnp.asarray(batch[k].R.numpy()), jnp.asarray(batch[k].t.numpy()))
        tdata[k] = batch[k]

    jgt = jax_model("depth_matcher").from_conf(GT)(jdata)
    tgt = get_model("depth_matcher")(GT, device="cpu")(tdata)
    for k in ("gt_matches0", "gt_matches1", "gt_assignment"):
        np.testing.assert_array_equal(tgt[k].numpy(), np.asarray(jgt[k]), err_msg=k)
    assert (tgt["gt_matches0"] >= 0).sum() > 10 and (tgt["gt_matches0"] == -1).sum() > 10
    jdata.update(jgt)
    tdata.update(tgt)

    jm = jax_model("lightglue").from_conf(LG)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jdata)
    tm = get_model("lightglue")(LG, device="cpu")
    tm.load_state_dict(params_from_jax(variables), strict=True)

    def jloss(params):
        pred = jm.apply({"params": params}, jdata)
        losses, _ = jm.apply({"params": params}, pred, jdata, method="loss")
        return losses["total"].mean(), losses

    (_, rlosses), rgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    losses, _ = tm.loss(tm(tdata), tdata)
    assert set(losses) == set(rlosses)
    for key in losses:
        np.testing.assert_allclose(losses[key].detach().numpy(), np.asarray(rlosses[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    losses["total"].mean().backward()
    for name, p in tm.named_parameters():
        ref = np.asarray(rgrads[name])
        assert np.abs(p.grad.numpy() - ref).max() <= 1e-3 * np.abs(ref).max() + 1e-7, name


def test_depth_finetune_configuration_trains_on_cpu(tmp_path, monkeypatch):
    """The configuration end to end through the trainer at a reduced size:
    the committed weights grafted from `load_experiment`, depth labels, a
    validation, and the end-of-epoch benchmark hook on synthetic_pose."""
    from gluefactory_tpu_torch.utils import experiments

    monkeypatch.setattr(experiments, "TRAINING_PATH", tmp_path)
    conf = merge(load_conf("superpoint-open+lightglue_depth"), {
        "data": {"image_size": [128, 96], "train_size": 2, "val_size": 2,
                 "train_batch_size": 2, "val_batch_size": 2, "num_workers": 0},
        "model": {"extractor": {"max_num_keypoints": 64}},
        "train": {"epochs": 1, "eval_every_iter": 0, "save_every_iter": 0}})
    assert conf["model"]["ground_truth"]["name"] == "depth_matcher"
    trainer = Trainer(conf, "depth", experiments.experiment_dir("depth"), device="cpu")
    trainer.build()
    assert trainer.model.matcher.conf.n_layers == 9
    history = trainer.train_steps(trainer.dataset.get_data_loader("train"), steps=1)
    assert len(history) == 1 and np.isfinite(history[0]["total"])
    assert history[0]["num_matchable"] > 1 and history[0]["skipped_nonfinite"] == 0
    results = trainer.do_evaluation(0, 1)
    assert np.isfinite(results["loss/total"])
    from gluefactory_tpu_torch.eval import run_benchmark

    bench = {"data": {"image_size": [128, 96], "test_size": 1},
             "model": {"extractor": {"max_num_keypoints": 64, "dtype": None}},
             "eval": {"ransac_th": 2.0}}
    summaries, _ = run_benchmark("synthetic_pose", bench, tmp_path / "bench",
                                 model=trainer.model.state_dict(), device="cpu")
    assert "rel_pose_error_mAA" in summaries and summaries["mnum_keypoints"] == 64
