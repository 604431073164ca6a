"""The port's TripletPipeline (`models/triplet_pipeline.py`) against the JAX
package on the CPU: on a homography triplet with the committed weights, the
port's triplet forward and loss against JAX's two-view pipeline on JAX's own
`stack_twoviews` of the same data; on a MegaDepth triplet (cameras, poses,
depth) against three two-view calls of the port. The two faults of the JAX
TripletPipeline are pinned."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_init import jit_o0
import gluefactory_tpu.datasets.megadepth as jmd
import gluefactory_tpu_torch.datasets.megadepth as tmd
from gluefactory_tpu.datasets.base_dataset import collate as jax_collate
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.matchers.lightglue_pretrained import load_npz_params
from gluefactory_tpu.models.triplet_pipeline import stack_twoviews as jax_stack
from gluefactory_tpu_torch.datasets import collate, get_dataset
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.models.triplet_pipeline import stack_twoviews, unstack_twoviews
from gluefactory_tpu_torch.utils.config import merge
from gluefactory_tpu_torch.utils.tensor import batch_to_device
from gluefactory_tpu_torch.weights import HERMETIC, load_hermetic

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

PAIRS = ("0to1", "0to2", "1to2")
CONF = {
    "extractor": {"name": "superpoint_open", "max_num_keypoints": 128, "dtype": "float32"},
    "matcher": {"name": "lightglue", "filter_threshold": 0.1},
    "ground_truth": {"name": "homography_matcher", "th_positive": 3.0, "th_negative": 3.0},
}


@pytest.fixture(scope="module")
def homography_triplets():
    ds = get_dataset("homographies")({
        "synthetic": {"do": True, "size": [320, 240], "pool": 4}, "triplet": True,
        "train_size": 2, "val_size": 2, "photometric": {"p": 0.0},
        "homography": {"patch_shape": [256, 192], "difficulty": 0.4, "max_angle": 20}})
    split = ds.get_dataset("val")
    return collate([split[0], split[1]])


@pytest.fixture(scope="module")
def jax_reference(homography_triplets):
    """JAX's two-view pipeline on JAX's stack of the triplet batch: its
    predictions and losses (one jit each)."""
    batch = homography_triplets
    jdata = {k: jnp.asarray(batch[k]) for k in ("H_0to1", "H_0to2", "H_1to2")}
    for v in ("view0", "view1", "view2"):
        jdata[v] = {k: jnp.asarray(batch[v][k]) for k in ("image", "image_size")}
    stacked = jax_stack(jdata)
    jp = jax_model("two_view_pipeline").from_conf(CONF)
    variables = jax.tree.map(lambda a: a.astype(jnp.float32), load_npz_params(HERMETIC))
    pred = jit_o0(jp.apply)(variables, stacked)
    losses, _ = jit_o0(lambda v, p, d: jp.apply(v, p, d, method="loss"))(variables, pred,
                                                                         stacked)
    return (jax.tree.map(np.asarray, pred), jax.tree.map(np.asarray, losses), jdata, jp,
            variables)


def test_homography_triplet_matches_jax(homography_triplets, jax_reference):
    ref, ref_losses, *_ = jax_reference
    pipe = get_model("triplet_pipeline")(CONF, device="cpu")
    pipe.load_state_dict(load_hermetic(device="cpu"))
    data = batch_to_device(homography_triplets, "cpu")
    with torch.no_grad():
        out = pipe(data)
        losses, _ = pipe.loss(out, data)
    stacked = out["stacked"]
    assert stacked["matches0"].shape == (6, 128)
    for k in ("matches0", "matches1"):
        assert (stacked[k].numpy() == ref[k]).mean() >= 0.99, k
        for i, pair in enumerate(PAIRS):  # each pair's split
            part = out[f"{k}_{pair}"].numpy()
            assert part.shape == (2, 128)
            assert (part == ref[k][2 * i:2 * i + 2]).mean() >= 0.99, (k, pair)
    assert (stacked["matches0"] >= 0).sum() > 30
    total, ref_total = losses["total"].mean().item(), float(ref_losses["total"].mean())
    assert abs(total - ref_total) <= 1e-4 * abs(ref_total), (total, ref_total)


def test_stack_order_and_unstack(homography_triplets):
    data = batch_to_device(homography_triplets, "cpu")
    stacked = stack_twoviews(data)
    img = lambda v: data[v]["image"]  # noqa: E731
    assert torch.equal(stacked["view0"]["image"], torch.cat([img("view0"), img("view0"),
                                                              img("view1")]))
    assert torch.equal(stacked["view1"]["image"], torch.cat([img("view1"), img("view2"),
                                                              img("view2")]))
    assert torch.equal(stacked["H_0to1"], torch.cat([data["H_0to1"], data["H_0to2"],
                                                      data["H_1to2"]]))
    parts = unstack_twoviews({"x": torch.arange(6), "layer": torch.tensor(3), "name": "n"}, 2)
    assert {k: v["x"].tolist() for k, v in parts.items()} == {
        "0to1": [0, 1], "0to2": [2, 3], "1to2": [4, 5]}


def test_jax_triplet_pipeline_faults(homography_triplets, jax_reference, tmp_path, monkeypatch):
    """The reference's TripletPipeline checks the triplet's keys on the
    stacked two-view data (AssertionError), and its `stack_twoviews`
    concatenates a Camera as an array (TypeError): pinned here, repaired in
    the port (ROADMAP Queue 3a)."""
    _, _, jdata, _, variables = jax_reference
    jt = jax_model("triplet_pipeline").from_conf(CONF)
    with pytest.raises(AssertionError, match="Missing key view2"):
        jt.apply(variables, jdata)
    tree = _megadepth_tree(tmp_path)
    monkeypatch.setattr(jmd, "DATA_PATH", tree)
    # JAX ignores square_pad: its box is pad_to (else mixed orientations cannot collate)
    split = jmd.MegaDepth(merge(MD_DATA, {"preprocessing": {"pad_to": [160, 160]}})).get_dataset(
        "train")
    batch = jax_collate([split[0], split[1]])
    with pytest.raises(TypeError, match="Camera"):
        jax_stack(batch)


MD_DATA = {"data_dir": "megadepth", "train_split": None, "grayscale": True, "views": 3,
           "train_num_per_scene": 4, "min_overlap": 0.1, "max_overlap": 0.9,
           "preprocessing": {"resize": 160, "side": "long", "square_pad": True}}


def _megadepth_tree(root):
    """One scene of 4 views (3 landscape, 1 portrait) in the reference schema."""
    from test_torch_megadepth import _write_scene

    (root / "megadepth" / "scene_info").mkdir(parents=True)
    _write_scene(root / "megadepth", "0000", [(320, 240)] * 3 + [(240, 320)],
                 np.random.RandomState(5))
    return root


def test_megadepth_triplet_equals_three_two_view_calls(tmp_path, monkeypatch):
    """A triplet with cameras, poses and depth (square-padded views of both
    orientations) through the port's TripletPipeline against three calls of
    its two-view pipeline; the depth loss on the stacked data is finite."""
    tree = _megadepth_tree(tmp_path)
    monkeypatch.setattr(tmd, "DATA_PATH", tree)
    split = tmd.MegaDepth(MD_DATA).get_dataset("train")
    data = batch_to_device(collate([split[0], split[1]]), "cpu")
    assert data["view0"]["image"].shape == (2, 160, 160, 1)
    conf = merge(CONF, {"ground_truth": {"name": "depth_matcher", "th_positive": 3.0,
                                         "th_negative": 5.0, "th_epi": 5.0},
                        "extractor": {"max_num_keypoints": 64, "detection_threshold": 0.0}})
    state = load_hermetic(device="cpu")
    triplet = get_model("triplet_pipeline")(conf, device="cpu")
    triplet.load_state_dict(state)
    two = get_model("two_view_pipeline")(conf, device="cpu")
    two.load_state_dict(state)
    with torch.no_grad():
        out = triplet(data)
        losses, _ = triplet.loss(out, data)
        gt = triplet.ground_truth({**stack_twoviews(data), **out["stacked"]})
    assert torch.isfinite(losses["total"]).all() and losses["total"].shape == (6,)
    for i, (a, b) in enumerate(((0, 1), (0, 2), (1, 2))):
        pair = {"view0": data[f"view{a}"], "view1": data[f"view{b}"],
                "T_0to1": data[f"T_{a}to{b}"], "T_1to0": data[f"T_{b}to{a}"]}
        with torch.no_grad():
            ref = two(pair)
            ref_gt = two.ground_truth({**pair, **ref})
        suffix = PAIRS[i]
        torch.testing.assert_close(out[f"keypoints0_{suffix}"], ref["keypoints0"])
        for k in ("matches0", "matches1"):
            assert (out[f"{k}_{suffix}"] == ref[k]).float().mean() >= 0.99, (k, suffix)
        for k in ("gt_matches0", "gt_matches1"):
            assert (gt[k][2 * i:2 * i + 2] == ref_gt[k]).float().mean() >= 0.99, (k, suffix)
    assert (gt["gt_matches0"] >= 0).sum() > 10
