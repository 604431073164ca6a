"""ETH3D of the port (`datasets/eth3d.py`, `eval/eth3d.py` and the
precision-recall functions of `eval/utils.py`) against the JAX package on
the CPU, on the JAX package's own fixture tree
(`tests/test_real_schema_benchmarks.py::eth3d_tree`: one scene of four
640 x 480 JPEG views, 1/8-resolution 16-bit depth PNGs, COLMAP text).

Bars: the COLMAP readers and the pair selection equal; each view's image
within the area-resize bar (mean < 1e-7, max < 1e-6), its camera and the
pair's poses within 1e-6, its nearest-resized depth equal; `gt_matches0`
of the port's `depth_matcher` equal to JAX's on the same keypoints, depths
and cameras; `eval_dataset_pr` on the same predictions (one HDF5 file, written by
h5py, read by both) JAX's AP within 1e-7 and its curves within 1e-12.
"""

import json
from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_real_schema_benchmarks import eth3d_tree  # noqa: F401  (the JAX fixture)

import gluefactory_tpu.datasets.eth3d as jeth
from gluefactory_tpu.eval import utils as jeu
from gluefactory_tpu.eval.eth3d import eval_dataset_pr as j_eval_dataset_pr
from gluefactory_tpu.geometry.wrappers import Camera as JCamera
from gluefactory_tpu.geometry.wrappers import Pose as JPose
from gluefactory_tpu.models.matchers.depth_matcher import DepthMatcher as JDepthMatcher
from gluefactory_tpu_torch.datasets import eth3d as teth
from gluefactory_tpu_torch.datasets import get_dataset
from gluefactory_tpu_torch.eval import eth3d as eval_eth3d
from gluefactory_tpu_torch.eval import get_benchmark
from gluefactory_tpu_torch.eval import utils as teu
from gluefactory_tpu_torch.geometry import depth as tdepth
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.utils.export_predictions import load_predictions

REPO = Path(__file__).resolve().parent.parent


def _conf(tree, **kw):
    data_dir, _ = tree
    return {"data_dir": str(data_dir / "ETH3D_undistorted"), "downsize_factor": 4,
            "min_covisibility": 500, **kw}


def test_colmap_readers_match_jax(eth3d_tree):  # noqa: F811
    calib = eth3d_tree[0] / "ETH3D_undistorted" / "courtyard" / "dslr_calibration_undistorted"
    assert teth.read_colmap_cameras_text(calib / "cameras.txt") == \
        jeth.read_colmap_cameras_text(calib / "cameras.txt")
    out, ref = (m.read_colmap_images_text(calib / "images.txt") for m in (teth, jeth))
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k][:2] == ref[k][:2]
        for a, b in zip(out[k][2:], ref[k][2:]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(teth.qvec2rotmat(out[k][2]), jeth.qvec2rotmat(ref[k][2]))


@pytest.mark.parametrize("selection", [{}, {"min_covisibility": 100}, {"max_pairs_per_scene": 1},
                                       {"min_covisibility": 1, "max_pairs_per_scene": 4}])
def test_pair_selection_matches_jax(eth3d_tree, selection):  # noqa: F811
    conf = _conf(eth3d_tree, **selection)
    port = get_dataset("eth3d")(conf)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeth, "DATA_PATH", Path("/"))
        ref = jeth.ETH3DDataset(conf)
    assert port.items == ref.items and len(ref.items) > 0


@pytest.fixture(scope="module")
def items(eth3d_tree):  # noqa: F811
    conf = _conf(eth3d_tree, min_covisibility=100)
    port = get_dataset("eth3d")(conf).get_dataset("test")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeth, "DATA_PATH", Path("/"))
        ref = jeth.ETH3DDataset(conf).get_dataset("test")
    assert len(port) == len(ref) >= 3
    return [(port[i], ref[i]) for i in range(len(ref))]


def _close(a, b, what, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=tol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("i", range(3))
def test_views_match_jax(items, i):
    out, ref = items[i]
    assert set(out) == set(ref)
    for k in ("name", "idx", "scene", "n_covisible_points"):
        assert out[k] == ref[k], k
    for v in ("view0", "view1"):
        o, w = out[v], ref[v]
        assert set(o) == set(w)
        assert o["image"].shape == w["image"].shape
        diff = np.abs(o["image"] - w["image"])
        assert diff.mean() < 1e-7 and diff.max() < 1e-6, (diff.mean(), diff.max())
        np.testing.assert_array_equal(o["scales"], w["scales"])
        np.testing.assert_array_equal(o["image_size"], w["image_size"])
        _close(o["camera"]._data, w["camera"]._data, f"{v} camera")
        assert o["depth"].dtype == w["depth"].dtype and o["depth"].shape == o["image"].shape[:2]
        np.testing.assert_array_equal(o["depth"], w["depth"])
    for k in ("T_0to1", "T_1to0"):
        _close(out[k].R, ref[k].R, f"{k}.R")
        _close(out[k].t, ref[k].t, f"{k}.t")


def test_gt_matches_match_jax(items):
    """Keypoints of view 1 are view 0's reprojected with 0.7 px noise (two
    thirds of them) and random elsewhere: positives, negatives and ignored."""
    (out, ref), rng = items[0], np.random.RandomState(9)
    h, w = out["view0"]["image"].shape[:2]
    kp0 = (rng.rand(1, 128, 2) * [w - 1, h - 1]).astype(np.float32)
    tdata = {f"view{i}": {"camera": out[f"view{i}"]["camera"].map(lambda x: x[None]),
                          "depth": torch.from_numpy(out[f"view{i}"]["depth"][None])}
             for i in range(2)}
    tdata.update({k: out[k].map(lambda x: x[None]) for k in ("T_0to1", "T_1to0")})
    z0, v0 = tdepth.sample_depth(torch.from_numpy(kp0), tdata["view0"]["depth"])
    cam0, cam1 = tdata["view0"]["camera"], tdata["view1"]["camera"]
    proj, vis = tdepth.project(torch.from_numpy(kp0), z0, None, cam0, cam1, tdata["T_0to1"], v0)
    kp1 = np.where(vis[..., None].numpy() & (np.arange(128) < 85)[None, :, None],
                   proj.numpy() + 0.7 * rng.randn(1, 128, 2),
                   rng.rand(1, 128, 2) * [w - 1, h - 1]).astype(np.float32)
    conf = {"th_positive": 3.0, "th_negative": 5.0}
    port = get_model("depth_matcher")(conf, device="cpu")(
        {**tdata, "keypoints0": torch.from_numpy(kp0), "keypoints1": torch.from_numpy(kp1)})
    jdata = {f"view{i}": {"camera": JCamera(jnp.asarray(ref[f"view{i}"]["camera"]._data)[None]),
                          "depth": jnp.asarray(ref[f"view{i}"]["depth"])[None]}
             for i in range(2)}
    for k in ("T_0to1", "T_1to0"):
        jdata[k] = JPose.from_Rt(jnp.asarray(ref[k].R)[None], jnp.asarray(ref[k].t)[None])
    want = JDepthMatcher.from_conf(conf)({**jdata, "keypoints0": jnp.asarray(kp0),
                                          "keypoints1": jnp.asarray(kp1)})
    gt = port["gt_matches0"].numpy()
    np.testing.assert_array_equal(gt, np.asarray(want["gt_matches0"]))
    assert (gt >= 0).sum() > 20 and (gt == -1).sum() > 5


def _predictions(seed, n_pairs=4, n=300):
    """Per pair: predicted matches (some -1), scores with ties, ground truth
    with -1 and -2, half the predictions right."""
    rng = np.random.RandomState(seed)
    preds = {}
    for p in range(n_pairs):
        gt = rng.randint(-2, 200, n)
        m = np.where(rng.rand(n) < 0.5, gt, rng.randint(-1, 200, n))
        m = np.where(m == -2, -1, m)
        scores = np.round(rng.rand(n), 2).astype(np.float32)  # ties
        preds[f"scene{p % 2}/pair{p}"] = {"matches0": m, "gt_matches0": gt,
                                           "matching_scores0": scores}
    return preds


@pytest.mark.parametrize("seed", range(3))
def test_eval_dataset_pr_matches_jax(tmp_path, seed):
    preds = _predictions(seed)
    with h5py.File(tmp_path / "p.h5", "w") as f:
        for n, p in preds.items():
            g = f.create_group(n)
            for k, v in p.items():
                g.create_dataset(k, data=v)
    out, ref = eval_eth3d.eval_dataset_pr(tmp_path / "p.h5"), j_eval_dataset_pr(tmp_path / "p.h5")
    assert out.keys() == ref.keys()
    assert abs(out["AP"] - ref["AP"]) <= 1e-7
    for k in ("curve_recall", "curve_precision"):
        _close(out[k], ref[k], k, 1e-12)
    p = preds["scene0/pair0"]
    for a, b in zip(teu.get_tp_fp_pts(p["matches0"], p["gt_matches0"], p["matching_scores0"]),
                    jeu.get_tp_fp_pts(p["matches0"], p["gt_matches0"], p["matching_scores0"])):
        np.testing.assert_array_equal(a, b)


def test_registry_pipeline_and_cli(eth3d_tree, tmp_path, monkeypatch, capsys):  # noqa: F811
    """The benchmark on the fixture tree (the committed weights, 256
    keypoints, the images at a quarter): what it exports and a finite AP;
    the command line; the synthetic variant's default extractor raises."""
    assert get_benchmark("eth3d") is eval_eth3d.ETH3DPipeline
    monkeypatch.setattr(eval_eth3d, "EVAL_PATH", tmp_path / "out")
    data_dir = eth3d_tree[0] / "ETH3D_undistorted"
    summaries = eval_eth3d.main([
        "--device", "cpu", "--checkpoint", str(REPO / "weights" / "hermetic" / "sp_open_lg.npz"),
        f"data.data_dir=\"{data_dir}\"", "data.downsize_factor=4", "data.min_covisibility=100",
        "model.extractor.max_num_keypoints=256", "model.extractor.dtype=null"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summaries
    out = tmp_path / "out" / "eth3d" / "sp_open_lg"
    keys = {k for p in load_predictions(out / "predictions.h5").values() for k in p}
    assert keys == {"gt_matches0", "matches0", "matching_scores0"}
    assert np.isfinite(summaries["AP"]) and summaries["AP"] > 0
    with pytest.raises(NotImplementedError, match="not portable"):
        eval_eth3d.SyntheticETH3DPipeline(device="cpu").run(tmp_path / "synth")
