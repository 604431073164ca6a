"""The MegaDepth training recipe of the port (`datasets/megadepth.py`,
`models/cache_loader.py`, `scripts/export_megadepth.py`, the repaired
`square_pad`, the four `*+lightglue_megadepth` configurations) against the
JAX package on the CPU, on scenes written here in the reference schema
(scene_info npz, JPEG images, HDF5 depth written by h5py), rendered by the
synthetic multi-plane engine so that depth and poses are exact. The scenes
mix landscape and portrait views, and list views without an image or a
depth (None), as real scene_info files do."""

import json
import os
from pathlib import Path

import cv2
import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import gluefactory_tpu.datasets.megadepth as jmd
import gluefactory_tpu.models.cache_loader as jcl
import gluefactory_tpu_torch.datasets.megadepth as tmd
import gluefactory_tpu_torch.models.cache_loader as tcl
from gluefactory_tpu.geometry.gt_generation import gt_matches_from_pose_depth
from gluefactory_tpu.geometry.wrappers import Camera as JCamera
from gluefactory_tpu.geometry.wrappers import Pose as JPose
from gluefactory_tpu_torch.datasets import collate
from gluefactory_tpu_torch.datasets.homographies import generate_texture_image
from gluefactory_tpu_torch.datasets.synthetic_two_view import render_view
from gluefactory_tpu_torch.geometry.utils import so3exp_map
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.utils.config import load_conf, merge

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = Path(__file__).resolve().parent.parent
# scene -> [(w, h) of each view, or None for a view without an image / depth]
SCENES = {
    "0000": [(320, 240)] * 4 + [(240, 320)] * 2 + ["no image", "no depth"],
    "0001": [(320, 240)] * 5,
}


def _write_scene(root, scene, views, rng):
    planes = [(generate_texture_image(rng, (1024, 1024)), 7.0, None)]
    for _ in range(3):
        cx, cy = rng.uniform(-1, 1, 2)
        planes.append((generate_texture_image(rng, (512, 512)), 3.0 + rng.rand() * 2,
                       (cx - 0.8, cy - 0.6, cx + 0.8, cy + 0.6)))
    planes.sort(key=lambda p: -p[1])
    (root / "imgs" / scene).mkdir(parents=True)
    (root / "depths" / scene).mkdir(parents=True)
    image_paths, depth_paths, poses, intrinsics = [], [], [], []
    for i, size in enumerate(views):
        w, h = size if isinstance(size, tuple) else (320, 240)
        K = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]])
        R = so3exp_map(torch.from_numpy((rng.randn(3) * 0.04).astype(np.float32)))
        R = R.numpy().astype(np.float64)
        t = rng.randn(3) * 0.25
        img, depth, _ = render_view(K, R, t, planes, (w, h))
        ip, dp = f"imgs/{scene}/{i}.jpg", f"depths/{scene}/{i}.h5"
        cv2.imwrite(str(root / ip), (img[..., 0] * 255).astype(np.uint8))
        with h5py.File(str(root / dp), "w") as hf:
            hf.create_dataset("/depth", data=depth)
        image_paths.append(None if size == "no image" else ip)
        depth_paths.append(None if size == "no depth" else dp)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        poses.append(T.astype(np.float32))
        intrinsics.append(K.astype(np.float32))
    n = len(views)
    overlap = rng.uniform(0.05, 0.75, (n, n)).astype(np.float32)
    overlap = (overlap + overlap.T) / 2
    np.fill_diagonal(overlap, 0.0)
    np.savez(root / "scene_info" / f"{scene}.npz",
             image_paths=np.array(image_paths, object), depth_paths=np.array(depth_paths, object),
             poses=np.array(poses), intrinsics=np.array(intrinsics), overlap_matrix=overlap)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("md_data")
    (root / "megadepth" / "scene_info").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for scene, views in SCENES.items():
        _write_scene(root / "megadepth", scene, views, rng)
    return root


BASE = {"data_dir": "megadepth", "train_split": None, "grayscale": True,
        "preprocessing": {"resize": None}, "train_batch_size": 2, "min_overlap": 0.1,
        "max_overlap": 0.7}


def datasets(tree, monkeypatch, **conf):
    """(the JAX MegaDepth, the port's) on `tree` with BASE and `conf`."""
    monkeypatch.setattr(jmd, "DATA_PATH", tree)
    monkeypatch.setattr(tmd, "DATA_PATH", tree)
    conf = merge(BASE, conf)
    return jmd.MegaDepth(conf), tmd.MegaDepth(conf)


SAMPLING = {
    "pairs": {"train_num_per_scene": 8},
    "all_pairs": {"train_num_per_scene": None},
    "three_bins": {"train_num_per_scene": 6, "num_overlap_bins": 3},
    "triplets": {"train_num_per_scene": 6, "views": 3},
    "all_triplets": {"train_num_per_scene": None, "views": 3},
}


@pytest.mark.parametrize("seed", [0, 123])
@pytest.mark.parametrize("kind", sorted(SAMPLING))
def test_items_equal_jax(tree, monkeypatch, kind, seed):
    jds, tds = datasets(tree, monkeypatch, seed=seed, **SAMPLING[kind])
    ref, out = jds.get_dataset("train"), tds.get_dataset("train")
    assert out.scenes == ref.scenes == ["0000", "0001"]
    assert len(out.items) > 4 and out.items == ref.items
    jds.sample_new_items(seed + 7)
    tds.sample_new_items(seed + 7)
    assert out.items == ref.items


def _same_view(out, ref, image_atol=0.0):
    np.testing.assert_allclose(out["image"], np.asarray(ref["image"]), rtol=0, atol=image_atol)
    for k in ("depth", "image_size", "scales"):
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(out["camera"]._data.numpy(), np.asarray(ref["camera"]._data),
                               rtol=1e-6, atol=1e-6)


def _same_pose(out, ref):
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-6)


@pytest.mark.parametrize("preprocessing,atol", [({"resize": None}, 0.0),
                                                ({"resize": 200, "side": "long"}, 1e-6),
                                                ({"resize": 160, "pad_to": [240, 240]}, 1e-6)])
def test_pair_views_equal_jax(tree, monkeypatch, preprocessing, atol):
    """Images (exact, or within the area resize's bar), depth nearest-resized
    to the valid region (exact), image_size, scales, K and the poses."""
    jds, tds = datasets(tree, monkeypatch, train_num_per_scene=6, preprocessing=preprocessing)
    ref, out = jds.get_dataset("train"), tds.get_dataset("train")
    for i in range(0, len(out), 3):
        r, o = ref[i], out[i]
        assert (o["name"], o["scene"], o["overlap_0to1"]) == (r["name"], r["scene"],
                                                                r["overlap_0to1"])
        for v in ("view0", "view1"):
            _same_view(o[v], r[v], atol)
        _same_pose(o["T_0to1"], r["T_0to1"])
        _same_pose(o["T_1to0"], r["T_1to0"])


def test_triplet_views_equal_jax(tree, monkeypatch):
    jds, tds = datasets(tree, monkeypatch, train_num_per_scene=6, views=3)
    ref, out = jds.get_dataset("train"), tds.get_dataset("train")
    for i in (0, len(out) - 1):
        r, o = ref[i], out[i]
        assert o["name"] == r["name"]
        for n in range(3):
            _same_view(o[f"view{n}"], r[f"view{n}"])
        for a, b in ((0, 1), (0, 2), (1, 2)):
            _same_pose(o[f"T_{a}to{b}"], r[f"T_{a}to{b}"])
            _same_pose(o[f"T_{b}to{a}"], r[f"T_{b}to{a}"])
        comp = o["T_1to2"] @ o["T_0to1"]
        np.testing.assert_allclose(comp.R.numpy(), o["T_0to2"].R.numpy(), atol=1e-5)


def test_square_pad_equals_jax_pad_to_and_collates(tree, monkeypatch):
    """`square_pad` with `resize: R` on the long side is the JAX preprocessor
    with `pad_to: [R, R]`; JAX's own `square_pad` leaves the views unpadded
    (a fault of the reference, pinned here), so a batch of mixed
    orientations stacks only in the port."""
    R = 200
    conf = {"train_num_per_scene": None, "preprocessing": {"resize": R, "side": "long",
                                                           "square_pad": True}}
    jds, tds = datasets(tree, monkeypatch, **conf)
    jpad, _ = datasets(tree, monkeypatch, **merge(conf, {"preprocessing": {
        "square_pad": False, "pad_to": [R, R]}}))
    out, ref, ref_sq = tds.get_dataset("train"), jpad.get_dataset("train"), jds.get_dataset(
        "train")
    mixed = [i for i, it in enumerate(out.items)
             if it[0] == "0000" and (it[1] in (4, 5)) != (it[2] in (4, 5))]
    assert mixed
    for i in mixed[:3]:
        o, r, sq = out[i], ref[i], ref_sq[i]
        for v in ("view0", "view1"):
            assert o[v]["image"].shape == (R, R, 1) and o[v]["depth"].shape == (R, R)
            _same_view(o[v], r[v], 1e-6)
        assert {sq[v]["image"].shape for v in ("view0", "view1")} == {(150, 200, 1),
                                                                      (200, 150, 1)}
    batch = collate([out[i] for i in mixed[:3]])
    assert batch["view0"]["image"].shape == (3, R, R, 1)
    assert batch["view0"]["camera"].shape == (3,) and batch["T_0to1"].R.shape == (3, 3, 3)
    with pytest.raises(ValueError):  # the JAX collate of the same unpadded samples
        np.stack([ref_sq[i]["view0"]["image"] for i in mixed[:3]]
                 + [ref_sq[i]["view1"]["image"] for i in mixed[:3]])


def test_overlap_bins_drop_small_scenes_as_jax(tree, monkeypatch):
    """At the configurations' 300 pairs in 3 bins a bin is kept only with at
    least 200 pairs: these scenes (at most 56 ordered pairs) give none, in
    both packages (the reference's rule); 30 a scene in 3 bins keeps them."""
    conf = {"train_num_per_scene": 300, "num_overlap_bins": 3}
    jds, tds = datasets(tree, monkeypatch, **conf)
    assert tds.get_dataset("train").items == jds.get_dataset("train").items == []
    jds, tds = datasets(tree, monkeypatch, train_num_per_scene=12, num_overlap_bins=3)
    assert tds.get_dataset("train").items == jds.get_dataset("train").items != []


def test_missing_tree_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tmd, "DATA_PATH", tmp_path)
    with pytest.raises(FileNotFoundError, match="not downloaded"):
        tmd.MegaDepth({"data_dir": "megadepth"})


def test_depth_matcher_matches_jax(tree, monkeypatch):
    """The port's `depth_matcher` on a sample's cameras, depths and poses
    against JAX's `gt_matches_from_pose_depth` (the JAX loader test's call)."""
    jds, tds = datasets(tree, monkeypatch, train_num_per_scene=6)
    s, js = tds.get_dataset("train")[0], jds.get_dataset("train")[0]
    rng = np.random.RandomState(0)
    kp = rng.uniform(20, [220, 220], (1, 200, 2)).astype(np.float32)
    jdata = {v: {"camera": JCamera(js[v]["camera"]._data[None]),
                 "depth": jnp.asarray(js[v]["depth"][None])} for v in ("view0", "view1")}
    for k in ("T_0to1", "T_1to0"):
        jdata[k] = JPose(js[k].R[None], js[k].t[None])
    ref = gt_matches_from_pose_depth(jnp.asarray(kp), jnp.asarray(kp), jdata, cc_th=5.0)
    tdata = {v: {"camera": s[v]["camera"][None], "depth": torch.from_numpy(s[v]["depth"][None])}
             for v in ("view0", "view1")}
    tdata.update({k: s[k][None] for k in ("T_0to1", "T_1to0")})
    tdata.update(keypoints0=torch.from_numpy(kp), keypoints1=torch.from_numpy(kp))
    out = get_model("depth_matcher")({"th_cc": 5.0}, device="cpu")(tdata)
    for k in ("matches0", "matches1", "assignment"):
        np.testing.assert_array_equal(out[f"gt_{k}"].numpy(), np.asarray(ref[k]), err_msg=k)
    assert (out["gt_matches0"] >= 0).sum() > 20


@pytest.fixture(scope="module")
def h5py_cache(tree):
    """A feature cache written by h5py, keyed by image path (the layout of
    the JAX package's export)."""
    rng = np.random.RandomState(3)
    path = tree / "exports" / "0000.h5"
    path.parent.mkdir(exist_ok=True)
    with h5py.File(str(path), "w") as hf:
        for i in range(6):
            g = hf.create_group(f"imgs/0000/{i}.jpg")
            n = 30 + i
            g["keypoints"] = rng.uniform(0, 200, (n, 2)).astype(np.float32)
            g["keypoint_scores"] = rng.rand(n).astype(np.float16)
            g["descriptors"] = rng.randn(n, 16).astype(np.float32)
            g["keypoint_mask"] = rng.rand(n) > 0.1
            g["depth_keypoints"] = rng.rand(n).astype(np.float64)
    return path


@pytest.mark.parametrize("conf", [{"padding_length": 64}, {"padding_length": 20},
                                  {"data_keys": ["keypoints", "descriptors"]}, {}])
def test_cache_loader_equals_jax(tree, h5py_cache, monkeypatch, conf):
    monkeypatch.setattr(jcl, "DATA_PATH", tree)
    monkeypatch.setattr(tcl, "DATA_PATH", tree)
    conf = {"path": "exports/{scene}.h5", **conf}
    jl, tl = jcl.CacheLoader(conf), get_model("cache_loader")(conf)
    for i in (0, 5):
        data = {"scene": "0000", "name": f"imgs/0000/{i}.jpg",
                "scales": np.array([0.5, 0.75], np.float32)}
        ref, out = jl(data), tl(data)
        assert set(out) == set(ref)
        for k in ref:
            assert out[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    jl.close()
    tl.close()


def test_cached_features_in_the_dataset(tree, h5py_cache, monkeypatch):
    monkeypatch.setattr(tcl, "DATA_PATH", tree)
    _, tds = datasets(tree, monkeypatch, train_num_per_scene=4, load_features={
        "do": True, "path": "exports/{scene}.h5", "padding_length": 64})
    split = tds.get_dataset("train")
    i = next(i for i, it in enumerate(split.items) if it[0] == "0000")
    cache = split[i]["view0"]["cache"]
    assert cache["keypoints"].shape == (64, 2) and cache["keypoint_mask"].sum() >= 25


def test_export_read_by_jax_cache_loader(tree, monkeypatch, tmp_path):
    """The port's export (seeded SuperPoint-open, 64 keypoints, CPU) read by
    the JAX CacheLoader equals the port's predictions on the same views, the
    keypoints' depths included; a view without depth or image is skipped."""
    from gluefactory_tpu_torch.geometry.depth import sample_depth
    from gluefactory_tpu_torch.scripts import export_megadepth as em

    monkeypatch.setattr(tmd, "DATA_PATH", tree)
    monkeypatch.setattr(jcl, "DATA_PATH", tmp_path)
    files = em.main(["--method", "sp", "--n_kpts", "64", "--splits", "train", "--output",
                     str(tmp_path), "--device", "cpu", "data.data_dir=megadepth",
                     "data.train_split=null", "data.grayscale=true"])
    assert [f.name for f in files] == ["0000_sp_64.h5", "0001_sp_64.h5"]
    with h5py.File(files[0], "r") as f:
        assert sorted(f["imgs/0000"].keys()) == [f"{i}.jpg" for i in range(6)]
        assert f["imgs/0000/0.jpg/valid_depth_keypoints"].dtype == bool
    model = em.make_extractor("sp", 64, device="cpu")
    ds = tmd.MegaDepth(merge(BASE, {"train_num_per_scene": 2})).get_dataset("train")
    loader = jcl.CacheLoader({"path": "{scene}_sp_64.h5"})
    for idx in (0, 4):
        view = ds._read_view("0000", idx)
        with torch.no_grad():
            pred = model({"image": torch.from_numpy(view["image"][None])})
        d, valid = sample_depth(pred["keypoints"], torch.from_numpy(view["depth"][None]))
        got = loader({"scene": "0000", "name": f"imgs/0000/{idx}.jpg"})
        want = {**{k: pred[k][0].numpy() for k in em.KEYS if k in pred},
                "depth_keypoints": d[0].numpy(), "valid_depth_keypoints": valid[0].numpy()}
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got["keypoints"].shape == (64, 2) and got["valid_depth_keypoints"].sum() > 10
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        em.main(["--method", "sift", "--device", "cpu"])


@pytest.mark.parametrize("name", ["superpoint-open+lightglue_megadepth",
                                  "superpoint+lightglue_megadepth", "aliked+lightglue_megadepth",
                                  "disk+lightglue_megadepth"])
def test_configs_equal_the_jax_yaml(name):
    ref = yaml.safe_load((REPO / "gluefactory_tpu" / "configs" / f"{name}.yaml").read_text())
    assert load_conf(name) == ref
    assert json.loads((REPO / "gluefactory_tpu_torch" / "configs" / f"{name}.json")
                      .read_text())["data"]["preprocessing"]["square_pad"] is True


def test_megadepth_configuration_trains_on_cpu(tree, monkeypatch, tmp_path):
    """superpoint-open+lightglue_megadepth through the trainer at a reduced
    size (resize 160 square-padded, 64 keypoints, 2 pairs): depth labels on
    square-padded views of both orientations, one finite step."""
    from gluefactory_tpu_torch.train.trainer import Trainer
    from gluefactory_tpu_torch.utils import experiments
    from gluefactory_tpu_torch.weights import load_hermetic

    monkeypatch.setattr(tmd, "DATA_PATH", tree)
    monkeypatch.setattr(experiments, "TRAINING_PATH", tmp_path)
    conf = merge(load_conf("superpoint-open+lightglue_megadepth"), {
        "data": {"data_dir": "megadepth", "train_split": None, "train_num_per_scene": 12,
                 "preprocessing": {"resize": 160}, "batch_size": 2, "grayscale": True},
        "model": {"extractor": {"max_num_keypoints": 64}},
        "train": {"epochs": 1, "eval_every_iter": 0, "save_every_iter": 0}})
    trainer = Trainer(conf, "md", experiments.experiment_dir("md"), device="cpu")
    trainer.build()
    from gluefactory_tpu_torch.train.trainer import graft_state

    graft_state(trainer.model, load_hermetic(device="cpu"))
    split = trainer.dataset.get_dataset("train")
    assert len(split) > 2
    history = trainer.train_steps(trainer.dataset.get_data_loader("train"), steps=1)
    assert np.isfinite(history[0]["total"]) and history[0]["skipped_nonfinite"] == 0
    assert history[0]["num_matchable"] > 1
