"""The port's multispectral (MP) slice against the JAX package and OpenCV on
the CPU: the two OpenCV operations of the pair dataset, the dataset and its
two-view bridge, the detector metrics, the MP benchmark, and LightGlue
training on MP pairs through both MP configurations.

Bars:
  - `fill_circle` equal to `cv2.circle(img, c, r, 1.0, -1)` pixel for pixel
    (OpenCV's integer midpoint `Circle`: the filled ellipse of
    `ellipse2Poly` draws other pixels);
  - `warp_perspective_cv` equal to `cv2.warpPerspective` bit for bit, image
    and ones mask, at widths that are multiples of OpenCV's 16-float SIMD
    block and at a ragged one (its scalar tail rounds differently). The
    port's older `warp_perspective` (the JAX package's native warp, float64)
    is up to 5.4e-5 off OpenCV's at 320 x 256, so it is not reused;
  - `synthetic_thermal` and the val / test samples within 1e-6 (the
    Gaussian blurs sum in float64, OpenCV in float32: a few float32 ulps),
    homographies and valid masks exact, the generator left in the same
    state; the bridge's H_0to1 bit for bit (the JAX package's float32
    numpy: `np.linalg.inv` of a float32 matrix stays float32);
  - the metrics exact;
  - the MP benchmark per pair against the JAX `MPPipeline`, SuperPoint-open
    (256 keypoints, threshold 0) + LightGlue (the committed 9 x 256
    weights, fp32) on 3 test pairs at 128 x 96 (a pool of 30): the bars of
    tests/test_torch_eval_hpatches.py (keypoints >= 99% common, matches
    within 2%, prec@3px within 0.02, H_error_dlt within 5% or 0.05 px;
    DLT AUCs within 0.02, RANSAC AUCs within 0.05). LightGlue cut to 2
    layers gives 1-10 matches a pair there, too few to hold the
    homographies to; the 9 layers cost the JAX chain about the same (45 s
    against 41 s);
  - the learning rate of the MP configurations' `lr_schedule` (`on_epoch:
    true`, `start: 20`, `exp_div_10: 10`): the JAX package ignores
    `on_epoch` and decays per step, and so does the port (1e-4 * 10^-8 at
    step 100; within 1e-4 relative of the learning rate in optax's float32
    Adam updates, which its bias correction moves by up to 1e-5).
"""

import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_init import jitted_pipeline_init

from gluefactory_tpu.datasets import get_dataset as jax_dataset
from gluefactory_tpu.multipoint.datasets import image_pair_dataset as jmp
from gluefactory_tpu.multipoint.utils import evaluation as jeval
from gluefactory_tpu.utils.config import load_yaml
from gluefactory_tpu_torch.datasets import collate, get_dataset
from gluefactory_tpu_torch.datasets.image_ops import (
    fill_circle,
    fill_ellipse,
    warp_perspective_cv,
)
from gluefactory_tpu_torch.geometry.homography import sample_homography_corners
from gluefactory_tpu_torch.multipoint.datasets import image_pair_dataset as tmp_ds
from gluefactory_tpu_torch.multipoint.utils import evaluation as teval
from gluefactory_tpu_torch.utils.tensor import batch_to_device
from gluefactory_tpu_torch.weights import HERMETIC

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"pool": 30, "size": [128, 96]}
AUG = {"photometric": {"enable": True, "name": "dark"},
       "homographic": {"enable": True,
                       "params": {"difficulty": 0.5, "translation": 0.3, "max_angle": 30}}}
CONFIGS = ["superpoint-open+lightglue_MP", "superpoint+lightglue_MP"]


# --------------------------------------------------------- OpenCV operations
@pytest.mark.parametrize("seed", range(3))
def test_fill_circle_equals_cv2(seed):
    rng = np.random.RandomState(seed)
    for _ in range(300):
        h, w = rng.randint(5, 300, 2)
        c, r = (rng.randint(0, w), rng.randint(0, h)), rng.randint(0, 150)
        ref = np.zeros((h, w), np.float32)
        cv2.circle(ref, c, r, 1.0, -1)
        out = fill_circle(np.zeros((h, w), np.float32), c, r, 1.0)
        np.testing.assert_array_equal(out, ref, err_msg=f"{(h, w)} {c} {r}")


def test_fill_circle_is_not_the_filled_ellipse():
    differ = 0
    for r in range(1, 64):
        a = fill_circle(np.zeros((140, 140), np.float32), (70, 70), r, 1.0)
        b = fill_ellipse(np.zeros((140, 140), np.float32), (70, 70), (r, r), 0, 1.0)
        differ += not np.array_equal(a, b)
    assert differ > 10


@pytest.mark.parametrize("size", [(320, 256), (128, 96), (100, 61)])
def test_warp_perspective_cv_equals_cv2(size):
    w, h = size
    rng = np.random.RandomState(w)
    for _ in range(3):
        img = rng.rand(h, w, 1).astype(np.float32)
        H, *_ = sample_homography_corners((w, h), (w, h), rng=rng, difficulty=0.5,
                                          translation=0.3, max_angle=30)
        out = warp_perspective_cv(np.concatenate([img, np.ones_like(img)], -1), H, (w, h))
        np.testing.assert_array_equal(out[..., 0], cv2.warpPerspective(img, H, (w, h)))
        np.testing.assert_array_equal(
            out[..., 1], cv2.warpPerspective(np.ones((h, w), np.float32), H, (w, h)))
        np.testing.assert_array_equal(warp_perspective_cv(img[..., 0], H, (w, h)), out[..., 0])


# --------------------------------------------------------------- the dataset
@pytest.mark.parametrize("seed", range(3))
def test_synthetic_thermal_matches_jax(seed):
    from gluefactory_tpu.datasets.homographies import generate_texture_image

    optical = generate_texture_image(np.random.RandomState(seed), (128, 96))
    r_j, r_t = np.random.RandomState(seed), np.random.RandomState(seed)
    ref = jmp.synthetic_thermal(optical, r_j)
    out = tmp_ds.synthetic_thermal(optical, r_t)
    assert out.shape == ref.shape == (96, 128, 1) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert r_j.randint(1 << 30) == r_t.randint(1 << 30)


@pytest.mark.parametrize("split,idx", [("val", 0), ("val", 2), ("test", 1)])
def test_sample_matches_jax(split, idx):
    conf = {"synthetic": SMALL, "augmentation": AUG}
    ref = jmp.ImagePairDataset(conf).get_dataset(split)[idx]
    out = tmp_ds.ImagePairDataset(conf).get_dataset(split)[idx]
    assert out["name"] == ref["name"] and out["idx"] == idx
    for key in ("optical", "thermal"):
        np.testing.assert_allclose(out[key]["image"], ref[key]["image"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out[key]["homography"], ref[key]["homography"])
        np.testing.assert_array_equal(out[key]["valid_mask"], ref[key]["valid_mask"])
        assert out[key]["image"].dtype == np.float32 and out[key]["image"].shape == (96, 128, 1)


def test_train_split_is_seeded_by_epoch():
    split = tmp_ds.ImagePairDataset({"synthetic": SMALL, "augmentation": AUG}).get_dataset(
        "train")
    assert len(split) == 27
    a = split[3]["thermal"]["image"]
    np.testing.assert_array_equal(split[3]["thermal"]["image"], a)
    split.set_epoch(1)
    assert not np.array_equal(split[3]["thermal"]["image"], a)


def _mp_h5(path, n=12, libver="earliest"):
    """An MP pair file in the reference's schema, written by h5py: a group a
    pair with aligned `optical` (H, W) and `thermal` (H, W, 1) images."""
    import h5py

    rng = np.random.RandomState(4)
    with h5py.File(path, "w", libver=libver) as f:
        for i in range(n):
            g = f.create_group(f"pair_{(i * 7) % n:03d}")
            g["optical"] = rng.rand(96, 128).astype(np.float32)
            g["thermal"] = rng.rand(96, 128, 1).astype(np.float64)


def test_hdf5_source_raises(tmp_path, monkeypatch):
    """The HDF5 source raises on a file that is not there, and names what
    the port's reader refuses (a file of h5py's libver='latest')."""
    monkeypatch.setattr(tmp_ds, "DATA_PATH", tmp_path)
    with pytest.raises(FileNotFoundError):
        tmp_ds.ImagePairDataset({"filename": "multipoint/training.hdf5"})
    _mp_h5(tmp_path / "latest.h5", n=2, libver="latest")
    with pytest.raises(ValueError, match="superblock v3"):
        tmp_ds.ImagePairDataset({"filename": "latest.h5"})


@pytest.mark.parametrize("split,idx", [("train", 0), ("val", 0), ("test", 1)])
def test_hdf5_source_matches_jax(tmp_path, monkeypatch, split, idx):
    """The `filename` source on an h5py-written file against the JAX
    package's: the same names and splits, and the same pair, augmented (val /
    test; the JAX train split draws its augmentation unseeded, so there the
    images are held without it)."""
    _mp_h5(tmp_path / "mp.h5")
    monkeypatch.setattr(jmp, "DATA_PATH", tmp_path)
    monkeypatch.setattr(tmp_ds, "DATA_PATH", tmp_path)
    aug = AUG if split != "train" else {"photometric": {"enable": False},
                                        "homographic": {"enable": False}}
    conf = {"filename": "mp.h5", "augmentation": aug}
    ref_ds, out_ds = jmp.ImagePairDataset(conf), tmp_ds.ImagePairDataset(conf)
    ref, out = ref_ds.get_dataset(split), out_ds.get_dataset(split)
    assert out.names == ref.names and len(out) == {"train": 10, "val": 2, "test": 2}[split]
    r, o = ref[idx], out[idx]
    assert o["name"] == r["name"]
    for key in ("optical", "thermal"):
        assert o[key]["image"].shape == (96, 128, 1) and o[key]["image"].dtype == np.float32
        np.testing.assert_allclose(o[key]["image"], r[key]["image"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(o[key]["homography"], r[key]["homography"])
        np.testing.assert_array_equal(o[key]["valid_mask"], r[key]["valid_mask"])


def test_bridge_matches_jax():
    conf = {"mp": {"synthetic": SMALL, "augmentation": AUG}}
    ref = jax_dataset("mp_image_pairs")(conf).get_dataset("test")
    out = get_dataset("mp_image_pairs")(conf).get_dataset("test")
    assert len(out) == len(ref) == 3
    for i in range(3):
        r, o = ref[i], out[i]
        assert o["H_0to1"].dtype == np.float32
        np.testing.assert_array_equal(o["H_0to1"], r["H_0to1"])
        for v, optical in (("view0", True), ("view1", False)):
            np.testing.assert_allclose(o[v]["image"], r[v]["image"], rtol=0, atol=1e-6)
            np.testing.assert_array_equal(o[v]["image_size"], [128.0, 96.0])
            assert o[v]["is_optical"] is r[v]["is_optical"] is optical
    # is_optical collates to a (B,) bool tensor: the extractors route by it
    batch = batch_to_device(collate([out[0], out[1]]), "cpu")
    for v, flag in (("view0", True), ("view1", False)):
        t = batch[v]["is_optical"]
        assert t.dtype == torch.bool and t.shape == (2,) and bool((t == flag).all())


# --------------------------------------------------------------- the metrics
@pytest.fixture(scope="module")
def metric_inputs():
    rng = np.random.RandomState(0)
    H = np.array([[1.02, 0.03, 4.0], [-0.02, 0.98, -3.0], [1e-4, -5e-5, 1.0]])
    k0 = rng.uniform(0, 128, (60, 2)).astype(np.float32)
    from gluefactory_tpu_torch.geometry.homography import warp_points_np

    k1 = (warp_points_np(k0, H) + rng.normal(0, 1.5, (60, 2))).astype(np.float32)
    k1[:15] = rng.uniform(0, 128, (15, 2))
    d0 = rng.normal(size=(60, 32)).astype(np.float32)
    d1 = (d0 + rng.normal(0, 0.6, (60, 32))).astype(np.float32)
    prob = rng.rand(96, 128).astype(np.float32) * 0.05
    return H, k0, k1, d0, d1, prob


@pytest.mark.parametrize("name", ["repeatability", "localization_error", "matching_score",
                                  "keypoints_from_prob"])
def test_metrics_match_jax(name, metric_inputs):
    H, k0, k1, d0, d1, prob = metric_inputs
    args = {"repeatability": (k0, k1, H, (128, 96)),
            "localization_error": (k0, k1, H),
            "matching_score": (d0, d1, k0, k1, H),
            "keypoints_from_prob": (prob, 0.015, 4, 50)}[name]
    ref, out = getattr(jeval, name)(*args), getattr(teval, name)(*args)
    if name == "keypoints_from_prob":
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        assert len(out[0]) == 50
    else:
        assert out == ref and 0 < out


# -------------------------------------------------------------- the benchmark
EXTRACTOR = {"name": "superpoint_open", "max_num_keypoints": 256, "detection_threshold": 0.0,
             "nms_radius": 3, "dtype": None}
LIGHTGLUE = {"name": "lightglue", "filter_threshold": 0.1, "collect_layers": False}


def _bench_conf():
    return {"data": {"mp": {"synthetic": SMALL}}, "eval": {"ransac_th": 0.5},
            "model": {"extractor": EXTRACTOR, "matcher": LIGHTGLUE, "checkpoint": str(HERMETIC)}}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The JAX MPPipeline and the port's, once each, on the same test split."""
    import h5py

    from gluefactory_tpu.eval.MP import MPPipeline as JaxPipeline
    from gluefactory_tpu_torch.eval.MP import MPPipeline
    from gluefactory_tpu_torch.utils.export_predictions import load_predictions

    out = tmp_path_factory.mktemp("mp")
    s, _, r = MPPipeline(_bench_conf(), device="cpu").run(out / "port")
    with jitted_pipeline_init():
        sj, _, rj = JaxPipeline(_bench_conf()).run(out / "jax")
    with h5py.File(str(out / "jax" / "predictions.h5"), "r") as f:
        pj = {str(n): {k: np.asarray(v) for k, v in f[str(n)].items()} for n in r["name"]}
    return (s, r, load_predictions(out / "port" / "predictions.h5")), (sj, rj, pj)


@pytest.mark.parametrize("k", range(3))
def test_benchmark_per_pair_against_jax(chains, k):
    (_, r, pred), (_, rj, pj) = chains
    names = [str(n) for n in r["name"]]
    assert names == [n.decode() if isinstance(n, bytes) else str(n) for n in rj["name"]]
    name = names[k]
    p, q = pred[name], pj[name]
    for i in "01":
        ours = {tuple(x) for x in np.round(p[f"keypoints{i}"][p[f"keypoint_scores{i}"] > 0], 2)}
        theirs = {tuple(x) for x in np.round(q[f"keypoints{i}"][q[f"keypoint_scores{i}"] > 0], 2)}
        assert len(ours & theirs) >= 0.99 * max(len(ours), len(theirs))
    n, nj = float(r["num_matches"][k]), float(rj["num_matches"][k])
    assert abs(n - nj) <= 0.02 * max(n, nj), (n, nj)
    assert abs(float(r["prec@3px"][k]) - float(rj["prec@3px"][k])) <= 0.02
    e, ej = float(r["H_error_dlt"][k]), float(rj["H_error_dlt"][k])
    assert abs(e - ej) <= max(0.05 * ej, 0.05), (e, ej)


@pytest.mark.parametrize("kind,bar", [("dlt", 0.02), ("ransac", 0.05)])
def test_benchmark_summaries_against_jax(chains, kind, bar):
    (s, _, _), (sj, _, _) = chains
    for th in (1, 3, 5):
        key = f"H_error_{kind}@{th}px"
        assert abs(s[key] - sj[key]) <= bar, (key, s[key], sj[key])
    assert s["mnum_matches"] > 20 and np.isfinite(s["mH_error_dlt"])


def test_benchmark_registry_and_default(tmp_path):
    from gluefactory_tpu_torch.eval import get_benchmark
    from gluefactory_tpu_torch.eval.MP import MPPipeline

    assert get_benchmark("MP") is MPPipeline
    from gluefactory_tpu.eval.MP import MPPipeline as JaxPipeline

    assert MPPipeline.default_conf == JaxPipeline.default_conf
    with pytest.raises(NotImplementedError, match="not portable"):  # the host OpenCV SIFT
        MPPipeline(device="cpu").run(tmp_path / "mp")


def test_cli(tmp_path, monkeypatch, capsys):
    from gluefactory_tpu_torch.eval import MP

    monkeypatch.setattr(MP, "EVAL_PATH", tmp_path)
    summaries = MP.main([
        "--device", "cpu", "--checkpoint", str(HERMETIC), "--tag", "t",
        "model.extractor=" + json.dumps({**EXTRACTOR, "max_num_keypoints": 64}),
        "model.matcher=" + json.dumps(LIGHTGLUE),
        "data.mp.synthetic=" + json.dumps({"pool": 10, "size": [64, 48]})])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summaries
    assert (tmp_path / "MP" / "t" / "predictions.h5").exists()
    assert summaries["mnum_keypoints"] == 64


# -------------------------------------------------------------- the training
@pytest.mark.parametrize("name", CONFIGS)
def test_json_config_equals_the_jax_yaml(name):
    ref = load_yaml(ROOT / "gluefactory_tpu" / "configs" / f"{name}.yaml")
    path = ROOT / "gluefactory_tpu_torch" / "configs" / f"{name}.json"
    assert json.loads(path.read_text()) == ref


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_trains_with_its_benchmark(name, tmp_path, monkeypatch):
    """The configuration through the command line's `main` with
    --run_benchmarks, cut to 2 steps of 4 pairs at 128 x 96, 64 keypoints,
    LightGlue 2 x 256. The configuration's `benchmarks: MP` entry names no
    model, so the JAX package evaluates the MP benchmark's default (SIFT +
    NN); the port raises at SIFT, which the trainer logs and goes on: the
    run gives the benchmark the trained model's extractor and matcher."""
    from gluefactory_tpu_torch.train import __main__ as cli
    from gluefactory_tpu_torch.utils import experiments as exps

    monkeypatch.setattr(exps, "TRAINING_PATH", tmp_path)
    model = {"extractor": {"name": "superpoint_open" if "open" in name else
                           "superpoint_magicleap", "max_num_keypoints": 64,
                           "detection_threshold": 0.0},
             "matcher": {"name": "lightglue", "n_layers": 2}}
    trainer = cli.main([
        "e", "--conf", name, "--device", "cpu", "--run_benchmarks",
        "data.batch_size=4", "data.mp.train_fraction=0.5",
        "data.mp.synthetic=" + json.dumps({"pool": 16, "size": [128, 96]}),
        "model.extractor.max_num_keypoints=64", "model.matcher.n_layers=2",
        "train.epochs=1", "train.log_every_iter=1",
        "benchmarks.MP.data=" + json.dumps({"mp": {"synthetic": {"pool": 20, "size": [64, 48]}}}),
        "benchmarks.MP.model=" + json.dumps(model)])
    assert trainer.state.step == 2
    events = [json.loads(x) for x in (tmp_path / "e" / "events.jsonl").read_text().splitlines()]
    tags = {k for e in events for k in e.get("scalars", e)}
    assert any(str(t).startswith("bench/MP/") for t in tags), sorted(tags)[:20]
    losses = [e for e in events if "train/loss/total" in e.get("scalars", e)]
    assert losses and all(np.isfinite(e.get("scalars", e)["train/loss/total"]) for e in losses)
    assert (tmp_path / "e" / "checkpoint_best").exists()


def test_lr_schedule_decays_per_step_in_both_packages():
    """`on_epoch: true` is ignored by the JAX package (train/step.py:39-44):
    the exp schedule decays per optimizer step. The port does the same."""
    from gluefactory_tpu.train.step import make_optimizer
    from gluefactory_tpu_torch.train.step import make_schedule

    train = json.loads((ROOT / "gluefactory_tpu_torch" / "configs"
                        / f"{CONFIGS[0]}.json").read_text())["train"]
    assert train["lr_schedule"]["on_epoch"] is True
    # with a constant gradient of 1, each Adam update of the JAX optimizer is
    # -lr(count) / (1 + 1e-8)
    tx = make_optimizer(train)
    params = jnp.zeros(())
    state = tx.init(params)
    step = jax.jit(lambda s: tx.update(jnp.ones(()), s, params))
    jax_lr = []
    for _ in range(101):
        updates, state = step(state)
        jax_lr.append(-float(updates) * (1 + 1e-8))
    sched = make_schedule(train)
    port_lr = [sched(i) for i in range(101)]
    # optax's float32 bias correction moves an update by up to 1e-5 of itself
    np.testing.assert_allclose(jax_lr, port_lr, rtol=1e-4, atol=0)
    assert port_lr[20] == 1e-4 and port_lr[30] == pytest.approx(1e-5, rel=1e-12)
    assert port_lr[100] == pytest.approx(1e-4 * 1e-8, rel=1e-12)
