"""The port's HPatches benchmark end to end on the CPU against the JAX
package's `HPatchesPipeline`, on the 3-scene HPatches-layout tree of
tests/test_real_schema_benchmarks.py (`i_synth`, `v_synth` at 480 x 640,
`v_wide` at 420 x 700, enlarged to 480 x 800 by the preprocessing), with
the committed weights: SuperPoint-open (512 keypoints, threshold 0.005,
fp32) + LightGlue (9 x 256, fp32, filter 0.1) and the same-detector mutual
nearest-neighbour baseline, RANSAC at 3 px.

Bars, per pair against JAX: keypoints with a score common on >= 99%,
`num_matches` within 2%, `prec@3px` within 0.02, `H_error_dlt` within 5% or
0.05 px; summaries: DLT AUCs within 0.02, RANSAC AUCs within 0.05 (each
side draws its own RANSAC noise). The port's chains meet the floors of
`TestHermeticQualityLoop.test_trained_chain_beats_nn_floors`.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_real_schema_benchmarks import HERMETIC_WEIGHTS, _random_homography, _texture  # noqa: E402
from torch_jax_init import jitted_pipeline_init  # noqa: E402

EXTRACTOR = {"name": "superpoint_open", "max_num_keypoints": 512,
             "detection_threshold": 0.005, "dtype": None}
LIGHTGLUE = {"name": "lightglue", "filter_threshold": 0.1, "collect_layers": False}
NN = {"name": "nearest_neighbor_matcher", "mutual_check": True}
PRE = {"resize": 480, "side": "short", "pad_to": [864, 480]}


def _conf(matcher, data=None):
    return {"data": {"preprocessing": PRE, **(data or {})}, "eval": {"ransac_th": 3.0},
            "model": {"extractor": EXTRACTOR, "matcher": matcher,
                      "checkpoint": str(HERMETIC_WEIGHTS)}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tree of test_real_schema_benchmarks.py's `hpatches_tree`, built the
    same way from the same seed."""
    rng = np.random.RandomState(0)
    data_dir = tmp_path_factory.mktemp("data")
    root = data_dir / "hpatches-sequences-release"
    for scene, (h, w) in (("i_synth", (480, 640)), ("v_synth", (480, 640)),
                          ("v_wide", (420, 700))):
        sdir = root / scene
        sdir.mkdir(parents=True)
        base = _texture(rng, h, w)
        cv2.imwrite(str(sdir / "1.ppm"), base)
        for i in range(2, 7):
            if scene[0] == "i":
                H = np.eye(3)
                gain, bias = rng.uniform(0.6, 1.4), rng.uniform(-25, 25)
                warped = np.clip(base.astype(np.float32) * gain + bias, 0, 255).astype(np.uint8)
            else:
                H = _random_homography(rng, h, w, mag=0.10)
                warped = cv2.warpPerspective(base, H, (w, h), flags=cv2.INTER_LINEAR)
            cv2.imwrite(str(sdir / f"{i}.ppm"), warped)
            np.savetxt(sdir / f"H_1_{i}", H)
    return data_dir, root


@pytest.fixture(scope="module")
def chains(tree, tmp_path_factory):
    """The port's LightGlue and NN chains and JAX's LightGlue chain, once.
    The two port chains share one extractor configuration, so SuperPoint
    runs once an image: a pair's batch is split into its images, each
    extracted once (SuperPoint-open on the CPU gives a batch's images bit
    for bit as it gives them alone) and reused, by the other pairs of its
    scene (view 0 is the scene's reference image) and by the NN chain."""
    import hashlib

    import gluefactory_tpu.datasets.hpatches as jhp
    from gluefactory_tpu.eval.hpatches import HPatchesPipeline as JaxPipeline
    from gluefactory_tpu_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_tpu_torch.models.extractors.superpoint_open import SuperPoint

    data_dir, root = tree
    out = tmp_path_factory.mktemp("eval")
    runs, features, forward, misses = {}, {}, SuperPoint.forward, []

    def shared_forward(self, data):
        outs = []
        for image in data["image"].split(1):
            image = image.contiguous()
            key = (tuple(image.shape), hashlib.sha1(image.numpy().tobytes()).hexdigest())
            if key not in features:
                misses.append(key)
                features[key] = forward(self, {**data, "image": image})
            outs.append(features[key])
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    old = jhp.DATA_PATH
    jhp.DATA_PATH = data_dir
    try:
        # JAX's chain runs in a thread beside the port's: each side's own work, overlapped
        with jitted_pipeline_init(), ThreadPoolExecutor(1) as pool, \
                pytest.MonkeyPatch.context() as mp:
            jax_chain = pool.submit(JaxPipeline(_conf(LIGHTGLUE)).run, out / "jax")
            mp.setattr(SuperPoint, "forward", shared_forward)
            for name, matcher in (("lg", LIGHTGLUE), ("nn", NN)):
                pipe = HPatchesPipeline(_conf(matcher, {"data_dir": str(root)}), device="cpu")
                runs[name] = pipe.run(out / name)[::2] + (out / name, pipe)
                runs[name + "_forwards"] = len(misses)
            runs["jax"] = jax_chain.result()[::2] + (out / "jax", None)
    finally:
        jhp.DATA_PATH = old
    assert runs["lg_forwards"] == runs["nn_forwards"] > 0  # the NN chain ran none of its own
    return runs


def _names(results):
    return [n.decode() if isinstance(n, bytes) else str(n) for n in results["name"]]


def _jax_predictions(path):
    import h5py

    with h5py.File(str(path / "predictions.h5"), "r") as f:
        return {f"{s}/{i}": {k: np.asarray(v) for k, v in f[s][i].items()}
                for s in f.keys() for i in f[s].keys()}


PAIRS = [f"{scene}/{i}" for scene in ("i_synth", "v_synth", "v_wide") for i in range(2, 7)]


@pytest.mark.parametrize("name", PAIRS)
def test_per_pair_against_jax(chains, name):
    from gluefactory_tpu_torch.utils.export_predictions import load_predictions

    (_, r, d, _), (_, rj, dj, _) = chains["lg"], chains["jax"]
    assert _names(r) == _names(rj) == PAIRS
    pred, jpred = load_predictions(d / "predictions.h5")[name], _jax_predictions(dj)[name]
    for i in "01":
        kp, kpj = pred[f"keypoints{i}"], jpred[f"keypoints{i}"]
        ours = {tuple(p) for p in np.round(kp[pred[f"keypoint_scores{i}"] > 0], 2)}
        theirs = {tuple(p) for p in np.round(kpj[jpred[f"keypoint_scores{i}"] > 0], 2)}
        assert len(ours & theirs) >= 0.99 * max(len(ours), len(theirs))
    k = PAIRS.index(name)
    n, nj = float(r["num_matches"][k]), float(rj["num_matches"][k])
    assert abs(n - nj) <= 0.02 * max(n, nj), (n, nj)
    assert abs(float(r["prec@3px"][k]) - float(rj["prec@3px"][k])) <= 0.02
    e, ej = float(r["H_error_dlt"][k]), float(rj["H_error_dlt"][k])
    assert abs(e - ej) <= max(0.05 * ej, 0.05), (e, ej)


@pytest.mark.parametrize("ath", [1, 3, 5])
def test_summaries_against_jax(chains, ath):
    s, sj = chains["lg"][0], chains["jax"][0]
    assert set(s) == set(sj)
    assert abs(s[f"H_error_dlt@{ath}px"] - sj[f"H_error_dlt@{ath}px"]) <= 0.02
    assert abs(s[f"H_error_ransac@{ath}px"] - sj[f"H_error_ransac@{ath}px"]) <= 0.05


# the floors of TestHermeticQualityLoop.test_trained_chain_beats_nn_floors
FLOORS = {
    "matches": lambda lg, nn: lg["mnum_matches"] > 150,
    "precision": lambda lg, nn: lg["mprec@3px"] > 0.50,
    "ransac_auc": lambda lg, nn: lg["H_error_ransac@3px"] > 0.42,
    "dlt_auc_above_nn": lambda lg, nn: lg["H_error_dlt@3px"] > nn["H_error_dlt@3px"],
    "dlt_error": lambda lg, nn: lg["mH_error_dlt"] < 10.0,
    "ransac_auc_near_nn":
        lambda lg, nn: lg["H_error_ransac@3px"] >= nn["H_error_ransac@3px"] - 0.12,
}


@pytest.mark.parametrize("floor", list(FLOORS))
def test_port_chain_meets_hermetic_floors(chains, floor):
    s_lg, s_nn = chains["lg"][0], chains["nn"][0]
    assert FLOORS[floor](s_lg, s_nn), (s_lg, s_nn)


def test_outputs_and_conf_guard(chains):
    from gluefactory_tpu_torch.eval.eval_pipeline import load_eval
    from gluefactory_tpu_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_tpu_torch.utils.export_predictions import load_predictions

    s, r, d, pipe = chains["lg"]
    for f in ("predictions.h5", "results.h5", "summaries.json", "conf.json"):
        assert (d / f).exists(), f
    s2, r2 = load_eval(d)
    assert s2 == s == json.loads((d / "summaries.json").read_text())
    assert set(r2) == set(r) and "H_error_ransac_3.0" in r2
    assert all(np.isfinite(v) for v in s.values())
    assert set(pipe.timings) == {"export_s", "eval_s"}
    stops = [int(p["stop_layer"]) for p in load_predictions(d / "predictions.h5").values()]
    assert stops == [8] * 15  # full depth: every pair exits after the last layer
    # one threshold alone through the eval layer gives the sweep's result
    from gluefactory_tpu_torch.datasets.hpatches import HPatchesDataset
    from gluefactory_tpu_torch.eval.utils import eval_homography_robust

    data = HPatchesDataset(pipe.conf.data).get_dataset("test")[7]
    pred = load_predictions(d / "predictions.h5")[data["name"]]
    one = eval_homography_robust(data, pred, {"ransac_th": 3.0}, "cpu")
    i = list(r["name"]).index(data["name"])
    assert abs(one["H_error_ransac"] - float(r["H_error_ransac_3.0"][i])) < 1e-3
    assert one["ransac_inl"] == int(r["ransac_inl_3.0"][i])
    changed = _conf({**LIGHTGLUE, "filter_threshold": 0.2}, pipe.conf.data)
    with pytest.raises(AssertionError, match="overwrite"):
        HPatchesPipeline(changed, device="cpu").run(d)


def test_export_rescale_fault_pinned(chains, tree, tmp_path):
    """The reference's keypoint rescale in export_predictions looks up
    `scales0` in `view0`, whose key is `scales`, so it never fires: the
    exported keypoints stay in the processed frame of `H_0to1` (consistent),
    in the port as in the JAX package. Multiplied by the scales, as that
    code means to, they leave that frame where the scale is not 1 (v_wide,
    8/7): prec@3px drops there and is unchanged at scale 1."""
    import h5py

    from gluefactory_tpu.utils.export_predictions import export_predictions as jax_export
    from gluefactory_tpu_torch.datasets.base_dataset import collate
    from gluefactory_tpu_torch.datasets.hpatches import HPatchesDataset
    from gluefactory_tpu_torch.eval.utils import eval_matches_homography
    from gluefactory_tpu_torch.utils.export_predictions import export_predictions, load_predictions

    _, root = tree
    preds = load_predictions(chains["lg"][2] / "predictions.h5")
    split = HPatchesDataset({"data_dir": str(root), "preprocessing": PRE}).get_dataset("test")
    for idx in range(len(split)):
        data = split[idx]
        pred = preds[data["name"]]
        scaled = {**pred, **{f"keypoints{i}": pred[f"keypoints{i}"] * data[f"view{i}"]["scales"]
                             for i in "01"}}
        p = eval_matches_homography(data, pred, "cpu")["prec@3px"]
        p_scaled = eval_matches_homography(data, scaled, "cpu")["prec@3px"]
        if data["scene"] == "v_wide":
            np.testing.assert_allclose(data["view0"]["scales"], [8 / 7, 8 / 7], rtol=1e-6)
            assert p_scaled < p - 0.2, (data["name"], p, p_scaled)
        else:
            assert p == p_scaled

    # both exports write a v_wide batch's keypoints as the model gave them
    batch = collate([split[10]])
    assert batch["name"] == ["v_wide/2"]
    kp = {f"keypoints{i}": np.full((1, 4, 2), 700.0, np.float32) for i in "01"}
    export_predictions([batch], lambda b: kp, tmp_path / "port.h5")
    jax_export([batch], lambda b: kp, tmp_path / "p.h5")
    with h5py.File(str(tmp_path / "p.h5"), "r") as f:
        np.testing.assert_array_equal(f["v_wide/2/keypoints0"], kp["keypoints0"][0])
    np.testing.assert_array_equal(load_predictions(tmp_path / "port.h5")["v_wide/2"]["keypoints1"],
                                  kp["keypoints1"][0])
