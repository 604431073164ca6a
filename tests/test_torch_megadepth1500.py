"""MegaDepth-1500 of the port (`datasets/image_pairs.py`,
`eval/megadepth1500.py`, the three JSON configurations naming it) against
the JAX package on the CPU, on the JAX package's own fixture tree
(`tests/test_real_schema_benchmarks.py::megadepth1500_tree`: two calibrated
JPEG pairs of 480 x 640, 36-field lines).

`ImagePairs` on 2-, 11- and 36-field lines: images within the area-resize
bar (mean < 1e-7, max < 1e-6), scales exact, cameras, T_0to1, T_1to0 and
H_0to1 within 1e-6. The benchmark runs at 320 px (padded to 320 x 320) with
256 keypoints, the committed weights, fp32, RANSAC at 1 px, as
`tests/test_torch_relpose.py` holds `synthetic_pose` (its module docstring
says why the pose errors are held by distribution): the port's export
against JAX's by keypoint coordinates, >= 98% of view 0's keypoints common
and >= 99% of the matches equal over the two pairs; epipolar precisions
within 0.01; the port's eval phase on JAX's predictions with JAX's draws:
per pair the epipolar precisions equal and `success` equal; over the draws
of PRNGKey(0 ... 11), per pair the port's mean pose error at most 1 degree
above JAX's, over both 0.25, and the mean mAA within 0.05. Twelve draws, not
`test_torch_relpose.py`'s four: on these pairs both estimators land in
modes about 2 degrees apart (4.3 or 6.1 degrees on pair 0) about as often,
so a mean over four draws moves by about 1 degree from draw to draw
(measured over PRNGKey(0 ... 11): pair 0 JAX 4.55 / port 5.04, pair 1 JAX
7.41 / port 6.67).
"""

import json
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import yaml
from test_real_schema_benchmarks import megadepth1500_tree  # noqa: F401  (the JAX fixture)
from test_torch_relpose import _equal_partners, _jax_core, _jax_noise, _rel_pose_err
from torch_jax_init import jitted_pipeline_init

from gluefactory_tpu.datasets.image_pairs import ImagePairs as JImagePairs
from gluefactory_tpu.eval.megadepth1500 import MegaDepth1500Pipeline as JPipeline
from gluefactory_tpu_torch.datasets import get_dataset
from gluefactory_tpu_torch.datasets.image_pairs import ImagePairs
from gluefactory_tpu_torch.estimators import ransac as port_ransac
from gluefactory_tpu_torch.eval import get_benchmark
from gluefactory_tpu_torch.eval.io import get_eval_parser, parse_eval_args
from gluefactory_tpu_torch.eval.megadepth1500 import MegaDepth1500Pipeline, main
from gluefactory_tpu_torch.utils.export_predictions import load_predictions
from gluefactory_tpu_torch.utils.tools import AUCMetric

REPO = Path(__file__).resolve().parent.parent
PRE = {"resize": 320, "side": "long", "pad_to": [320, 320]}


def _data_conf(tree, pairs="pairs_calibrated.txt"):
    root = tree / "megadepth1500"
    return {"pairs": str(root / pairs), "root": str(root / "images"), "preprocessing": PRE}


@pytest.fixture(scope="module")
def tree(megadepth1500_tree):  # noqa: F811
    """The JAX fixture's tree, plus the same pairs as 2- and 11-field lines."""
    root = megadepth1500_tree / "megadepth1500"
    lines = [line.split() for line in (root / "pairs_calibrated.txt").read_text().splitlines()]
    H = "0.98 0.02 5.5 -0.01 1.01 -3.25 1e-05 -2e-05 1.0"
    (root / "pairs_plain.txt").write_text("".join(f"{a} {b}\n" for a, b, *_ in lines))
    (root / "pairs_h.txt").write_text("".join(f"{a} {b} {H}\n" for a, b, *_ in lines))
    return megadepth1500_tree


def _close(a, b, what, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("pairs", ["pairs_plain.txt", "pairs_h.txt", "pairs_calibrated.txt"])
def test_image_pairs_match_jax(tree, pairs):
    port = ImagePairs(_data_conf(tree, pairs)).get_dataset("test")
    ref = JImagePairs(_data_conf(tree, pairs)).get_dataset("test")
    assert len(port) == len(ref) == 2
    assert get_dataset("image_pairs") is ImagePairs
    for i in range(2):
        out, want = port[i], ref[i]
        assert out["name"] == want["name"] and out["idx"] == want["idx"]
        assert set(out) == set(want), (set(out), set(want))
        for v in ("view0", "view1"):
            o, w = out[v], want[v]
            assert set(o) == set(w) and o["name"] == w["name"]
            assert o["image"].shape == w["image"].shape
            diff = np.abs(o["image"] - w["image"])
            assert diff.mean() < 1e-7 and diff.max() < 1e-6, (diff.mean(), diff.max())
            np.testing.assert_array_equal(o["scales"], w["scales"])
            np.testing.assert_array_equal(o["image_size"], w["image_size"])
            if "camera" in w:
                _close(o["camera"]._data, w["camera"]._data, f"{v} camera")
            meta = port.metadata(i)[v]
            np.testing.assert_array_equal(meta["scales"], o["scales"])
            if "camera" in o:
                _close(meta["camera"]._data, o["camera"]._data, "metadata camera", 0)
        if "H_0to1" in want:
            _close(out["H_0to1"], want["H_0to1"], "H_0to1")
        for k in ("T_0to1", "T_1to0"):
            if k in want:
                _close(out[k].R, want[k].R, f"{k}.R")
                _close(out[k].t, want[k].t, f"{k}.t")


CONF = {
    "eval": {"ransac_th": 1.0},
    "model": {
        "extractor": {"name": "superpoint_open", "max_num_keypoints": 256,
                      "detection_threshold": 0.0, "dtype": None},
        "matcher": {"name": "lightglue", "filter_threshold": 0.1},
        "checkpoint": str(REPO / "weights" / "hermetic" / "sp_open_lg.npz"),
    },
}


@pytest.fixture(scope="module")
def chains(tree, tmp_path_factory):
    """The JAX and the port's benchmark on the same configuration, once;
    the port reads JAX's `predictions.h5` as it is."""
    root = tmp_path_factory.mktemp("megadepth1500")
    conf = {**CONF, "data": _data_conf(tree)}
    with jitted_pipeline_init():
        js, _, jr = JPipeline(conf).run(root / "jax")
    port = MegaDepth1500Pipeline(conf, device="cpu")
    ps, _, pr = port.run(root / "port")
    names = list(pr["name"])
    with h5py.File(str(root / "jax" / "predictions.h5"), "r") as f:
        jpreds = {n: {k: np.asarray(v) for k, v in f[n].items()} for n in names}
    split = port.make_dataset(port.conf.data).get_dataset("test")
    matches, gt = {}, []
    for i, (name, p) in enumerate(jpreds.items()):
        meta = split.metadata(i)
        m0 = p["matches0"]
        cams = [meta["view0"]["camera"], meta["view1"]["camera"]]
        pts = [torch.from_numpy(p["keypoints0"][m0 > -1]),
               torch.from_numpy(p["keypoints1"][m0[m0 > -1]])]
        n = len(pts[0])
        pad = -(-n // 256) * 256 - n
        pts = [torch.nn.functional.pad(c.normalize(q[None])[0], (0, 0, 0, pad)).numpy()
               for c, q in zip(cams, pts)]
        f_mean = (np.float32(cams[0].f.mean()) + np.float32(cams[1].f.mean())) / np.float32(2)
        matches[name] = (pts[0], pts[1], np.arange(n + pad) < n, np.float32(1.0) / f_mean)
        gt.append(meta["T_0to1"])
    return {"root": root, "names": names, "jax": (js, jr), "port": (ps, pr), "pipeline": port,
            "jax_preds": jpreds, "port_preds": load_predictions(root / "port" / "predictions.h5"),
            "jax_matches": matches, "gt": gt}


def test_export_matches_equal_jax(chains):
    equal = [_equal_partners(chains, name) for name in chains["names"]]  # >= 98% common
    assert np.mean(np.concatenate(equal)) >= 0.99


def test_summaries_match_jax(chains):
    js, ps = chains["jax"][0], chains["port"][0]
    assert set(ps) == set(js)
    for k in ("mepi_prec@1e-4", "mepi_prec@5e-4", "mepi_prec@1e-3"):
        assert abs(ps[k] - js[k]) <= 0.01, k
    assert abs(ps["mnum_matches"] - js["mnum_matches"]) <= 0.02 * js["mnum_matches"]
    assert all(np.isfinite(v) for v in ps.values())


@pytest.fixture(scope="module")
def eval_on_jax_predictions(chains):
    """The port's eval phase on JAX's predictions, fed JAX's draws."""
    calls = []

    def jax_gumbel(shape, generator, device):
        noise = _jax_noise(shape[1])[len(calls) % 2]
        calls.append(shape)
        return noise.to(device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ransac, "gumbel", jax_gumbel)
        pipe = chains["pipeline"]
        _, _, results = pipe.run_eval(pipe.get_eval_data(), chains["root"] / "jax" / "predictions.h5")
    assert len(calls) == 2 * 2
    assert list(results["name"]) == chains["names"]
    return results


@pytest.mark.parametrize("i", range(2))
def test_eval_phase_on_jax_predictions(chains, eval_on_jax_predictions, i):
    results, jr = eval_on_jax_predictions, chains["jax"][1]
    for k in ("epi_prec@1e-4", "epi_prec@5e-4", "epi_prec@1e-3", "num_matches"):
        assert results[k][i] == pytest.approx(float(jr[k][i]), abs=1e-9), k
    assert np.isfinite(results["rel_pose_error_1.0"][i]) == np.isfinite(
        jr["rel_pose_error_1.0"][i])


SEEDS = range(12)


@pytest.fixture(scope="module")
def errors_by_seed(chains, eval_on_jax_predictions):
    """rel_pose_error (seed, pair): the eval phases' for PRNGKey(0), the
    cores' for the other seeds. JAX's cores run under the device context of
    its eval phase, so they reuse the program that phase compiled, and are
    all dispatched before the port's cores run (JAX computes them
    asynchronously meanwhile), after their draws."""
    import jax

    cases = [(seed, *m, T) for seed in SEEDS[1:]
             for m, T in zip(chains["jax_matches"].values(), chains["gt"])]
    # the draws before the cores: drawn after, they would queue behind them
    noises = [_jax_noise(len(p0), seed=seed) for seed, p0, *_ in cases]
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        jax_out = [_jax_core(p0, p1, valid, th, seed) for seed, p0, p1, valid, th, _ in cases]
    port_out = [port_ransac.ransac_relative_pose_core(
        torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(valid), noise, float(th),
        refine_iters=4) for (seed, p0, p1, valid, th, _), noise in zip(cases, noises)]
    errs = {"jax": [chains["jax"][1]["rel_pose_error_1.0"]],
            "port": [eval_on_jax_predictions["rel_pose_error_1.0"]]}
    for k, outs in (("jax", jax_out), ("port", port_out)):
        per_case = [_rel_pose_err(r, case[-1]) for r, case in zip(outs, cases)]
        errs[k] += np.reshape(per_case, (len(SEEDS) - 1, -1)).tolist()
    return {k: np.array(v, np.float64) for k, v in errs.items()}


@pytest.mark.parametrize("i", range(2))
def test_pose_errors_by_seed_per_pair(errors_by_seed, i):
    port, ref = errors_by_seed["port"][:, i], errors_by_seed["jax"][:, i]
    assert np.isfinite(port).sum() == np.isfinite(ref).sum()
    assert np.mean(port) <= np.mean(ref) + 1.0


def test_pose_errors_by_seed_on_average(errors_by_seed):
    port, ref = errors_by_seed["port"], errors_by_seed["jax"]
    assert np.mean(port) <= np.mean(ref) + 0.25
    def maa(errors):
        return np.mean([np.mean(AUCMetric([5, 10, 20], list(row)).compute()) for row in errors])

    assert abs(maa(port) - maa(ref)) <= 0.05


def test_eval_phase_reads_no_pixels(chains, monkeypatch):
    import gluefactory_tpu_torch.datasets.image_pairs as ip

    def refuse(*args, **kwargs):
        raise AssertionError("the eval phase read an image")

    monkeypatch.setattr(ip, "read_image", refuse)
    pipe = chains["pipeline"]
    s, _, _ = pipe.run_eval(pipe.get_eval_data(), chains["root"] / "port" / "predictions.h5")
    assert s["mnum_matches"] == chains["port"][0]["mnum_matches"]


@pytest.mark.parametrize("name", ["superpoint-open+NN", "superpoint+NN",
                                  "superpoint+lightglue-MINE"])
def test_configs_equal_the_jax_yaml(name):
    ref = yaml.safe_load((REPO / "gluefactory_tpu" / "configs" / f"{name}.yaml").read_text())
    path = REPO / "gluefactory_tpu_torch" / "configs" / f"{name}.json"
    assert json.loads(path.read_text()) == ref
    args = get_eval_parser().parse_intermixed_args(["--conf", str(path)])
    _, conf = parse_eval_args("megadepth1500", args, MegaDepth1500Pipeline.default_conf)
    assert conf["data"]["preprocessing"] == {"resize": 1600, "side": "long",
                                             "pad_to": [1600, 1600]}
    assert conf["eval"] == {"estimator": "jax_ransac", "ransac_th": 1.0}
    assert conf["model"]["extractor"]["max_num_keypoints"] == 2048


def test_registry_and_cli(tree, tmp_path, monkeypatch, capsys):
    from gluefactory_tpu_torch.eval import megadepth1500 as md

    assert get_benchmark("megadepth1500") is MegaDepth1500Pipeline
    assert MegaDepth1500Pipeline.default_conf == JPipeline.default_conf
    monkeypatch.setattr(md, "EVAL_PATH", tmp_path / "out")
    conf = tmp_path / "nn.json"
    conf.write_text((REPO / "gluefactory_tpu_torch" / "configs" / "superpoint-open+NN.json")
                    .read_text())
    root = tree / "megadepth1500"
    summaries = main(["--conf", str(conf), "--device", "cpu", "--checkpoint",
                      str(REPO / "weights" / "hermetic" / "sp_open_lg.npz"),
                      f"data.pairs=\"{root / 'pairs_calibrated.txt'}\"",
                      f"data.root=\"{root / 'images'}\"",
                      "data.preprocessing={\"resize\": 160, \"side\": \"long\", "
                      "\"pad_to\": [160, 160]}",
                      "model.extractor.max_num_keypoints=128", "model.extractor.dtype=null"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summaries
    out = tmp_path / "out" / "megadepth1500" / "nn_sp_open_lg"
    for f in ("predictions.h5", "results.h5", "summaries.json", "conf.json"):
        assert (out / f).exists(), f
    assert {"rel_pose_error_mAA", "mepi_prec@1e-3", "mransac_inl%"} <= set(summaries)
    assert all(np.isfinite(v) for v in summaries.values())
