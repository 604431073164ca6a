"""The port's relative-pose RANSAC, its estimator, the epipolar and pose
evaluation, and the `synthetic_pose` benchmark against the JAX package on
the CPU.

The RANSAC's parts are held tightly against JAX's: triangulated depths 1e-5
relative, the square roots of Sampson distances 1e-5 relative with a floor
of 1e-7 (5e-5 px at f = 500: their residual x1^T E x0 cancels terms of ~1),
Hartley conditioning 1e-6, a weighted 8-point solve on 64 points within 1e-3
of max|E| of JAX's E, up to sign (JAX's fp32 Jacobi sweeps: 3e-4 measured),
the cheirality choice for the same E the same pose and mask.

The whole estimate is not held per case. Fed JAX's draws, the core solves
each minimal sample with a float64 eigensolver where JAX runs fp32 Jacobi
sweeps, whose minimal-sample E differ from the exact solution by up to
several units on near-degenerate samples (measured: median 5e-4, p99 0.33);
the candidates' scores then differ by ~1%, and the RANSAC's outcome is not
a continuous function of its input at that level: a 1e-7 relative change of
the points moves the JAX estimator's rotation by degrees on the
benchmark's pairs (`test_reference_estimate_is_unstable_at_fp32`, ROADMAP
Queue 3a). So, on 6 cases of 256 points (20% and 50% outliers, 0.5 px
noise): `success` equal and inlier masks >= 95% equal on every case; the
larger of the R and t errors against the ground truth at most 1 degree
above JAX's on every case and 0.25 above on average; R and t within 0.05
degrees of JAX's on at least 3 of the 6 (4 measured).

The benchmark (3 test pairs at 320 x 240, 256 keypoints, the committed
depth-fine-tuned weights, RANSAC at 1 px): the matches equal to JAX's,
compared by keypoint coordinates (near-equal detection scores order a few
keypoints differently: the images differ by texture rounding, <= 2e-7), on
>= 98% of view 0's keypoints each pair and >= 99% of the three; the
epipolar precisions within 0.01; the port's eval phase on JAX's predictions
with JAX's draws: epipolar precision per pair equal, `success` per pair
equal. Its pose errors are held by their distribution over the draws of
PRNGKey(0 ... 3), JAX's core against the port's fed the same draws: per
pair, the port's mean error at most 1 degree above JAX's; over the three
pairs, 0.25 above; the mean of the four 3-pair mAAs within 0.05 of JAX's
(measured: per-pair means 75.87 / 15.96 / 19.89 against JAX's 75.99 /
18.42 / 31.39, mAA 0.125 against 0.107). Per draw the errors are not held:
JAX's own estimate on these pairs moves by more than a degree with view 0's
points scaled by 1 + 1e-7 (pinned below). The 20-pair comparison at the
benchmark's size, with that witness per pair, is
`tests/torch_relpose_parity.py` (readings in PERF.md).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_init import jitted_pipeline_init

from gluefactory_tpu.estimators.ransac import ransac_relative_pose_jit
from gluefactory_tpu.eval.synthetic_pose import SyntheticPosePipeline as JPipeline
from gluefactory_tpu.eval.utils import eval_matches_epipolar as j_eval_epi
from gluefactory_tpu.geometry.wrappers import Camera as JCamera
from gluefactory_tpu.geometry.wrappers import Pose as JPose
from gluefactory_tpu_torch.estimators import load_estimator
from gluefactory_tpu_torch.estimators import ransac as port_ransac
from gluefactory_tpu_torch.estimators.relative_pose.torch_ransac import TorchRansacRelativePose
from gluefactory_tpu_torch.eval import get_benchmark
from gluefactory_tpu_torch.eval.synthetic_pose import SyntheticPosePipeline
from gluefactory_tpu_torch.eval.utils import (
    eval_matches_epipolar,
    eval_relative_pose_robust,
    eval_relative_pose_robust_sweep,
)
from gluefactory_tpu_torch.geometry.epipolar import relative_pose_error
from gluefactory_tpu_torch.geometry.utils import (
    angle_error_mat,
    angle_error_vec,
    hartley_matrix,
    hartley_normalize,
    so3exp_map,
)
from gluefactory_tpu_torch.geometry.wrappers import Camera, Pose
from gluefactory_tpu_torch.utils.export_predictions import load_predictions
from gluefactory_tpu_torch.utils.tools import AUCMetric

REPO = Path(__file__).resolve().parent.parent
K_HYP, F_PX = 8192, 500.0  # the estimator's hypotheses; the focal length of the point cases
FEW = {"num_hypotheses": 1024}  # for the tests of the plumbing, not of parity


def _jax_noise(n, rounds=2, seed=0):
    """The Gumbel draws of JAX's ransac_relative_pose for PRNGKey(seed)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, (K_HYP, n)))))
    return out


def _deg(a, b, rot):
    a, b = torch.as_tensor(np.asarray(a)).double(), torch.as_tensor(np.asarray(b)).double()
    return float(angle_error_mat(a, b) if rot else angle_error_vec(a, b))


def _points(seed, outliers, n=256):
    """Normalised correspondences of a random scene under a random pose,
    0.5 px noise at f = 500, a share of outliers, 16 invalid at the end."""
    rng = np.random.RandomState(seed)
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, n)]
    R = so3exp_map(torch.from_numpy(rng.randn(3).astype(np.float32) * 0.1)).double().numpy()
    t = rng.randn(3) * [0.5, 0.2, 0.1]
    X1 = X @ R.T + t
    x0 = X[:, :2] / X[:, 2:] + rng.randn(n, 2) * 0.5 / F_PX
    x1 = X1[:, :2] / X1[:, 2:] + rng.randn(n, 2) * 0.5 / F_PX
    k = int(outliers * n)
    x1[:k] = rng.uniform(-0.6, 0.6, (k, 2))
    valid = np.ones(n, bool)
    valid[-16:] = False
    return x0.astype(np.float32), x1.astype(np.float32), valid, R, t


def _jax_core(p0, p1, valid, th, seed=0):
    """JAX's core as its eval phase calls it: on the host device (the eval's
    `jax.default_device`) with a float32 threshold, so that every call shares
    the eval's compiled program."""
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        return ransac_relative_pose_jit(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid),
                                        jax.random.PRNGKey(seed), th=np.float32(th),
                                        num_hypotheses=K_HYP, refine_iters=4, guided_rounds=1)


@pytest.fixture(scope="module")
def parts():
    """64 clean correspondences, weights, and the port's weighted 8-point E."""
    p0, p1, valid, R, t = _points(11, 0.0, n=64)
    w = np.random.RandomState(12).uniform(0.2, 1.0, 64).astype(np.float32)
    E = port_ransac._eight_point(torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(w))
    return p0, p1, valid, R, t, w, E


@pytest.mark.parametrize("weighted", [False, True])
def test_hartley_matches_jax(parts, weighted):
    from gluefactory_tpu.estimators import ransac as jr

    p0, w = parts[0], parts[5]
    tw = torch.from_numpy(w) if weighted else None
    pts, scale, mean = hartley_normalize(torch.from_numpy(p0), tw)
    a = (pts, hartley_matrix(scale, mean))
    b = jr._hartley_transform(jnp.asarray(p0), jnp.asarray(w) if weighted else None)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)


def test_eight_point_and_sampson_match_jax(parts):
    from gluefactory_tpu.estimators import ransac as jr

    p0, p1, _, _, _, w, E = parts
    jE = np.asarray(jr._eight_point(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(w)))
    sign = np.sign((E.numpy() * jE).sum())
    np.testing.assert_allclose(E.numpy() * sign, jE, rtol=0, atol=1e-3 * np.abs(jE).max())
    Es = torch.stack([E, E * 1.5, torch.eye(3)])
    out = port_ransac.sampson_distance(torch.from_numpy(p0), torch.from_numpy(p1), Es)
    ref = jr.sampson_distance(jnp.asarray(p0)[None], jnp.asarray(p1)[None], jnp.asarray(Es.numpy()))
    np.testing.assert_allclose(np.sqrt(out.numpy()), np.sqrt(np.asarray(ref)), rtol=1e-5,
                               atol=1e-7)


def test_triangulation_and_cheirality_match_jax(parts):
    from gluefactory_tpu.estimators import ransac as jr

    p0, p1, valid, R, t, _, E = parts
    tp0, tp1 = torch.from_numpy(p0), torch.from_numpy(p1)
    tR, tt = torch.tensor(R, dtype=torch.float32), torch.tensor(t, dtype=torch.float32)
    for x, y in zip(port_ransac._triangulate_depths(tp0, tp1, tR, tt),
                    jr._triangulate_depths(jnp.asarray(p0), jnp.asarray(p1),
                                           jnp.asarray(tR.numpy()), jnp.asarray(tt.numpy()))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    Rc, tc, good = port_ransac.decompose_and_choose(E, tp0, tp1, torch.from_numpy(valid))
    jRc, jtc, jgood = jr.decompose_and_choose(jnp.asarray(E.numpy()), jnp.asarray(p0),
                                              jnp.asarray(p1), jnp.asarray(valid))
    assert _deg(Rc, jRc, True) < 0.01 and _deg(tc, jtc, False) < 0.01
    assert np.array_equal(good.numpy(), np.asarray(jgood)) and good.sum() > 40
    assert _deg(Rc, R, True) < 0.5


def test_eigh_in_chunks_equals_one_call(monkeypatch):
    """Batched eigh runs in chunks of EIGH_BATCH matrices (cuSOLVER refuses
    a sweep's 6 x 8192 at once); chunks give the one call's result."""
    from gluefactory_tpu_torch.ops import linalg

    A = torch.randn(3, 7, 9, 9, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    A = A @ A.transpose(-1, -2)
    w, v = torch.linalg.eigh(A)
    monkeypatch.setattr(linalg, "EIGH_BATCH", 5)
    w2, v2 = linalg.eigh(A)
    assert torch.equal(w, w2) and torch.equal(v, v2)


CASES = [(outliers, seed) for outliers in (0.2, 0.5) for seed in range(3)]


@pytest.fixture(scope="module")
def core_runs():
    """JAX's core and the port's fed its draws on each case: {case: (port,
    JAX, true R, true t, valid)}."""
    th = float(np.float32(1.0) / np.float32(F_PX))
    noise = _jax_noise(256)  # PRNGKey(0)'s, the draws of every case
    cases = {case: _points(case[1], case[0]) for case in CASES}
    # JAX's cores are dispatched first and run asynchronously beside the port's
    refs = {case: _jax_core(p0, p1, valid, th) for case, (p0, p1, valid, _, _) in cases.items()}
    runs = {}
    for case, (p0, p1, valid, R, t) in cases.items():
        out = port_ransac.ransac_relative_pose_core(
            torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(valid), noise, th,
            refine_iters=4)
        runs[case] = (out, refs[case], R, t, valid)
    return runs


def _pose_err(R_est, t_est, R, t):
    return max(_deg(R_est, R, True), _deg(t_est, t, False))


@pytest.mark.parametrize("case", CASES)
def test_core_fed_jax_draws_case(core_runs, case):
    out, ref, R, t, valid = core_runs[case]
    assert bool(out.success) == bool(ref.success)
    assert not out.inliers[~torch.from_numpy(valid)].any()
    assert float(out.score) == float(out.inliers.sum())
    assert (out.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.95
    assert _pose_err(out.R, out.t, R, t) <= _pose_err(ref.R, ref.t, R, t) + 1.0


def test_core_fed_jax_draws_agrees_on_average(core_runs):
    port_err = [_pose_err(o.R, o.t, R, t) for o, _, R, t, _ in core_runs.values()]
    jax_err = [_pose_err(r.R, r.t, R, t) for _, r, R, t, _ in core_runs.values()]
    same = sum(_deg(o.R, r.R, True) < 0.05 and _deg(o.t, r.t, False) < 0.05
               for o, r, _, _, _ in core_runs.values())
    assert np.mean(port_err) <= np.mean(jax_err) + 0.25
    assert same >= 3


def test_reference_estimate_is_unstable_at_fp32(chains):
    """Pinned, not fixed (ROADMAP Queue 3a): on the benchmark's pairs at
    1 px, scaling the points of view 0 by 1 + 1e-7 moves the JAX
    estimator's pose error by more than a degree on some pair."""
    moved = []
    for i, pts in enumerate(chains["jax_matches"].values()):
        r = _jax_core(pts[0] * np.float32(1 + 1e-7), pts[1], pts[2], pts[3])
        T = chains["gt"][i]
        err = max(_deg(r.R, T.R, True), min(_deg(r.t, T.t, False), 180 - _deg(r.t, T.t, False)))
        moved.append(abs(err - chains["jax"][1]["rel_pose_error_1.0"][i]))
    assert max(moved) > 1.0, moved


THS = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]


@pytest.fixture(scope="module")
def sweep_data():
    """A pair in pixels (f = 500), its true pose, and the estimator's sweep."""
    p0, p1, _, R, t = _points(5, 0.2, n=240)
    cam = Camera(torch.tensor([640.0, 480.0, F_PX, F_PX, 320.0, 240.0]))
    px0, px1 = (cam.denormalize(torch.from_numpy(p)[None])[0].numpy() for p in (p0, p1))
    data = {"m_kpts0": px0, "m_kpts1": px1, "camera0": cam, "camera1": cam}
    return data, R, _estimator(THS)(data)


def _estimator(th):
    return TorchRansacRelativePose({"ransac_th": th, "options": FEW}, device="cpu")


def test_estimator_registry_and_defaults(monkeypatch):
    assert load_estimator("relative_pose", "jax_ransac") is TorchRansacRelativePose
    for name in ("opencv", "poselib", "pycolmap"):
        with pytest.raises(NotImplementedError, match="not portable"):
            load_estimator("relative_pose", name)
    assert TorchRansacRelativePose(device="cpu").conf.options.num_hypotheses == K_HYP
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (TorchRansacRelativePose, SyntheticPosePipeline):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.parametrize("i", [1, 4])
def test_threshold_sweep_equals_single_calls(sweep_data, i):
    data, R, sweep = sweep_data
    assert sweep["M_0to1"].R.shape == (6, 3, 3) and sweep["inliers"].shape == (6, 240)
    assert bool(sweep["success"].all())
    assert torch.allclose(sweep["M_0to1"].t.norm(dim=-1), torch.ones(6))
    one = _estimator(THS[i])(data)
    assert _deg(one["M_0to1"].R, sweep["M_0to1"].R[i], True) < 0.05
    assert (one["inliers"] == sweep["inliers"][i]).float().mean() >= 0.99
    assert _deg(one["M_0to1"].R, R, True) < 1.0
    if i == 1:  # the seed fixes the draw
        assert torch.equal(_estimator(THS[i])(data)["M_0to1"].R, one["M_0to1"].R)


def _pair_data(seed=7, n=200):
    """One pair's data and predictions in pixels (f = 500) for the eval
    functions, in the port's and the JAX package's wrappers."""
    p0, p1, valid, R, t = _points(seed, 0.1, n=n)
    cam = np.array([640.0, 480.0, F_PX, F_PX, 320.0, 240.0], np.float32)
    px0 = (p0 * F_PX + cam[4:]).astype(np.float32)
    px1 = (p1 * F_PX + cam[4:]).astype(np.float32)
    m0 = np.where(valid, np.arange(n), -1).astype(np.int32)
    pred = {"keypoints0": px0, "keypoints1": px1, "matches0": m0,
            "matching_scores0": np.ones(n, np.float32)}
    R32, t32 = R.astype(np.float32), t.astype(np.float32)
    tdata = {"view0": {"camera": Camera(torch.from_numpy(cam))},
             "view1": {"camera": Camera(torch.from_numpy(cam))},
             "T_0to1": Pose(torch.from_numpy(R32), torch.from_numpy(t32))}
    jdata = {"view0": {"camera": JCamera(jnp.asarray(cam))},
             "view1": {"camera": JCamera(jnp.asarray(cam))},
             "T_0to1": JPose(jnp.asarray(R32), jnp.asarray(t32))}
    return tdata, jdata, pred


def test_eval_functions_match_jax():
    tdata, jdata, pred = _pair_data()
    out, ref = eval_matches_epipolar(tdata, pred, "cpu"), j_eval_epi(jdata, pred)
    assert out.keys() == ref.keys()
    for k in out:
        assert out[k] == pytest.approx(ref[k], abs=1e-6), k
    assert 0.3 < out["epi_prec@1e-3"] < 1.0
    res = eval_relative_pose_robust(tdata, pred, {"ransac_th": 1.0, "options": FEW}, "cpu")
    assert res["rel_pose_error"] < 1.0 and res["ransac_inl"] > 150
    sweep = eval_relative_pose_robust_sweep(tdata, pred, {"options": FEW}, [1.0, 2.0], "cpu")
    assert len(sweep) == 2 and all(s["rel_pose_error"] < 1.0 for s in sweep)
    few = {**pred, "matches0": np.where(np.arange(200) < 7, pred["matches0"], -1)}
    assert eval_relative_pose_robust(tdata, few, {"ransac_th": 1.0}, "cpu") == {
        "rel_pose_error": float("inf"), "ransac_inl": 0, "ransac_inl%": 0.0}
    none = {**pred, "matches0": np.full(200, -1, np.int32)}
    assert eval_matches_epipolar(tdata, none, "cpu")["epi_prec@1e-4"] == 0.0


CONF = {
    "data": {"image_size": [320, 240], "test_size": 3},
    "eval": {"ransac_th": 1.0},
    "model": {
        "extractor": {"name": "superpoint_open", "max_num_keypoints": 256,
                      "detection_threshold": 0.005, "dtype": None},
        "matcher": {"name": "lightglue", "filter_threshold": 0.1, "collect_layers": False},
        "checkpoint": str(REPO / "weights" / "hermetic" / "sp_open_lg_depth.npz"),
    },
}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The JAX and the port's benchmark on the same configuration, once."""
    root = tmp_path_factory.mktemp("synthetic_pose")
    with jitted_pipeline_init():
        js, _, jr = JPipeline(CONF).run(root / "jax")
    port = SyntheticPosePipeline(CONF, device="cpu")
    ps, _, pr = port.run(root / "port")
    with h5py.File(str(root / "jax" / "predictions.h5"), "r") as f:
        jpreds = {f"synth3d/test/{i}": {k: np.asarray(v) for k, v in f[f"synth3d/test/{i}"].items()}
                  for i in range(3)}
    matches, gt = {}, []
    split = port.make_dataset(port.conf.data).get_dataset("test")
    for i, (name, p) in enumerate(jpreds.items()):
        m0 = p["matches0"]
        meta = split[i]
        cam = meta["view0"]["camera"]
        pts = [torch.from_numpy(p["keypoints0"][m0 > -1]),
               torch.from_numpy(p["keypoints1"][m0[m0 > -1]])]
        n = len(pts[0])
        pad = -(-n // 256) * 256 - n
        pts = [torch.nn.functional.pad(cam.normalize(q[None])[0], (0, 0, 0, pad)).numpy()
               for q in pts]
        th = np.float32(1.0) / np.float32(float(cam.f.mean()))
        matches[name] = (pts[0], pts[1], np.arange(n + pad) < n, th)
        gt.append(meta["T_0to1"])
    return {"root": root, "jax": (js, jr), "port": (ps, pr), "pipeline": port,
            "jax_preds": jpreds, "port_preds": load_predictions(root / "port" / "predictions.h5"),
            "jax_matches": matches, "gt": gt}


def _partners(pred):
    """{keypoint-0 coordinates: matched keypoint-1 coordinates or None}."""
    key = lambda xy: tuple(np.round(xy, 2))
    m0 = pred["matches0"]
    return {key(xy): (key(pred["keypoints1"][m]) if m > -1 else None)
            for xy, m in zip(pred["keypoints0"], m0)}


def _equal_partners(chains, name):
    a, b = _partners(chains["port_preds"][name]), _partners(chains["jax_preds"][name])
    common = set(a) & set(b)
    assert len(common) >= 0.98 * len(b)
    return [a[k] == b[k] for k in common]


PAIRS = [f"synth3d/test/{i}" for i in range(3)]


@pytest.mark.parametrize("name", PAIRS)
def test_benchmark_matches_equal_jax(chains, name):
    assert np.mean(_equal_partners(chains, name)) >= 0.98


def test_benchmark_summaries_match_jax(chains):
    js, ps = chains["jax"][0], chains["port"][0]
    assert set(ps) == set(js)
    assert np.mean(np.concatenate([_equal_partners(chains, n) for n in PAIRS])) >= 0.99
    for k in ("mepi_prec@1e-4", "mepi_prec@5e-4", "mepi_prec@1e-3"):
        assert abs(ps[k] - js[k]) <= 0.01, k
    assert abs(ps["mnum_matches"] - js["mnum_matches"]) <= 0.02 * js["mnum_matches"]
    assert all(np.isfinite(v) for v in ps.values())


@pytest.fixture(scope="module")
def eval_on_jax_predictions(chains):
    """The port's eval phase on JAX's predictions, fed JAX's draws (every
    estimator call: the uniform round, then the guided one)."""
    calls = []

    def jax_gumbel(shape, generator, device):
        noise = _jax_noise(shape[1])[len(calls) % 2]
        calls.append(shape)
        return noise.to(device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ransac, "gumbel", jax_gumbel)
        pipe = chains["pipeline"]
        _, _, results = pipe.run_eval(pipe.get_eval_data(), chains["root"] / "jax" / "predictions.h5")
    assert len(calls) == 2 * 3
    assert list(results["name"]) == PAIRS
    return results


@pytest.mark.parametrize("i", range(3))
def test_benchmark_eval_phase_on_jax_predictions(chains, eval_on_jax_predictions, i):
    results, jr = eval_on_jax_predictions, chains["jax"][1]
    for k in ("epi_prec@1e-4", "epi_prec@5e-4", "epi_prec@1e-3", "num_matches"):
        assert results[k][i] == pytest.approx(float(jr[k][i]), abs=1e-9), k
    port_err, ref_err = results["rel_pose_error_1.0"][i], jr["rel_pose_error_1.0"][i]
    assert np.isfinite(port_err) == np.isfinite(ref_err)


SEEDS = range(4)


def _rel_pose_err(r, T):
    """rel_pose_error of a core's result (inf without success), as the eval
    phase computes it."""
    if not bool(r.success):
        return float("inf")
    R, t = (torch.as_tensor(np.asarray(x)).float() for x in (r.R, r.t))
    t_err, r_err = relative_pose_error(T, R, t / t.norm().clamp(min=1e-9))
    return float(torch.maximum(t_err, r_err))


@pytest.fixture(scope="module")
def errors_by_seed(chains, eval_on_jax_predictions):
    """rel_pose_error (seed, pair) on JAX's predictions under the draws of
    PRNGKey(seed): JAX's and the port's eval phase for seed 0, their cores
    for the others."""
    errs = {"jax": [chains["jax"][1]["rel_pose_error_1.0"]],
            "port": [eval_on_jax_predictions["rel_pose_error_1.0"]]}
    cases = [(seed, m, T) for seed in SEEDS[1:]
             for m, T in zip(chains["jax_matches"].values(), chains["gt"])]
    # the draws first, then JAX's cores, which run asynchronously beside the port's
    noises = [_jax_noise(len(m[0]), seed=seed) for seed, m, _ in cases]
    jax_out = [_jax_core(*m, seed) for seed, m, _ in cases]
    port_out = [port_ransac.ransac_relative_pose_core(
        torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(valid), noise, float(th),
        refine_iters=4) for ((p0, p1, valid, th), noise) in zip((m for _, m, _ in cases), noises)]
    for k, outs in (("jax", jax_out), ("port", port_out)):
        per_case = [_rel_pose_err(r, T) for r, (_, _, T) in zip(outs, cases)]
        errs[k] += np.reshape(per_case, (len(SEEDS) - 1, -1)).tolist()
    return {k: np.array(v, np.float64) for k, v in errs.items()}


@pytest.mark.parametrize("i", range(3))
def test_benchmark_pose_errors_by_seed_per_pair(errors_by_seed, i):
    port, ref = errors_by_seed["port"][:, i], errors_by_seed["jax"][:, i]
    assert np.isfinite(port).sum() == np.isfinite(ref).sum()
    assert np.mean(port) <= np.mean(ref) + 1.0


def test_benchmark_pose_errors_by_seed_on_average(errors_by_seed):
    port, ref = errors_by_seed["port"], errors_by_seed["jax"]
    assert np.mean(port) <= np.mean(ref) + 0.25
    maa = lambda e: np.mean([np.mean(AUCMetric([5, 10, 20], list(row)).compute()) for row in e])
    assert abs(maa(port) - maa(ref)) <= 0.05


def test_benchmark_registry_and_cli(tmp_path):
    assert get_benchmark("synthetic_pose") is SyntheticPosePipeline
    env = {**os.environ, "GLUEFACTORY_TPU_TORCH_EVAL": str(tmp_path / "out"),
           "PYTHONPATH": f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, "-m", "gluefactory_tpu_torch.eval.synthetic_pose", "--device", "cpu",
           "--checkpoint", str(REPO / "weights/hermetic/sp_open_lg_depth.npz"),
           "data.image_size=[128,96]", "data.test_size=2", "eval.ransac_th=-1",
           "model.extractor.max_num_keypoints=96", "model.extractor.dtype=null"]
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    summaries = json.loads(run.stdout.strip().splitlines()[-1])
    out = tmp_path / "out" / "synthetic_pose" / "sp_open_lg_depth"
    for f in ("predictions.h5", "results.h5", "summaries.json", "conf.json"):
        assert (out / f).exists(), f
    assert {"rel_pose_error_mAA", "mepi_prec@1e-3", "mransac_inl%"} <= set(summaries)
    assert all(np.isfinite(v) for v in summaries.values())
