"""The evaluation slice's building blocks of the port against the JAX package
on the CPU, on inputs made from numpy seeds: the weighted DLT and the
homography errors, the eigensolver, the AUC summaries, the nearest-neighbour
matcher, the image reader and preprocessor, and the HPatches scan.

Bars: DLT H within 1e-4 relative (fp32 eigensolvers of two kinds: cuSOLVER /
LAPACK `eigh` here, 10 Jacobi sweeps there; the minimal samples are spread
over the image, since on a near-collinear random sample both fp32 solves
are off the true H by up to pixels, each differently); errors within 1e-5
relative plus 1e-4 px (a 640-px coordinate carries 6.1e-5 px of fp32
rounding, and each side rounds its own inverse and warp); eigenvectors within 1e-5 up to sign; AUCs,
pose summaries, matches and images at scale 1 exact. Area resampling against
OpenCV's INTER_AREA (these cases skip without cv2): mean abs difference
below 1e-7 and max below 1e-6 on [0, 1] images, shrinking and enlarging
(float32 summation order; measured 1-2e-8 mean, 1.8e-7 max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry import homography as jh
from gluefactory_tpu.models.matchers import nearest_neighbor_matcher as jnn
from gluefactory_tpu.ops.linalg import jacobi_eigh
from gluefactory_tpu.utils import tools as jtools
from gluefactory_tpu_torch.datasets.utils import ImagePreprocessor, read_image, resize_image
from gluefactory_tpu_torch.eval.utils import eval_poses
from gluefactory_tpu_torch.geometry import homography as th
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.ops.linalg import smallest_eigenvector
from gluefactory_tpu_torch.utils.tools import cal_error_auc

H_TRUE = np.array([[0.95, 0.05, 12.0], [-0.04, 0.98, -7.0], [1e-4, -5e-5, 1.0]])


def _correspondences(seed, b, n, noise=0.3):
    """b sets of n points in a 640 x 480 image and their images under H_TRUE
    (+ Gaussian noise), with weights; 4 points are a minimal sample, one
    near each image corner."""
    rng = np.random.RandomState(seed)
    if n == 4:
        corners = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
        p0 = (0.1 + 0.8 * corners + rng.uniform(-0.1, 0.1, (b, 4, 2))) * [640, 480]
    else:
        p0 = rng.uniform(0, [640, 480], (b, n, 2))
    h = np.concatenate([p0, np.ones((b, n, 1))], -1) @ H_TRUE.T
    p1 = h[..., :2] / h[..., 2:] + rng.randn(b, n, 2) * noise
    w = rng.uniform(0.05, 1.0, (b, n))
    return p0.astype(np.float32), p1.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("n", [4, 200])
@pytest.mark.parametrize("weighted", [False, True])
def test_dlt_matches_jax(n, weighted):
    p0, p1, w = _correspondences(n, 6, n, noise=0.0 if n == 4 else 0.3)
    w = w if weighted else None
    ref = np.asarray(jh.solve_homography_dlt(
        jnp.asarray(p0), jnp.asarray(p1), None if w is None else jnp.asarray(w)))
    out = th.solve_homography_dlt(
        torch.from_numpy(p0), torch.from_numpy(p1), None if w is None else torch.from_numpy(w))
    assert out.shape == (6, 3, 3)
    rel = np.abs(out.numpy() - ref).max(axis=(-1, -2)) / np.abs(ref).max(axis=(-1, -2))
    assert rel.max() < 1e-4, rel
    if n == 4:  # a noise-free minimal sample: the homography it was made with
        corners = np.array([[0.0, 0], [640, 0], [640, 480], [0, 480]])
        for H in out.numpy():
            err = th.warp_points_np(corners, H) - th.warp_points_np(corners, H_TRUE)
            assert np.abs(err).max() < 0.05


def test_dlt_keeps_leading_dims():
    p0, p1, w = _correspondences(7, 6, 50)
    r = lambda a: torch.from_numpy(a.reshape((2, 3) + a.shape[1:]))
    out = th.solve_homography_dlt(r(p0), r(p1), r(w))
    flat = th.solve_homography_dlt(torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(w))
    assert out.shape == (2, 3, 3, 3)
    torch.testing.assert_close(out.reshape(6, 3, 3), flat, rtol=1e-5, atol=1e-6)


def test_homography_errors_match_jax():
    rng = np.random.RandomState(3)
    p0, p1, _ = _correspondences(3, 2, 40, noise=2.0)
    H = np.stack([H_TRUE, H_TRUE @ np.diag([1.01, 0.99, 1.0])]).astype(np.float32)
    size = np.array([[640.0, 480.0], [700.0, 420.0]], np.float32)
    H_gt = (H + rng.randn(2, 3, 3) * [[1e-3, 1e-3, 0.5], [1e-3, 1e-3, 0.5], [1e-6, 1e-6, 0]]
            ).astype(np.float32)
    J, T = (lambda *a: [jnp.asarray(x) for x in a]), (lambda *a: [torch.from_numpy(x) for x in a])
    for name in ("sym_homography_error", "sym_homography_error_all"):
        ref = np.asarray(getattr(jh, name)(*J(p0, p1, H)))
        out = getattr(th, name)(*T(p0, p1, H)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
    ref = np.asarray(jh.homography_corner_error(*J(H, H_gt, size)))
    out = th.homography_corner_error(*T(H, H_gt, size)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(th.warp_points_np(p0[0], H_TRUE, inverse=True),
                               jh.warp_points_np(p0[0], H_TRUE, inverse=True))


def test_smallest_eigenvector_matches_jacobi():
    rng = np.random.RandomState(0)
    # well-conditioned: eigenvalues spread over [0.1, 10], a clear smallest one
    Q = np.linalg.qr(rng.randn(64, 9, 9))[0]
    ev = np.sort(rng.uniform(1.0, 10.0, (64, 9)), axis=-1)
    ev[:, 0] = 0.1
    A = (Q * ev[:, None, :]) @ np.swapaxes(Q, -1, -2)
    A = ((A + np.swapaxes(A, -1, -2)) / 2).astype(np.float32)
    _, V = jacobi_eigh(jnp.asarray(A))
    ref = np.asarray(V)[..., :, 0]
    out = smallest_eigenvector(torch.from_numpy(A)).numpy()
    sign = np.sign((out * ref).sum(-1, keepdims=True))
    np.testing.assert_allclose(out * sign, ref, atol=1e-5)


def test_cal_error_auc_and_eval_poses_exact():
    rng = np.random.RandomState(1)
    errs = np.concatenate([rng.exponential(2.0, 40), [np.inf, 0.0, 1.0, 3.0]])
    for ths in ([1, 3, 5], [0.5, 10]):
        assert cal_error_auc(errs, ths) == jtools.cal_error_auc(errs, ths)
    assert np.isnan(cal_error_auc([], [1])[0])
    from gluefactory_tpu.eval.utils import eval_poses as jeval_poses

    sweep = {th_: {"H_error_ransac": list(rng.exponential(th_, 20)),
                   "ransac_inl": list(rng.randint(0, 100, 20))} for th_ in (0.5, 1.0, 3.0)}
    assert eval_poses(sweep, [1, 3, 5], "H_error_ransac", "px") == \
        jeval_poses(sweep, [1, 3, 5], "H_error_ransac", "px")


@pytest.mark.parametrize("masked", [False, True])
def test_nn_matcher_exact(masked):
    rng = np.random.RandomState(2)
    b, m, n, d = 2, 60, 50, 32
    d0 = rng.randn(b, m, d).astype(np.float32)
    d1 = np.concatenate([d0[:, :n] + 0.3 * rng.randn(b, n, d), ], 1).astype(np.float32)
    d1[:, n // 2:] = rng.randn(b, n - n // 2, d)  # half of view 1 unrelated
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    data = {"descriptors0": d0, "descriptors1": d1}
    if masked:
        data["keypoint_mask0"] = rng.rand(b, m) > 0.2
        data["keypoint_mask1"] = rng.rand(b, n) > 0.2
    for conf in ({"mutual_check": True}, {"mutual_check": False, "ratio_thresh": 0.9},
                 {"distance_thresh": 0.8}):
        ref = jnn.NearestNeighborMatcher.from_conf(conf)
        ref = jax.tree.map(np.asarray, ref({k: jnp.asarray(v) for k, v in data.items()}))
        model = get_model("nearest_neighbor_matcher")(conf, device="cpu")
        out = model({k: torch.from_numpy(v) for k, v in data.items()})
        for k in ("matches0", "matches1"):
            np.testing.assert_array_equal(out[k].numpy(), ref[k])
        np.testing.assert_allclose(out["matching_scores0"].numpy(), ref["matching_scores0"],
                                   atol=1e-6)
        assert (out["matches0"] >= 0).sum() > 10


def _write_color_ppm(path, rng, h, w):
    import cv2

    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    cv2.imwrite(str(path), img)
    return img


def test_read_image_and_preprocessor_exact_at_scale_1(tmp_path):
    pytest.importorskip("cv2")
    from gluefactory_tpu.datasets import utils as jdu

    rng = np.random.RandomState(4)
    _write_color_ppm(tmp_path / "a.ppm", rng, 48, 64)
    for gray in (True, False):
        np.testing.assert_array_equal(read_image(tmp_path / "a.ppm", gray),
                                      jdu.read_image(tmp_path / "a.ppm", gray))
    img = read_image(tmp_path / "a.ppm", True)
    conf = {"resize": 48, "side": "short", "pad_to": [80, 48]}
    out, ref = ImagePreprocessor(conf)(img), jdu.ImagePreprocessor(conf)(img)
    assert set(out) == set(ref)
    for k in out:
        np.testing.assert_array_equal(out[k], ref[k])
    out = ImagePreprocessor({"grayscale": True})(read_image(tmp_path / "a.ppm"))
    ref = jdu.ImagePreprocessor({"grayscale": True})(jdu.read_image(tmp_path / "a.ppm"))
    np.testing.assert_allclose(out["image"], ref["image"], atol=1e-6)
    assert read_image(tmp_path / "missing.ppm") is None
    (tmp_path / "x.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(16))  # truncated
    with pytest.raises(ValueError, match="PNG"):
        read_image(tmp_path / "x.png")


@pytest.mark.parametrize("shape,size", [((420, 700), 480), ((600, 800), 480), ((97, 131), 40)])
def test_area_resize_against_cv2(shape, size):
    cv2 = pytest.importorskip("cv2")
    from gluefactory_tpu.datasets import utils as jdu

    img = np.random.RandomState(5).rand(*shape, 1).astype(np.float32)
    out, scales = resize_image(img, size, fn="min")
    ref, ref_scales = jdu.resize_image(img, size, fn="min")
    assert out.shape == ref.shape
    np.testing.assert_array_equal(scales, ref_scales)
    diff = np.abs(out - ref)
    assert diff.mean() < 1e-7 and diff.max() < 1e-6, (diff.mean(), diff.max())
    h, w = out.shape[:2]
    direct = cv2.resize(img[..., 0], (w, h), interpolation=cv2.INTER_AREA)
    assert np.abs(out[..., 0] - direct).max() < 1e-6


def test_hpatches_scan_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    import gluefactory_tpu.datasets.hpatches as jhp
    from gluefactory_tpu_torch.datasets.hpatches import HPatchesDataset

    rng = np.random.RandomState(6)
    root = tmp_path / "hpatches-sequences-release"
    for scene in ("v_b", "i_a", "i_dc", "v_c"):  # i_dc is an ignored scene
        (root / scene).mkdir(parents=True)
        for i in range(1, 7):
            _write_color_ppm(root / scene / f"{i}.ppm", rng, 24, 32)
            np.savetxt(root / scene / f"H_1_{i}", np.eye(3) * (1 + 0.01 * i))
    conf = {"preprocessing": {"resize": 30, "side": "short", "pad_to": [48, 32]}}
    old = jhp.DATA_PATH
    jhp.DATA_PATH = tmp_path
    try:
        for subset in (None, "v"):
            jds = jhp.HPatchesDataset({**conf, "subset": subset})
            tds = HPatchesDataset({**conf, "subset": subset, "data_dir": str(root)})
            assert tds.items == jds.items
            jsplit, tsplit = jds.get_dataset("test"), tds.get_dataset("test")
            for i in (0, len(tds.items) - 1):
                a, b = tsplit[i], jsplit[i]
                assert (a["name"], a["scene"], a["idx"]) == (b["name"], b["scene"], b["idx"])
                np.testing.assert_allclose(a["H_0to1"], b["H_0to1"], rtol=1e-6)
                for v in ("view0", "view1"):
                    np.testing.assert_array_equal(a[v]["image_size"], b[v]["image_size"])
                    np.testing.assert_allclose(a[v]["image"], b[v]["image"], atol=1e-6)
            batch = next(iter(tds.get_data_loader("test")))
            assert batch["view0"]["image"].shape == (1, 32, 48, 1)
            assert batch["name"] == [tds.items[0][0] + "/2"]
    finally:
        jhp.DATA_PATH = old
    assert "i_dc" not in {s for s, _ in tds.items}


@pytest.mark.parametrize("pre", [{"resize": 30, "side": "short", "pad_to": [48, 32]},
                                 {"resize": 20, "side": "long"}, {"resize": None}])
def test_hpatches_metadata_is_the_item_without_images(tmp_path, pre):
    """The eval phase's ground truth, read from the image headers, equals the
    loaded items' (views of other sizes than image 1, enlarged and shrunk,
    a header comment)."""
    from gluefactory_tpu_torch.datasets.hpatches import HPatchesDataset

    rng = np.random.RandomState(7)
    root = tmp_path / "hpatches-sequences-release"
    for scene, (h, w) in (("i_a", (24, 32)), ("v_b", (21, 35))):
        (root / scene).mkdir(parents=True)
        for i in range(1, 7):
            hi, wi = (h, w) if i == 1 else (h + i, w - i)
            px = rng.randint(0, 256, (hi, wi, 3), dtype=np.uint8)
            header = b"P6\n# comment\n%d %d\n255\n" % (wi, hi)
            (root / scene / f"{i}.ppm").write_bytes(header + px.tobytes())
            np.savetxt(root / scene / f"H_1_{i}", np.eye(3) + 0.01 * rng.randn(3, 3))
    split = HPatchesDataset({"data_dir": str(root), "preprocessing": pre}).get_dataset("test")
    for idx in range(len(split)):
        item, meta = split[idx], split.metadata(idx)
        assert [meta[k] for k in ("name", "scene", "idx")] == [item[k] for k in
                                                            ("name", "scene", "idx")]
        np.testing.assert_array_equal(meta["H_0to1"], item["H_0to1"])
        for v in ("view0", "view1"):
            assert set(meta[v]) == {"image_size", "scales"}
            for k in ("image_size", "scales"):
                np.testing.assert_array_equal(meta[v][k], item[v][k])


def test_pnm_header_long_comment_and_truncation(tmp_path):
    from gluefactory_tpu_torch.datasets.utils import read_image_size

    long = tmp_path / "long.pgm"  # a header past the first 4 KiB
    long.write_bytes(b"P5\n#" + b"x" * 5000 + b"\n3 2\n255\n" + bytes(range(6)))
    assert read_image_size(long) == (2, 3)
    np.testing.assert_array_equal(read_image(long)[..., 0] * 255,
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    for cut in (b"P6\n64 4", b"P6\n64 48\n255", b"P5\n# no end"):
        (tmp_path / "cut.ppm").write_bytes(cut)
        for fn in (read_image_size, read_image):
            with pytest.raises(ValueError):
                fn(tmp_path / "cut.ppm")


def test_hpatches_cli_end_to_end(tmp_path):
    """`python -m gluefactory_tpu_torch.eval.hpatches` on the CPU: a JSON
    configuration, dotlist overrides, the threshold sweep; it writes the
    three outputs and prints the summaries. One 120 x 160 scene of integer
    shifts (the committed weights match such small images poorly: the
    floors check the plumbing)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    rng = np.random.RandomState(8)
    root = tmp_path / "data" / "hpatches-sequences-release" / "v_cli"
    root.mkdir(parents=True)
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(rng.rand(120, 160), 4.0, mode="wrap")
    base = (base - base.min()) / (base.max() - base.min()) * 0.6 + 0.2
    for _ in range(40):  # corners for the detector
        x, y, w, h = rng.randint(0, 150), rng.randint(0, 110), rng.randint(4, 14), rng.randint(4, 14)
        base[y:y + h, x:x + w] = rng.rand()
    base = gaussian_filter(base, 0.8, mode="wrap")
    for i in range(1, 7):
        shift = 0 if i == 1 else i
        img = np.roll(base, (shift, 2 * shift), axis=(0, 1))
        (root / f"{i}.ppm").write_bytes(b"P5\n160 120\n255\n" + (img * 255).astype(np.uint8).tobytes())
        np.savetxt(root / f"H_1_{i}", np.array([[1, 0, 2 * shift], [0, 1, shift], [0, 0, 1]]))
    conf = {"benchmarks": {"hpatches": {
        "data": {"preprocessing": {"resize": 120, "pad_to": [160, 120]}},
        "eval": {"ransac_th": -1}}}}
    (tmp_path / "c.json").write_text(json.dumps(conf))
    env = {**os.environ, "GLUEFACTORY_TPU_TORCH_DATA": str(tmp_path / "data"),
           "GLUEFACTORY_TPU_TORCH_EVAL": str(tmp_path / "out"),
           "PYTHONPATH": f"{repo}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
           "OMP_NUM_THREADS": "2"}  # a small job: no thread pool over every core
    cmd = [sys.executable, "-m", "gluefactory_tpu_torch.eval.hpatches", "--device", "cpu",
           "--conf", str(tmp_path / "c.json"), "--checkpoint", str(repo / "weights/hermetic/sp_open_lg.npz"),
           "model.extractor.max_num_keypoints=128",
           "model.extractor.dtype=null", "data.preprocessing.side=short"]
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    summaries = json.loads(run.stdout.strip().splitlines()[-1])
    out = tmp_path / "out" / "hpatches" / "c_sp_open_lg"
    for f in ("predictions.h5", "results.h5", "summaries.json", "conf.json"):
        assert (out / f).exists(), f
    assert json.loads((out / "summaries.json").read_text()) == summaries
    saved = json.loads((out / "conf.json").read_text())
    assert saved["eval"]["ransac_th"] == -1 and saved["model"]["extractor"]["dtype"] is None
    assert all(np.isfinite(v) for v in summaries.values())
    assert summaries["mnum_matches"] > 30 and summaries["mprec@3px"] > 0.3, summaries
