"""SyntheticShapes in the port against the JAX package and OpenCV 5 on the
CPU: the OpenCV operations it draws and filters with, each primitive, and
whole samples of both splits.

Bars:
  - `image_ops` against cv2 on a few hundred random cases each: the thick
    `line` (end points inside the image, as the primitives draw them:
    thickness 1-5) and the filled `rectangle` pixel for pixel;
    `resize_linear` (640 x 480 to 320 x 240 and other sizes, up and down),
    `normalize_minmax`, `get_perspective_transform` (the checkerboard's
    point sets) and `rodrigues` (single-axis vectors) bit for bit; the
    filled ellipse with the background's float angle pixel for pixel;
    `gaussian_blur` at (21, 21), sigma 0 (ksize 21 and 51) and at (0, 0),
    sigma h / 30 (129 taps) within 1e-6: the port sums in float64, OpenCV
    in float32;
  - each primitive drawn on the same image from the same RandomState as
    the JAX package's: the image equal, the keypoints equal, the generator
    left in the same state; `generate_background` within 1e-6 (its blur);
  - 6 samples of each split with the warped pair on and off (48 samples
    in all, at the default 480 x 640 rendering and 240 x 320 size):
    keypoints, keypoint maps, masks, `is_optical`, `H_aug` and `H_0to1`
    equal, images within 2e-6 (measured <= 1.2e-6: the blurs' float32 ulps
    carried through the resize, warps and photometric augmentation);
  - the registry bridge and the draw_primitives re-export.
"""

import cv2
import numpy as np
import pytest

from gluefactory_tpu.multipoint.datasets import synthetic_shapes as jss
from gluefactory_tpu_torch.datasets import get_dataset
from gluefactory_tpu_torch.datasets import image_ops as ops
from gluefactory_tpu_torch.multipoint.datasets import synthetic_shapes as tss


# ------------------------------------------------------------------- OpenCV
def _line_cases(rng):
    for _ in range(300):
        h, w = rng.randint(5, 200, 2)
        p0 = (int(rng.randint(0, w)), int(rng.randint(0, h)))
        p1 = (int(rng.randint(0, w)), int(rng.randint(0, h)))
        t = int(rng.randint(1, 6))
        ref = np.zeros((h, w), np.float32)
        cv2.line(ref, p0, p1, 1.0, t)
        yield ref, ops.line(np.zeros((h, w), np.float32), p0, p1, 1.0, t)


def _rectangle_cases(rng):
    for _ in range(300):
        h, w = rng.randint(5, 200, 2)
        p0 = (int(rng.randint(-20, w + 20)), int(rng.randint(-20, h + 20)))
        p1 = (int(rng.randint(-20, w + 20)), int(rng.randint(-20, h + 20)))
        ref = np.zeros((h, w), np.float32)
        cv2.rectangle(ref, p0, p1, 0.7, -1)
        yield ref, ops.fill_rectangle(np.zeros((h, w), np.float32), p0, p1, 0.7)


def _ellipse_cases(rng):
    for _ in range(300):
        h, w = rng.randint(20, 300, 2)
        c = (rng.randint(0, w), rng.randint(0, h))
        ax = rng.randint(max(h // 20, 1), max(h // 4, 2))
        axes, angle = (ax, int(ax * rng.uniform(0.3, 1.0))), rng.uniform(0, 360)
        ref = np.zeros((h, w), np.float32)
        cv2.ellipse(ref, c, axes, angle, 0, 360, 0.6, -1)
        yield ref, ops.fill_ellipse(np.zeros((h, w), np.float32), c, axes, angle, 0.6)


def _resize_cases(rng):
    for dsize in [(320, 240), (321, 241), (160, 120), (300, 200), (700, 500), (64, 48)]:
        for _ in range(10):
            img = rng.rand(480, 640).astype(np.float32)
            yield cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR), \
                ops.resize_linear(img, dsize)


def _normalize_cases(rng):
    for _ in range(200):
        img = (rng.rand(50, 60) * rng.uniform(0.1, 3) + rng.uniform(-1, 1)).astype(np.float32)
        yield cv2.normalize(img, None, 0.15, 0.85, cv2.NORM_MINMAX), \
            ops.normalize_minmax(img, 0.15, 0.85)


def _perspective_cases(rng):
    w, h = 640, 480
    for _ in range(300):
        xs = np.linspace(rng.randint(w // 8), w - 1 - rng.randint(w // 8), 5)
        ys = np.linspace(rng.randint(h // 8), h - 1 - rng.randint(h // 8), 4)
        src = np.array([[xs[0], ys[0]], [xs[-1], ys[0]], [xs[-1], ys[-1]], [xs[0], ys[-1]]],
                       np.float32)
        dst = (src + rng.uniform(-0.05, 0.05, (4, 2)) * [w, h]).astype(np.float32)
        yield cv2.getPerspectiveTransform(src, dst), ops.get_perspective_transform(src, dst)


def _rodrigues_cases(rng):
    for _ in range(300):
        v = np.zeros(3)
        v[rng.randint(3)] = rng.uniform(0, np.pi / 3)
        yield cv2.Rodrigues(v)[0], ops.rodrigues(v)


CASES = {"line": _line_cases, "rectangle": _rectangle_cases, "ellipse": _ellipse_cases,
         "resize_linear": _resize_cases, "normalize": _normalize_cases,
         "perspective": _perspective_cases, "rodrigues": _rodrigues_cases}


@pytest.mark.parametrize("op", list(CASES))
def test_image_op_equals_cv2(op):
    n = 0
    for ref, out in CASES[op](np.random.RandomState(0)):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref, err_msg=f"{op} case {n}")
        n += 1
    assert n >= 60


@pytest.mark.parametrize("ksize,sigma", [((21, 21), 0), ((51, 51), 0), ((0, 0), 480 / 30)])
def test_gaussian_blur_within_float32_rounding(ksize, sigma):
    img = np.random.RandomState(1).rand(480, 640).astype(np.float32)
    ref = cv2.GaussianBlur(img, ksize, sigma)
    out = ops.gaussian_blur(img, ksize, sigma)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


# --------------------------------------------------------------- primitives
@pytest.mark.parametrize("name", list(jss.PRIMITIVES))
def test_primitive_matches_jax(name):
    for seed in range(4):
        base = np.random.RandomState(100 + seed).uniform(0.2, 0.8, (240, 320)).astype(np.float32)
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        img_j, img_t = base.copy(), base.copy()
        kj = jss.PRIMITIVES[name](rj, img_j, 0.1)
        kt = tss.PRIMITIVES[name](rt, img_t, 0.1)
        np.testing.assert_array_equal(img_t, img_j, err_msg=f"{name} {seed}")
        np.testing.assert_array_equal(kt, kj, err_msg=f"{name} {seed}")
        assert rt.randint(1 << 30) == rj.randint(1 << 30)
        if name != "gaussian_noise":
            assert not np.array_equal(img_t, base)


def test_background_matches_jax():
    for seed in range(3):
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        ref = jss.generate_background(rj, (240, 320))
        out = tss.generate_background(rt, (240, 320))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        assert rt.randint(1 << 30) == rj.randint(1 << 30)


# ------------------------------------------------------------------ samples
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("warped_pair", [True, False])
def test_samples_match_jax(split, warped_pair):
    conf = {"warped_pair": warped_pair, "additional_ir_blur": True}
    ref = jss.SyntheticShapes(conf).get_dataset(split)
    out = get_dataset("synthetic_shapes")(conf).get_dataset(split)
    assert len(out) == len(ref) == (1000 if split == "train" else 64)
    for idx in range(6):
        a, b = ref[idx], out[idx]
        assert set(a) == set(b) and a["name"] == b["name"]
        for k, v in a.items():
            if k.startswith("image"):
                assert b[k].dtype == np.float32 and b[k].shape == (240, 320, 1)
                np.testing.assert_allclose(b[k], v, rtol=0, atol=2e-6, err_msg=f"{idx} {k}")
            elif isinstance(v, np.ndarray):
                assert b[k].dtype == v.dtype, k
                np.testing.assert_array_equal(b[k], v, err_msg=f"{idx} {k}")
        assert a["keypoint_mask"].any() or not a["keypoint_map"].any()


def test_bridge_and_reexport():
    from gluefactory_tpu_torch.multipoint.utils import draw_primitives

    assert get_dataset("synthetic_shapes") is tss.SyntheticShapes
    assert draw_primitives.PRIMITIVES is tss.PRIMITIVES
    assert tss.SyntheticShapes.default_conf == jss.SyntheticShapes.default_conf
    loader = get_dataset("synthetic_shapes")({
        "warped_pair": True, "length": 4, "train_batch_size": 2, "image_size": [48, 64],
        "generation_size": [96, 128]}).get_data_loader("train")
    batch = next(iter(loader))
    assert batch["image"].shape == batch["image2"].shape == (2, 48, 64, 1)
    assert batch["H_0to1"].shape == (2, 3, 3) and batch["keypoint_map2"].shape == (2, 48, 64)
