"""The port's homography training data against the JAX package on the CPU.

Tolerances (measured, then fixed): the rasterisers (`fillPoly`, the filled
ellipse) equal OpenCV pixel for pixel; the filters, the cubic resize, the
textures, the augmentations and whole dataset items within 1e-6 absolute
(their largest differences were 2e-7 to 8e-7: float64 sums against
OpenCV's float32 ones); the warp equals the JAX package's native warp
exactly and homographies within 1e-6 relative (both are the same numpy
and float64 code). Every random draw comes in the JAX order: the
`RandomState` ends in the same state.
"""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest

from gluefactory_tpu.datasets import augmentations as jaug
from gluefactory_tpu.datasets.homographies import HomographyDataset as JaxDataset
from gluefactory_tpu.datasets.homographies import generate_texture_image as jax_texture
from gluefactory_tpu.geometry.homography import sample_homography_corners as jax_sample
from gluefactory_tpu.native import warp_perspective as jax_warp
from gluefactory_tpu.utils.config import load_yaml
from gluefactory_tpu_torch.datasets import augmentations as taug
from gluefactory_tpu_torch.datasets import get_dataset, image_ops
from gluefactory_tpu_torch.datasets.homographies import HomographyDataset, generate_texture_image
from gluefactory_tpu_torch.geometry.homography import sample_homography_corners
from gluefactory_tpu_torch.utils.config import load_conf

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-6
CONF = {"synthetic": {"do": True, "pool": 12, "size": [320, 240]}, "train_size": 8,
        "val_size": 4, "train_batch_size": 4, "val_batch_size": 2,
        "homography": {"patch_shape": [160, 120], "difficulty": 0.5}}


def same_state(a: np.random.RandomState, b: np.random.RandomState) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))


def test_sampler_matches_jax():
    kw = dict(difficulty=0.7, max_angle=45, translation=1.0, n_angles=10, min_convexity=0.05)
    for seed in range(20):
        r0, r1 = np.random.RandomState(seed), np.random.RandomState(seed)
        ref = jax_sample((960, 720), (640, 480), rng=r0, **kw)
        out = sample_homography_corners((960, 720), (640, 480), rng=r1, **kw)
        for a, b in zip(out[:3], ref[:3]):
            np.testing.assert_array_equal(a, b)
        assert same_state(r0, r1)


def test_warp_matches_native_including_edges():
    rng = np.random.RandomState(0)
    src = rng.rand(72, 96, 1).astype(np.float32)
    hs = [np.eye(3), np.array([[1, 0, -0.5], [0, 1, -0.5], [0, 0, 1.0]]),  # half-pixel shift
          np.array([[1.3, 0.1, -20], [0.05, 0.9, 6], [1e-3, 2e-3, 1.0]]),  # leaves the image
          np.array([[1, 0, 95.5], [0, 1, 0], [0, 0, 1.0]])]  # one column of border pixels
    hs += [jax_sample((96, 72), (64, 48), difficulty=0.7, max_angle=45, translation=1.0,
                      rng=rng)[0] for _ in range(4)]
    for H in hs:
        ref = jax_warp(src, H, (64, 48))
        np.testing.assert_array_equal(image_ops.warp_perspective(src, H, (64, 48)), ref)


def _polygons(rng, n, h, w, margin):
    for _ in range(n):
        k = rng.randint(3, 7)
        cx, cy = rng.randint(-margin, w + margin), rng.randint(-margin, h + margin)
        rad = rng.randint(3, 30) * (0.4 + 0.6 * rng.rand(k))
        ang = rng.rand(k) * 2 * np.pi
        yield np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1).astype(np.int32)


def test_rasterisers_equal_opencv():
    rng = np.random.RandomState(0)
    h, w = 40, 50
    for pts in _polygons(rng, 300, h, w, margin=10):  # many leave the image
        ref = cv2.fillPoly(np.zeros((h, w), np.float32), [pts], 1.0)
        np.testing.assert_array_equal(image_ops.fill_poly(np.zeros((h, w), np.float32), [pts],
                                                          1.0), ref, err_msg=str(pts.tolist()))
    h, w = 120, 160
    for _ in range(100):
        ax, ay = int(max(rng.rand() * 40, 8)), int(max(rng.rand() * 40, 8))
        x, y = rng.randint(ax, w - ax), rng.randint(ay, h - ay)
        angle = rng.rand() * 90
        ref = cv2.ellipse(np.zeros((h, w), np.float32), (x, y), (ax, ay), angle, 0, 360, 1.0, -1)
        out = image_ops.fill_ellipse(np.zeros((h, w), np.float32), (x, y), (ax, ay), angle, 1.0)
        np.testing.assert_array_equal(out, ref, err_msg=str((x, y, ax, ay, angle)))


@pytest.mark.parametrize("op", ["blur3", "blur5", "blur_sigma1", "blur_sigma12", "motion",
                                "resize_cubic"])
def test_filters_match_opencv(op):
    img = np.random.RandomState(1).rand(120, 160).astype(np.float32)
    if op.startswith("blur") and op[4:].isdigit():
        k = int(op[4:])
        out, ref = image_ops.gaussian_blur(img, (k, k), 0), cv2.GaussianBlur(img, (k, k), 0)
    elif op.startswith("blur_sigma"):
        s = float(op[len("blur_sigma"):])
        out, ref = image_ops.gaussian_blur(img, (0, 0), s), cv2.GaussianBlur(img, (0, 0), s)
    elif op == "motion":
        kernel = np.zeros((7, 7), np.float32)
        kernel[3, :] = 1
        kernel[0, 6] = 1
        kernel /= kernel.sum()
        out, ref = image_ops.filter2d(img, kernel), cv2.filter2D(img, -1, kernel)
    else:
        small = img[:30, :40].copy()
        out = image_ops.resize_cubic(small, (160, 120))
        ref = cv2.resize(small, (160, 120), interpolation=cv2.INTER_CUBIC)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["lg", "dark", "identity"])
def test_augmentations_match_jax(name):
    img = np.ascontiguousarray(generate_texture_image(np.random.RandomState(5), (160, 120)))
    for seed in range(10):
        r0, r1 = np.random.RandomState(seed), np.random.RandomState(seed)
        ref = jaug.augmentations[name]()(img.copy(), r0)
        out = taug.augmentations[name]()(img.copy(), r1)
        assert out.shape == ref.shape and out.dtype == ref.dtype
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0, err_msg=f"seed {seed}")
        assert same_state(r0, r1), f"seed {seed}: draws differ"


def test_texture_matches_jax():
    for seed in range(3):
        out = generate_texture_image(np.random.RandomState(seed), (320, 240))
        ref = jax_texture(np.random.RandomState(seed), (320, 240))
        assert out.shape == ref.shape == (240, 320, 1) and out.dtype == ref.dtype
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def _assert_items_equal(out, ref, where):
    assert out.keys() == ref.keys(), where
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_items_equal(out[k], ref[k], f"{where}/{k}")
        elif isinstance(ref[k], np.ndarray):
            assert out[k].shape == ref[k].shape and out[k].dtype == ref[k].dtype, f"{where}/{k}"
            if k == "H_0to1":
                np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, err_msg=where)
            else:
                np.testing.assert_allclose(out[k], ref[k], atol=ATOL, rtol=0, err_msg=where)
        else:
            assert out[k] == ref[k], f"{where}/{k}"


@pytest.mark.parametrize("photometric", ["lg", "dark"])
def test_items_match_jax(photometric):
    conf = {**CONF, "photometric": {"name": photometric, "p": 1.0}}
    jds, tds = JaxDataset(conf), HomographyDataset(conf)
    assert tds.splits == jds.splits
    for split in ("train", "val"):
        for epoch in (0, 1):
            ref, out = jds.get_dataset(split), tds.get_dataset(split)
            ref.set_epoch(epoch)
            out.set_epoch(epoch)
            for i in range(len(ref)):
                _assert_items_equal(out[i], ref[i], f"{split} epoch {epoch} item {i}")


def test_shuffled_batches_follow_jax():
    conf = {**CONF, "homography": {"patch_shape": [64, 48], "difficulty": 0.5}}
    jds, tds = JaxDataset(conf), get_dataset("homographies")(conf)
    for epoch in (0, 1):
        ref = [b["idx"].tolist() for b in jds.get_data_loader("train", epoch=epoch, shuffle=True)]
        out = [b["idx"].tolist() for b in tds.get_data_loader("train", epoch=epoch, shuffle=True)]
        assert out == ref and len(out) == 2
        assert sorted(sum(out, [])) == list(range(8))
    # the thread pool gives the same batches
    pooled = get_dataset("homographies")({**conf, "num_workers": 2})
    a = next(iter(pooled.get_data_loader("train", epoch=1)))
    b = next(iter(tds.get_data_loader("train", epoch=1)))
    np.testing.assert_array_equal(a["view1"]["image"], b["view1"]["image"])


def test_overfit_loader_fault_of_the_reference_is_not_copied():
    """The JAX package's `get_overfit_loader` reads an undefined `epoch`
    (gluefactory_tpu/datasets/base_dataset.py:169-176) and raises NameError
    on the homography dataset; the port's repeats the epoch-0 batch."""
    with pytest.raises(NameError):
        JaxDataset(CONF).get_overfit_loader("train")
    tds = HomographyDataset(CONF)
    batches = list(tds.get_overfit_loader("train", length=3))
    first = next(iter(tds.get_data_loader("train", epoch=0, shuffle=False)))
    assert len(batches) == 3
    for b in batches:
        np.testing.assert_array_equal(b["idx"], first["idx"])
        np.testing.assert_array_equal(b["view1"]["image"], first["view1"]["image"])


def test_options_not_ported_raise():
    """`features.do` is ported with `sift_tpu` (tests/test_torch_sift.py);
    its default extractor, the host OpenCV SIFT, is not portable."""
    with pytest.raises(NotImplementedError, match="not portable"):
        HomographyDataset({**CONF, "features": {"do": True}})


def test_json_config_equals_the_jax_yaml():
    name = "superpoint-open+lightglue_homography"
    ref = load_yaml(ROOT / "gluefactory_tpu" / "configs" / f"{name}.yaml")
    assert load_conf(name) == ref
    path = ROOT / "gluefactory_tpu_torch" / "configs" / f"{name}.json"
    assert json.loads(path.read_text()) == ref


def test_image_folder_items_match_jax(tmp_path, monkeypatch):
    """A folder of PPM images (OpenCV's float grey conversion); other formats
    raise, naming the format."""
    import gluefactory_tpu.datasets.homographies as jhom

    import gluefactory_tpu_torch.datasets.homographies as thom

    image_dir = tmp_path / "images" / "ppm"
    image_dir.mkdir(parents=True)
    rng = np.random.RandomState(2)
    for i in range(4):
        rgb = (rng.rand(90, 120, 3) * 255).astype(np.uint8)
        (image_dir / f"{i}.ppm").write_bytes(b"P6\n120 90\n255\n" + rgb.tobytes())
    for mod in (jhom, thom):
        monkeypatch.setattr(mod, "DATA_PATH", tmp_path)
    conf = {"data_dir": "images", "image_dir": "ppm", "glob": ["*.ppm"], "train_size": 2,
            "val_size": 2, "homography": {"patch_shape": [64, 48], "difficulty": 0.5},
            "photometric": {"name": "lg", "p": 1.0}}
    jds, tds = JaxDataset(conf), HomographyDataset(conf)
    for split in ("train", "val"):
        for i in range(2):
            _assert_items_equal(tds.get_dataset(split)[i], jds.get_dataset(split)[i],
                                f"{split} {i}")
    cv2.imwrite(str(image_dir / "4.png"), np.zeros((8, 8), np.uint8))
    png = HomographyDataset({**conf, "glob": ["*.png"], "train_size": 1, "val_size": 0})
    with pytest.raises(ValueError, match="PNG images are not supported"):
        png.get_dataset("train")[0]
