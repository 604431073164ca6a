"""SyntheticShapes: procedural corner-annotated images for the detector's
pretraining (counterpart of
gluefactory_tpu/multipoint/datasets/synthetic_shapes.py).

Each sample draws a blobby background and one of nine primitives at
`generation_size` (lines, a convex polygon, several polygons, ellipses, a
star, a perspective checkerboard, stripes, a shaded cube, noise), each
returning its corner keypoints; then a 21-tap blur (and a 51-tap one on
the "thermal" half when `additional_ir_blur`), the INTER_LINEAR resize to
`image_size`, a homographic warp with its valid mask, with `warped_pair`
a second view warped from the first by a fresh homography (its draws come
before view 1's photometric draws), and the `dark` photometric
augmentation of each view. The OpenCV calls of the JAX module are
`datasets.image_ops`' copies: the rasterisers pixel for pixel, the resize,
normalisation, perspective solve, Rodrigues and warps bit for bit, the
Gaussian blurs within a few float32 ulps.

Every split is seeded: sample `idx` draws from RandomState(seed + idx),
plus 100000 outside the train split, in the JAX package's order, so
samples equal the JAX package's. Images are (H, W, 1) float32 in [0, 1];
a sample carries `keypoint_map` (H, W), the padded `keypoints` (K, 2) with
`keypoint_mask`, `valid_mask`, `is_optical`, `H_aug` and, for a pair,
`image2`, `keypoint_map2`, `valid_mask2` and `H_0to1`.
"""

from __future__ import annotations

import numpy as np

from ...datasets.augmentations import augmentations
from ...datasets.base_dataset import BaseDataset
from ...datasets.image_ops import (
    fill_ellipse,
    fill_poly,
    fill_rectangle,
    gaussian_blur,
    get_perspective_transform,
    line,
    normalize_minmax,
    resize_linear,
    rodrigues,
    warp_perspective_cv,
)
from ...geometry.homography import sample_homography_corners
from ...utils.config import to_dict

# --------------------------------------------------------------- primitives


def generate_background(rng, shape, n_blobs: int = 30):
    """Smooth blobby background in [0.15, 0.85]."""
    h, w = shape
    img = np.full((h, w), rng.uniform(0.3, 0.7), np.float32)
    for _ in range(n_blobs):
        c = (rng.randint(0, w), rng.randint(0, h))
        ax = rng.randint(h // 20, h // 4)
        axes = (ax, int(ax * rng.uniform(0.3, 1.0)))
        angle = rng.uniform(0, 360)
        fill_ellipse(img, c, axes, angle, float(rng.uniform(0, 1)))
    img = gaussian_blur(img, (0, 0), h / 30)
    return normalize_minmax(img, 0.15, 0.85)


def _contrast_color(rng, image, pts, min_contrast):
    mean = float(np.mean([image[int(p[1]), int(p[0])] for p in pts]))
    sign = 1.0 if mean < 0.5 else -1.0
    return float(np.clip(mean + sign * rng.uniform(min_contrast, 0.5), 0, 1))


def draw_lines(rng, image, min_contrast, nb_lines: int = 10):
    h, w = image.shape
    kpts = []
    for _ in range(rng.randint(1, nb_lines)):
        p0 = np.array([rng.randint(w), rng.randint(h)])
        p1 = np.array([rng.randint(w), rng.randint(h)])
        col = _contrast_color(rng, image, [p0, p1], min_contrast)
        line(image, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), col,
             int(rng.randint(2, 5)))
        kpts += [p0, p1]
    return np.array(kpts, np.float32)


def _random_convex_polygon(rng, shape, max_sides: int = 8):
    h, w = shape
    n = rng.randint(3, max_sides + 1)
    c = np.array([rng.randint(w // 4, 3 * w // 4), rng.randint(h // 4, 3 * h // 4)])
    rad = rng.uniform(0.1, 0.3) * min(h, w)
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    pts = c + np.stack([rad * np.cos(angles), rad * np.sin(angles)], -1) \
        * rng.uniform(0.7, 1.0, (n, 1))
    return np.clip(pts, 0, [w - 1, h - 1]).astype(np.float32)


def draw_polygon(rng, image, min_contrast, max_sides: int = 8):
    pts = _random_convex_polygon(rng, image.shape, max_sides)
    col = _contrast_color(rng, image, pts, min_contrast)
    fill_poly(image, [pts.round().astype(np.int32)], col)
    return pts


def draw_multiple_polygons(rng, image, min_contrast, n_poly: int = 5):
    kpts = []
    for _ in range(rng.randint(2, n_poly + 1)):
        kpts.append(draw_polygon(rng, image, min_contrast))
    return np.concatenate(kpts, 0)


def draw_ellipses(rng, image, min_contrast, n: int = 4):
    h, w = image.shape
    for _ in range(rng.randint(1, n + 1)):
        c = (rng.randint(w), rng.randint(h))
        axes = (rng.randint(h // 16, h // 4), rng.randint(h // 16, h // 4))
        col = _contrast_color(rng, image, [c], min_contrast)
        fill_ellipse(image, c, axes, rng.uniform(0, 360), col)
    return np.zeros((0, 2), np.float32)  # a smooth boundary has no corners


def draw_star(rng, image, min_contrast, nb_branches: int = 6):
    h, w = image.shape
    c = np.array([rng.randint(w // 4, 3 * w // 4), rng.randint(h // 4, 3 * h // 4)])
    n = rng.randint(3, nb_branches + 1)
    kpts = [c]
    for a in np.sort(rng.uniform(0, 2 * np.pi, n)):
        r = rng.uniform(0.1, 0.3) * min(h, w)
        p = np.clip(c + r * np.array([np.cos(a), np.sin(a)]), 0, [w - 1, h - 1])
        col = _contrast_color(rng, image, [c, p], min_contrast)
        line(image, (int(c[0]), int(c[1])), (int(round(p[0])), int(round(p[1]))), col,
             int(rng.randint(2, 4)))
        kpts.append(p)
    return np.array(kpts, np.float32)


def draw_checkerboard(rng, image, min_contrast, grid: int = 5):
    h, w = image.shape
    rows, cols = rng.randint(3, grid + 1), rng.randint(3, grid + 1)
    xs = np.linspace(rng.randint(w // 8), w - 1 - rng.randint(w // 8), cols + 1)
    ys = np.linspace(rng.randint(h // 8), h - 1 - rng.randint(h // 8), rows + 1)
    # perspective jitter of the grid
    src = np.array([[xs[0], ys[0]], [xs[-1], ys[0]], [xs[-1], ys[-1]], [xs[0], ys[-1]]],
                   np.float32)
    dst = (src + rng.uniform(-0.05, 0.05, (4, 2)) * [w, h]).astype(np.float32)
    T = get_perspective_transform(src, dst)

    def warp(p):
        q = T @ np.array([p[0], p[1], 1.0])
        return q[:2] / q[2]

    colors = rng.uniform(0, 1, (rows, cols))
    for i in range(rows):
        for j in range(cols):
            quad = np.array([warp((xs[j], ys[i])), warp((xs[j + 1], ys[i])),
                             warp((xs[j + 1], ys[i + 1])), warp((xs[j], ys[i + 1]))])
            fill_poly(image, [quad.round().astype(np.int32)], float(colors[i, j]))
    kpts = np.array([warp((x, y)) for y in ys for x in xs], np.float32)
    inb = (kpts[:, 0] >= 0) & (kpts[:, 0] < w) & (kpts[:, 1] >= 0) & (kpts[:, 1] < h)
    return kpts[inb]


def draw_stripes(rng, image, min_contrast, n_stripes: int = 6):
    h, w = image.shape
    n = rng.randint(2, n_stripes + 1)
    xs = np.sort(rng.randint(0, w, n))
    kpts = []
    for i, x in enumerate(xs):
        x1 = xs[i + 1] if i + 1 < n else w - 1
        fill_rectangle(image, (int(x), 0), (int(x1), h - 1), float(rng.uniform(0, 1)))
        kpts += [[x, 0], [x, h - 1]]
    return np.array(kpts, np.float32)


def draw_cube(rng, image, min_contrast):
    h, w = image.shape
    # axonometric cube: three visible faces under a random 3D rotation
    s = rng.uniform(0.15, 0.3) * min(h, w)
    angles = rng.uniform(0, np.pi / 3, 3)
    Rx = rodrigues(np.array([angles[0], 0, 0]))
    Ry = rodrigues(np.array([0, angles[1], 0]))
    Rz = rodrigues(np.array([0, 0, angles[2]]))
    R = Rz @ Ry @ Rx
    corners3d = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                         np.float32) * s
    proj = (corners3d @ R.T)[:, :2]
    c = np.array([rng.randint(w // 3, 2 * w // 3), rng.randint(h // 3, 2 * h // 3)])
    pts = np.clip(proj - proj.mean(0) + c, 0, [w - 1, h - 1]).astype(np.float32)
    col = _contrast_color(rng, image, pts, min_contrast)
    # the three faces around corner 7 (x = y = z = 1) are the visible ones
    faces = [[7, 6, 4, 5], [7, 5, 1, 3], [7, 3, 2, 6]]
    for f, shade in zip(faces, (1.0, 0.8, 0.6)):
        fill_poly(image, [pts[f].round().astype(np.int32)], col * shade)
    visible = sorted({i for f in faces for i in f})
    return pts[visible]


def gaussian_noise(rng, image, min_contrast):
    image[:] = rng.uniform(0, 1, image.shape)
    return np.zeros((0, 2), np.float32)


PRIMITIVES = {
    "draw_lines": draw_lines,
    "draw_polygon": draw_polygon,
    "draw_multiple_polygons": draw_multiple_polygons,
    "draw_ellipses": draw_ellipses,
    "draw_star": draw_star,
    "draw_checkerboard": draw_checkerboard,
    "draw_stripes": draw_stripes,
    "draw_cube": draw_cube,
    "gaussian_noise": gaussian_noise,
}


# ----------------------------------------------------------------- dataset
def _warp_keypoints(kpts: np.ndarray, H: np.ndarray) -> np.ndarray:
    kh = np.concatenate([kpts, np.ones((len(kpts), 1))], 1) @ H.T
    return (kh[:, :2] / kh[:, 2:]).astype(np.float32)


def _inside(kpts: np.ndarray, w: int, h: int) -> np.ndarray:
    return (kpts[:, 0] >= 0) & (kpts[:, 0] <= w - 1) & (kpts[:, 1] >= 0) & (kpts[:, 1] <= h - 1)


def _keypoint_map(kpts: np.ndarray, h: int, w: int) -> np.ndarray:
    kmap = np.zeros((h, w), np.float32)
    if len(kpts):
        kmap[kpts[:, 1].round().astype(int), kpts[:, 0].round().astype(int)] = 1.0
    return kmap


class _ShapesSplit:
    def __init__(self, parent, split, length):
        self.parent = parent
        self.split = split
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        conf = self.parent.conf
        seed = conf.seed + idx + (100000 if self.split != "train" else 0)
        rng = np.random.RandomState(seed)
        gh, gw = conf.generation_size
        h, w = conf.image_size
        aug = conf.augmentation
        homography = to_dict(aug.homographic.params)

        image = generate_background(rng, (gh, gw))
        prim = conf.primitives
        names = list(PRIMITIVES) if prim in (None, "all") else list(prim)
        kpts = PRIMITIVES[names[rng.randint(len(names))]](rng, image, conf.min_contrast)

        is_optical = bool(rng.randint(2))
        image = gaussian_blur(image, (conf.blur_size, conf.blur_size), 0)
        if not is_optical and conf.additional_ir_blur:  # the thermal-style extra blur
            image = gaussian_blur(
                image, (conf.additional_ir_blur_size, conf.additional_ir_blur_size), 0)
        image = resize_linear(image, (w, h))
        if len(kpts):
            kpts = kpts * np.array([w / gw, h / gh], np.float32)

        valid = np.ones((h, w), np.float32)
        H = np.eye(3, dtype=np.float32)
        if aug.homographic.enable:
            H, *_ = sample_homography_corners((w, h), (w, h), rng=rng, **homography)
            image = warp_perspective_cv(image, H, (w, h))
            valid = warp_perspective_cv(valid, H, (w, h))
            if len(kpts):
                kpts = _warp_keypoints(kpts, H)
        pair = {}
        if conf.warped_pair:
            # the second view warps view 1 (before its photometric jitter) by
            # a fresh homography; keypoints and validity follow
            H2, *_ = sample_homography_corners((w, h), (w, h), rng=rng, **homography)
            image2 = warp_perspective_cv(image, H2, (w, h))
            valid2 = warp_perspective_cv(valid, H2, (w, h))
            kpts2 = kpts.copy() if len(kpts) else kpts
            if len(kpts2):
                kpts2 = _warp_keypoints(kpts2, H2)
                kpts2 = kpts2[_inside(kpts2, w, h)]
            if aug.photometric.enable:
                image2 = self.parent.photo_aug(image2[..., None], rng)[..., 0]
            pair = {
                "image2": image2[..., None].astype(np.float32),
                "keypoint_map2": _keypoint_map(kpts2, h, w),
                "valid_mask2": (valid2 > 0.999).astype(np.float32),
                "H_0to1": H2.astype(np.float32),
            }

        if aug.photometric.enable:
            image = self.parent.photo_aug(image[..., None], rng)[..., 0]
        if len(kpts):
            kpts = kpts[_inside(kpts, w, h)]
        kmap = _keypoint_map(kpts, h, w)

        K = int(conf.max_keypoints)
        pad_kpts = np.zeros((K, 2), np.float32)
        mask = np.zeros((K,), bool)
        n = min(len(kpts), K)
        if n:
            pad_kpts[:n] = kpts[:n]
            mask[:n] = True

        return {
            "name": f"shapes/{idx:06d}",
            "idx": idx,
            "image": image[..., None].astype(np.float32),
            "keypoint_map": kmap,
            "keypoints": pad_kpts,
            "keypoint_mask": mask,
            "valid_mask": (valid > 0.999).astype(np.float32),
            "is_optical": np.asarray(is_optical),
            "H_aug": H.astype(np.float32),
            **pair,
        }


class SyntheticShapes(BaseDataset):
    default_conf = {
        "name": "synthetic_shapes",
        "length": 1000,
        "val_length": 64,
        "primitives": "all",
        "generation_size": [480, 640],
        "image_size": [240, 320],
        "min_contrast": 0.1,
        "blur_size": 21,
        "additional_ir_blur": True,
        "additional_ir_blur_size": 51,
        "max_keypoints": 128,
        # also give a warped second view (image2, keypoint_map2, valid_mask2,
        # H_0to1) for the paired detector + descriptor training
        "warped_pair": False,
        "seed": 0,
        "augmentation": {
            "photometric": {"enable": True, "name": "dark"},
            "homographic": {
                "enable": True,
                "params": {"difficulty": 0.4, "translation": 0.2, "max_angle": 25},
            },
        },
    }

    def _init(self, conf):
        self.photo_aug = augmentations[conf.augmentation.photometric.get("name", "dark")]()

    def get_dataset(self, split):
        length = self.conf.length if split == "train" else self.conf.val_length
        return _ShapesSplit(self, split, int(length))


__main_dataset__ = SyntheticShapes
