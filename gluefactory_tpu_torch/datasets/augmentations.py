"""Photometric augmentation pipelines (counterpart of
gluefactory_tpu/datasets/augmentations.py): identity, "dark" (strong
low-light degradation) and "lg" (the LightGlue training recipe) on float32
(H, W, 1) or (H, W, 3) images in [0, 1].

The JAX module's code with its cv2 calls replaced by the numpy versions of
`image_ops` (Gaussian blur with OpenCV's small kernels, `filter2D`, the
filled ellipse of the random shade): every draw comes from the caller's
`RandomState` in the JAX order, so a seed gives the same image.
"""

from __future__ import annotations

import numpy as np

from .image_ops import fill_ellipse, filter2d, gaussian_blur


def _rand(rng, lo, hi):
    return rng.uniform(lo, hi)


def _maybe(rng, p):
    return rng.rand() < p


def _clip(img):
    return np.clip(img, 0.0, 1.0)


def _brightness_contrast(img, rng, b=0.2, c=0.2):
    alpha = 1.0 + _rand(rng, -c, c)
    beta = _rand(rng, -b, b)
    return _clip(img * alpha + beta)


def _gamma(img, rng, lo=0.5, hi=2.0):
    return _clip(np.power(np.maximum(img, 1e-6), _rand(rng, lo, hi)))


def _gaussian_noise(img, rng, sigma_max=0.05):
    return _clip(img + rng.randn(*img.shape).astype(np.float32) * _rand(rng, 0, sigma_max))


def _blur(img, rng, kmax=5):
    k = rng.choice([3, 5]) if kmax >= 5 else 3
    return gaussian_blur(img, (k, k), 0).reshape(img.shape)


def _motion_blur(img, rng, kmax=7):
    k = int(rng.choice([3, 5, 7]))
    kernel = np.zeros((k, k), np.float32)
    ang = _rand(rng, 0, np.pi)
    c = (k - 1) / 2
    for i in range(k):
        x = int(round(c + (i - c) * np.cos(ang)))
        y = int(round(c + (i - c) * np.sin(ang)))
        kernel[np.clip(y, 0, k - 1), np.clip(x, 0, k - 1)] = 1
    kernel /= kernel.sum()
    return filter2d(img, kernel).reshape(img.shape)


def _random_shade(img, rng, nb_ellipses=12, intensity=(-0.4, 0.2)):
    """Additive elliptical shading."""
    h, w = img.shape[:2]
    mask = np.zeros((h, w), np.float32)
    for _ in range(nb_ellipses):
        ax = int(max(rng.rand() * min(h, w) / 3, 8))
        ay = int(max(rng.rand() * min(h, w) / 3, 8))
        x = rng.randint(ax, max(w - ax, ax + 1))
        y = rng.randint(ay, max(h - ay, ay + 1))
        angle = rng.rand() * 90
        fill_ellipse(mask, (x, y), (ax, ay), angle, 1.0)
    mask = gaussian_blur(mask, (0, 0), min(h, w) / 10)
    shade = _rand(rng, *intensity)
    out = img + shade * mask[..., None] if img.ndim == 3 else img + shade * mask
    return _clip(out)


class IdentityAugmentation:
    def __call__(self, img, rng):
        return img


class LGAugmentation:
    """LightGlue training photometric recipe: mild brightness/contrast/gamma,
    occasional blur and noise."""

    def __call__(self, img, rng):
        img = img.astype(np.float32)
        if _maybe(rng, 0.95):
            img = _brightness_contrast(img, rng)
        if _maybe(rng, 0.3):
            img = _gamma(img, rng, 0.7, 1.4)
        if _maybe(rng, 0.2):
            img = _blur(img, rng)
        if _maybe(rng, 0.2):
            img = _gaussian_noise(img, rng, 0.03)
        return img


class DarkAugmentation:
    """Strong low-light degradation."""

    def __call__(self, img, rng):
        img = img.astype(np.float32)
        img = _gamma(img, rng, 1.5, 3.0)
        img = _brightness_contrast(img, rng, b=0.3, c=0.4)
        if _maybe(rng, 0.5):
            img = _gaussian_noise(img, rng, 0.06)
        if _maybe(rng, 0.3):
            img = _motion_blur(img, rng)
        if _maybe(rng, 0.3):
            img = _random_shade(img, rng)
        return img


augmentations = {
    "identity": IdentityAugmentation,
    "lg": LGAugmentation,
    "dark": DarkAugmentation,
}


__all__ = ["augmentations", "IdentityAugmentation", "LGAugmentation", "DarkAugmentation"]
