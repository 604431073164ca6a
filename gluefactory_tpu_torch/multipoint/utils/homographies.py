"""Homographic adaptation: the detector's probability aggregated over random
warps of the image (counterpart of
gluefactory_tpu/multipoint/utils/homographies.py).

The K homographies are drawn on the host by `sample_homography_corners`
from the caller's `RandomState`, in the JAX order, so a seed gives the same
warps. The bilinear inverse warp keeps the JAX function's arithmetic: pixel
centres at +0.5, the homogeneous `z` clamped at 1e-8, the left / top corner
index clipped before its neighbour is taken (so the border sample differs
from a clamp of both), and the `inside` test on [-0.5, size - 0.5].
"""

from __future__ import annotations

import numpy as np
import torch

from ...geometry.homography import sample_homography_corners


def warp_image_bilinear(image: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Inverse-warp (B, H, W, C) images by (B, 3, 3) homographies (each output
    pixel samples the source at H^-1 of its centre); zero outside."""
    b, h, w, c = image.shape
    dev = image.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = torch.einsum("bij,nj->bni", torch.linalg.inv(H.float()), pix)
    z = src[..., 2]
    z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    sx = src[..., 0] / z - 0.5
    sy = src[..., 1] / z - 0.5

    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0, sy - y0
    # clipped as floats before the integer cast: equal to the JAX clip of
    # the cast for every finite value, and defined for those past int32
    x0i = x0.clamp(0, w - 1).long()
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.clamp(0, h - 1).long()
    y1i = (y0i + 1).clamp(0, h - 1)
    inside = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)

    flat = image.reshape(b, h * w, c)

    def gather(iy, ix):
        return torch.gather(flat, 1, (iy * w + ix)[..., None].expand(-1, -1, c))

    out = (gather(y0i, x0i) * ((1 - wx) * (1 - wy))[..., None]
           + gather(y0i, x1i) * (wx * (1 - wy))[..., None]
           + gather(y1i, x0i) * ((1 - wx) * wy)[..., None]
           + gather(y1i, x1i) * (wx * wy)[..., None])
    return (out * inside[..., None]).reshape(b, h, w, c)


def homographic_adaptation(apply_prob_fn, image: torch.Tensor, num: int = 32,
                           aggregation: str = "mean", rng: np.random.RandomState | None = None,
                           hconf: dict | None = None) -> torch.Tensor:
    """The (B, H, W) probability of `apply_prob_fn` ((B, H, W, C) images ->
    (B, H, W)) aggregated over the image and `num` random warps of it, each
    warped back: "max" keeps the largest where a warp covers the pixel
    (coverage > 0.5), "mean" the coverage-weighted mean."""
    rng = rng or np.random.RandomState(0)
    hconf = hconf or {"difficulty": 0.8, "translation": 0.3, "max_angle": 30}
    b, h, w, _ = image.shape

    probs = [apply_prob_fn(image)]
    counts = [torch.ones((b, h, w), device=image.device)]
    ones = torch.ones((b, h, w, 1), device=image.device)
    for _ in range(num):
        H, *_ = sample_homography_corners((w, h), (w, h), rng=rng, **hconf)
        Hb = torch.as_tensor(np.asarray(H, np.float32), device=image.device).expand(b, 3, 3)
        prob_w = apply_prob_fn(warp_image_bilinear(image, Hb))
        Hinv = torch.linalg.inv(Hb)  # in float32, as the JAX function inverts it
        probs.append(warp_image_bilinear(prob_w[..., None], Hinv)[..., 0])
        counts.append(warp_image_bilinear(ones, Hinv)[..., 0])

    probs, counts = torch.stack(probs), torch.stack(counts)
    if aggregation == "max":
        return torch.max(probs * (counts > 0.5), dim=0).values
    return (probs * counts).sum(0) / (counts.sum(0)).clamp(min=1e-6)


__all__ = ["homographic_adaptation", "warp_image_bilinear"]
