"""2D figures as rasterisers on numpy canvases (counterpart of
gluefactory_tpu/visualization/viz2d.py, which draws with matplotlib).

A `Figure` is a white RGB canvas (H, W, 3) in [0, 1] with its `Axes`; an
axis maps an image's xy coordinates (pixel corners at integers, as the
keypoints' +0.5 centres assume) onto the canvas. `plot_images` puts images
side by side at a common height (grey images stretched to their own range,
as `imshow` with a grey colormap does); `plot_keypoints` stamps discs;
`plot_matches` rasterises every match line at once (each segment sampled
once a pixel along its major axis, all segments in one set of numpy index
arrays, then a square pen of `lw` pixels) with a colour per match; `plot_curve` draws a
curve in a unit box (the PR figure) and keeps its arrays in `fig.curves`;
`save_plot` writes the canvas as an 8-bit PNG with the port's own encoder.
Without a font rasteriser titles and text are not drawn. There is no
current figure: the drawing functions take the axes that `plot_images`
returned.
"""

from __future__ import annotations

import colorsys
from pathlib import Path

import numpy as np

from ..datasets.image_codecs import encode_png

__all__ = ["Figure", "Axes", "cm_RdGn", "cm_ranking", "to_rgb", "plot_images",
           "plot_keypoints", "plot_matches", "plot_curve", "save_plot"]

# matplotlib's named colours used by the figures
COLORS = {
    "red": (1.0, 0.0, 0.0), "yellow": (1.0, 1.0, 0.0), "lime": (0.0, 1.0, 0.0),
    "cyan": (0.0, 1.0, 1.0), "blue": (0.0, 0.0, 1.0), "black": (0.0, 0.0, 0.0),
    "royalblue": (65 / 255, 105 / 255, 225 / 255),
    "tab:blue": (31 / 255, 119 / 255, 180 / 255),
}


class Axes:
    """An image's place on its figure: canvas = xy * scale + (x0, y0)."""

    def __init__(self, fig: "Figure", x0: float, y0: float, scale: float):
        self.figure, self.x0, self.y0, self.scale = fig, x0, y0, scale

    def to_canvas(self, xy) -> np.ndarray:
        return np.asarray(xy, np.float64).reshape(-1, 2) * self.scale + (self.x0, self.y0)


class Figure:
    def __init__(self, height: int, width: int):
        self.canvas = np.ones((height, width, 3), np.float32)
        self.axes: list = []
        self.curves: list = []  # the (x, y) arrays of each `plot_curve`

    @property
    def shape(self) -> tuple:
        return self.canvas.shape

    def to_uint8(self) -> np.ndarray:
        return np.round(np.clip(self.canvas, 0, 1) * 255).astype(np.uint8)


def cm_RdGn(x):
    """Map [0, 1] to a red -> green colormap."""
    x = np.clip(np.asarray(x, float), 0, 1)[..., None] * 2
    c = x * np.array([[0, 1.0, 0]]) + (2 - x) * np.array([[1.0, 0, 0]])
    return np.clip(c, 0, 1)


def cm_ranking(sc, ths=(512, 1024, 2048, 4096)):
    """Colour keypoints by score rank band: the strongest 512 red, the next
    band yellow, ..."""
    sc = np.asarray(sc)
    colors = ["red", "yellow", "lime", "cyan", "blue"]
    ranks = np.empty(len(sc), int)
    ranks[np.argsort(-sc)] = np.arange(len(sc))
    bands = np.searchsorted(np.asarray(ths), ranks, side="right")
    return [colors[min(b, len(colors) - 1)] for b in bands]


def to_rgb(color, n: int) -> np.ndarray:
    """(n, 3) RGB in [0, 1] of one colour (a name, RGB or RGBA) or of one a
    point (a list or an (n, 3 | 4) array)."""
    def one(c):
        if isinstance(c, str):
            return COLORS[c]
        return tuple(float(v) for v in c)[:3]

    if n == 0:
        return np.zeros((0, 3), np.float32)
    if isinstance(color, str) or all(np.isscalar(v) and not isinstance(v, str) for v in color):
        return np.tile(np.asarray(one(color), np.float32), (n, 1))
    out = np.asarray([one(c) for c in color], np.float32).reshape(-1, 3)
    if len(out) != n:
        raise ValueError(f"{len(out)} colours for {n} points")
    return out


def hsv_colors(values) -> np.ndarray:
    """(N, 3) RGB of hues in [0, 1] at full saturation and value."""
    return np.asarray([colorsys.hsv_to_rgb(float(h), 1.0, 1.0) for h in values], np.float32)


def _image_rgb(img) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:  # stretched to its range, as imshow's grey colormap does
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        return np.repeat(img[..., None], 3, -1)
    return np.clip(img[..., :3], 0, 1)


def plot_images(imgs, titles=None, cmaps="gray", pad: int = 8):
    """A row of images at the height of the tallest (nearest resampling), `pad`
    white pixels apart; returns (fig, axes). `titles` and `cmaps` (grey) are
    taken for the JAX signature; no text is drawn."""
    rgbs = [_image_rgb(im) for im in imgs]
    height = max(im.shape[0] for im in rgbs)
    scales = [height / im.shape[0] for im in rgbs]
    widths = [int(round(im.shape[1] * s)) for im, s in zip(rgbs, scales)]
    fig = Figure(height, sum(widths) + pad * (len(rgbs) - 1))
    x0 = 0
    for im, s, w in zip(rgbs, scales, widths):
        ys = np.minimum((np.arange(height) / s).astype(int), im.shape[0] - 1)
        xs = np.minimum((np.arange(w) / s).astype(int), im.shape[1] - 1)
        fig.canvas[:, x0:x0 + w] = im[ys][:, xs]
        fig.axes.append(Axes(fig, x0, 0.0, s))
        x0 += w + pad
    return fig, fig.axes


def _stamp(fig: Figure, pts: np.ndarray, rgb: np.ndarray, size: float, alpha: float,
           disc: bool) -> None:
    """Blend `rgb[i]` into the pixels of a pen of `size` pixels (a disc or a
    square) at each canvas point `pts[i]`, all points in one indexed update."""
    if len(pts) == 0:
        return
    k = max(int(np.ceil(size)), 1)
    oy, ox = np.mgrid[0:k, 0:k].reshape(2, -1)
    if disc and k > 2:
        c = (k - 1) / 2.0
        keep = (oy - c) ** 2 + (ox - c) ** 2 <= (size / 2.0) ** 2 + 0.5
        oy, ox = oy[keep], ox[keep]
    h, w = fig.canvas.shape[:2]
    corner = np.floor(pts - (k - 1) / 2.0).astype(np.int32)
    ys = corner[:, 1:2] + oy[None]
    xs = corner[:, 0:1] + ox[None]
    inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    flat = (ys * w + xs)[inside]
    col = np.broadcast_to(rgb.astype(np.float32)[:, None], (*ys.shape, 3))[inside]
    canvas = fig.canvas.reshape(-1, 3)
    canvas[flat] = canvas[flat] * (1 - alpha) + col * alpha


def _segments(p0: np.ndarray, p1: np.ndarray):
    """Points along each segment p0[i] -> p1[i], one a pixel along its major
    axis, and the segment of each point."""
    d = p1 - p0
    n = np.ceil(np.abs(d).max(-1)).astype(np.int64) + 1
    seg = np.repeat(np.arange(len(p0)), n)
    first = np.repeat(np.cumsum(n) - n, n)
    t = (np.arange(len(seg)) - first) / np.repeat(np.maximum(n - 1, 1), n)
    return p0[seg] + t[:, None] * d[seg], seg


def plot_keypoints(kpts, colors="lime", ps=4, axes=(), a=1.0):
    """Keypoints of each image as discs of about sqrt(ps) pixels."""
    if not isinstance(colors, list):
        colors = [colors] * len(kpts)
    for ax, k, c in zip(axes, kpts, colors):
        k = np.asarray(k).reshape(-1, 2)
        _stamp(ax.figure, ax.to_canvas(k), to_rgb(c, len(k)), max(np.sqrt(ps), 1.0), a,
               disc=True)


def plot_matches(kpts0, kpts1, color=None, lw=1.5, ps=4, a=1.0, axes=(), labels=None):
    """A line from each keypoint of the first image (on `axes[0]`) to its
    match in the second (`axes[1]`), random hues without `color`, then the
    endpoints with `ps`. `labels` (the interactive viewer's) are not used."""
    ax0, ax1 = axes
    kpts0, kpts1 = np.asarray(kpts0).reshape(-1, 2), np.asarray(kpts1).reshape(-1, 2)
    rgb = hsv_colors(np.random.rand(len(kpts0))) if color is None else to_rgb(color,
                                                                              len(kpts0))
    p0, p1 = ax0.to_canvas(kpts0), ax1.to_canvas(kpts1)
    pts, seg = _segments(p0, p1)
    _stamp(ax0.figure, pts, rgb[seg], lw, a, disc=False)
    if ps > 0:
        for ax, p in ((ax0, p0), (ax1, p1)):
            _stamp(ax.figure, p, rgb, max(np.sqrt(ps), 1.0), 1.0, disc=True)


def plot_curve(x, y, size=(400, 400), color="tab:blue", lw=1.5, margin: int = 20) -> Figure:
    """A curve of x, y in [0, 1] in a framed unit box (y up)."""
    h, w = size
    fig = Figure(h, w)
    box = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)

    def canvas(xy):
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        return np.stack([margin + xy[:, 0] * (w - 2 * margin),
                         (h - margin) - xy[:, 1] * (h - 2 * margin)], -1)

    frame, _ = _segments(canvas(box), canvas(np.roll(box, -1, 0)))
    _stamp(fig, frame, to_rgb("black", len(frame)), 1.0, 1.0, disc=False)
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    pts = canvas(np.stack([x, y], -1))
    if len(pts) > 1:
        line, _ = _segments(pts[:-1], pts[1:])
        _stamp(fig, line, to_rgb(color, len(line)), lw, 1.0, disc=False)
    fig.curves.append((x, y))
    return fig


def save_plot(path, fig) -> Path:
    """Write a figure (or an (H, W[, 3]) array in [0, 1] or uint8) as PNG."""
    img = fig.to_uint8() if isinstance(fig, Figure) else np.asarray(fig)
    if img.dtype != np.uint8:
        img = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
    path = Path(path)
    # deflate level 1: the trainer writes its figures inside the training loop,
    # and the default level takes several times as long for a somewhat smaller file
    path.write_bytes(encode_png(img, level=1))
    return path
