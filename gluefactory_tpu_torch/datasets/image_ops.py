"""The OpenCV image operations of the homography data pipeline, in numpy
(the JAX package calls cv2, which the card's machine lacks).

Each function repeats OpenCV's semantics on float32 single-channel images:

- `gaussian_blur`: `cv2.GaussianBlur`, separable, border REFLECT_101. With
  sigma 0 and ksize 3, 5 or 7 it takes OpenCV's fixed small kernels; with
  ksize 0 it derives ksize = round(8 sigma + 1) | 1, as OpenCV does for
  float images. Kernels are OpenCV's float32 ones.
- `filter2d`: `cv2.filter2D` (a correlation), anchor at the centre,
  REFLECT_101.
- `resize_cubic`: `cv2.resize(..., INTER_CUBIC)`: source x = (dx + 0.5) s -
  0.5, Keys' cubic with a = -0.75 computed in float32, borders replicated.
- `fill_poly`: `cv2.fillPoly` on int32 vertices as OpenCV 5 draws it: the
  8-connected outline, then the even-odd scanline fill of the edge
  collection, each row from the first pixel at or right of the left edge to
  the last at or left of the right one; an edge that leaves the image takes
  the x of its clipped segment.
- `fill_ellipse`: the filled `cv2.ellipse` over 0-360 degrees: the polygon of
  `ellipse2Poly` (OpenCV's float sine table at whole degrees, the angle
  rounded to a whole degree) filled as OpenCV's convex fill does.
- `warp_perspective`: the JAX package's `native/warp_ops.cpp`: dst(x, y)
  samples src at H^-1 (x, y), raw coordinates without a half-pixel offset,
  bilinear, out-of-range neighbours weigh 0, float64 arithmetic.

Sums run in float64 and round to float32 where OpenCV stores float32 (after
the horizontal pass, at the end), so results are within a few float32 ulps
of OpenCV's float32 accumulation. The rasterisers are integer code, exact.
"""

from __future__ import annotations

import numpy as np
import torch

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}
# OpenCV's table of sin at whole degrees 0..450, float literals of 7 decimals
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32).astype(np.float64)
_FFT_TAPS = 32  # kernels at least this long filter through the FFT (float64)


# ----------------------------------------------------------------- filtering
def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """`cv2.getGaussianKernel(n, sigma, CV_32F)`."""
    if n % 2 == 1 and n <= 7 and sigma <= 0:
        return np.asarray(_SMALL_GAUSSIAN[n], np.float32)
    sigma = sigma if sigma > 0 else ((n - 1) * 0.5 - 1) * 0.3 + 0.8
    scale2x = -0.5 / (sigma * sigma)
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    t = np.exp(scale2x * x * x)
    total = 0.0
    for v in t.tolist():  # OpenCV's running sum
        total += v
    return (t * (1.0 / total)).astype(np.float32)


def reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's borderInterpolate for BORDER_REFLECT_101."""
    if n == 1:
        return np.zeros_like(idx)
    idx = np.asarray(idx).copy()
    while True:
        low, high = idx < 0, idx >= n
        if not (low.any() or high.any()):
            return idx
        idx = np.where(low, -idx, np.where(high, 2 * n - 2 - idx, idx))


def _correlate_axis(img: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """float64 correlation of a float64 2-D image with a 1-D kernel along
    `axis`, centre anchor, REFLECT_101 border."""
    k = len(kernel)
    n = img.shape[axis]
    anchor = k // 2
    src = np.take(img, reflect101(np.arange(-anchor, n + k - 1 - anchor), n), axis=axis)
    kernel = kernel.astype(np.float64)
    if k >= _FFT_TAPS:
        length = src.shape[axis]
        spec = np.fft.rfft(src, axis=axis) * np.expand_dims(
            np.conj(np.fft.rfft(kernel, length)), 1 - axis)
        full = np.fft.irfft(spec, length, axis=axis)
        return np.take(full, np.arange(n), axis=axis)
    src = np.moveaxis(src, axis, 0)
    out = np.zeros(src.shape[:0] + (n,) + src.shape[1:], np.float64)
    tmp = np.empty_like(out)
    for i, w in enumerate(kernel.tolist()):
        if w != 0.0:
            np.multiply(src[i:i + n], w, out=tmp)
            out += tmp
    return np.moveaxis(out, 0, axis)


def sep_filter(img: np.ndarray, kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    """`cv2.sepFilter2D` on a float32 (H, W) image: the row pass, float32,
    then the column pass."""
    tmp = _correlate_axis(img.astype(np.float64), kx, 1).astype(np.float32)
    return _correlate_axis(tmp.astype(np.float64), ky, 0).astype(np.float32)


def _per_channel(fn, img: np.ndarray, *args) -> np.ndarray:
    """fn on each channel of an (H, W, C) image with C > 1, as OpenCV
    filters them; (H, W) and (H, W, 1) images give (H, W)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[2] > 1:
        return np.stack([fn(img[..., i], *args) for i in range(img.shape[2])], -1)
    return fn(img.reshape(img.shape[0], img.shape[1]), *args)


def gaussian_blur(img: np.ndarray, ksize=(0, 0), sigma: float = 0.0) -> np.ndarray:
    """`cv2.GaussianBlur(img, ksize, sigma)` of a float32 image."""
    return _per_channel(_gaussian_blur, img, ksize, sigma)


def _gaussian_blur(img: np.ndarray, ksize, sigma: float) -> np.ndarray:
    kw, kh = ksize
    if kw <= 0 and sigma > 0:
        kw = int(round(sigma * 4 * 2 + 1)) | 1
    if kh <= 0 and sigma > 0:
        kh = int(round(sigma * 4 * 2 + 1)) | 1
    return sep_filter(img, gaussian_kernel(kw, sigma), gaussian_kernel(kh, sigma))


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """`cv2.filter2D(img, -1, kernel)` of a float32 image."""
    return _per_channel(_filter2d, img, kernel)


def _filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    img = img.astype(np.float64)
    kernel = np.asarray(kernel, np.float32).astype(np.float64)
    kh, kw = kernel.shape
    h, w = img.shape
    ay, ax = kh // 2, kw // 2
    rows = reflect101(np.arange(-ay, h + kh - 1 - ay), h)
    cols = reflect101(np.arange(-ax, w + kw - 1 - ax), w)
    src = img[rows][:, cols]
    out = np.zeros((h, w), np.float64)
    for (i, j), v in np.ndenumerate(kernel):
        if v != 0.0:
            out += v * src[i:i + h, j:j + w]
    return out.astype(np.float32)


# ------------------------------------------------------------------- resize
def _cubic_taps(n_out: int, n_in: int):
    """(first source index, float32 coefficients (n_out, 4)) of OpenCV's
    cubic interpolation along one axis."""
    scale = 1.0 / (n_out / n_in)
    fx = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    x = fx - sx.astype(np.float32)
    one, a = np.float32(1), np.float32(-0.75)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one) + np.float32(8) * a) * (x + one) \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    y = one - x
    c2 = ((a + np.float32(2)) * y - (a + np.float32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    return sx - 1, np.stack([c0, c1, c2, c3], -1)


def resize_cubic(img: np.ndarray, dsize) -> np.ndarray:
    """`cv2.resize(img, dsize, interpolation=cv2.INTER_CUBIC)` of a float32
    (H, W) image; `dsize` is (width, height)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    dw, dh = dsize
    x0, cx = _cubic_taps(dw, w)
    y0, cy = _cubic_taps(dh, h)
    src = img.astype(np.float64)
    tmp = np.zeros((h, dw), np.float64)
    for k in range(4):
        tmp += src[:, np.clip(x0 + k, 0, w - 1)] * cx[:, k].astype(np.float64)
    tmp = tmp.astype(np.float32).astype(np.float64)
    out = np.zeros((dh, dw), np.float64)
    for k in range(4):
        out += tmp[np.clip(y0 + k, 0, h - 1)] * cy[:, k:k + 1].astype(np.float64)
    return out.astype(np.float32)


# --------------------------------------------------------------- rasterising
def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, p1, p2):
    """OpenCV's clipLine to [0, w - 1] x [0, h - 1]; (inside, p1, p2)."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line(img: np.ndarray, p1, p2, color: float) -> None:
    """OpenCV's 8-connected `Line` (LineIterator, left to right)."""
    h, w = img.shape
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        inside, p1, p2 = clip_line(w, h, p1, p2)
        if not inside:
            return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - (dy + dy), dx + dx, -(dy + dy)
    xs = np.empty(dx + 1, np.int64)
    ys = np.empty(dx + 1, np.int64)
    x, y = x1, y1
    for i in range(dx + 1):
        xs[i], ys[i] = x, y
        step_minor = err < 0
        err += minus + (plus if step_minor else 0)
        if vert:
            y += sy
            x += sx if step_minor else 0
        else:
            x += sx
            y += sy if step_minor else 0
    img[ys, xs] = color


def _line2(img: np.ndarray, p1, p2, color: float) -> None:
    """OpenCV's `Line2`: a line between fixed-point (16 bit) endpoints."""
    h, w = img.shape
    inside, (x1, y1), (x2, y2) = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    i = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + i
        ys = (y1 + i * y_step) >> XY_SHIFT
    else:
        ys = (y1 >> XY_SHIFT) + i
        xs = (x1 + i * x_step) >> XY_SHIFT
    xs = np.append(xs, (x2 + (XY_ONE >> 1)) >> XY_SHIFT)
    ys = np.append(ys, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _collect_poly_edges(img: np.ndarray, pts, color: float) -> list:
    """OpenCV's CollectPolyEdges for an 8-connected polygon at shift 0:
    draws the outline and returns the edges [y0, y1, x, dx] (x, dx in
    16-bit fixed point, vertices on pixel centres)."""
    h, w = img.shape
    edges = []
    count = len(pts)
    pt0 = (int(pts[-1][0]) << XY_SHIFT, int(pts[-1][1]))
    for i in range(count):
        pt1 = (int(pts[i][0]) << XY_SHIFT, int(pts[i][1]))
        pt0c, pt1c = list(pt0), list(pt1)
        t0 = ((pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1])
        _line(img, t0, t1, color)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            # the edge takes the clipped segment's x; its rows stay unless
            # the clipped segment is horizontal
            _, t0, t1 = clip_line(w, h, t0, t1)
            if t0[1] != t1[1]:
                pt0c[1], pt1c[1] = t0[1], t1[1]
            pt0c[0], pt1c[0] = t0[0] << XY_SHIFT, t1[0] << XY_SHIFT
        if pt0[1] != pt1[1]:
            dx = _tdiv(pt1c[0] - pt0c[0], pt1c[1] - pt0c[1])
            if pt0[1] < pt1[1]:
                edges.append([pt0[1], pt1[1], pt0c[0] + (pt0[1] - pt0c[1]) * dx, dx])
            else:
                edges.append([pt1[1], pt0[1], pt1c[0] + (pt1[1] - pt1c[1]) * dx, dx])
        pt0 = pt1
    return edges


def _fill_edge_collection(img: np.ndarray, edges: list, color: float) -> None:
    """OpenCV's FillEdgeCollection (non-antialiased): an active edge list
    walked scanline by scanline, spans between pairs of edges."""
    h, w = img.shape
    total = len(edges)
    if total < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    # a linked list as in OpenCV: nxt[i] is the index after edge i, -1 the
    # end; index `total` is the list head ("tmp")
    head = total
    nxt = [-1] * (total + 1)
    x = [e[2] for e in edges] + [0]
    y0s = [e[0] for e in edges] + [1 << 62]
    y1s = [e[1] for e in edges]
    dxs = [e[3] for e in edges]
    i = 0
    y_max = min(y_max, h)
    y = y0s[0]
    while y < y_max:
        draw = False
        clipline = y < 0
        prelast = head
        last = nxt[head]
        while last != -1 or y0s[i] == y:
            if last != -1 and y1s[last] == y:
                nxt[prelast] = nxt[last]  # the edge ends here
                last = nxt[last]
                continue
            keep_prelast = prelast
            if last != -1 and (y0s[i] > y or x[last] < x[i]):
                prelast = last
                last = nxt[last]
            elif i < total:
                nxt[prelast] = i  # the edge starts here
                nxt[i] = last
                prelast = i
                i += 1
            else:
                break
            if draw:
                if not clipline:
                    # from the first pixel centre at or right of the left
                    # edge to the last at or left of the right one
                    lo, hi = sorted((x[prelast], x[keep_prelast]))
                    x1, x2 = (lo + XY_ONE - 1) >> XY_SHIFT, hi >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = color
                x[keep_prelast] += dxs[keep_prelast]
                x[prelast] += dxs[prelast]
            draw = not draw
        # bubble sort of the active list by x
        keep_prelast = -1
        while True:
            prelast = head
            last = nxt[head]
            last_exchange = -1
            while last != keep_prelast and nxt[last] != -1:
                te = nxt[last]
                if x[last] > x[te]:
                    nxt[prelast] = te
                    nxt[last] = nxt[te]
                    nxt[te] = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast = last
                    last = te
            if last_exchange == -1:
                break
            keep_prelast = last_exchange
            if keep_prelast == nxt[head] or keep_prelast == head:
                break
        y += 1


def fill_poly(img: np.ndarray, polys, color: float) -> np.ndarray:
    """`cv2.fillPoly(img, polys, color)` in place on a float32 (H, W) image,
    for (N, 2) int32 vertex arrays."""
    edges = []
    for pts in polys:
        edges += _collect_poly_edges(img, np.asarray(pts, np.int64).tolist(), color)
    _fill_edge_collection(img, edges, color)
    return img


def _fill_convex_poly(img: np.ndarray, v: list, color: float, shift: int) -> None:
    """OpenCV's FillConvexPoly (non-antialiased) of points in `shift`-bit
    fixed point."""
    h, w = img.shape
    npts = len(v)
    delta = (1 << shift) >> 1
    delta1 = delta2 = XY_ONE >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i in range(npts):
        px, py = v[i]
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << (XY_SHIFT - shift), py << (XY_SHIFT - shift))
        if shift == 0:
            _line(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT), (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT),
                  color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge_idx, edge_di, edge_x, edge_dx, edge_ye = [imin, imin], [1, npts - 1], \
        [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    y = ymin
    edges = npts
    while True:
        for k in range(2):
            if y >= edge_ye[k]:
                idx0, di = edge_idx[k], edge_di[k]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        edge_ye[k] = ty
                        edge_dx[k] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        edge_x[k] = xs
                        edge_idx[k] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge_x[0] > edge_x[1] else (0, 1)
            xx1 = (edge_x[left] + delta1) >> XY_SHIFT
            xx2 = (edge_x[right] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge_x[0] += edge_dx[0]
        edge_x[1] += edge_dx[1]
        y += 1
        if y > ymax:
            break


def ellipse_poly(center, axes, angle: int, delta: int) -> list:
    """OpenCV's ellipse2Poly over 0-360 degrees (float64 points)."""
    angle %= 360
    alpha, beta = _SIN_TABLE[450 - angle], _SIN_TABLE[angle]
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = axes[0] * _SIN_TABLE[450 - a]
        y = axes[1] * _SIN_TABLE[a]
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    return pts


def fill_ellipse(img: np.ndarray, center, axes, angle: float, color: float) -> np.ndarray:
    """`cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)` in place on a
    float32 (H, W) image (integer centre and axes)."""
    c = (int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT)
    ax = (abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT)
    delta = (max(ax) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v, prev = [], None
    for px, py in ellipse_poly((float(c[0]), float(c[1])), (float(ax[0]), float(ax[1])),
                               int(round(angle)), delta):
        qx = round(px / XY_ONE) << XY_SHIFT
        qy = round(py / XY_ONE) << XY_SHIFT
        pt = (qx + round(px - qx), qy + round(py - qy))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [c, c]
    _fill_convex_poly(img, v, color, XY_SHIFT)
    return img


# -------------------------------------------------------------------- warping
def warp_perspective(img: np.ndarray, H: np.ndarray, size) -> np.ndarray:
    """Warp a float32 (H, W, C) image by the homography H into (w, h) =
    `size`, as the JAX package's native `warp_perspective_f32`. Runs as
    whole-image torch CPU operations (float64, the C++ order of operations),
    which spread over the intra-op threads and release the GIL."""
    w, h = size
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    sh, sw, c = img.shape
    hi = np.linalg.inv(np.asarray(H, np.float64)).reshape(-1).tolist()
    f64 = torch.float64
    px = torch.arange(w, dtype=f64)[None, :]
    py = torch.arange(h, dtype=f64)[:, None]
    sx = hi[0] * px + hi[1] * py + hi[2]
    sy = hi[3] * px + hi[4] * py + hi[5]
    sz = hi[6] * px + hi[7] * py + hi[8]
    sz = torch.where(sz.abs() < 1e-12, torch.full_like(sz, 1e-12), sz)
    ux, uy = sx / sz, sy / sz
    fx, fy = torch.floor(ux), torch.floor(uy)
    wx, wy = ux - fx, uy - fy
    # the C++ casts floor() to int; far outside it only matters that the
    # pixel is out of range
    x0 = fx.clamp(-2, sw + 1).to(torch.int64)
    y0 = fy.clamp(-2, sh + 1).to(torch.int64)
    inside = (x0 >= -1) & (y0 >= -1) & (x0 < sw) & (y0 < sh)
    x0ok, x1ok, y0ok, y1ok = x0 >= 0, x0 + 1 < sw, y0 >= 0, y0 + 1 < sh
    zero = torch.zeros((), dtype=f64)
    w00 = torch.where(x0ok & y0ok & inside, (1 - wx) * (1 - wy), zero)
    w01 = torch.where(x1ok & y0ok & inside, wx * (1 - wy), zero)
    w10 = torch.where(x0ok & y1ok & inside, (1 - wx) * wy, zero)
    w11 = torch.where(x1ok & y1ok & inside, wx * wy, zero)
    xa, xb = x0.clamp(0, sw - 1), (x0 + 1).clamp(0, sw - 1)
    ya, yb = y0.clamp(0, sh - 1), (y0 + 1).clamp(0, sh - 1)
    src = torch.from_numpy(img).reshape(sh * sw, c)
    pick = lambda yy, xx: src[(yy * sw + xx).reshape(-1)].reshape(h, w, c).to(f64)
    out = (w00[..., None] * pick(ya, xa) + w01[..., None] * pick(ya, xb)
           + w10[..., None] * pick(yb, xa) + w11[..., None] * pick(yb, xb))
    return out.to(torch.float32).numpy()


def remap_linear(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """`cv2.remap(src, map_x, map_y, cv2.INTER_LINEAR)` of a float32 (H, W)
    image with float32 maps (border constant 0), as OpenCV 5 computes it:
    no 1/32 px quantisation of the coordinates (that of OpenCV 4's fixed-point
    tables); a = x - floor(x) and b = y - floor(y) in float32, each tap
    outside the image reads 0, and the two row lerps and the column lerp are
    each one fused multiply-add, fma(a, p01 - p00, p00), rounded once to
    float32 (here from float64, where the product is exact)."""
    sh, sw = src.shape
    # two zero pixels around the image: a tap outside it reads one of them
    # once the top-left tap is clamped to [-2, size]
    img = torch.nn.functional.pad(torch.from_numpy(np.ascontiguousarray(src, np.float32)),
                                  (2, 2, 2, 2)).reshape(-1)
    x = torch.from_numpy(np.ascontiguousarray(map_x, np.float32))
    y = torch.from_numpy(np.ascontiguousarray(map_y, np.float32))
    fx, fy = torch.floor(x), torch.floor(y)
    a, b = (x - fx).double(), (y - fy).double()
    pw = sw + 4
    base = ((fy.clamp(-2, sh) + 2) * pw + fx.clamp(-2, sw) + 2).to(torch.int64).reshape(-1)
    tap = lambda off: img[base + off].reshape(x.shape)
    fma = lambda w, p, q: (w * (q - p).double() + p.double()).float()
    p00, p01, p10, p11 = tap(0), tap(1), tap(pw), tap(pw + 1)
    return fma(b, fma(a, p00, p01), fma(a, p10, p11)).numpy()


__all__ = ["gaussian_kernel", "gaussian_blur", "filter2d", "sep_filter", "resize_cubic",
           "fill_poly", "fill_ellipse", "ellipse_poly", "clip_line", "warp_perspective",
           "remap_linear"]
