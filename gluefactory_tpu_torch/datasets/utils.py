"""Image reading and preprocessing on the host (counterpart of
gluefactory_tpu/datasets/utils.py, without cv2).

`read_image` dispatches on the file's magic number: binary 8-bit PPM / PGM
(P6 / P5, the format of the HPatches release) read with numpy, baseline
JPEG and PNG through the port's own decoders (`image_codecs`, the loops in
`csrc/image_decode.cpp`), which give what `cv2.imread` gives bit for bit.
PPM colour to grey is OpenCV's fixed-point conversion
(Y = (4899 R + 9617 G + 1868 B + 2^13) >> 14); a colour JPEG's grey is its Y
plane and a colour PNG's libpng's, as cv2 reads them. Other formats, and
the JPEG / PNG variants `image_codecs` lists, raise and name what they met.
`read_image_anydepth` keeps 16 bits of a PNG (cv2's IMREAD_ANYDEPTH).

`resize_image` computes "area" resampling, the preprocessing's default,
as OpenCV's INTER_AREA does: each output pixel is the mean of the input over
its footprint, weighted by the overlap of pixel areas, which averages when
shrinking and interpolates between the two nearest pixels when enlarging.
The weights are one matrix an axis and the resize two products (float32).
"nearest" is OpenCV's INTER_NEAREST: source index floor(x / (dst / src)) in
double precision, clamped to the last pixel. "linear" and "cubic" are
INTER_LINEAR and INTER_CUBIC through `image_ops` (linear bit for bit, cubic
within a few float32 ulps).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..utils.config import Config, merge
from . import image_ops
from .image_codecs import JPEG_MAGIC, PNG_MAGIC, decode_jpeg, decode_png, jpeg_size, png_size

_MAGIC = {b"GIF8": "GIF", b"II*\x00": "TIFF", b"MM\x00*": "TIFF", b"BM": "BMP", b"RIFF": "WebP"}


def _pnm_header(data: bytes, path: Path):
    """(width, height, channels, offset of the pixels) of binary PGM / PPM
    bytes; raises on any other format."""
    for magic, fmt in _MAGIC.items():
        if data.startswith(magic):
            raise ValueError(f"{path}: {fmt} images are not supported (PPM/PGM, JPEG and PNG)")
    if data[:2] not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PPM/PGM, JPEG or PNG file (magic {data[:2]!r})")
    fields, pos = [], 2
    while len(fields) < 3:  # width, height, maxval; '#' starts a comment
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end == len(data):
            raise ValueError(f"{path}: truncated PPM/PGM header")
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError(f"{path}: 16-bit PPM/PGM is not supported")
    return w, h, 3 if data[:2] == b"P6" else 1, pos + 1


def _read_pnm(data: bytes, path: Path) -> np.ndarray:
    """(H, W, C) uint8 of a binary PGM (C = 1) or PPM (C = 3)."""
    w, h, c, offset = _pnm_header(data, path)
    return np.frombuffer(data, np.uint8, count=h * w * c, offset=offset).reshape(h, w, c)


def _size(head: bytes, path: Path) -> tuple[int, int]:
    if head.startswith(JPEG_MAGIC):
        return jpeg_size(head, path)
    if head.startswith(PNG_MAGIC):
        return png_size(head, path)
    w, h, _, _ = _pnm_header(head, path)
    return h, w


def read_image_size(path: str | Path) -> tuple[int, int]:
    """(H, W) of a PPM / PGM, JPEG or PNG from its headers (a JPEG's or
    PNG's Exif orientation applied, as `read_image` applies it), without
    decoding the pixels."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(65536)
    try:
        return _size(head, path)
    except (ValueError, IndexError):  # headers longer than the first 64 KiB, or a bad file
        return _size(path.read_bytes(), path)


def _decode(data: bytes, path: Path, grayscale: bool) -> np.ndarray:
    """(H, W, C) uint8 as cv2.imread gives it (RGB), C = 1 or 3."""
    if data.startswith(JPEG_MAGIC):
        img = decode_jpeg(data, grayscale, path)
        return img[..., None] if grayscale else img
    if data.startswith(PNG_MAGIC):
        img = decode_png(data, "grey" if grayscale else "color", path)
        return img[..., None] if grayscale else img
    img = _read_pnm(data, path)
    if grayscale and img.shape[-1] == 3:
        rgb = img.astype(np.int32)
        y = (rgb[..., 0] * 4899 + rgb[..., 1] * 9617 + rgb[..., 2] * 1868 + (1 << 13)) >> 14
        img = y.astype(np.uint8)[..., None]
    elif not grayscale and img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def read_image(path: str | Path, grayscale: bool = False) -> np.ndarray | None:
    """Read an image into float32 [0, 1], (H, W, 1) grey or (H, W, 3) RGB;
    None if the file does not exist."""
    path = Path(path)
    if not path.is_file():
        return None
    return _decode(path.read_bytes(), path, grayscale).astype(np.float32) / 255.0


def read_image_anydepth(path: str | Path) -> np.ndarray | None:
    """A single-channel image at its own depth, (H, W) uint16 for a 16-bit
    PNG, else uint8, as cv2.imread with IMREAD_ANYDEPTH gives it; None if
    the file does not exist."""
    path = Path(path)
    if not path.is_file():
        return None
    data = path.read_bytes()
    if data.startswith(PNG_MAGIC):
        return decode_png(data, "anydepth", path)
    return _decode(data, path, True)[..., 0]


def area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of area resampling: the overlap of output pixel
    i's footprint [i s, (i + 1) s), s = n_in / n_out, with input pixel j, over s."""
    s = n_in / n_out
    lo = np.arange(n_out, dtype=np.float64)[:, None] * s
    j = np.arange(n_in, dtype=np.float64)[None]
    return np.clip(np.minimum(lo + s, j + 1) - np.maximum(lo, j), 0.0, None) / s


def resized_shape(h: int, w: int, size, fn: str = "max") -> tuple[int, int]:
    """(H', W') of `resize_image` for an (h, w) image."""
    if isinstance(size, int):
        scale = size / (max(h, w) if fn == "max" else min(h, w))
        return int(round(h * scale)), int(round(w * scale))
    w_new, h_new = size
    return h_new, w_new


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each of n_out pixels under OpenCV's INTER_NEAREST:
    floor(i * (1 / (n_out / n_in))) in double precision, at most n_in - 1."""
    inv = 1.0 / (n_out / n_in)
    return np.minimum(np.floor(np.arange(n_out, dtype=np.float64) * inv).astype(np.int64),
                      n_in - 1)


def resize_image(img: np.ndarray, size, fn: str = "max", interp: str = "area"):
    """Resize so that fn(h, w) == size (an int) keeping the aspect, or to
    size = (w, h); returns (img (H', W'[, C]) float32, scales = new / old
    (x, y)). "area", "linear" and "cubic" keep a channel axis (add one to a
    2-D image, as the JAX function does); "nearest" keeps the input's dims
    and dtype, as cv2 does. "linear" is `image_ops.resize_linear` (cv2's
    bit for bit), "cubic" `image_ops.resize_cubic`, a channel at a time."""
    if interp not in ("area", "nearest", "linear", "cubic"):
        raise ValueError(f"unknown interpolation {interp!r} (area, nearest, linear, cubic)")
    h, w = img.shape[:2]
    h_new, w_new = resized_shape(h, w, size, fn)
    scales = np.array([w_new / w, h_new / h], np.float32)
    if interp == "nearest":
        out = np.asarray(img)[nearest_index(h, h_new)][:, nearest_index(w, w_new)]
        return np.ascontiguousarray(out), scales
    if interp in ("linear", "cubic"):
        fn_ = image_ops.resize_linear if interp == "linear" else image_ops.resize_cubic
        x = np.asarray(img, np.float32)
        x = x[..., None] if x.ndim == 2 else x
        out = np.stack([fn_(x[..., c], (w_new, h_new)) for c in range(x.shape[-1])], -1)
        return out, scales
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    if x.ndim == 2:
        x = x[..., None]
    if (h_new, w_new) == (h, w):
        out = x.clone()
    else:
        wy = torch.from_numpy(area_weights(h, h_new).astype(np.float32))
        wx = torch.from_numpy(area_weights(w, w_new).astype(np.float32))
        out = torch.einsum("xj,yjc->yxc", wx, torch.tensordot(wy, x, dims=([1], [0])))
    return out.contiguous().numpy(), scales


class ImagePreprocessor:
    """Resize and optional zero pad, with metadata.

    Output: image (H', W', C), image_size (w, h) of the valid region, scales
    (2,) = processed / original size (x, y): divide processed coordinates by
    them to get back to the original frame. `pad_to` pads (and crops) to a
    fixed (w, h) box; `square_pad` pads the bottom and right to a square of
    side max(h', w'), so that views of either orientation batch together
    (with `resize: R` on the long side, the box [R, R]). The JAX package's
    preprocessor documents `square_pad` but ignores it, which leaves a
    MegaDepth batch of mixed orientations unstackable (ROADMAP Queue 3a).
    """

    default_conf = {
        "resize": None,  # int or (w, h)
        "side": "long",  # "long" | "short" when resize is an int
        "interpolation": "area",
        "pad_to": None,  # (w, h) static output box
        "square_pad": False,  # pad to a square of the longer side (unless pad_to)
        "grayscale": False,
    }

    def __init__(self, conf=None):
        self.conf = Config(merge(self.default_conf, conf or {}))

    def _resize_args(self):
        conf = self.conf
        size = conf.resize if isinstance(conf.resize, int) else tuple(conf.resize)
        return size, "max" if conf.side == "long" else "min"

    def metadata(self, h: int, w: int) -> dict:
        """`image_size` and `scales` of the output for an (h, w) input,
        without the image."""
        if self.conf.resize is None:
            h_new, w_new = h, w
        else:
            h_new, w_new = resized_shape(h, w, *self._resize_args())
        return {"image_size": np.array([w_new, h_new], np.float32),
                "scales": np.array([w_new / w, h_new / h], np.float32)}

    def __call__(self, img: np.ndarray) -> dict:
        conf = self.conf
        scales = np.array([1.0, 1.0], np.float32)
        if conf.grayscale and img.shape[-1] == 3:
            img = (img * np.array([0.299, 0.587, 0.114], np.float32)).sum(-1, keepdims=True)
        if conf.resize is not None:
            size, fn = self._resize_args()
            img, scales = resize_image(img, size, fn=fn, interp=conf.interpolation)
        h, w = img.shape[:2]
        out = {
            "image": img.astype(np.float32),
            "image_size": np.array([w, h], np.float32),
            "scales": scales,
        }
        box = conf.pad_to
        if box is None and conf.square_pad:
            box = (max(h, w), max(h, w))
        if box is not None:
            tw, th = box
            padded = np.zeros((th, tw, img.shape[-1]), np.float32)
            padded[: min(h, th), : min(w, tw)] = img[: min(h, th), : min(w, tw)]
            out["image"] = padded
        return out


def scale_homography(H: np.ndarray, scales0, scales1) -> np.ndarray:
    """A homography between the resized views: x1' = S1 H S0^-1 x0'."""
    S0 = np.diag([scales0[0], scales0[1], 1.0])
    S1 = np.diag([scales1[0], scales1[1], 1.0])
    return (S1 @ H @ np.linalg.inv(S0)).astype(np.float32)


def scale_intrinsics(K: np.ndarray, scales) -> np.ndarray:
    """A calibration matrix after an image resize."""
    return (np.diag([scales[0], scales[1], 1.0]) @ K).astype(np.float32)


__all__ = [
    "read_image", "read_image_size", "read_image_anydepth", "area_weights", "nearest_index",
    "resized_shape", "resize_image",
    "ImagePreprocessor",
    "scale_homography", "scale_intrinsics",
]
