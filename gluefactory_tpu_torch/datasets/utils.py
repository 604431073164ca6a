"""Image reading and preprocessing on the host (counterpart of
gluefactory_tpu/datasets/utils.py, without cv2).

`read_image` reads binary 8-bit PPM / PGM (P6 / P5), the format of the
HPatches release, with numpy; colour to grey is OpenCV's fixed-point
conversion (Y = (4899 R + 9617 G + 1868 B + 2^13) >> 14), so both read the
same values. Other formats raise and name the format.

`resize_image` computes "area" resampling, the preprocessing's only mode,
as OpenCV's INTER_AREA does: each output pixel is the mean of the input over
its footprint, weighted by the overlap of pixel areas, which averages when
shrinking and interpolates between the two nearest pixels when enlarging.
The weights are one matrix an axis and the resize two products (float32).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..utils.config import Config, merge

_MAGIC = {b"\x89PNG": "PNG", b"\xff\xd8\xff": "JPEG", b"GIF8": "GIF", b"II*\x00": "TIFF",
          b"MM\x00*": "TIFF", b"BM": "BMP", b"RIFF": "WebP"}


def _pnm_header(data: bytes, path: Path):
    """(width, height, channels, offset of the pixels) of binary PGM / PPM
    bytes; raises on any other format."""
    for magic, fmt in _MAGIC.items():
        if data.startswith(magic):
            raise ValueError(f"{path}: {fmt} images are not supported (binary PPM/PGM only)")
    if data[:2] not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PPM/PGM file (magic {data[:2]!r})")
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


def _read_pnm(path: Path) -> np.ndarray:
    """(H, W, C) uint8 of a binary PGM (C = 1) or PPM (C = 3)."""
    data = path.read_bytes()
    w, h, c, offset = _pnm_header(data, path)
    return np.frombuffer(data, np.uint8, count=h * w * c, offset=offset).reshape(h, w, c)


def read_image_size(path: str | Path) -> tuple[int, int]:
    """(H, W) of a binary PPM / PGM from its header, without reading the pixels."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(4096)
    try:
        w, h, _, _ = _pnm_header(head, path)
    except ValueError:  # a header longer than the first 4 KiB, or a bad file
        w, h, _, _ = _pnm_header(path.read_bytes(), path)
    return h, w


def read_image(path: str | Path, grayscale: bool = False) -> np.ndarray | None:
    """Read an image into float32 [0, 1], (H, W, 1) grey or (H, W, 3) RGB;
    None if the file does not exist."""
    path = Path(path)
    if not path.is_file():
        return None
    img = _read_pnm(path)
    if grayscale and img.shape[-1] == 3:
        rgb = img.astype(np.int32)
        y = (rgb[..., 0] * 4899 + rgb[..., 1] * 9617 + rgb[..., 2] * 1868 + (1 << 13)) >> 14
        img = y.astype(np.uint8)[..., None]
    elif not grayscale and img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(np.float32) / 255.0


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


def resize_image(img: np.ndarray, size, fn: str = "max", interp: str = "area"):
    """Resize so that fn(h, w) == size (an int) keeping the aspect, or to
    size = (w, h); returns (img (H', W', C) float32, scales = new / old (x, y))."""
    if interp != "area":
        raise ValueError(f"interpolation {interp!r} is not ported (area only)")
    h, w = img.shape[:2]
    h_new, w_new = resized_shape(h, w, size, fn)
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    if x.ndim == 2:
        x = x[..., None]
    if (h_new, w_new) == (h, w):
        out = x.clone()
    else:
        wy = torch.from_numpy(area_weights(h, h_new).astype(np.float32))
        wx = torch.from_numpy(area_weights(w, w_new).astype(np.float32))
        out = torch.einsum("xj,yjc->yxc", wx, torch.tensordot(wy, x, dims=([1], [0])))
    scales = np.array([w_new / w, h_new / h], np.float32)
    return out.contiguous().numpy(), scales


class ImagePreprocessor:
    """Resize and optional zero pad to a fixed (w, h) box, with metadata.

    Output: image (H', W', C), image_size (w, h) of the valid region, scales
    (2,) = processed / original size (x, y): divide processed coordinates by
    them to get back to the original frame.
    """

    default_conf = {
        "resize": None,  # int or (w, h)
        "side": "long",  # "long" | "short" when resize is an int
        "interpolation": "area",
        "pad_to": None,  # (w, h) static output box
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
        if conf.pad_to is not None:
            tw, th = conf.pad_to
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
    "read_image", "read_image_size", "area_weights", "resized_shape", "resize_image",
    "ImagePreprocessor",
    "scale_homography", "scale_intrinsics",
]
