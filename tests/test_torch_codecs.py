"""The port's JPEG and PNG decoders (`datasets/image_codecs.py`,
`csrc/image_decode.cpp`) and its reader and resizes against cv2 and the JAX
package on the CPU.

Bars: bit for bit. `read_image` equals the JAX package's (`cv2.imread`) in
colour and grey on a seeded corpus: JPEG at quality 50 / 75 / 95 / 100 in
4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, grey JPEGs, restart intervals,
optimised Huffman tables, sizes down to 1 x 1 and 17 x 33, every Exif
orientation; PNG at 8 and 16 bits, grey / grey + alpha / RGB / RGBA,
written by a filter-cycling encoder here (every filter type in every file)
and by cv2. The 16-bit reader equals IMREAD_ANYDEPTH, the
header reader cv2's shapes, the nearest resize cv2's INTER_NEAREST index for
index; the area resize at ETH3D's and MegaDepth's sizes stays within
`test_area_resize_against_cv2`'s bar (mean < 1e-7, max < 1e-6). The
variants the decoders refuse raise ValueError naming the variant, and so
do malformed scan headers (the C scan refuses them too). The
committed corpus of `chip_smoke.py` (tests/data/codecs) decodes to the
digests its manifest records, and those are cv2's.
"""

import hashlib
import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from gluefactory_tpu.datasets import utils as jdu
from gluefactory_tpu_torch.datasets.image_codecs import decode_jpeg, decode_png
from gluefactory_tpu_torch.datasets.utils import (
    nearest_index,
    read_image,
    read_image_anydepth,
    read_image_size,
    resize_image,
)

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "data" / "codecs"


def _texture(rng, h, w, c):
    """Smooth structure plus noise, uint8 (h, w, c)."""
    base = cv2.resize(rng.rand(max(h // 8, 1), max(w // 8, 1), c).astype(np.float32), (w, h),
                      interpolation=cv2.INTER_CUBIC).reshape(h, w, c)
    return np.clip(base * 200 + rng.rand(h, w, c) * 55, 0, 255).astype(np.uint8)


def _exif_app1(orientation: int, big_endian: bool) -> bytes:
    e = ">" if big_endian else "<"
    tiff = ((b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(e + "I", 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    return b"\xff\xe1" + struct.pack(">H", 8 + len(tiff)) + b"Exif\x00\x00" + tiff


SAMPLING = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")
            for s in ("444", "422", "420", "440", "411")}
JPEG_CASES = (
    [f"q{q}_{s}" for q in (50, 75, 95, 100) for s in ("444", "422", "420")]
    + ["q90_440", "q90_411", "grey_q90", "grey_q50", "rst1_420", "rst3_422", "rst7_444",
       "grey_rst2", "optimised_420", "optimised_grey", "optimised_rst5_422", "size1x1_420",
       "size17x33_420", "size33x17_422", "size2x5_444", "size9x255_420"]
    + [f"exif{o}_{'mm' if o % 2 else 'ii'}" for o in range(1, 9)]
)
PNG_CASES = [f"png{d}_{k}" for d in (8, 16) for k in ("grey", "ga", "rgb", "rgba")] + [
    "png8_size1x1", "png16_size17x33", "cv2png8_rgb", "cv2png16_grey"]


def _jpeg_bytes(name: str, rng) -> bytes:
    h, w = 61, 97
    if name.startswith("size"):
        h, w = (int(v) for v in name.split("_")[0][4:].split("x"))
    grey = "grey" in name
    img = _texture(rng, h, w, 1 if grey else 3)
    img = img[..., 0] if grey else img
    params = []
    for part in name.split("_"):
        if part.startswith("q"):
            params += [cv2.IMWRITE_JPEG_QUALITY, int(part[1:])]
        elif part in SAMPLING:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[part]]
        elif part.startswith("rst"):
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(part[3:])]
        elif part == "optimised":
            params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    ok, enc = cv2.imencode(".jpg", img, params)
    data = enc.tobytes()
    if name.startswith("exif"):
        data = data[:2] + _exif_app1(int(name[4]), name.endswith("mm")) + data[2:]
    return data


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_row(row, prev, bpp, f):
    r, p = row.astype(np.int64), prev.astype(np.int64)
    a = np.r_[np.zeros(bpp, np.int64), r[:-bpp]]
    c = np.r_[np.zeros(bpp, np.int64), p[:-bpp]]
    if f == 1:
        r = r - a
    elif f == 2:
        r = r - p
    elif f == 3:
        r = r - (a + p) // 2
    elif f == 4:
        q = a + p - c
        pa, pb, pc = abs(q - a), abs(q - p), abs(q - c)
        r = r - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return (r % 256).astype(np.uint8)


def encode_png(arr, depth, ctype, palette=None, interlace=0, extra=b"") -> bytes:
    """A PNG whose rows cycle through filters 0-4."""
    h, w = arr.shape[:2]
    raw = arr.astype(">u2" if depth == 16 else np.uint8).tobytes()
    rows = np.frombuffer(raw, np.uint8).reshape(h, -1)
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8)
    body, prev = b"", np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        body += bytes([y % 5]) + _filter_row(rows[y], prev, bpp, y % 5).tobytes()
        prev = rows[y]
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return out + extra + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b"")


def _png_bytes(name: str, rng) -> bytes:
    h, w = (1, 1) if "1x1" in name else (17, 33) if "17x33" in name else (29, 40)
    depth = 16 if name.startswith(("png16", "cv2png16")) else 8
    top = 65536 if depth == 16 else 256
    if name.startswith("cv2png"):
        arr = (rng.rand(h, w, 3) * top).astype(np.uint16 if depth == 16 else np.uint8)
        ok, enc = cv2.imencode(".png", arr[..., 0] if "grey" in name else arr)
        return enc.tobytes()
    kind = name.split("_")[1]
    ctype, ch = {"grey": (0, 1), "ga": (4, 2), "rgb": (2, 3), "rgba": (6, 4)}.get(kind, (2, 3))
    arr = (rng.rand(h, w, ch) * top).astype(np.int64)
    if ch >= 3:  # some grey pixels, which libpng's colour-to-grey passes through
        arr[::3, ::2, 1] = arr[::3, ::2, 0]
        arr[::3, ::2, 2] = arr[::3, ::2, 0]
    return encode_png(arr, depth, ctype)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("codecs")
    files = {}
    for i, name in enumerate(JPEG_CASES + PNG_CASES):
        rng = np.random.RandomState(100 + i)
        data = _jpeg_bytes(name, rng) if name in JPEG_CASES else _png_bytes(name, rng)
        path = root / (name + (".jpg" if name in JPEG_CASES else ".png"))
        path.write_bytes(data)
        files[name] = path
    return files


def _cv2(path, grey):
    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if grey else cv2.IMREAD_COLOR)
    return img if grey else img[..., ::-1]


@pytest.mark.parametrize("name", JPEG_CASES + PNG_CASES)
def test_read_image_equals_cv2(corpus, name):
    path = corpus[name]
    decode = decode_jpeg if name in JPEG_CASES else (
        lambda d, g: decode_png(d, "grey" if g else "color"))
    for grey in (False, True):
        ref = _cv2(path, grey)
        np.testing.assert_array_equal(decode(path.read_bytes(), grey), ref)
        out, jax_out = read_image(path, grey), jdu.read_image(path, grey)
        assert out.dtype == jax_out.dtype == np.float32
        np.testing.assert_array_equal(out, jax_out)
    assert read_image_size(path) == ref.shape[:2]


@pytest.mark.parametrize("name", [n for n in PNG_CASES if "16" in n or "grey" in n])
def test_anydepth_equals_cv2(corpus, name):
    ref = cv2.imread(str(corpus[name]), cv2.IMREAD_ANYDEPTH)
    out = read_image_anydepth(corpus[name])
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_corpus_uses_every_filter_and_variant(corpus):
    """The encoder cycles filters 0-4 (a file of 29 rows holds each), and
    the JPEG cases do carry what their names say."""
    data = zlib.decompress(corpus["png8_rgb"].read_bytes().split(b"IDAT")[1][:-4])
    assert {data[y * (40 * 3 + 1)] for y in range(29)} == {0, 1, 2, 3, 4}
    rst = corpus["rst3_422"].read_bytes()
    assert b"\xff\xdd" in rst and b"\xff\xd0" in rst and b"\xff\xd1" in rst
    plain, opt = (corpus[n].read_bytes() for n in ("q75_420", "optimised_420"))
    dht = lambda d: d[d.index(b"\xff\xc4"):][:200]  # noqa: E731
    assert dht(plain) != dht(opt)
    for o in range(1, 9):
        assert cv2.imread(str(corpus[f"exif{o}_{'mm' if o % 2 else 'ii'}"])).shape[:2] == (
            (97, 61) if o >= 5 else (61, 97))


REFUSED = {
    "progressive": "progressive", "sof3": "lossless", "sof9": "arithmetic",
    "precision12": "12-bit", "cmyk": "CMYK", "adobe_rgb": "RGB-coded", "truncated": "truncated",
    "interlaced_png": "interlaced", "png4bit": "4 bits", "png_crc": "CRC", "gif": "GIF",
    "png_palette": "palette", "sos_ns5": "scan header names 5 components",
    "sos_repeat": "repeated component",
}


@pytest.mark.parametrize("variant", sorted(REFUSED))
def test_refused_variants_raise_naming_them(tmp_path, variant):
    rng = np.random.RandomState(7)
    img = _texture(rng, 24, 40, 3)
    base = cv2.imencode(".jpg", img)[1].tobytes()
    sof = base.index(b"\xff\xc0")
    if variant == "progressive":
        data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    elif variant in ("sof3", "sof9"):
        data = base[:sof + 1] + bytes([0xC3 if variant == "sof3" else 0xC9]) + base[sof + 2:]
    elif variant == "precision12":
        data = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    elif variant == "cmyk":
        ok, enc = cv2.imencode(".jpg", img)
        data = enc.tobytes()
        n = data[sof + 9]
        assert n == 3
        comp = data[sof + 10:sof + 13]
        length = struct.unpack(">H", data[sof + 2:sof + 4])[0] + 3
        data = (data[:sof + 2] + struct.pack(">H", length) + data[sof + 4:sof + 9] + b"\x04"
                + data[sof + 10:sof + 19] + bytes([4]) + comp[1:] + data[sof + 19:])
    elif variant == "adobe_rgb":
        app14 = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + b"\x00\x64\x00\x00\x00\x00\x00"
        data = base[:2] + app14 + base[2:].replace(b"JFIF\x00", b"JFXX\x00", 1)
    elif variant == "truncated":
        data = base[: len(base) // 2]
    elif variant == "interlaced_png":
        data = encode_png(img.astype(np.int64), 8, 2, interlace=1)
    elif variant == "png4bit":
        data = encode_png(np.zeros((4, 4, 1), np.int64), 8, 0)
        data = data[:24] + b"\x04" + data[25:]
    elif variant == "png_palette":
        idx = (rng.rand(24, 40, 1) * 16).astype(np.int64)
        data = encode_png(idx, 8, 3, palette=(rng.rand(16, 3) * 256).astype(np.uint8))
    elif variant in ("sos_ns5", "sos_repeat"):
        sos = base.index(b"\xff\xda")
        assert base[sos + 4] == 3
        comps = base[sos + 5:sos + 11]
        if variant == "sos_ns5":  # component 1 five times: past libjpeg's 4 a scan
            head = b"\x05" + comps[:2] * 5
        else:
            head = b"\x03" + comps[:2] + comps[:2] + comps[4:]
        head += base[sos + 11:sos + 14]
        data = base[:sos + 2] + struct.pack(">H", 2 + len(head)) + head + base[sos + 14:]
    elif variant == "png_crc":
        data = bytearray(encode_png(img.astype(np.int64), 8, 2))
        data[-20] ^= 1
        data = bytes(data)
    else:
        data = b"GIF89a" + bytes(20)
    path = tmp_path / "x.img"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=REFUSED[variant]):
        read_image(path)


@pytest.mark.parametrize("ncomp,table", [(0, 0), (5, 0), (1, 4), (1, -1)])
def test_scan_refuses_bad_component_count_or_table(ncomp, table):
    """The C scan itself refuses a scan of other than 1 to 4 components and
    a table id outside 0-3, before it reads a byte of the data."""
    import ctypes

    from gluefactory_tpu_torch._ext import load_host

    lib = load_host("image_decode")
    data = np.zeros(64, np.uint8)
    comp = np.tile(np.array([1, 1, 1, 1, 1, table, 0], np.int32), 5)
    coef = np.zeros((5, 64), np.int16)
    ptrs = (ctypes.c_void_p * 5)(*[coef[i].ctypes.data for i in range(5)])
    huff, present = np.zeros((8, 272), np.uint8), np.zeros(8, np.uint8)
    end = ctypes.c_int64(-1)
    rc = lib.gf_jpeg_scan(data.ctypes.data, data.size, ncomp, comp.ctypes.data, ptrs,
                          huff.ctypes.data, present.ctypes.data, 1, 1, 0, ctypes.byref(end))
    assert rc == -7 and end.value == -1 and not coef.any()


@pytest.mark.parametrize("sizes", [(4032, 6048, 504, 756), (1200, 1600, 1600, 2133),
                                   (97, 131, 40, 55), (1, 1, 5, 3)])
def test_nearest_resize_equals_cv2(sizes):
    h, w, nh, nw = sizes
    x = np.random.RandomState(3).rand(h, w).astype(np.float32)
    out, scales = resize_image(x, (nw, nh), interp="nearest")
    ref = cv2.resize(x, (nw, nh), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(scales, np.array([nw / w, nh / h], np.float32))


def test_nearest_index_map_equals_cv2():
    for n_in in list(range(1, 70)) + [504, 756, 1008, 4032, 6048]:
        for n_out in list(range(1, 70)) + [504, 756]:
            ref = cv2.resize(np.arange(n_in, dtype=np.float32)[None].repeat(2, 0), (n_out, 2),
                             interpolation=cv2.INTER_NEAREST)[0]
            np.testing.assert_array_equal(nearest_index(n_in, n_out), ref.astype(np.int64))


@pytest.mark.parametrize("shape,size", [((4032, 6048), 756), ((1200, 1600), 1600),
                                        ((900, 1200), 1600)])
def test_area_resize_at_benchmark_sizes(shape, size):
    img = np.random.RandomState(5).rand(*shape, 1).astype(np.float32)
    out, scales = resize_image(img, size, fn="max")
    ref, ref_scales = jdu.resize_image(img, size, fn="max")
    assert out.shape == ref.shape
    np.testing.assert_array_equal(scales, ref_scales)
    diff = np.abs(out - ref)
    assert diff.mean() < 1e-7 and diff.max() < 1e-6, (diff.mean(), diff.max())


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("interp", ["linear", "cubic"])
@pytest.mark.parametrize("shape,size", [((480, 640, 1), 320), ((120, 160, 3), (64, 48)),
                                        ((97, 131), 55), ((30, 40, 1), (120, 160)),
                                        ((1200, 1600, 1), 1200)])
def test_linear_and_cubic_resize_against_cv2(interp, shape, size):
    """INTER_LINEAR to cv2's digest; INTER_CUBIC within 4 float32 ulps of 1
    (OpenCV 5's order of float32 operations in its cubic pass is not
    repeated); shapes and scales as the JAX function's."""
    img = np.random.RandomState(9).rand(*shape).astype(np.float32)
    out, scales = resize_image(img, size, interp=interp)
    ref, ref_scales = jdu.resize_image(img, size, interp=interp)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_array_equal(scales, ref_scales)
    if interp == "linear":
        assert _digest(out) == _digest(ref)
    else:
        diff = np.abs(out - ref)
        assert diff.max() <= 4 * 2.0**-23 and diff.mean() < 1e-7, (diff.max(), diff.mean())


def test_committed_corpus_decodes_to_its_manifest():
    manifest = json.loads((CORPUS / "manifest.json").read_text())
    assert sum(p.stat().st_size for p in CORPUS.iterdir()) <= 1.5 * 2**20
    for name, entry in manifest["files"].items():
        path = CORPUS / name
        flags = {"color": cv2.IMREAD_COLOR, "grey": cv2.IMREAD_GRAYSCALE,
                 "anydepth": cv2.IMREAD_ANYDEPTH}
        for mode, want in entry["decoded"].items():
            ref = cv2.imread(str(path), flags[mode])
            ref = ref[..., ::-1] if mode == "color" else ref
            assert list(ref.shape) == want["shape"] and _digest(ref) == want["sha256"], (name, mode)
            if mode == "anydepth":
                out = read_image_anydepth(path)
            else:
                out = (read_image(path, mode == "grey") * 255).round().astype(np.uint8)
                out = out[..., 0] if mode == "grey" else out
            assert _digest(out) == want["sha256"], (name, mode)
