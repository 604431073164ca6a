"""JPEG and PNG decoding on the host, as `cv2.imread` decodes them (OpenCV 5
with its bundled libjpeg-turbo 3.1 and libpng), without cv2.

This module parses the containers and hands the entropy-coded data and the
scanlines to `csrc/image_decode.cpp` (built by the host C++ compiler at
first use, `_ext.load_host`):

- JPEG: the markers SOI, DQT, SOF0 / SOF1 (8-bit), DHT, DRI, SOS, EOI, APPn
  and COM; sequential Huffman scans, interleaved or not, with restart
  intervals; any integral sampling factors (fancy upsampling where libjpeg
  uses it); grey or YCbCr. APP1 Exif's orientation is applied as
  `cv2.imread` applies it by default.
- PNG: the chunks IHDR, PLTE, IDAT (inflated by `zlib`), eXIf and IEND, each
  CRC checked (PLTE's suggested palette of a truecolour image is ignored);
  8- and 16-bit grey, grey + alpha, RGB and RGBA; filters 0-4.

These raise `ValueError` and name what they met, on purpose (neither
benchmark uses them): progressive, lossless, hierarchical and
arithmetic-coded JPEG, 12-bit samples, RGB-coded and CMYK / YCCK JPEG
(Adobe transforms), a scan cut short, interlaced (Adam7) PNG, palette
(colour type 3) PNG, PNG below 8 bits a sample, and an unknown critical PNG
chunk.

Outputs are uint8 arrays: (H, W, 3) RGB or (H, W) grey, as cv2's
IMREAD_COLOR (flipped to RGB) and IMREAD_GRAYSCALE give them; `decode_png`
also keeps 16 bits of a grey result, as IMREAD_ANYDEPTH does. cv2's
conversions are kept: 16 bits to 8 by the high byte, alpha dropped, colour
to grey for PNG by libpng's (9797 R + 19234 G + 3737 B) >> 15 (rounded at
16 bits), and for JPEG the Y plane itself.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from .._ext import load_host

JPEG_MAGIC = b"\xff\xd8\xff"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

_SOF_REFUSED = {
    0xC2: "progressive JPEG", 0xC3: "lossless JPEG", 0xC5: "hierarchical JPEG",
    0xC6: "hierarchical JPEG", 0xC7: "lossless JPEG", 0xC9: "arithmetic-coded JPEG",
    0xCA: "progressive arithmetic-coded JPEG", 0xCB: "lossless arithmetic-coded JPEG",
    0xCD: "hierarchical arithmetic-coded JPEG", 0xCE: "hierarchical arithmetic-coded JPEG",
    0xCF: "lossless arithmetic-coded JPEG",
}
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_SCAN_ERRORS = {-1: "a bad Huffman code", -2: "a scan without its Huffman table",
                -3: "a missing restart marker", -4: "a scan cut short (truncated data)",
                -7: "a scan of other than 1 to 4 components, or a table id above 3",
                -10: "a bad Huffman table", -11: "a bad Huffman table"}


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check(rc: int, what: str, path) -> None:
    if rc != 0:
        raise ValueError(f"{path}: {what} ({_SCAN_ERRORS.get(rc, f'error {rc}')})")


# ---------------------------------------------------------------------------
# Exif orientation (APP1 in JPEG, eXIf in PNG), as cv2.imread applies it
# ---------------------------------------------------------------------------


def exif_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of a TIFF-structured Exif block;
    1 when there is none or the block is malformed."""
    if len(tiff) < 8 or tiff[:4] not in (b"II*\x00", b"MM\x00*"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack_from(e + "I", tiff, 4)
        (n,) = struct.unpack_from(e + "H", tiff, ifd)
        for i in range(n):
            tag, typ, count = struct.unpack_from(e + "HHI", tiff, ifd + 2 + 12 * i)
            if tag == 0x0112 and typ == 3 and count >= 1:
                (value,) = struct.unpack_from(e + "H", tiff, ifd + 2 + 12 * i + 8)
                return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation: flips and a transpose of (H, W[, C])."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    flip_x = orientation in (2, 3, 6, 7)
    flip_y = orientation in (3, 4, 7, 8)
    if flip_x:
        img = img[:, ::-1]
    if flip_y:
        img = img[::-1]
    return np.ascontiguousarray(img)


def oriented_size(h: int, w: int, orientation: int) -> tuple[int, int]:
    return (w, h) if orientation >= 5 else (h, w)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


def _segments(data: bytes, path, pos: int = 2):
    """(marker, offset of its payload, payload length) of each segment from
    `pos` (2: after SOI) to EOI; SOS's payload is its header, the scan's
    data follows it."""
    if pos == 2 and not data.startswith(b"\xff\xd8"):
        raise ValueError(f"{path}: not a JPEG file")
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # garbage between segments, skipped as libjpeg does
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{path}: JPEG data ends before EOI (truncated)")
        m = data[pos]
        pos += 1
        if m == 0x01 or 0xD0 <= m <= 0xD7:  # TEM, RSTn: no length
            continue
        if m == 0xD9:
            yield m, pos, 0
            return
        if pos + 2 > len(data):
            raise ValueError(f"{path}: JPEG data ends inside a marker (truncated)")
        (length,) = struct.unpack_from(">H", data, pos)
        if length < 2 or pos + length > len(data):
            raise ValueError(f"{path}: a JPEG segment runs past the end of the data (truncated)")
        yield m, pos + 2, length - 2
        pos += length


def _frame(data: bytes, off: int, m: int, path) -> dict:
    if m in _SOF_REFUSED:
        raise ValueError(f"{path}: {_SOF_REFUSED[m]} is not supported (baseline and "
                         "extended sequential Huffman JPEG only)")
    precision, h, w, n = struct.unpack_from(">BHHB", data, off)
    if precision != 8:
        raise ValueError(f"{path}: {precision}-bit JPEG samples are not supported (8-bit only)")
    if h == 0:
        raise ValueError(f"{path}: a JPEG height defined by DNL is not supported")
    comps = []
    for i in range(n):
        cid, hv, tq = struct.unpack_from(">BBB", data, off + 6 + 3 * i)
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
    return {"height": h, "width": w, "comps": comps}


def _jpeg_header(data: bytes, path) -> dict:
    """The frame and the markers before the first scan: {height, width,
    comps, orientation, jfif, adobe}."""
    info = {"orientation": 1, "jfif": False, "adobe": None}
    for m, off, n in _segments(data, path):
        seg = data[off:off + n]
        if m == 0xE0 and seg.startswith(b"JFIF\x00"):
            info["jfif"] = True
        elif m == 0xE1 and seg.startswith(b"Exif\x00\x00") and info["orientation"] == 1:
            info["orientation"] = exif_orientation(seg[6:])
        elif m == 0xEE and seg.startswith(b"Adobe") and n >= 12:
            info["adobe"] = seg[11]
        elif m in (0xC0, 0xC1) or m in _SOF_REFUSED:
            info.update(_frame(data, off, m, path))
        elif m == 0xDA or m == 0xD9:
            break
    if "comps" not in info:
        raise ValueError(f"{path}: JPEG without a frame header")
    return info


def jpeg_size(data: bytes, path="JPEG") -> tuple[int, int]:
    """(H, W) of a JPEG as cv2.imread returns it (Exif orientation applied),
    from its headers."""
    info = _jpeg_header(data, path)
    return oriented_size(info["height"], info["width"], info["orientation"])


def _color_space(info: dict, path) -> str:
    n = len(info["comps"])
    if n == 1:
        return "grey"
    if n != 3:
        raise ValueError(f"{path}: {n}-component (CMYK / YCCK) JPEG is not supported")
    ids = [c["id"] for c in info["comps"]]
    rgb = (not info["jfif"]
           and (info["adobe"] == 0 if info["adobe"] is not None else ids == [82, 71, 66]))
    if rgb:
        raise ValueError(f"{path}: RGB-coded JPEG (Adobe transform 0) is not supported")
    return "ycc"


def decode_jpeg(data: bytes, grayscale: bool = False, path="JPEG") -> np.ndarray:
    """uint8 (H, W, 3) RGB, or (H, W) grey with `grayscale`, as cv2.imread."""
    lib = load_host("image_decode")
    info = _jpeg_header(data, path)
    space = _color_space(info, path)
    H, W, comps = info["height"], info["width"], info["comps"]
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    if min(min(c["h"], c["v"]) for c in comps) < 1 or max(hmax, vmax) > 4:
        raise ValueError(f"{path}: bad JPEG sampling factors")
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    for c in comps:
        if hmax % c["h"] or vmax % c["v"]:
            raise ValueError(f"{path}: fractional JPEG sampling factors are not supported")
        c["coef"] = np.zeros((my * c["v"], mx * c["h"], 64), np.int16)
        c["dw"], c["dh"] = -(-W * c["h"] // hmax), -(-H * c["v"] // vmax)
        c["quant"] = None
    by_id = {c["id"]: c for c in comps}
    quant: dict = {}
    huff = np.zeros((8, 272), np.uint8)
    present = np.zeros(8, np.uint8)
    restart = 0
    pos = 2
    while pos is not None:
        resume, pos = pos, None
        for m, off, n in _segments(data, path, resume):
            if m == 0xDB:  # DQT
                q = off
                while q < off + n:
                    pq, tq = data[q] >> 4, data[q] & 15
                    size = 128 if pq else 64
                    vals = np.frombuffer(data, ">u2" if pq else np.uint8, 64, q + 1)
                    table = np.zeros(64, np.uint16)
                    table[_ZIGZAG] = vals
                    quant[tq] = table
                    q += 1 + size
            elif m == 0xC4:  # DHT
                q = off
                while q < off + n:
                    tc, th = data[q] >> 4, data[q] & 15
                    if tc > 1 or th > 3:
                        raise ValueError(f"{path}: a JPEG Huffman table of class {tc}, id {th}")
                    counts = np.frombuffer(data, np.uint8, 16, q + 1)
                    total = int(counts.sum())
                    slot = 4 * tc + th
                    huff[slot] = 0
                    huff[slot, :16] = counts
                    huff[slot, 16:16 + total] = np.frombuffer(data, np.uint8, total, q + 17)
                    present[slot] = 1
                    q += 17 + total
            elif m == 0xCC:
                raise ValueError(f"{path}: arithmetic-coded JPEG is not supported")
            elif m == 0xDD:  # DRI
                (restart,) = struct.unpack_from(">H", data, off)
            elif m == 0xDC:
                raise ValueError(f"{path}: a JPEG height defined by DNL is not supported")
            elif m == 0xDA:  # SOS
                ns = data[off]
                if not 1 <= ns <= min(4, len(comps)) or n != 4 + 2 * ns:
                    raise ValueError(f"{path}: a JPEG scan header names {ns} components (1 to "
                                     f"4 of the frame's {len(comps)}) in {n + 2} bytes")
                scan = []
                for i in range(ns):
                    cid, tables = data[off + 1 + 2 * i], data[off + 2 + 2 * i]
                    if cid not in by_id or any(c["id"] == cid for c, _, _ in scan):
                        raise ValueError(f"{path}: a JPEG scan names an unknown or repeated "
                                         "component")
                    if tables >> 4 > 3 or tables & 15 > 3:
                        raise ValueError(f"{path}: a JPEG scan names a Huffman table above 3")
                    scan.append((by_id[cid], tables >> 4, tables & 15))
                ss, se, a = data[off + 1 + 2 * ns:off + 4 + 2 * ns]
                if (ss, se, a) != (0, 63, 0):
                    raise ValueError(f"{path}: progressive JPEG is not supported")
                info_arr, ptrs = [], (ctypes.c_void_p * ns)()
                for i, (c, td, ta) in enumerate(scan):
                    if c["quant"] is None:  # libjpeg latches the table at the first scan
                        if c["tq"] not in quant:
                            raise ValueError(f"{path}: a JPEG component without its "
                                             "quantisation table")
                        c["quant"] = quant[c["tq"]].copy()
                    single = ns == 1
                    info_arr += [c["h"], c["v"], c["coef"].shape[1],
                                 -(-c["dw"] // 8) if single else mx,
                                 -(-c["dh"] // 8) if single else my, td, ta]
                    ptrs[i] = _ptr(c["coef"])
                comp_info = np.array(info_arr, np.int32)
                start = off + n
                entropy = np.frombuffer(data, np.uint8, len(data) - start, start)
                end = ctypes.c_int64(0)
                rc = lib.gf_jpeg_scan(_ptr(entropy), len(entropy), ns, _ptr(comp_info), ptrs,
                                      _ptr(huff), _ptr(present), mx, my, restart,
                                      ctypes.byref(end))
                _check(rc, "cannot decode the JPEG scan", path)
                pos = start + end.value  # the marker after the scan
                break

    want = [comps[0]] if grayscale or space == "grey" else comps
    planes = []
    for c in want:
        if c["quant"] is None:
            raise ValueError(f"{path}: a JPEG component has no scan")
        bh, bw = c["coef"].shape[:2]
        plane = np.empty((bh * 8, bw * 8), np.uint8)
        lib.gf_jpeg_idct(_ptr(c["coef"]), bw, bh, _ptr(c["quant"]), _ptr(plane))
        full = np.empty((H, W), np.uint8)
        rc = lib.gf_jpeg_upsample(_ptr(plane), bw * 8, c["dw"], c["dh"], hmax // c["h"],
                                  vmax // c["v"], _ptr(full), W, H)
        _check(rc, "cannot upsample a JPEG component", path)
        planes.append(full)
    if grayscale:
        out = planes[0]
    elif space == "grey":
        out = np.repeat(planes[0][..., None], 3, axis=-1)
    else:
        out = np.empty((H, W, 3), np.uint8)
        lib.gf_jpeg_ycc_rgb(*(_ptr(p) for p in planes), H * W, _ptr(out))
    return apply_orientation(out, info["orientation"])


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunks(data: bytes, path):
    if not data.startswith(PNG_MAGIC):
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: PNG data ends before IEND (truncated)")
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: a PNG chunk runs past the end of the data (truncated)")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: PNG chunk {kind.decode('latin-1')} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _png_ihdr(data: bytes, path) -> dict:
    if len(data) < 33 or not data.startswith(PNG_MAGIC) or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file, or truncated before IHDR")
    w, h, depth, ctype, _, _, interlace = struct.unpack_from(">IIBBBBB", data, 16)
    return {"width": w, "height": h, "depth": depth, "ctype": ctype, "interlace": interlace}


def png_size(data: bytes, path="PNG") -> tuple[int, int]:
    """(H, W) of a PNG from IHDR, oriented by an eXIf chunk before IDAT as
    cv2.imread orients it."""
    hdr = _png_ihdr(data, path)
    orientation, pos = 1, 8
    while pos + 8 <= len(data):  # chunks up to the first IDAT, CRCs unchecked
        n, kind = struct.unpack_from(">I4s", data, pos)
        if kind in (b"IDAT", b"IEND"):
            break
        if kind == b"eXIf":
            orientation = exif_orientation(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    return oriented_size(hdr["height"], hdr["width"], orientation)


def _rgb_to_grey(x: np.ndarray, depth: int) -> np.ndarray:
    """libpng's png_do_rgb_to_gray without gamma: 8-bit truncates, 16-bit
    rounds; grey pixels (R = G = B) pass through."""
    r, g, b = (x[..., i].astype(np.int64) for i in range(3))
    y = (9797 * r + 19234 * g + 3737 * b + (16384 if depth == 16 else 0)) >> 15
    y = np.where((r == g) & (r == b), r, y)
    return y.astype(x.dtype)


def decode_png(data: bytes, mode: str = "color", path="PNG") -> np.ndarray:
    """uint8 (H, W, 3) RGB with mode "color", uint8 (H, W) with "grey",
    (H, W) uint16 or uint8 (the file's depth) with "anydepth", as cv2.imread
    with IMREAD_COLOR, IMREAD_GRAYSCALE and IMREAD_ANYDEPTH."""
    lib = load_host("image_decode")
    hdr = _png_ihdr(data, path)
    w, h, depth, ctype = hdr["width"], hdr["height"], hdr["depth"], hdr["ctype"]
    if hdr["interlace"]:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if ctype == 3:
        raise ValueError(f"{path}: palette (colour type 3) PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not valid")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG at {depth} bits a sample is not supported (8 and 16 "
                         "bits)")
    idat, orientation = [], 1
    for kind, body in _png_chunks(data, path):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = exif_orientation(body)
        elif kind not in (b"IHDR", b"PLTE", b"IEND") and kind[0] < 0x61:  # unknown, critical
            raise ValueError(f"{path}: PNG chunk {kind.decode('latin-1')} is not supported")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: PNG image data does not inflate ({e})") from None
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    row_bytes = w * bpp
    if raw.size < h * (row_bytes + 1):
        raise ValueError(f"{path}: PNG image data is short (truncated)")
    rows = np.empty((h, row_bytes), np.uint8)
    rc = lib.gf_png_unfilter(_ptr(raw), h, row_bytes, bpp, _ptr(rows))
    if rc != 0:
        raise ValueError(f"{path}: a PNG scanline has an unknown filter type")
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(h, w, ch)
    colour = img.shape[-1] >= 3
    if mode == "color":
        if depth == 16:
            img = (img >> 8).astype(np.uint8)
        out = img[..., :3] if colour else np.repeat(img[..., :1], 3, axis=-1)
    else:
        grey = _rgb_to_grey(img, depth) if colour else img[..., 0]
        out = (grey >> 8).astype(np.uint8) if depth == 16 and mode == "grey" else grey
    return apply_orientation(np.ascontiguousarray(out), orientation)


__all__ = ["decode_jpeg", "decode_png", "jpeg_size", "png_size", "exif_orientation",
           "apply_orientation", "JPEG_MAGIC", "PNG_MAGIC"]
