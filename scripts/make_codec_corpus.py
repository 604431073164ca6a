"""Write the image corpus that `chip_smoke.py` phase 15 decodes on the card's
host, and its manifest, into tests/data/codecs/ (needs cv2; run from the
repository root):

    python scripts/make_codec_corpus.py

Files (all cv2-encoded, seeded):
- md_pair0_a.jpg, md_pair0_b.jpg: 1600 x 1200, 4:2:0, quality 85, a view
  pair of the port's synthetic two-view renderer (test item 0 at 1600 x
  1200, tinted to colour), the first pair of phase 15's MegaDepth-1500 tree;
  its calibrations and relative pose go into the manifest;
- grey.jpg: 480 x 640 grey;
- rst_422.jpg: 480 x 640, 4:2:2, a restart marker every 4 MCUs, optimised
  Huffman tables;
- rgb8.png: 240 x 320 8-bit RGB; depth16.png: 240 x 320 16-bit grey.

manifest.json holds, for each file and read mode ("color" as RGB, "grey",
"anydepth"), the shape and sha256 of what `cv2.imread` returns (colour
flipped to RGB): the port's decoders must give the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUT = REPO / "tests" / "data" / "codecs"


def digest(a: np.ndarray) -> dict:
    return {"shape": list(a.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}


def tinted(grey: np.ndarray, rng) -> np.ndarray:
    """A colour BGR uint8 image from a grey one in [0, 1]: a smooth tint per
    channel."""
    h, w = grey.shape[:2]
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    out = []
    for _ in range(3):
        a, b, phase = rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0), rng.uniform(0, 6.28)
        out.append(grey[..., 0] * (0.8 + 0.2 * np.sin(6.28 * (a * x + b * y) + phase)))
    return (np.clip(np.stack(out, -1), 0, 1) * 255).round().astype(np.uint8)


def main():
    from gluefactory_tpu_torch.datasets.synthetic_two_view import SyntheticTwoViewDataset

    OUT.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    item = SyntheticTwoViewDataset({"image_size": [1600, 1200], "test_size": 1}).get_dataset(
        "test")[0]
    files = {}
    jpeg420 = [cv2.IMWRITE_JPEG_QUALITY, 85,
               cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    for v, name in ((0, "md_pair0_a.jpg"), (1, "md_pair0_b.jpg")):
        cv2.imwrite(str(OUT / name), tinted(item[f"view{v}"]["image"], rng), jpeg420)
        files[name] = ("color", "grey")
    texture = (rng.rand(60, 80).astype(np.float32))
    smooth = cv2.resize(texture, (640, 480), interpolation=cv2.INTER_CUBIC)
    grey = np.clip(smooth * 200 + rng.rand(480, 640) * 55, 0, 255).astype(np.uint8)
    cv2.imwrite(str(OUT / "grey.jpg"), grey, [cv2.IMWRITE_JPEG_QUALITY, 90])
    files["grey.jpg"] = ("color", "grey")
    colour = tinted(grey[..., None] / 255.0, rng)
    cv2.imwrite(str(OUT / "rst_422.jpg"), colour,
                [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 4,
                 cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422])
    files["rst_422.jpg"] = ("color", "grey")
    cv2.imwrite(str(OUT / "rgb8.png"), colour[::2, ::2])
    files["rgb8.png"] = ("color", "grey", "anydepth")
    depth = (cv2.resize(texture, (320, 240), interpolation=cv2.INTER_CUBIC) * 40000 + 1000)
    cv2.imwrite(str(OUT / "depth16.png"), np.clip(depth, 0, 65535).astype(np.uint16))
    files["depth16.png"] = ("color", "grey", "anydepth")

    flags = {"color": cv2.IMREAD_COLOR, "grey": cv2.IMREAD_GRAYSCALE,
             "anydepth": cv2.IMREAD_ANYDEPTH}
    manifest = {"files": {}}
    for name, modes in files.items():
        decoded = {}
        for mode in modes:
            img = cv2.imread(str(OUT / name), flags[mode])
            decoded[mode] = digest(img[..., ::-1] if mode == "color" else img)
        manifest["files"][name] = {"decoded": decoded}
    K = item["view0"]["camera"].calibration_matrix().numpy().astype(np.float64)
    T = np.eye(4)
    T[:3, :3] = item["T_0to1"].R.numpy()
    T[:3, 3] = item["T_0to1"].t.numpy()
    manifest["megadepth_pair0"] = {"images": ["md_pair0_a.jpg", "md_pair0_b.jpg"],
                                   "K0": K.tolist(), "K1": K.tolist(), "T_0to1": T.tolist()}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    sizes = {p.name: p.stat().st_size for p in sorted(OUT.iterdir())}
    print(json.dumps(sizes), sum(sizes.values()))


if __name__ == "__main__":
    main()
