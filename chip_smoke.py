#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SuperPoint-open + LightGlue on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel of gluefactory_tpu_torch/csrc with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, with its time, the plain version's, a library
     yardstick's and the bound the work allows;
  4. end to end: the two-view pipeline with the committed weights on a
     synthetic pair warped by a known homography, 480x640 / 1024 keypoints
     at batch 8 (launch counts, finiteness, agreement with the port's plain
     path, pairs/s, batch-1 latency, match precision), then the MegaDepth
     protocol shape 1200x1600 / 2048 keypoints at batch 4.
The last three lines of standard output are the card's name and power
limit, the kernels' JSON record and the result JSON. Without CUDA, or
without the package beside it, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12  # dense tensor-core FLOP/s, H100 SXM
PEAK_FP32 = 67e12   # FLOP/s outside the tensor cores
HBM = 3.35e12       # bytes/s
D, H, DH = 256, 4, 64
# bf16: a few ulps (both sides round at the same points; a value on a
# rounding boundary can land one ulp apart and carry on); fp32: summation order
TOL = {"bfloat16": (0.0625, 0.03), "float32": (1e-4, 1e-5)}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(out, ref, dtype_name: str, what: str) -> float:
    atol, rtol = TOL[dtype_name]
    diff = (out.float() - ref.float()).abs()
    bad = diff > atol + rtol * ref.float().abs()
    if not torch_finite(out) or bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} entries outside atol {atol} + rtol {rtol}, "
             f"max abs err {float(diff.max()):.4g}")
    return float(diff.max())


def torch_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


# ------------------------------------------------------------------ phase 3
def block_inputs(gen, s, n, masked_frac=0.2):
    import torch

    dev = "cuda"
    x = torch.randn(s, n, D, generator=gen, device=dev).bfloat16()
    ang = torch.rand(s, n, DH // 2, generator=gen, device=dev) * 6
    cos = torch.cos(ang).repeat_interleave(2, -1).bfloat16().contiguous()
    sin = torch.sin(ang).repeat_interleave(2, -1).bfloat16().contiguous()
    mask = torch.rand(s, n, generator=gen, device=dev) > masked_frac
    return x, cos, sin, mask


def block_weights(gen, cross):
    import torch

    def w(din, dout):
        return (torch.randn(din, dout, generator=gen, device="cuda") * din**-0.5).bfloat16()

    def b(k):
        return (0.1 * torch.randn(k, generator=gen, device="cuda")).bfloat16()

    pre = [w(D, D), b(D), w(D, D), b(D)] if cross else [w(D, 3 * D), b(3 * D)]
    ln = (1 + 0.1 * torch.randn(2 * D, generator=gen, device="cuda")).bfloat16()
    return pre + [w(D, D), b(D), w(2 * D, 2 * D), b(2 * D), ln, b(2 * D), w(2 * D, D), b(D)]


def check_block(kind, s, n, seed):
    """Self or cross block: kernel vs plain, masked and unmasked; times."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import lightglue_block as lb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, cos, sin, mask = block_inputs(gen, s, n)
    w = block_weights(gen, cross=kind == "cross")
    if kind == "self":
        kern = lambda m: lb.fused_self_block(x, cos, sin, mask, *w, masked=m)
        plain = lambda m: lb.self_block(x, cos, sin, mask, *w, masked=m)
        other = torch.arange(s, device="cuda")
    else:
        kern = lambda m: lb.fused_cross_block(x, mask, *w, masked=m)
        plain = lambda m: lb.cross_block(x, mask, *w, masked=m)
        other = (torch.arange(s, device="cuda") + s // 2) % s
    err = 0.0
    for m in (False, True):
        out = kern(m)
        torch.cuda.synchronize()
        err = max(err, compare(out, plain(m), "bfloat16", f"{kind} block s={s} n={n} masked={m}"))
    ms = timed(lambda: kern(True), 10)
    plain_ms = timed(lambda: plain(True), 3, warmup=1)

    # yardstick: the attention core as one scaled_dot_product_attention call
    q = torch.randn(s, H, n, DH, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(s, H, n, DH, generator=gen, device="cuda").bfloat16()
    amask = mask[other][:, None, None, :]
    lib_ms = timed(lambda: F.scaled_dot_product_attention(q, kv, kv, attn_mask=amask), 10)

    nv = mask.sum(1).double()
    if kind == "self":
        flops = s * n * 20 * D * D + 4 * D * float((nv * nv).sum())
        wbytes = (3 * D * D + D * D + 4 * D * D + 2 * D * D + 3 * D + D + 6 * D) * 2
        nbytes = 2 * s * n * D * 2 + 2 * s * n * DH * 2 + s * n + wbytes
    else:
        b = s // 2
        flops = s * n * 18 * D * D + 6 * D * float((nv[:b] * nv[b:]).sum())
        wbytes = (2 * D * D + D * D + 4 * D * D + 2 * D * D + 2 * D + D + 6 * D) * 2
        nbytes = 2 * s * n * D * 2 + s * n + wbytes
    bms, by = bound(flops, nbytes, PEAK_BF16)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, tol="atol %g + rtol %g" % TOL["bfloat16"])


def check_assignment(b, m, n, seed):
    import torch

    from gluefactory_tpu_torch.ops import log_assignment as la

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d0 = torch.randn(b, m, D, generator=gen, device="cuda") * D**-0.25
    d1 = torch.randn(b, n, D, generator=gen, device="cuda") * D**-0.25
    z0 = torch.randn(b, m, generator=gen, device="cuda")
    z1 = torch.randn(b, n, generator=gen, device="cuda")
    m0 = torch.rand(b, m, generator=gen, device="cuda") > 0.2
    m1 = torch.rand(b, n, generator=gen, device="cuda") > 0.2
    err = 0.0
    for masks in ((None, None), (m0, m1)):
        out = la.fused_log_assignment(d0, d1, z0, z1, *masks)
        ref = la.log_assignment(d0, d1, z0, z1, *masks)
        torch.cuda.synchronize()
        for name, o, r in zip(("scores", "rowmax", "rowarg", "colmax", "colarg"), out, ref):
            if o.dtype == torch.int32:
                agree = float((o == r).float().mean())
                if agree < 0.999:
                    fail(f"log assignment {name}: {agree:.4f} equal (< 0.999)")
            else:
                err = max(err, compare(o, r, "float32", f"log assignment {name} b={b} n={n}"))
    ms = timed(lambda: la.fused_log_assignment(d0, d1, z0, z1, m0, m1), 10)
    plain_ms = timed(lambda: la.log_assignment(d0, d1, z0, z1, m0, m1), 3, warmup=1)
    pairs = float((m0.sum(1).double() * m1.sum(1).double()).sum())
    flops = 2 * D * pairs
    nbytes = (b * (m + n) * D + b * (m + n)) * 4 + b * (m + n) + \
        (b * (m + 1) * (n + 1) + 2 * b * (m + n)) * 4
    bms, by = bound(flops, nbytes, PEAK_FP32)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bms, bound_by=by,
                tol="atol %g + rtol %g, argmax >= 99.9%% equal" % TOL["float32"])


# ------------------------------------------------------------------ phase 4
def homography(seed, h, w):
    """A mild random homography in pixel coordinates (3x3 float64 list)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ang = math.radians(rng.uniform(-8, 8))
    sc = rng.uniform(0.9, 1.1)
    c, s = math.cos(ang) * sc, math.sin(ang) * sc
    cx, cy = w / 2, h / 2
    tx, ty = rng.uniform(-0.05, 0.05) * w, rng.uniform(-0.05, 0.05) * h
    A = np.array([[c, -s, cx + tx - c * cx + s * cy], [s, c, cy + ty - s * cx - c * cy], [0, 0, 1]])
    P = np.eye(3)
    P[2, :2] = rng.uniform(-2e-5, 2e-5, 2) * 640 / w
    return P @ A


def synthetic_pair(seed, b, h, w):
    """Images (B, H, W, 1) in [0, 1] with sharp structure, and their warps by
    per-pair homographies H (image0 -> image1), made with grid_sample."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    coarse = torch.rand(b, 1, h // 24, w // 24, generator=gen, device="cuda")
    img = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
    fine = torch.rand(b, 1, h // 6, w // 6, generator=gen, device="cuda")
    img = img + 0.6 * F.interpolate(fine, size=(h, w), mode="nearest")
    img = (img - img.amin((2, 3), keepdim=True)) / (
        img.amax((2, 3), keepdim=True) - img.amin((2, 3), keepdim=True))
    hs = torch.from_numpy(np.stack([homography(seed * 100 + i, h, w) for i in range(b)]))
    hs = hs.to("cuda")
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float64) + 0.5,
                            torch.arange(w, device="cuda", dtype=torch.float64) + 0.5,
                            indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = torch.einsum("bij,nj->bni", torch.linalg.inv(hs), pts)
    src = src[..., :2] / src[..., 2:]
    grid = torch.stack([src[..., 0] / w * 2 - 1, src[..., 1] / h * 2 - 1], -1)
    grid = grid.reshape(b, h, w, 2).float()
    img1 = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    to_bhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()
    return to_bhwc(img), to_bhwc(img1), hs


def pipeline(k):
    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.weights import load_hermetic

    conf = {
        "extractor": {"name": "superpoint_open", "max_num_keypoints": k},
        "matcher": {"name": "lightglue", "filter_threshold": 0.1, "mp": True,
                    "collect_layers": False},
    }
    pipe = get_model("two_view_pipeline")(conf, device="cuda")
    pipe.load_state_dict(load_hermetic(device="cuda"), strict=True)
    return pipe.eval()


def counters():
    from gluefactory_tpu_torch.ops import lightglue_block as lb
    from gluefactory_tpu_torch.ops import log_assignment as la

    return lb.fused_self_block, lb.fused_cross_block, la.fused_log_assignment


def set_launches(kernels, n, counts):
    """Record the launch counts of one pipeline run on the rows of size n."""
    for k in kernels:
        if str(n) in k["name"]:
            k["launches"] = counts[0 if "self" in k["name"] else 1 if "cross" in k["name"] else 2]


def reset_counts():
    for fn in counters():
        fn.launches = 0


def read_counts():
    return [fn.launches for fn in counters()]


@contextlib.contextmanager
def plain_path():
    """Run the matcher through the plain versions (for the agreement check)."""
    from gluefactory_tpu_torch.models.matchers import lightglue as lgmod
    from gluefactory_tpu_torch.ops import lightglue_block as lb
    from gluefactory_tpu_torch.ops import log_assignment as la

    saved = (lgmod.fused_self_block, lgmod.fused_cross_block, lgmod.fused_log_assignment)
    lgmod.fused_self_block, lgmod.fused_cross_block = lb.self_block, lb.cross_block
    lgmod.fused_log_assignment = la.log_assignment
    try:
        yield
    finally:
        lgmod.fused_self_block, lgmod.fused_cross_block, lgmod.fused_log_assignment = saved


def run_main_path(b, h, w, k, seed, label):
    """One batch through the pipeline with counts reset just before and read
    just after; returns (pipe, data, out, hs, counts)."""
    import torch

    pipe = pipeline(k)
    img0, img1, hs = synthetic_pair(seed, b, h, w)
    size = torch.tensor([[float(w), float(h)]] * b, device="cuda")
    data = {"view0": {"image": img0, "image_size": size},
            "view1": {"image": img1, "image_size": size}}
    torch.cuda.synchronize()
    reset_counts()
    out = pipe(data)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[{label}] launches per forward: self {counts[0]}, cross {counts[1]}, "
        f"assignment {counts[2]}")
    if counts != [9, 9, 1]:
        fail(f"{label}: expected 9 self, 9 cross, 1 assignment launches, got {counts}")
    for key in ("matches0", "matching_scores0", "log_assignment", "descriptors0", "keypoints0"):
        if not torch_finite(out[key]):
            fail(f"{label}: non-finite {key}")
    valid = out["keypoint_mask0"]
    nmatch = int((out["matches0"] >= 0).sum())
    if nmatch == 0:
        fail(f"{label}: no matches")
    if bool((out["matches0"][~valid] >= 0).any()):
        fail(f"{label}: a padded keypoint was matched")
    log(f"[{label}] valid keypoints {int(valid.sum())}, matches {nmatch}, "
        f"log_assignment {tuple(out['log_assignment'].shape)}")
    return pipe, data, out, hs, counts


def precision(out, hs, th=3.0):
    import torch

    kp0, kp1, m0 = out["keypoints0"].double(), out["keypoints1"].double(), out["matches0"]
    ok = m0 >= 0
    pts = torch.cat([kp0, torch.ones_like(kp0[..., :1])], -1)
    proj = torch.einsum("bij,bnj->bni", hs, pts)
    proj = proj[..., :2] / proj[..., 2:]
    tgt = torch.gather(kp1, 1, m0.clamp(min=0).long()[..., None].expand(-1, -1, 2))
    err = (proj - tgt).norm(dim=-1)
    return float(((err < th) & ok).sum()) / max(int(ok.sum()), 1)


def pairs_per_s(pipe, data, iters):
    import torch

    b = data["view0"]["image"].shape[0]
    pipe(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe(data)
    torch.cuda.synchronize()
    return b * iters / (time.perf_counter() - t0)


# ---------------------------------------------------------------------- main
def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from gluefactory_tpu_torch import _ext
    except ImportError:
        print("chip_smoke: gluefactory_tpu_torch is not beside this script", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else "nvidia-smi gave nothing"
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    built = _ext.build_all()
    log(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s")
    for logf in sorted(_ext.BUILD.glob("*.log")):
        for line in logf.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {logf.stem}: {line.strip()}")

    # 3. kernels against their plain versions at the main path's shapes
    src_blk = "gluefactory_tpu_torch/csrc/lightglue_block.cu"
    src_asg = "gluefactory_tpu_torch/csrc/log_assignment.cu"
    pal_blk = "gluefactory_tpu/ops/pallas_lightglue_block.py"
    rows = [
        ("K1 fused_self_block (16, 1024, 256) bf16", "self", 16, 1024, f"{pal_blk}:326", src_blk),
        ("K3a fused_self_block_v2 (8, 2048, 256) bf16", "self", 8, 2048, f"{pal_blk}:659", src_blk),
        ("K2 fused_cross_block (16, 1024, 256) bf16", "cross", 16, 1024, f"{pal_blk}:393", src_blk),
        ("K3b fused_cross_block_v2 (8, 2048, 256) bf16", "cross", 8, 2048, f"{pal_blk}:717", src_blk),
    ]
    kernels = []
    for i, (name, kind_, s, n, replaces, src) in enumerate(rows):
        r = check_block(kind_, s, n, seed=i)
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces, **r))
    for i, (b, n) in enumerate(((8, 1024), (4, 2048))):
        r = check_assignment(b, n, n, seed=10 + i)
        tag = "K4" if n == 1024 else "K4 (MegaDepth shape)"
        kernels.append(dict(
            name=f"{tag} fused_log_assignment B={b} M=N={n} f32", route="cuda", source=src_asg,
            replaces="gluefactory_tpu/ops/pallas_assignment.py:200,225", **r))
    for k in kernels:
        log(f"[kernel] {k['name']}: matches its plain version within {k['tol']} "
            f"(max abs err {k['max_abs_err']:.3g})")

    # 4. end to end: the main path, 480x640 / 1024 keypoints / batch 8
    pipe, data, out, hs, counts = run_main_path(8, 480, 640, 1024, seed=1, label="main b8")
    set_launches(kernels, 1024, counts)
    with plain_path():
        ref = pipe(data)
    valid = out["keypoint_mask0"]
    agree = float((out["matches0"] == ref["matches0"])[valid].float().mean())
    log(f"[main b8] matches0 equal to the plain path on {agree:.4f} of valid keypoints")
    if agree < 0.95:
        fail(f"matches0 agrees with the plain path on {agree:.4f} < 0.95 of valid keypoints")
    prec = precision(out, hs)
    pps = pairs_per_s(pipe, data, iters=10)
    data1 = {v: {kk: t[:1] for kk, t in d.items()} for v, d in data.items()}
    b1_ms = 1000.0 / pairs_per_s(pipe, data1, iters=10)
    log(f"[main b8] {pps:.2f} pairs/s at b8; b1 latency {b1_ms:.2f} ms; "
        f"precision@3px {prec:.4f} (synthetic homography pairs)")
    ext_ms = timed(lambda: [pipe.extractor(data[v]) for v in ("view0", "view1")], 5)
    matcher_ms = sum(k["ms"] * k["launches"] for k in kernels if "1024" in k["name"])
    log(f"[main b8] per batch: {8000.0 / pps:.2f} ms end to end; extractor {ext_ms:.2f} ms "
        f"(both views); matcher kernels {matcher_ms:.2f} ms (kernel_ms x launches)")

    # the MegaDepth protocol shape through the same kernels (the K3 rows)
    pipe_md, data_md, out_md, hs_md, counts_md = run_main_path(
        4, 1200, 1600, 2048, seed=2, label="megadepth b4")
    set_launches(kernels, 2048, counts_md)
    md_pps = pairs_per_s(pipe_md, data_md, iters=3)
    log(f"[megadepth b4] {1000.0 / md_pps:.2f} ms/pair ({md_pps:.2f} pairs/s); "
        f"precision@3px {precision(out_md, hs_md):.4f}")

    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        log(f"[kernel] {k['name']}: kernel_ms {k['ms']:.4f} plain_ms {k['plain_ms']:.4f} "
            f"library_ms {lib} bound_ms {k['bound_ms']:.4f} ({k['bound_by']}) "
            f"launches {k['launches']}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
