#!/usr/bin/env python3
"""Time the attention backward (K7b, gluefactory_tpu_torch/csrc/attention.cu)
and SuperPoint's block 0 (K8, csrc/block0_conv.cu) in variant builds of their
sources, on one CUDA card:

    python3 scripts/torch_k7b_k8_variants.py

Each variant substitutes statements in a source and builds it with nvcc into
gluefactory_tpu_torch/_build/variants/. Two kinds. Alternatives that the
design chose against (the output stays right): for K7b the split by
cvt.rna.tf32.f32 for both parts, 64-row loop tiles (two blocks a
multiprocessor in place of three) and expf in place of exp2f. And
timing-only removals of one part of a kernel's work (the output is then
wrong; only the time is read), which show what a launch waits on: for K7b
one TF32 pass in place of the three of the split, the three passes without
the split's arithmetic, and its kernels alone; for K8 its two stages apart
(conv1a and conv1b, both on the tensor cores). K7b runs at the self form of
a training step, (64, 512, 256) fp32, K8 at one view of a b8 batch, (8, 480,
640, 1), in two rounds; the max abs error against the plain version is
printed beside.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from torch_block_variants import build  # noqa: E402  (this script's directory)

ONE_PASS = '''#include "mma.cuh"
namespace {
__device__ __forceinline__ void mma_one_pass(float d[4], const unsigned ah[4], const unsigned*,
                                             const unsigned bh[2], const unsigned*) {
  gf::mma_tf32_m16n8k8(d, ah, bh);
}
}  // namespace
'''
NO_SPLIT = '''#include "mma.cuh"
namespace {
__device__ __forceinline__ void raw_split(float x, unsigned& hi, unsigned& lo) {
  hi = lo = __float_as_uint(x);
}
}  // namespace
'''
RNA_SPLIT = '''#include "mma.cuh"
namespace {
__device__ __forceinline__ void rna_split(float x, unsigned& hi, unsigned& lo) {
  hi = gf::to_tf32(x);
  lo = gf::to_tf32(x - __uint_as_float(hi));
}
}  // namespace
'''
EXP2 = ["exp2f(fmaf(st[nt][e], scale2, -rw[i]))", "exp2f(fmaf(sa[nt][e], scale2, -rl[r]))"]
DKV = "  GF_LAUNCH(attn_bwd_dkv_kernel<T>,"
DQ = "  GF_LAUNCH(attn_bwd_dq_kernel<T>,"
B0_MMA = [("          gf::mma_bf16_m16n8k16(acc[{r}][2 * np{o}], fa{r}, fb{b});",
           "          acc[{r}][2 * np{o}][0] += __uint_as_float(fa{r}[0] ^ fb[{i}]);")]
VARIANTS = {
    "attention": {
        "base": [],
        "split by cvt.rna for hi and lo": [('#include "mma.cuh"\n', RNA_SPLIT),
                                           ("gf::split_tf32(", "rna_split(")],
        "64-row loop tiles": [("constexpr int kStep = 32;", "constexpr int kStep = 64;")],
        "expf in place of exp2f": [
            (e, e.replace("exp2f(", "expf(0.69314718f * ")) for e in EXP2],
        "timing only: one TF32 pass": [('#include "mma.cuh"\n', ONE_PASS),
                                       ("gf::mma_tf32x3(", "mma_one_pass(")],
        "timing only: three passes without the split's arithmetic": [
            ('#include "mma.cuh"\n', NO_SPLIT), ("gf::split_tf32(", "raw_split(")],
        "timing only: delta and dk/dv kernels": [(DQ, "  if (Nq < 0)" + DQ[1:])],
        "timing only: delta and dq kernels": [(DKV, "  if (Nq < 0)" + DKV[1:])],
        "timing only: delta kernel": [(DQ, "  if (Nq < 0)" + DQ[1:]),
                                      (DKV, "  if (Nq < 0)" + DKV[1:])],
    },
    "block0_conv": {
        "base": [],
        "timing only: without stage 1 (conv1a)": [
            ("    if (next < tiles) conv1a(next, img + (1 - cur) * kImgF, at + (1 - cur) * kATile);",
             "")],
        "timing only: without stage 2's ldmatrix and mma": [
            ("    for (int tap = 0; tap < kTaps; ++tap) {", "    for (int tap = 0; tap < 0; ++tap) {")],
        "timing only: without stage 2's mma (ldmatrix kept)": [
            (a.format(r=r, o=o, b=b), z.format(r=r, o=o, i=i))
            for a, z in B0_MMA for r in (0, 1)
            for o, b, i in (("", "", 0), (" + 1", " + 2", 2))],
    },
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k7b_k8_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gluefactory_tpu_torch import _ext
    from gluefactory_tpu_torch.ops import attention as plain
    from gluefactory_tpu_torch.ops import block0_conv as b0
    from gluefactory_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out = _ext.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    libs = build(VARIANTS, out)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    # K7b, self form of a training step
    s, n = 2 * cs.TRAIN_B, cs.TRAIN_N
    (q, k, v, do), masks = cs.attn_inputs(gen, torch.float32, n, n, n, n, sets=s)
    mask = masks[n]
    scale = cs.DH**-0.5
    o, lse = fa.launch_attention_fwd(_ext.load("attention"), stream, q, k, v, mask, mask, cs.H,
                                     scale)
    ref = plain.attention_backward(q, k, v, mask, mask, do, cs.H, scale)

    # K8, one view of a b8 batch, with seeded weights
    image = cs.synthetic_pair(23, 8, 480, 640)[0].contiguous()
    rn = lambda *sh, sc=1.0: torch.randn(*sh, generator=gen, device="cuda") * sc
    pos = lambda: torch.rand(64, generator=gen, device="cuda") + 0.5
    weights = (rn(3, 3, 1, 64, sc=0.3), rn(64, sc=0.1), pos(), rn(64, sc=0.1),
               rn(3, 3, 64, 64, sc=0.05), rn(64, sc=0.1), pos(), rn(64, sc=0.1))
    ref0 = b0.block0_plain(image, *weights)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    for rnd in range(2):
        for label, lib in libs["attention"].items():
            run = lambda: fa.launch_attention_bwd(lib, stream, q, k, v, o, lse, mask, mask, do,
                                                  cs.H, scale)
            got = run()
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            print(f"K7b self ({s}, {n}, 256) f32 round {rnd} {label}: {cs.timed(run, 20):.4f} ms; "
                  f"max abs err {err:.4g}", flush=True)
        for label, lib in libs["block0_conv"].items():
            run = lambda: b0.launch_block0(lib, stream, image, *weights, blocks=sms)
            got = run()
            torch.cuda.synchronize()
            err = float((got.float() - ref0.float()).abs().max())
            print(f"K8 (8, 480, 640, 1) round {rnd} {label}: {cs.timed(run, 10):.4f} ms; "
                  f"max abs err {err:.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
