#!/usr/bin/env python3
"""Time the attention backward (K7b, gluefactory_tpu_torch/csrc/attention.cu)
and SuperPoint's block 0 (K8, csrc/block0_conv.cu) in variant builds of their
sources, on one CUDA card:

    python3 scripts/torch_k7b_k8_variants.py [--only WORD ...] [--parent DIR]

Each variant substitutes statements in a source and builds it with nvcc into
gluefactory_tpu_torch/_build/variants/. Three kinds. Alternatives that the
design chose against (the output stays right): for the fp32 K7b the split
by cvt.rna.tf32.f32 for both parts, 64-row loop tiles (two blocks a
multiprocessor in place of three) and expf in place of exp2f; for the bf16
K7b its first design (64-row blocks of 4 warps, 32-row loop tiles, K and V
kept in registers: 191 and 152 registers), and around the chosen blocks
(BwdShape<128, 32, 2> for both kernels) other shapes of the dk/dv block
(64 rows and 64-row loop tiles with K and V kept, three blocks a
multiprocessor with K and V kept, four 4-warp blocks, one 8-warp block of
64-row loop tiles) and of the dq block (four 4-warp blocks, Q and dO read
each tile in two or three 8-warp blocks, one 8-warp block of 64-row loop
tiles). Timing-only removals of one part of a kernel's work (the output is
then wrong; only the time is read), which show what a launch waits on: for
the fp32 K7b one TF32 pass in place of the three of the split, the three
passes without the split's arithmetic; for both types its kernels alone;
for K8 its two stages apart (conv1a and conv1b, both on the tensor cores).
And two controls, the bf16 K7b with query tile 1 skipped in its dk/dv
kernel and with key tile 1 skipped in its dq kernel, which must fall
outside chip_smoke.py's bar of the bf16 backward (K7B_BF16). The fp32 K7b
runs at a training step's self form (64, 512, 256) and cross form (32
pairs, one direction, 512 x 512) and at SuperGlue's per-head form (32, 4,
512, 64), its max abs error against the plain version printed beside; the
bf16 K7b at the `mp: True`
step's self form (64, 512, 256) and cross form (32 pairs, one direction,
512 x 512), timed by CUDA events and by device time, with each variant's
registers and spills, its max and mean abs err against fp32 autograd of the
plain version and whether they are within K7B_BF16, and
scaled_dot_product_attention's bf16 backward beside; K8 at one view of a
b8 batch, (8, 480, 640, 1). Two rounds. `--only WORD ...` builds the base
and the variants whose labels hold one of the words. `--parent DIR` builds
the attention.cu of another checkout at DIR too and times its K7b (fp32
and bf16) in the same rounds, first in round 0 and last in round 1.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from torch_block_variants import build, inlined_headers  # noqa: E402  (this directory)

ONE_PASS = '''#include "mma.cuh"
namespace {
__device__ __forceinline__ void mma_one_pass(float d[4], const unsigned ah[4], const unsigned*,
                                             const unsigned bh[2], const unsigned*) {
  gf::mma_tf32_m16n8k8(d, ah, bh);
}
}  // namespace
'''
# the body of gf::split_tf32 (csrc/mma.cuh) and two others
SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));")
RNA_SPLIT = "  hi = to_tf32(x);\n  lo = to_tf32(x - __uint_as_float(hi));"
NO_SPLIT = "  hi = lo = __float_as_uint(x);"
EXP2 = ["exp2f(fmaf(st[nt][e], scale2, -rw[i]))", "exp2f(fmaf(sa[nt][e], scale2, -rl[r]))"]


def skip(*launches):
    """Substitutions that leave out the launches of the named kernels."""
    return [(f"    GF_LAUNCH({k},", f"    if (Nq < 0) GF_LAUNCH({k},") for k in launches]


DKV, DQ = "attn_bwd_dkv_kernel<T>", "attn_bwd_dq_kernel<T>"
DKV16, DQ16 = "attn_bwd_dkv_bf16_kernel", "attn_bwd_dq_bf16_kernel"
DKV_SHAPE, DQ_SHAPE = "using Dkv = BwdShape<128, 32, 2>;", "using Dq = BwdShape<128, 32, 2>;"


def dkv(shape):
    """The bf16 dk/dv kernel's block as BwdShape<rows, loop, blocks>."""
    return [(DKV_SHAPE, f"using Dkv = BwdShape<{shape}>;")]


def dq(shape):
    return [(DQ_SHAPE, f"using Dq = BwdShape<{shape}>;")]


# the bf16 dk/dv kernel keeping its K and V fragments in registers, in place
# of reading them again at every loop tile
KV_KEPT = [
    ("\n  float dka[8][4] = {}, dva[8][4] = {};  // (key",
     "  gf::cp_async_wait<0>();\n  __syncthreads();\n  unsigned kf[4][4], vf[4][4];\n"
     "  frags_a(kf, Ks);\n  frags_a(vf, Vs);\n\n  float dka[8][4] = {}, dva[8][4] = {};  // (key"),
    ("    {\n      unsigned a[4][4];\n      frags_a(a, Ks);\n      product_rows<kL>(st, a, Qt);\n"
     "      frags_a(a, Vs);\n      product_rows<kL>(dpt, a, dOt);\n    }\n",
     "    product_rows<kL>(st, kf, Qt);\n    product_rows<kL>(dpt, vf, dOt);\n")]
# the bf16 dq kernel reading its Q and dO fragments again at every loop tile
QDO_EACH_TILE = [
    ("  unsigned qf[4][4], of[4][4];\n  frags_a(qf, Qs);\n  frags_a(of, dOs);\n", ""),
    ("      product_rows<kL>(sa, qf, Kt);\n      product_rows<kL>(dpa, of, Vt);\n",
     "      unsigned a[4][4];\n      frags_a(a, Qs);\n      product_rows<kL>(sa, a, Kt);\n"
     "      frags_a(a, dOs);\n      product_rows<kL>(dpa, a, Vt);\n")]
B0_MMA = [("          gf::mma_bf16_m16n8k16(acc[{r}][2 * np{o}], fa{r}, fb{b});",
           "          acc[{r}][2 * np{o}][0] += __uint_as_float(fa{r}[0] ^ fb[{i}]);")]
VARIANTS = {
    "attention": {
        "base": [],
        "split by cvt.rna for hi and lo": inlined_headers(mma=[(SPLIT, RNA_SPLIT)]),
        "64-row loop tiles": [("constexpr int kStep = 32;", "constexpr int kStep = 64;")],
        "expf in place of exp2f": [
            (e, e.replace("exp2f(", "expf(0.69314718f * ")) for e in EXP2],
        "timing only: one TF32 pass": [('#include "mma.cuh"\n', ONE_PASS),
                                       ("gf::mma_tf32x3(", "mma_one_pass(")],
        "timing only: three passes without the split's arithmetic": inlined_headers(
            mma=[(SPLIT, NO_SPLIT)]),
        "timing only: delta and dk/dv kernels": skip(DQ, DQ16),
        "timing only: delta and dq kernels": skip(DKV, DKV16),
        "timing only: delta kernel": skip(DKV, DQ, DKV16, DQ16),
        "bf16 first design: <64, 32, 2> both, K and V kept in registers":
            dkv("64, 32, 2") + KV_KEPT + dq("64, 32, 2"),
        "bf16 dk/dv <64, 64, 2>, K and V kept in registers": dkv("64, 64, 2") + KV_KEPT,
        "bf16 dk/dv <64, 32, 3>, K and V kept in registers": dkv("64, 32, 3") + KV_KEPT,
        "bf16 dk/dv <64, 32, 4>": dkv("64, 32, 4"),
        "bf16 dk/dv <128, 64, 1>": dkv("128, 64, 1"),
        "bf16 dq <64, 32, 4>": dq("64, 32, 4"),
        "bf16 dq <128, 32, 2>, Q and dO read each tile": QDO_EACH_TILE,
        "bf16 dq <128, 32, 3>, Q and dO read each tile": dq("128, 32, 3") + QDO_EACH_TILE,
        "bf16 dq <128, 64, 1>": dq("128, 64, 1"),
        "bf16 control: dk/dv without query tile 1": [
            ("const float p = kv[e >> 1] ?", "const float p = kv[e >> 1] && it != 1 ?")],
        "bf16 control: dq without key tile 1": [
            ("    if (any) {  // the same", "    if (any && it != 1) {  // the same")],
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


def f32_cases(cs, gen, stream, base):
    """{tag: (inputs of fused_attention.launch_attention_bwd after the
    library, the plain version's gradients)} for the fp32 K7b at a training
    step's self form and cross form (one direction) and SuperGlue's per-head
    form."""
    import torch

    from gluefactory_tpu_torch.ops import attention as plain
    from gluefactory_tpu_torch.ops import fused_attention as fa

    s, n, b, scale = 2 * cs.TRAIN_B, cs.TRAIN_N, cs.TRAIN_B, cs.DH**-0.5
    (q, k, v, do), masks = cs.attn_inputs(gen, torch.float32, n, n, n, n, sets=s)
    mask = masks[n]
    mask1 = torch.rand(b, n, generator=gen, device="cuda") > 0.2
    cases = {}
    for tag, (cq, ck, cv, cdo, mq, mk) in (
            (f"K7b self ({s}, {n}, 256) f32", (q, k, v, do, mask, mask)),
            (f"K7b cross B={b} {n} x {n} f32", (q[:b], q[b:], v[b:], do[:b], mask[:b], mask1))):
        o, lse = fa.launch_attention_fwd(base, stream, cq, ck, cv, mq, mk, cs.H, scale)
        cases[tag] = ((cq, ck, cv, o, lse, mq, mk, cdo, cs.H, scale),
                      plain.attention_backward(cq, ck, cv, mq, mk, cdo, cs.H, scale))
    qh, kh, vh, dh = (torch.randn(b, cs.H, n, cs.DH, generator=gen, device="cuda")
                      for _ in range(4))
    o, lse = fa.launch_attention_fwd_heads(base, stream, qh, kh, vh, mask[:b], mask1, scale)
    cases[f"K7b per-head ({b}, {cs.H}, {n}, {cs.DH}) f32"] = (
        (qh, kh, vh, o, lse, mask[:b], mask1, dh, cs.H, scale),
        plain.attention_backward_heads(qh, kh, vh, mask[:b], mask1, dh, scale))
    return cases


def bf16_cases(cs, gen, stream, base):
    """{tag: (inputs of fused_attention.launch_attention_bwd after the
    library, fp32 autograd references, SDPA's bf16 backward)} for the bf16
    K7b at the `mp: True` step's self form and cross form (one direction)."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import attention as plain
    from gluefactory_tpu_torch.ops import fused_attention as fa

    s, n, b, scale = 2 * cs.TRAIN_B, cs.TRAIN_N, cs.TRAIN_B, cs.DH**-0.5
    (q, k, v, do), masks = cs.attn_inputs(gen, torch.bfloat16, n, n, n, n, sets=s)
    mask = masks[n]
    mask0, mask1 = mask[:b], torch.rand(b, n, generator=gen, device="cuda") > 0.2
    cases = {}
    for tag, (cq, ck, cv, cdo, mq, mk) in (
            (f"K7b self ({s}, {n}, 256) bf16", (q, k, v, do, mask, mask)),
            (f"K7b cross B={b} {n} x {n} bf16", (q[:b], q[b:], v[b:], do[:b], mask0, mask1))):
        o, lse = fa.launch_attention_fwd(base, stream, cq, ck, cv, mq, mk, cs.H, scale)
        fn = lambda a, b_, c, mq=mq, mk=mk: plain.masked_attention_packed(a, b_, c, mq, mk, cs.H,
                                                                          scale)
        refs = cs.autograd_reference(fn, (cq, ck, cv), (cdo,))
        lq, lk, lv = (cs.heads(t).requires_grad_() for t in (cq, ck, cv))
        lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mk[:, None, None, :])
        ldo = cs.heads(cdo)
        sdpa = lambda lout=lout, leaves=(lq, lk, lv), ldo=ldo: torch.autograd.grad(
            lout, leaves, ldo, retain_graph=True)
        cases[tag] = ((cq, ck, cv, o, lse, mq, mk, cdo, cs.H, scale), refs, sdpa)
    return cases


def print_bf16_build(cs, label, lib):
    """Registers and spills of the bf16 backward's kernels in a variant."""
    import re

    fn = spill = None
    for line in lib.build_log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            fn = cs.kernel_name(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif (m := re.search(r"Used (\d+) registers", line)) and fn:
            if "bf16_kernel" in fn:
                print(f"[build] {label}: {fn} {m.group(1)} registers, {spill}", flush=True)
            fn = None


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", default=None,
                        help="build only the variants whose labels contain one of these")
    parser.add_argument("--parent", type=Path, default=None,
                        help="another checkout whose K7b is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_k7b_k8_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gluefactory_tpu_torch import _ext
    from gluefactory_tpu_torch.ops import block0_conv as b0
    from gluefactory_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out = _ext.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    variants = VARIANTS
    if args.only:
        variants = {lib: {k: v for k, v in vs.items()
                          if k == "base" or any(o in k for o in args.only)}
                    for lib, vs in VARIANTS.items()}
    libs = build(variants, out)
    if args.parent is not None:
        (out / "parent").mkdir(exist_ok=True)
        parent = build({"attention": {"parent": []}}, out / "parent",
                       csrc=args.parent / "gluefactory_tpu_torch" / "csrc")
        libs["attention"] = {**parent["attention"], **libs["attention"]}
    for label, lib in libs["attention"].items():
        print_bf16_build(cs, label, lib)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    f32 = f32_cases(cs, gen, stream, libs["attention"]["base"])
    bf16 = bf16_cases(cs, gen, stream, libs["attention"]["base"])

    # K8, one view of a b8 batch, with seeded weights
    image = cs.synthetic_pair(23, 8, 480, 640)[0].contiguous()
    rn = lambda *sh, sc=1.0: torch.randn(*sh, generator=gen, device="cuda") * sc
    pos = lambda: torch.rand(64, generator=gen, device="cuda") + 0.5
    weights = (rn(3, 3, 1, 64, sc=0.3), rn(64, sc=0.1), pos(), rn(64, sc=0.1),
               rn(3, 3, 64, 64, sc=0.05), rn(64, sc=0.1), pos(), rn(64, sc=0.1))
    ref0 = b0.block0_plain(image, *weights)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    for rnd in range(2):
        order = list(libs["attention"].items())
        for label, lib in order if rnd == 0 else order[::-1]:
            for tag, (inputs, ref) in f32.items() if not label.startswith("bf16") else ():
                run = lambda: fa.launch_attention_bwd(lib, stream, *inputs)
                got = run()
                torch.cuda.synchronize()
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                print(f"{tag} round {rnd} {label}: {cs.timed(run, 20):.4f} ms; max abs err "
                      f"{err:.4g}", flush=True)
            if label.startswith("bf16") or label in ("base", "parent") or "delta" in label:
                for tag, (inputs, refs, _) in bf16.items():
                    run = lambda: fa.launch_attention_bwd(lib, stream, *inputs)
                    got = run()
                    torch.cuda.synchronize()
                    err, rel, mean, ok = cs.k7b_bar(got, refs)
                    bar = ("" if "timing only" in label else
                           f"; max abs err {err:.4g}, worst max err {rel:.4g} and mean err "
                           f"{mean:.4g} of max|ref|: {'within' if ok else 'OUTSIDE'} K7B_BF16")
                    print(f"{tag} round {rnd} {label}: {cs.timed(run, 20):.4f} ms by events, "
                          f"{cs.device_ms(run, 20):.4f} ms device time{bar}", flush=True)
        for tag, (_, _, sdpa) in bf16.items():
            print(f"{tag} round {rnd} SDPA bf16 backward: {cs.timed(sdpa, 20):.4f} ms by "
                  f"events, {cs.device_ms(sdpa, 20):.4f} ms device time", flush=True)
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
