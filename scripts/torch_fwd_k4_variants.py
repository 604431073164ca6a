#!/usr/bin/env python3
"""Time the attention forward tile (gluefactory_tpu_torch/csrc/attention_fwd.cuh,
through the forwards of csrc/attention.cu and the block attention of
csrc/lightglue_block.cu) and the log assignment (K4, csrc/log_assignment.cu)
in variant builds of their sources, on one CUDA card:

    python3 scripts/torch_fwd_k4_variants.py [--parent DIR] [--only WORD ...]

Each variant substitutes statements in a source and builds it with nvcc into
gluefactory_tpu_torch/_build/variants/ (an edit of the forward tile inlines
its header into the variant of attention.cu). Two kinds. Alternatives that
the design chose against (the output stays right): for the fp32 tile, the
forward without its skip of key tiles that hold no valid key, without its
cap of 168 registers a thread (three blocks a multiprocessor), and with K7a
capped too; for the bf16 tile, 64 queries (4 warps) a block in place of 128
(8 warps), 128-key tiles in place of 64 (capped at 128 registers, and
uncapped: one block a multiprocessor), Q's fragments loaded once and kept
in registers in place of read again each key tile, exp2f in place of
ex2.approx, and masked keys zero-filled by their mask bytes (as the fp32
tile does) besides the rows past the set; each
variant's registers and spills of its bf16 forwards are printed. And
timing-only removals of one part of a kernel's work (the output is then
wrong; only the time is read), which show what a launch waits on: one TF32
pass in place of the split's three (fp32 forward and K4); the bf16 tile
without its exp2 and with K and V copied for its first two key tiles
alone; and K4's product kernel with and without the
log-sum-exp merge but without the finish pass and the argmax merge. And a
control, the bf16 tile with its second key tile skipped, which must fall
outside chip_smoke.py's bar of the bf16 attention forwards (ATT_BF16):
every bf16 case prints its max and mean abs err and whether it is within
that bar. `--only WORD ...` builds the base and the variants whose labels
hold one of the words.

The fp32 forwards run at a training step's shapes, K5 and K6b at (64, 512,
256) with ~80% valid keys (K5 also with the last quarter of every set
padded), K7a and K7c at SuperGlue's b8 shape, (8, 4, 1024, 64); the bf16
forwards at the `mp: True` step's, K5 and K6b at (64, 512, 256) and K6a at
32 pairs of 512 x 384, with scaled_dot_product_attention in bf16 on the same
inputs beside them, K7a and K7c at (8, 4, 1024, 64), and the serving blocks'
bf16 attention launch at (16, 1024, 256) and (8, 2048, 256), self and cross;
K4 at the main b8 and the MegaDepth b4 shapes. Two rounds; the max abs
error against the plain version is printed beside. `--parent DIR` builds
the attention.cu and lightglue_block.cu of another checkout at DIR too and
times its bf16 forwards and block attention in the same rounds, first in
round 0 and last in round 1.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from torch_block_variants import build, inlined_headers  # noqa: E402  (this directory)

F32_BLOCKS = "static constexpr int kBlocks = 3;  // a cap of 168 registers"
BF16_BLOCKS = "static constexpr int kBlocks = 2;  // a cap of 128 registers"
BF16_QUERIES = "static constexpr int kQueries = 128;"
BF16_FILL = "const bool in = j < nk;"
# 128-key tiles: o's rescaling moves out of the loop over the key columns
KEYS_128 = [("static constexpr int kKeys = 64;", "static constexpr int kKeys = 128;"),
            ("kKT == 64, ", "kKT == 128, "),
            ("        o[ni][e] *= alpha[e / 2];", "        if (ni < 8) o[ni][e] *= alpha[e / 2];")]
BF16_STAGE = "if (jt + 1 < tiles) stage_keys(jt + 1);  // into tile jt - 1's stage"
EXP2 = "const float p = valid ? exp2_approx(sc[ni][e] - m[e / 2]) : 0.f;"
# the bf16 tile with this warp's Q fragments loaded once and kept in registers
Q_REGS = [("  const int tiles = (nk + kKT - 1) / kKT;\n",
           "  unsigned qf[4][4];\n  const int tiles = (nk + kKT - 1) / kKT;\n"),
          ("    if (jt + 1 < tiles) stage_keys(jt + 1);  // into tile jt - 1's stage\n"
           "    cp_async_commit();\n",
           "    if (jt + 1 < tiles) stage_keys(jt + 1);  // into tile jt - 1's stage\n"
           "    cp_async_commit();\n    if (jt == 0)\n      for (int kk = 0; kk < 4; ++kk)\n"
           "        ldsm_x4(qf[kk], Qs + (warp * 16 + lane % 16) * kS + kk * 16 + lane / 16 * 8);\n"),
          ("      unsigned qa[4];  // this warp's 16 queries, dims 16kk..\n"
           "      ldsm_x4(qa, Qs + (warp * 16 + lane % 16) * kS + kk * 16 + lane / 16 * 8);\n",
           "      const unsigned* qa = qf[kk];\n")]
# the bf16 tile's skip of a key tile without a valid key (the fp32 tile's loop
# runs `ni < 8`)
SKIP = ("    if (!any) continue;  // the same for the whole block\n    unsigned bits = 0;"
        "  // bit 2ni + c: key 8ni + 2t + c of this lane's columns\n#pragma unroll\n"
        "    for (int ni = 0; ni < kKT / 8;")
SKIP_ONE = SKIP.replace("if (!any)", "if (!any || jt == 1)")
K7A_BLOCKS = "kK7aBlocks = std::is_same<T, float>::value ? 1 : Fwd<T>::kBlocks;"
FINISH = "  GF_LAUNCH(finish_kernel,"
ARGMAX = "  GF_LAUNCH(argmax_kernel,"
LSE = "  GF_LAUNCH(lse_kernel,"


VARIANTS = {
    "attention": {
        "base": [],
        "f32 no skip of key tiles without a valid key": inlined_headers(
            fwd=[("    if (!any) continue;  // the same for the whole block\n    unsigned bits = 0;"
                  "  // bit 2ni + c: key 8ni + 2t + c of this lane's columns\n#pragma unroll\n"
                  "    for (int ni = 0; ni < 8;",
                  "    unsigned bits = 0;\n#pragma unroll\n    for (int ni = 0; ni < 8;")]),
        "f32 no register cap (two blocks an SM for the cross forwards)": inlined_headers(
            fwd=[(F32_BLOCKS, "static constexpr int kBlocks = 1;")]),
        "f32 K7a capped at 168 registers too": [(K7A_BLOCKS, "kK7aBlocks = Fwd<T>::kBlocks;")],
        "f32 timing only: one TF32 pass": inlined_headers(
            fwd=[("        mma_tf32x3(sc[ni], qh[ks], ql[ks], bh, bl);\n"
                  "        mma_tf32x3(sc[ni + 1], qh[ks], ql[ks], bh + 2, bl + 2);",
                  "        mma_tf32_m16n8k8(sc[ni], qh[ks], bh);\n"
                  "        mma_tf32_m16n8k8(sc[ni + 1], qh[ks], bh + 2);"),
                 ("        mma_tf32x3(o[nd], ph, pl, bh, bl);",
                  "        mma_tf32_m16n8k8(o[nd], ph, bh);")]),
        "bf16 64 queries (4 warps) a block": inlined_headers(
            fwd=[(BF16_QUERIES, "static constexpr int kQueries = 64;"),
                 (BF16_BLOCKS, "static constexpr int kBlocks = 4;")]),
        "bf16 128-key tiles, 128 registers": inlined_headers(fwd=KEYS_128),
        "bf16 128-key tiles, uncapped": inlined_headers(
            fwd=KEYS_128 + [(BF16_BLOCKS, "static constexpr int kBlocks = 1;")]),
        "bf16 Q fragments kept in registers": inlined_headers(fwd=Q_REGS),
        "bf16 exp2f in place of ex2.approx": inlined_headers(fwd=[("exp2_approx(", "exp2f(")]),
        "bf16 masked keys zero-filled by their mask bytes": inlined_headers(
            fwd=[(BF16_FILL, "const bool in = j < nk && (mk == nullptr || mk[j]);")]),
        "bf16 timing only: without exp2": inlined_headers(
            fwd=[(EXP2, "const float p = valid ? sc[ni][e] - m[e / 2] : 0.f;")]),
        "bf16 timing only: K and V copied for the first two tiles alone": inlined_headers(
            fwd=[(BF16_STAGE, "if (jt + 1 < tiles && jt < 1) stage_keys(jt + 1);")]),
        "bf16 control: key tile 1 skipped": inlined_headers(fwd=[(SKIP, SKIP_ONE)]),
    },
    "log_assignment": {
        "base": [],
        "timing only: one TF32 pass": [("gf::mma_tf32x3(", "gf::mma_split<true, true>(")],
        "timing only: product and lse merge": [(FINISH, "  if (M < 0)" + FINISH[1:]),
                                               (ARGMAX, "  if (M < 0)" + ARGMAX[1:])],
        "timing only: product alone": [(FINISH, "  if (M < 0)" + FINISH[1:]),
                                       (ARGMAX, "  if (M < 0)" + ARGMAX[1:]),
                                       (LSE, "  if (M < 0)" + LSE[1:])],
    },
}


def time_case(tag, label, run, ref, timed, bar=None):
    """Time `run`; its max abs err against `ref`, and with `bar`
    (chip_smoke.attention_bar) also its mean abs err and whether it is
    within chip_smoke.py's bar of the bf16 attention forwards."""
    import torch

    got = run()
    torch.cuda.synchronize()
    if bar is None or "timing only" in label:
        err = float((got.float() - ref.float()).abs().max())
        print(f"{tag} {label}: {timed(run, 20):.4f} ms; max abs err {err:.4g}", flush=True)
        return
    err, mean, ok = bar(got, ref)
    print(f"{tag} {label}: {timed(run, 20):.4f} ms; max abs err {err:.4g}, mean abs err "
          f"{mean:.4g}: {'within' if ok else 'OUTSIDE'} chip_smoke's bf16 attention bar",
          flush=True)


def main() -> int:
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="another checkout whose bf16 forwards are timed beside")
    parser.add_argument("--only", nargs="+", default=None,
                        help="build only the variants whose labels contain one of these")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_k4_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gluefactory_tpu_torch import _ext
    from gluefactory_tpu_torch.ops import attention as plain
    from gluefactory_tpu_torch.ops import fused_attention as fa
    from gluefactory_tpu_torch.ops import lightglue_block as lb
    from gluefactory_tpu_torch.ops import log_assignment as la

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out = _ext.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    variants = dict(VARIANTS, lightglue_block={"base": []})
    if args.only:
        variants = {lib: {k: v for k, v in vs.items()
                          if k == "base" or any(o in k for o in args.only)}
                    for lib, vs in variants.items()}
    libs = build(variants, out)
    if args.parent is not None:
        (out / "parent").mkdir(exist_ok=True)
        parent = build({"attention": {"parent": []}, "lightglue_block": {"parent": []}},
                       out / "parent", csrc=args.parent / "gluefactory_tpu_torch" / "csrc")
        for name in ("attention", "lightglue_block"):
            libs[name] = {**parent[name], **libs[name]}
    for name in ("attention", "lightglue_block"):
        for label, lib in libs[name].items():
            fn = None
            for line in lib.build_log.splitlines():
                if m := re.search(r"Compiling entry function '([^']+)'", line):
                    fn = cs.kernel_name(m.group(1))
                elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                    spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
                elif (m := re.search(r"Used (\d+) registers", line)) and fn:
                    if fn.endswith("<bf16>") and ("fwd" in fn or fn.startswith("attn_kernel")):
                        print(f"[build] {label}: {name} {fn} {m.group(1)} registers, {spill}")
                    fn = None
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = cs.DH**-0.5
    s, n, b, n1 = 2 * cs.TRAIN_B, cs.TRAIN_N, cs.TRAIN_B, cs.TRAIN_N1
    hb, hn = cs.HEADS_B, cs.HEADS_N

    def forwards(dtype):
        """{tag: (launch through a library, plain result)} at the training
        step's and SuperGlue's shapes in `dtype`."""
        (q, k, v), masks = cs.attn_inputs(gen, dtype, n, n, n, sets=s)
        (q1, v1), masks1 = cs.attn_inputs(gen, dtype, n1, n1, sets=b)
        mask, mask1, mask0 = masks[n], masks1[n1], masks[n][:b]
        padded = mask.clone()
        padded[:, 3 * n // 4:] = False
        qh, kh, vh, wh = (torch.randn(hb, cs.H, hn, cs.DH, generator=gen, device="cuda")
                          .to(dtype) for _ in range(4))
        mh = torch.rand(hb, hn, generator=gen, device="cuda") > 0.2
        t = "f32" if dtype == torch.float32 else "bf16"
        cases = {
            f"K5 ({s}, {n}, 256) {t} 80% valid": (
                lambda lib: fa.launch_attention_fwd(lib, stream, q, k, v, mask, mask, cs.H,
                                                    scale)[0],
                plain.masked_attention_packed(q, k, v, mask, mask, cs.H, scale)),
            f"K6b ({s}, {n}, 256) {t}": (
                lambda lib: fa.launch_cross_fwd_stacked(lib, stream, q, v, mask, cs.H, scale)[0],
                torch.cat(plain.cross_attention_bidirectional_stacked(q, v, mask, cs.H))),
            f"K7a ({hb}, {cs.H}, {hn}, {cs.DH}) {t}": (
                lambda lib: fa.launch_attention_fwd_heads(lib, stream, qh, kh, vh, mh, mh,
                                                          scale)[0],
                plain.attention_heads(qh, kh, vh, mh, mh, scale)),
            f"K7c ({hb}, {cs.H}, {hn}, {cs.DH}) x same {t}": (
                lambda lib: fa.launch_cross_fwd_heads(lib, stream, qh, kh, vh, wh, mh, mh,
                                                      scale)[0],
                plain.cross_attention_heads(qh, kh, vh, wh, mh, mh)[0]),
        }
        if dtype == torch.float32:
            cases[f"K5 ({s}, {n}, 256) f32 last quarter padded"] = (
                lambda lib: fa.launch_attention_fwd(lib, stream, q, k, v, padded, padded, cs.H,
                                                    scale)[0],
                plain.masked_attention_packed(q, k, v, padded, padded, cs.H, scale))
            return cases, {}
        cases[f"K6a B={b} {n} x {n1} bf16"] = (
            lambda lib: fa.launch_cross_fwd_pair(lib, stream, q[:b], q1, v[:b], v1, mask0,
                                                 mask1, cs.H, scale)[0],
            plain.cross_attention_bidirectional_packed(q[:b], q1, v[:b], v1, mask0, mask1,
                                                       cs.H)[0])
        # the serving blocks' attention launch (q pre-scaled, as the block's proj leaves it)
        for sb, nb in ((16, 1024), (8, 2048)):
            (bq, bk, bv), bm = cs.attn_inputs(gen, dtype, nb, nb, nb, sets=sb)
            bq, bmask = bq * scale, bm[nb]
            other = torch.cat([torch.arange(sb // 2, sb), torch.arange(sb // 2)]).cuda()
            for kind, shift in (("self", 0), ("cross", sb // 2)):
                idx = other if shift else torch.arange(sb, device="cuda")
                cases[f"block attention {kind} ({sb}, {nb}, 256) bf16"] = (
                    lambda lib, bq=bq, bk=bk, bv=bv, bmask=bmask, shift=shift:
                        lb._attention_step(lib, stream, bq, bk, bv, bmask, cs.H, shift,
                                           1.0)[0](),
                    plain.masked_attention_packed(bq, bk[idx], bv[idx], bmask, bmask[idx],
                                                  cs.H, 1.0))
        # scaled_dot_product_attention in bf16 on the inputs of K5, K6b and K6a,
        # as contiguous per-head tensors made here (outside its time)
        partner = torch.cat([torch.arange(b, s), torch.arange(b)]).cuda()
        hq, hk, hv, hp, hpv = (cs.heads(x) for x in (q, k, v, q[partner], v[partner]))
        h0, h1, hv0, hv1 = (cs.heads(x) for x in (q[:b], q1, v[:b], v1))
        am, am0, am1 = mask[:, None, None, :], mask0[:, None, None, :], mask1[:, None, None, :]
        sdpa = {
            f"K5 ({s}, {n}, 256)": lambda: F.scaled_dot_product_attention(hq, hk, hv,
                                                                          attn_mask=am),
            f"K6b ({s}, {n}, 256)": lambda: F.scaled_dot_product_attention(
                hq, hp, hpv, attn_mask=am[partner]),
            f"K6a B={b} {n} x {n1}": lambda: (
                F.scaled_dot_product_attention(h0, h1, hv1, attn_mask=am1),
                F.scaled_dot_product_attention(h1, h0, hv0, attn_mask=am0)),
        }
        return cases, sdpa

    fwd32, _ = forwards(torch.float32)
    fwd16, sdpa = forwards(torch.bfloat16)
    # K4 at the main b8 and the MegaDepth b4 shapes
    k4 = {}
    for bb, m in ((8, 1024), (4, 2048)):
        d0 = torch.randn(bb, m, cs.D, generator=gen, device="cuda") * cs.D**-0.25
        d1 = torch.randn(bb, m, cs.D, generator=gen, device="cuda") * cs.D**-0.25
        z0, z1 = (torch.randn(bb, m, generator=gen, device="cuda") for _ in range(2))
        m0, m1 = (torch.rand(bb, m, generator=gen, device="cuda") > 0.2 for _ in range(2))
        fargs = (d0, d1, z0, z1, m0, m1)
        k4[f"B={bb} M=N={m}"] = (fargs, la.log_assignment(*fargs)[0])

    for rnd in range(2):
        order = (lambda d: list(d.items())) if rnd == 0 else (lambda d: list(d.items())[::-1])
        for label, lib in order(libs["attention"]):
            if label == "parent" or label.startswith("bf16"):
                cases = fwd16
            elif label.startswith("f32"):
                cases = fwd32
            else:
                cases = {**fwd32, **fwd16}
            for tag, (launch, ref) in cases.items():
                if tag.startswith("block"):
                    continue
                time_case(f"{tag} round {rnd}", label, lambda: launch(lib), ref, cs.timed,
                          cs.attention_bar if "bf16" in tag else None)
        for label, lib in order(libs["lightglue_block"]):
            for tag, (launch, ref) in fwd16.items():
                if tag.startswith("block"):
                    time_case(f"{tag} round {rnd}", label, lambda: launch(lib), ref, cs.timed,
                              cs.attention_bar)
        for tag, fn in sdpa.items():
            print(f"{tag} round {rnd} SDPA bf16: {cs.timed(fn, 20):.4f} ms by events, "
                  f"{cs.device_ms(fn, 20):.4f} ms device time", flush=True)
        for label, lib in libs["log_assignment"].items():
            for tag, (fargs, ref) in k4.items():
                time_case(f"K4 {tag} f32 round {rnd}", label,
                          lambda: la.launch_log_assignment(lib, stream, *fargs)[0], ref, cs.timed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
