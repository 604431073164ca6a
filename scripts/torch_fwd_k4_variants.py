#!/usr/bin/env python3
"""Time the attention forward tile (gluefactory_tpu_torch/csrc/attention_fwd.cuh,
through K5 and K7a of csrc/attention.cu) and the log assignment (K4,
csrc/log_assignment.cu) in variant builds of their sources, on one CUDA card:

    python3 scripts/torch_fwd_k4_variants.py

Each variant substitutes statements in a source and builds it with nvcc into
gluefactory_tpu_torch/_build/variants/ (an edit of the forward tile inlines
its header into the variant of attention.cu). Two kinds. Alternatives that the design
chose against (the output stays right): the forward without its skip of key
tiles that hold no valid key, without its cap of 168 registers a thread
(three blocks a multiprocessor), and with K7a capped too. And timing-only
removals of one part of a kernel's work (the output is then wrong; only the
time is read), which show what a launch waits on: one TF32 pass in place of
the split's three (forward and K4), and K4's product kernel with and without
the log-sum-exp merge but without the finish pass and the argmax merge. K5 and
K6b run at the self and stacked cross forms of a training step, (64, 512,
256) fp32, with ~80% valid keys (K5 also with the last quarter of every set
padded); K7a and K7c at SuperGlue's b8 shape, (8, 4, 1024, 64); K4 at the
main b8 and the MegaDepth b4 shapes. Two rounds; the max abs error against
the plain version is printed beside.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from torch_block_variants import build, inlined_headers  # noqa: E402  (this directory)

K7A_BOUND = "__launch_bounds__(kThreads) attn_fwd_heads_kernel("
FINISH = "  GF_LAUNCH(finish_kernel,"
ARGMAX = "  GF_LAUNCH(argmax_kernel,"
LSE = "  GF_LAUNCH(lse_kernel,"


VARIANTS = {
    "attention": {
        "base": [],
        "no skip of key tiles without a valid key": inlined_headers(
            fwd=[("    if (!any) continue;", "")]),
        "no register cap (two blocks an SM for the cross forwards)": [
            ("__launch_bounds__(kThreads, kFwdBlocks)", "__launch_bounds__(kThreads)")],
        "K7a capped at 168 registers too": [(K7A_BOUND, K7A_BOUND.replace(
            "(kThreads)", "(kThreads, kFwdBlocks)"))],
        "timing only: one TF32 pass": inlined_headers(
            fwd=[("mma_split<kExact, kExact>(", "mma_split<true, true>("),
                 ("mma_split<false, kExact>(", "mma_split<true, true>(")]),
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fwd_k4_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gluefactory_tpu_torch import _ext
    from gluefactory_tpu_torch.ops import attention as plain
    from gluefactory_tpu_torch.ops import fused_attention as fa
    from gluefactory_tpu_torch.ops import log_assignment as la

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
    scale = cs.DH**-0.5

    # the forwards, each a launch through a library and its plain result:
    # K5 and K6b at a training step's self and stacked cross forms, (64, 512,
    # 256) fp32 with ~80% valid keys (K5 also with the last quarter of every
    # set padded: whole key tiles without a key); K7a and K7c at SuperGlue's
    # b8 shape, (8, 4, 1024, 64)
    s, n = 2 * cs.TRAIN_B, cs.TRAIN_N
    (q, k, v), masks = cs.attn_inputs(gen, torch.float32, n, n, n, sets=s)
    mask = masks[n]
    padded = mask.clone()
    padded[:, 3 * n // 4:] = False
    hb, hn = cs.HEADS_B, cs.HEADS_N
    qh, kh, vh, wh = (torch.randn(hb, cs.H, hn, cs.DH, generator=gen, device="cuda")
                      for _ in range(4))
    mh = torch.rand(hb, hn, generator=gen, device="cuda") > 0.2
    fwd = {
        f"K5 ({s}, {n}, 256) f32 80% valid": (
            lambda lib: fa.launch_attention_fwd(lib, stream, q, k, v, mask, mask, cs.H, scale)[0],
            plain.masked_attention_packed(q, k, v, mask, mask, cs.H, scale)),
        f"K5 ({s}, {n}, 256) f32 last quarter padded": (
            lambda lib: fa.launch_attention_fwd(lib, stream, q, k, v, padded, padded, cs.H,
                                                scale)[0],
            plain.masked_attention_packed(q, k, v, padded, padded, cs.H, scale)),
        f"K6b ({s}, {n}, 256) f32": (
            lambda lib: fa.launch_cross_fwd_stacked(lib, stream, q, v, mask, cs.H, scale)[0],
            torch.cat(plain.cross_attention_bidirectional_stacked(q, v, mask, cs.H))),
        f"K7a ({hb}, {cs.H}, {hn}, {cs.DH}) f32": (
            lambda lib: fa.launch_attention_fwd_heads(lib, stream, qh, kh, vh, mh, mh, scale)[0],
            plain.attention_heads(qh, kh, vh, mh, mh, scale)),
        f"K7c ({hb}, {cs.H}, {hn}, {cs.DH}) x same f32": (
            lambda lib: fa.launch_cross_fwd_heads(lib, stream, qh, kh, vh, wh, mh, mh, scale)[0],
            plain.cross_attention_heads(qh, kh, vh, wh, mh, mh)[0]),
    }
    # K4 at the main b8 and the MegaDepth b4 shapes
    k4 = {}
    for b, m in ((8, 1024), (4, 2048)):
        d0 = torch.randn(b, m, cs.D, generator=gen, device="cuda") * cs.D**-0.25
        d1 = torch.randn(b, m, cs.D, generator=gen, device="cuda") * cs.D**-0.25
        z0, z1 = (torch.randn(b, m, generator=gen, device="cuda") for _ in range(2))
        m0, m1 = (torch.rand(b, m, generator=gen, device="cuda") > 0.2 for _ in range(2))
        args = (d0, d1, z0, z1, m0, m1)
        k4[f"B={b} M=N={m}"] = (args, la.log_assignment(*args)[0])

    for rnd in range(2):
        for label, lib in libs["attention"].items():
            for tag, (launch, ref) in fwd.items():
                run = lambda: launch(lib)
                got = run()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                print(f"{tag} round {rnd} {label}: {cs.timed(run, 20):.4f} ms; "
                      f"max abs err {err:.4g}", flush=True)
        for label, lib in libs["log_assignment"].items():
            for tag, (args, ref) in k4.items():
                run = lambda: la.launch_log_assignment(lib, stream, *args)
                got = run()[0]
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                print(f"K4 {tag} f32 round {rnd} {label}: {cs.timed(run, 20):.4f} ms; "
                      f"max abs err {err:.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
