#!/usr/bin/env python3
"""Time the three bf16 launches of the LightGlue self block (proj, attention,
FFN tail; gluefactory_tpu_torch/csrc/lightglue_block.cu) in variant builds of
the source, on one CUDA card:

    python3 scripts/torch_block_variants.py

Each variant substitutes constants or statements in the source and builds it
with nvcc into gluefactory_tpu_torch/_build/variants/. Two kinds: other
pipeline depths of the weight and operand rings (the outputs stay right), and
timing-only removals of one part of a kernel's work (the output is then
wrong; only the time is read), which show what a launch waits on. Every
variant runs on the same inputs at (16, 1024, 256) and (2, 1024, 256), in two
rounds; the max abs error against the plain version is printed beside.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FFN_MMA = "          gf::mma_bf16_m16n8k16(acc[mi][ni], a[mi], &b[ni / 2][(ni % 2) * 2]);\n    }\n  }\n  __syncthreads();  // the W ring"
VARIANTS = {
    "base": [],
    "ffn 2 stages x 32 deep": [("kFBK = 16", "kFBK = 32"), ("kFStages = 4", "kFStages = 2")],
    "ffn 3 stages x 16 deep": [("kFStages = 4", "kFStages = 3")],
    "proj 2 stages x 64 deep": [("kBK = 32, kStages = 3", "kBK = 64, kStages = 2")],
    "proj 4 stages x 32 deep": [("kBK = 32, kStages = 3", "kBK = 32, kStages = 4")],
    "timing only: proj without stores": [
        ("        store_bf16x2(out + (size_t)r * D + col0",
         "        if (ve == 12345.f) store_bf16x2(out + (size_t)r * D + col0")],
    "timing only: proj without operand loads": [
        ("    if (pf < nk) load(pf % kStages, pf * kBK);", "")],
    "timing only: ffn without weight loads": [
        ("    if (pf < nk) load(pf % kFStages, pf * kFBK);", ""),
        ("    if (st < nk) load(st, st * kFBK);", "")],
    "timing only: ffn without mma": [
        (FFN_MMA, FFN_MMA.replace(
            "gf::mma_bf16_m16n8k16(acc[mi][ni], a[mi], &b[ni / 2][(ni % 2) * 2]);",
            "acc[mi][ni][0] += __uint_as_float(a[mi][0] ^ b[ni / 2][(ni % 2) * 2]);"))],
    "timing only: ffn without erf": [("erff(y * 0.70710678118654752f)", "y")],
}


def inlined_headers(mma=(), fwd=()):
    """Substitutions for csrc/attention.cu that inline its headers
    csrc/mma.cuh and csrc/attention_fwd.cuh, each edited by its (old, new)
    pairs: a variant of code the headers hold, built without touching them."""
    from gluefactory_tpu_torch import _ext

    def edited(name, subs):
        text = (_ext.CSRC / name).read_text().replace("#pragma once\n", "")
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"{a[:60]!r} is not in {name}")
            text = text.replace(a, b)
        return text

    tile = edited("attention_fwd.cuh", fwd).replace('#include "mma.cuh"\n', "")
    return [('#include "attention_fwd.cuh"\n', edited("mma.cuh", mma) + tile),
            ('#include "mma.cuh"\n', "")]


def build(variants_by_lib: dict, out: Path, csrc: Path | None = None) -> dict:
    """Build every variant of each <csrc>/<name>.cu (default: this checkout's
    csrc/), all nvcc processes at once, and load them: {name: {label:
    library}}."""
    from gluefactory_tpu_torch import _ext

    csrc = csrc or _ext.CSRC
    procs = {}
    for name, variants in variants_by_lib.items():
        src = (csrc / f"{name}.cu").read_text()
        for i, (label, subs) in enumerate(variants.items()):
            s = src
            for a, b in subs:
                if a not in s:
                    raise SystemExit(f"variant {label!r}: {a[:60]!r} is not in {name}.cu")
                s = s.replace(a, b)
            cu = out / f"{name}_variant_{i}.cu"
            cu.write_text(s)
            so = out / f"lib{name}_variant_{i}.so"
            cmd = [_ext._nvcc(), *_ext.NVCC_FLAGS, f"-I{csrc}", "-o", str(so), str(cu)]
            procs[name, label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), so)
    libs = {name: {} for name in variants_by_lib}
    for (name, label), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {label!r}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.build_log = log  # nvcc's output: ptxas's registers and spills of each kernel
        for fn, argtypes in _ext.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name][label] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_block_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gluefactory_tpu_torch import _ext
    from gluefactory_tpu_torch.ops import lightglue_block as lb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    out = _ext.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    libs = build({"lightglue_block": VARIANTS}, out)["lightglue_block"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = cs.block_weights(gen, cross=False)
    stream = torch.cuda.current_stream().cuda_stream
    for s, n in ((16, 1024), (2, 1024)):
        x, cos, sin, mask = cs.block_inputs(gen, s, n)
        ref = lb.self_block(x, cos, sin, mask, *w)
        for rnd in range(2):
            for name, lib in libs.items():
                steps = lb.self_block_steps(lib, stream, x, cos, sin, mask, *w, 4)
                for step in steps:
                    got = step()
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                t = [cs.timed(step, 30) for step in steps]
                print(f"({s}, {n}) round {rnd} {name}: proj {t[0]:.4f} attention {t[1]:.4f} "
                      f"ffn {t[2]:.4f} ms, sum {sum(t):.4f}; max abs err {err:.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
