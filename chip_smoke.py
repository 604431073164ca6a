#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SuperPoint-open + LightGlue (full depth,
adaptive, training) and SuperGlue on one GPU.

    python3 chip_smoke.py [--train-batch PAIRS]

`--train-batch` (default 32) sets the pairs a training step takes in phases
3 and 5. Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel of gluefactory_tpu_torch/csrc with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (the block kernels also at N = 512 and 1000),
     with its time, the plain version's, a library yardstick's and the bound
     the work allows; for the blocks also the time of each of their three
     launches and of the same block as bf16 torch calls. The build log's
     registers and spills are printed, and the bf16 block kernels, the
     attention forwards (K5, K6a, K6b, K7a, K7c and the fp32 block
     attention) and backward (K7b), block 0 (K8) and the log assignment's
     product (K4) must show HMMA (tensor-core) instructions in their SASS;
  4. end to end: the two-view pipeline with the committed weights on a
     synthetic pair warped by a known homography, 480x640 / 1024 keypoints
     at batch 8 (launch counts, finiteness, agreement with the port's plain
     path, pairs/s, batch-1 latency, match precision), then the MegaDepth
     protocol shape 1200x1600 / 2048 keypoints at batch 4;
  5. training: the trainer at the homography configuration (frozen
     SuperPoint-open, 512 keypoints, LightGlue 9 x 256 in fp32, per-layer
     checkpointing, deep supervision) on 480x640 synthetic pairs at batch
     32: the first step against the plain path, 2 warm-up and 5 timed steps
     (launch counts, finite losses, which parameters moved), the non-finite
     veto, and one step of the matcher alone with 512 x 384 keypoints (the
     two-array cross attention);
  6. adaptive serving: SuperPoint-open with the fused block 0 feeding
     LightGlue with early exit and width pruning, 480x640 / 1024 keypoints
     at batch 8 and batch 1 on easy pairs (launch counts against the exit
     layer, agreement with the port's plain path in fp32 and in bf16,
     pairs/s and latency against full depth on the same pairs, the cost of
     the per-layer host read);
  7. SuperGlue (9 layer pairs x 256, 50 Sinkhorn iterations, seeded
     weights) on SuperPoint-open's features at batch 8: 36 per-head
     attention launches a forward, agreement with the plain path.
The last three lines of standard output are the card's name and power
limit, the kernels' JSON record and the result JSON. Without CUDA, or
without the package beside it, it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12  # dense tensor-core FLOP/s, H100 SXM
PEAK_TF32 = 495e12  # dense tensor-core FLOP/s on TF32 operands
# the least time for a product at fp32 accuracy: three TF32 passes (split
# operands), faster than the 67 TFLOP/s of fp32 outside the tensor cores
PEAK_FP32_PRODUCT = PEAK_TF32 / 3
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
    out, ref = out.detach().float(), ref.detach().float()
    diff = (out - ref).abs()
    bad = diff > atol + rtol * ref.abs()
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


def torch_block(kind, x, cos, sin, mask, w):
    """The same block as bf16 torch calls (`@`, scaled_dot_product_attention,
    layer_norm, gelu): a yardstick that the port never calls."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops.attention import apply_rotary

    s, n, _ = x.shape
    heads = lambda t: t.view(s, n, H, DH).transpose(1, 2)
    if kind == "self":
        wqkv, bqkv, *tail = w
        q, k, v = (x @ wqkv + bqkv).split(D, -1)
        c, sn = cos.repeat(1, 1, H), sin.repeat(1, 1, H)
        q, k, o = apply_rotary(q, c, sn), apply_rotary(k, c, sn), torch.arange(s, device="cuda")
    else:
        wqk, bqk, wv, bv, *tail = w
        q, v = x @ wqk + bqk, x @ wv + bv
        o = (torch.arange(s, device="cuda") + s // 2) % s
        k, v = q[o], v[o]
    ctx = F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                         attn_mask=mask[o][:, None, None, :])
    wout, bout, w1, b1, lns, lnb, w2, b2 = tail
    msg = ctx.transpose(1, 2).reshape(s, n, D) @ wout + bout
    h = F.gelu(F.layer_norm(torch.cat([x, msg], -1) @ w1 + b1, (2 * D,), lns, lnb, eps=1e-5))
    return x + (h @ w2 + b2)


def check_block(kind, s, n, seed, also=()):
    """Self or cross block: kernel vs plain, masked and unmasked, at N = n
    and at each N of `also` (same S); times of the block, of each of its
    three launches, of the plain version and of two yardsticks."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch import _ext
    from gluefactory_tpu_torch.ops import lightglue_block as lb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = block_weights(gen, cross=kind == "cross")
    err = 0.0
    for nn in (*also, n):
        x, cos, sin, mask = block_inputs(gen, s, nn)
        if kind == "self":
            kern = lambda m: lb.fused_self_block(x, cos, sin, mask, *w, masked=m)
            plain = lambda m: lb.self_block(x, cos, sin, mask, *w, masked=m)
        else:
            kern = lambda m: lb.fused_cross_block(x, mask, *w, masked=m)
            plain = lambda m: lb.cross_block(x, mask, *w, masked=m)
        for m in (False, True):
            out = kern(m)
            torch.cuda.synchronize()
            err = max(err, compare(out, plain(m), "bfloat16",
                                   f"{kind} block s={s} n={nn} masked={m}"))
    ms = timed(lambda: kern(True), 10)
    plain_ms = timed(lambda: plain(True), 3, warmup=1)

    # the three launches one by one, on the same inputs
    lib, stream = _ext.load("lightglue_block"), torch.cuda.current_stream().cuda_stream
    chain = lb.self_block_steps if kind == "self" else lb.cross_block_steps
    args = (x, cos, sin, mask) if kind == "self" else (x, mask)
    steps = chain(lib, stream, *args, *w, H)
    for step in steps:
        step()
    split = [timed(step, 20) for step in steps]
    torch_ms = timed(lambda: torch_block(kind, x, cos, sin, mask, w), 10)

    # yardstick: the attention core as one scaled_dot_product_attention call
    other = torch.arange(s, device="cuda")
    if kind == "cross":
        other = (other + s // 2) % s
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
    ns = ", ".join(str(k) for k in (*also, n))
    log(f"[kernel] {kind} block ({s}, {n}, 256) bf16: {ms:.4f} ms, {flops / ms / 1e9:.1f} "
        f"TFLOP/s; launches proj {split[0]:.4f}, attention {split[1]:.4f}, FFN tail "
        f"{split[2]:.4f} ms; the block as bf16 torch calls {torch_ms:.4f} ms; held against "
        f"the plain version at N = {ns}, masked and unmasked")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, tol="atol %g + rtol %g" % TOL["bfloat16"],
                split_ms=split, torch_ms=torch_ms)


def kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel symbol: the nested names without
    the anonymous namespace, and <float> for a float instantiation."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, parts = 3, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        k = int(mangled[i:j])
        parts.append(mangled[j:j + k])
        i = j + k
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL__N"))
    return name + ("<float>" if mangled[i:i + 2] == "If" else "")


def build_report():
    """Registers and spills of every kernel, from the nvcc logs (-Xptxas -v)."""
    import re

    from gluefactory_tpu_torch import _ext

    for logf in sorted(_ext.BUILD.glob("*.log")):
        fn, spill = None, ""
        for line in logf.read_text().splitlines():
            if m := re.search(r"Compiling entry function '([^']+)'", line):
                fn = kernel_name(m.group(1))
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            elif (m := re.search(r"Used (\d+) registers", line)) and fn:
                log(f"[build] {logf.stem} {fn}: {m.group(1)} registers, {spill}")
                fn, spill = None, ""


# library: (kernel-name prefixes, kernels with those prefixes), each of which
# must have HMMA (tensor-core) instructions in its SASS
TENSOR_CORE_KERNELS = {
    # the bf16 block kernels and the fp32 block attention (the forward tile)
    "lightglue_block": (("tc::", "attn_kernel"), 4),
    # the forwards (K5, K6b, K6a, K7a, K7c) and K7b's dk/dv and dq kernels,
    # fp32 and bf16
    "attention": (("attn_fwd_kernel", "cross_fwd_stacked_kernel", "cross_fwd_pair_kernel",
                   "attn_fwd_heads_kernel", "cross_fwd_heads_kernel", "attn_bwd_dkv_kernel",
                   "attn_bwd_dq_kernel"), 14),
    "block0_conv": (("block0_kernel",), 1),
    "log_assignment": (("sim_kernel",), 1),  # K4's product
}


def check_tensor_cores():
    """Fail unless every kernel of TENSOR_CORE_KERNELS has HMMA instructions
    in its SASS (split-TF32 products show as HMMA.1684.F32.TF32)."""
    from gluefactory_tpu_torch import _ext

    cuobjdump = Path(_ext._nvcc()).parent / "cuobjdump"
    for lib, (prefix, n) in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(_ext._target(lib))],
                              capture_output=True, text=True, timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = kernel_name(line.split("Function :")[1].strip())
                counts[fn] = 0
            elif fn is not None and "HMMA" in line:
                counts[fn] += 1
        log(f"[build] {lib} HMMA instructions in the SASS: " + ", ".join(
            f"{k} {v}" for k, v in sorted(counts.items())))
        tc = {k: v for k, v in counts.items() if k.startswith(prefix)}
        if len(tc) != n or not all(tc.values()):
            fail(f"the {lib} kernels {prefix} do not all use the tensor cores: {tc}")


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
    bms, by = bound(flops, nbytes, PEAK_FP32_PRODUCT)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bms, bound_by=by,
                tol="atol %g + rtol %g, argmax >= 99.9%% equal" % TOL["float32"])


# ------------------------------------------- phase 3: the training attention
TRAIN_B, TRAIN_N, TRAIN_N1 = 32, 512, 384  # pairs a step, keypoints, the shorter set of K6a
SRC_ATT = "gluefactory_tpu_torch/csrc/attention.cu"
PAL_ATT = "gluefactory_tpu/ops/pallas_attention.py"


def attn_inputs(gen, dtype, *lengths, sets):
    """One (sets, n, D) tensor per length, and one ~80% valid mask per
    distinct length."""
    import torch

    xs = [torch.randn(sets, n, D, generator=gen, device="cuda").to(dtype) for n in lengths]
    masks = {n: torch.rand(sets, n, generator=gen, device="cuda") > 0.2 for n in set(lengths)}
    return xs, masks


def heads(x):
    """(S, N, D) -> contiguous (S, H, N, Dh), the layout of the yardstick."""
    s, n, _ = x.shape
    return x.reshape(s, n, H, DH).transpose(1, 2).contiguous()


def autograd_reference(fn, inputs, grads_out):
    """Gradients of the plain forward `fn` by torch.autograd, in fp32."""
    import torch

    leaves = [t.detach().float().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, [g.float() for g in grads_out])


def attention_bound(pairs, n_products, tensors_bytes):
    """Bound of `n_products` N x N x 64 products per head over the valid
    (query, key) pairs, at fp32 accuracy (the training type)."""
    return bound(2.0 * n_products * D * pairs, tensors_bytes, PEAK_FP32_PRODUCT)


def check_self_attention(seed):
    """K5 and the self form of K7b at (64, 512, 256): fp32 (timed) and bf16."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import attention as plain
    from gluefactory_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    s, n = 2 * TRAIN_B, TRAIN_N
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        (q, k, v, do), masks = attn_inputs(gen, dtype, n, n, n, n, sets=s)
        mask = masks[n]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.fused_attention_packed(*leaves, mask, mask, H)
        grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
        torch.cuda.synchronize()
        ref = plain.self_attention_packed(q, k, v, mask, H)
        err_f = compare(out, ref, name, f"K5 forward {name}")
        if float(out.detach()[~mask].abs().max()) != 0.0:
            fail(f"K5 {name}: an invalid query row is not exactly zero")
        fn = lambda a, b, c: plain.self_attention_packed(a, b, c, mask, H)
        err_b = max(compare(g, r, name, f"K7b self form d{w} {name}")
                    for g, r, w in zip(grads, autograd_reference(fn, (q, k, v), (do,)), "qkv"))
        log(f"[kernel] K5 / K7b self form {name}: forward max abs err {err_f:.3g}, "
            f"gradients {err_b:.3g} (atol %g + rtol %g)" % TOL[name])
        if dtype != torch.float32:
            continue
        ms_f = timed(lambda: fa.fused_attention_packed(q, k, v, mask, mask, H), 10)
        # the backward alone: autograd calls the backward kernels on the saved forward
        ms_b = timed(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 10)
        plain_f = timed(lambda: plain.self_attention_packed(q, k, v, mask, H), 3, warmup=1)
        plain_b = timed(lambda: plain.attention_backward(q, k, v, mask, mask, do, H, DH**-0.5),
                        3, warmup=1)
        lq, lk, lv = (heads(t).requires_grad_() for t in (q, k, v))
        amask = mask[:, None, None, :]
        lib_f = timed(lambda: F.scaled_dot_product_attention(lq.detach(), lk.detach(),
                                                             lv.detach(), attn_mask=amask), 10)
        lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask)
        ldo = heads(do)
        lib_b = timed(lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True), 10)
        nv = mask.sum(1).double()
        pairs = float((nv * nv).sum())
        act = s * n * D * 4
        bf, byf = attention_bound(pairs, 2, 4 * act + s * n + s * H * n * 4)
        bb, byb = attention_bound(pairs, 5, 8 * act + s * n + s * H * n * 4)
        tol = "atol %g + rtol %g" % TOL[name]
        rows["K5"] = dict(max_abs_err=err_f, ms=ms_f, plain_ms=plain_f, library_ms=lib_f,
                          bound_ms=bf, bound_by=byf, tol=tol)
        rows["K7b self"] = dict(max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, library_ms=lib_b,
                                bound_ms=bb, bound_by=byb, tol=tol)
    return rows


def check_cross_attention(form, seed):
    """K6b (stacked, N = 512) or K6a (two arrays, 512 x 384) with the
    gradients of the shared projection, fp32 (timed) and bf16; for the
    stacked form also the cross form of K7b alone."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import attention as plain
    from gluefactory_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, m = TRAIN_B, TRAIN_N
    n = m if form == "stacked" else TRAIN_N1
    tag = "K6b" if form == "stacked" else "K6a"
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        (qk0, v0, g0, qk1, v1, g1), masks = attn_inputs(gen, dtype, m, m, m, n, n, n, sets=b)
        mask0 = masks[m]
        mask1 = masks[n] if n != m else torch.rand(b, n, generator=gen, device="cuda") > 0.2
        if form == "stacked":
            args = (torch.cat([qk0, qk1]), torch.cat([v0, v1]))
            mk = (torch.cat([mask0, mask1]),)
            kern, ref_fn = fa.fused_cross_attention_stacked, plain.cross_attention_bidirectional_stacked
        else:
            args, mk = (qk0, qk1, v0, v1), (mask0, mask1)
            kern, ref_fn = fa.fused_cross_attention_packed, plain.cross_attention_bidirectional_packed
        leaves = [t.clone().requires_grad_() for t in args]
        out = kern(*leaves, *mk, H)
        grads = torch.autograd.grad(out, leaves, (g0, g1))
        torch.cuda.synchronize()
        ref = ref_fn(*args, *mk, H)
        err_f = max(compare(o, r, name, f"{tag} forward m{i} {name}")
                    for i, (o, r) in enumerate(zip(out, ref)))
        fn = lambda *a: ref_fn(*a, *mk, H)
        err_b = max(compare(g, r, name, f"{tag} gradient {i} {name}")
                    for i, (g, r) in enumerate(zip(grads, autograd_reference(fn, args, (g0, g1)))))
        log(f"[kernel] {tag} {name}: forward max abs err {err_f:.3g}, gradients (dqk, dv) "
            f"{err_b:.3g} (atol %g + rtol %g)" % TOL[name])
        if dtype != torch.float32:
            continue
        ms_f = timed(lambda: kern(*args, *mk, H), 10)
        plain_f = timed(lambda: ref_fn(*args, *mk, H), 3, warmup=1)
        # yardstick: the two directions as scaled_dot_product_attention calls
        # (one call over the stacked sets when both have the same length)
        h0, h1, hv0, hv1 = heads(qk0), heads(qk1), heads(v0), heads(v1)
        a0, a1 = mask0[:, None, None, :], mask1[:, None, None, :]
        if form == "stacked":
            hq, hk, hv = torch.cat([h0, h1]), torch.cat([h1, h0]), torch.cat([hv1, hv0])
            am = torch.cat([a1, a0])
            lib_f = timed(lambda: F.scaled_dot_product_attention(hq, hk, hv, attn_mask=am), 10)
        else:
            lib_f = timed(lambda: (F.scaled_dot_product_attention(h0, h1, hv1, attn_mask=a1),
                                   F.scaled_dot_product_attention(h1, h0, hv0, attn_mask=a0)), 10)
        pairs = float((mask0.sum(1).double() * mask1.sum(1).double()).sum())
        act0, act1 = b * m * D * 4, b * n * D * 4
        # one similarity and two message products serve both directions
        bf, byf = attention_bound(pairs, 3, 3 * (act0 + act1) + b * (m + n) * (1 + H * 4))
        tol = "atol %g + rtol %g" % TOL[name]
        rows[tag] = dict(max_abs_err=err_f, ms=ms_f, plain_ms=plain_f, library_ms=lib_f,
                         bound_ms=bf, bound_by=byf, tol=tol)
        if form != "stacked":
            continue
        # K7b, cross form: one direction, queries of set 0 against keys of set 1
        direction = lambda q, k, v: plain.masked_attention_packed(q, k, v, mask0, mask1, H, DH**-0.5)
        one = [t.clone().requires_grad_() for t in (qk0, qk1, v1)]
        out01 = fa.fused_attention_packed(*one, mask0, mask1, H)
        got = torch.autograd.grad(out01, one, g0, retain_graph=True)
        err = max(compare(g, r, name, f"K7b cross form d{w}") for g, r, w in zip(
            got, autograd_reference(direction, (qk0, qk1, v1), (g0,)), "qkv"))
        ms_b = timed(lambda: torch.autograd.grad(out01, one, g0, retain_graph=True), 10)
        plain_b = timed(lambda: plain.attention_backward(qk0, qk1, v1, mask0, mask1, g0, H,
                                                         DH**-0.5), 3, warmup=1)
        lq, lk, lv = (t.requires_grad_() for t in (h0, h1, hv1))
        lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=a1)
        ldo = heads(g0)
        lib_b = timed(lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True), 10)
        bb, byb = attention_bound(pairs, 5, 8 * act0 + b * (m + n) + b * H * m * 4)
        rows["K7b cross"] = dict(max_abs_err=err, ms=ms_b, plain_ms=plain_b, library_ms=lib_b,
                                 bound_ms=bb, bound_by=byb, tol=tol)
    return rows


# ------------------------------------------------------------------ phase 4
def homography(seed, h, w, difficulty=1.0):
    """A mild random homography in pixel coordinates (3x3 float64 array):
    rotation within 8 degrees, translation within 5% of the side; `difficulty`
    scales the range of the scale change and of the perspective terms."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ang = math.radians(rng.uniform(-8, 8))
    sc = 1.0 + (rng.uniform(0.9, 1.1) - 1.0) * difficulty
    c, s = math.cos(ang) * sc, math.sin(ang) * sc
    cx, cy = w / 2, h / 2
    tx, ty = rng.uniform(-0.05, 0.05) * w, rng.uniform(-0.05, 0.05) * h
    A = np.array([[c, -s, cx + tx - c * cx + s * cy], [s, c, cy + ty - s * cx - c * cy], [0, 0, 1]])
    P = np.eye(3)
    P[2, :2] = rng.uniform(-2e-5, 2e-5, 2) * 640 / w * difficulty
    return P @ A


def synthetic_pair(seed, b, h, w, difficulty=1.0):
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
    hs = torch.from_numpy(np.stack([homography(seed * 100 + i, h, w, difficulty)
                                    for i in range(b)]))
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


def pipeline(k, extractor=None, matcher=None):
    """The two-view pipeline with the committed weights; `extractor` and
    `matcher` override the main path's configuration."""
    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.weights import load_hermetic

    conf = {
        "extractor": {"name": "superpoint_open", "max_num_keypoints": k, **(extractor or {})},
        "matcher": {"name": "lightglue", "filter_threshold": 0.1, "mp": True,
                    "collect_layers": False, **(matcher or {})},
    }
    pipe = get_model("two_view_pipeline")(conf, device="cuda")
    pipe.load_state_dict(load_hermetic(device="cuda"), strict=True)
    return pipe.eval()


def counters():
    from gluefactory_tpu_torch.ops import lightglue_block as lb
    from gluefactory_tpu_torch.ops import log_assignment as la

    return lb.fused_self_block, lb.fused_cross_block, la.fused_log_assignment


def set_launches(kernels, n, counts):
    """Record the launch counts of one pipeline run on the block and
    assignment rows of size n."""
    for k in kernels:
        if "key" not in k and str(n) in k["name"]:
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


# ------------------------------------------------------------------ phase 5
def training_batch(seed, b, h, w):
    import torch

    img0, img1, hs = synthetic_pair(seed, b, h, w)
    size = torch.tensor([[float(w), float(h)]] * b, device="cuda")
    return {"view0": {"image": img0, "image_size": size},
            "view1": {"image": img1, "image_size": size}, "H_0to1": hs.float()}


def reset_train_counts():
    from gluefactory_tpu_torch.ops import fused_attention as fa

    for fn in (fa.fused_attention_packed, fa.fused_cross_attention_stacked,
               fa.fused_cross_attention_packed, fa.fused_attention_backward):
        fn.launches = 0
    fa.fused_attention_backward.cross_launches = 0


def read_train_counts():
    """Launches of K5, K6b, K6a, and of K7b in its self and cross form."""
    from gluefactory_tpu_torch.ops import fused_attention as fa

    bwd = fa.fused_attention_backward
    return {"K5": fa.fused_attention_packed.launches,
            "K6b": fa.fused_cross_attention_stacked.launches,
            "K6a": fa.fused_cross_attention_packed.launches,
            "K7b self": bwd.launches - bwd.cross_launches, "K7b cross": bwd.cross_launches}


def run_training():
    """Phase 5; returns the launches per training step of each attention kernel."""
    import torch

    from gluefactory_tpu_torch.train.step import TrainState, make_optimizer, make_train_step
    from gluefactory_tpu_torch.train.trainer import Trainer, homography_train_conf
    from gluefactory_tpu_torch.weights import load_hermetic

    b, h, w, layers = TRAIN_B, 480, 640, 9
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def make(flash, mark=None):
        conf = homography_train_conf()
        conf["model"]["matcher"]["flash"] = flash
        trainer = Trainer(conf, device="cuda", mark=mark)
        trainer.load_weights(load_hermetic(device="cuda"))
        return trainer

    trainer = make(True, mark)
    mconf = trainer.model.matcher.conf
    if (mconf.n_layers, mconf.descriptor_dim, mconf.num_heads, mconf.mp, mconf.checkpointed,
            trainer.model.extractor.conf.max_num_keypoints) != (layers, D, H, False, True, TRAIN_N):
        fail("the training configuration is not 9 x 256, 4 heads, fp32, checkpointed, 512 keypoints")
    batches = [training_batch(10 + i, b, h, w) for i in range(3)]

    # the first step's loss and two gradients against the plain path on the card
    named = ("matcher.self_Wqkv_w", "matcher.assign_proj_w")

    def loss_and_grads(tr):
        params = dict(tr.model.named_parameters())
        pred = tr.model(batches[0])
        losses, _ = tr.model.loss(pred, batches[0])
        total = losses["total"].mean()
        grads = torch.autograd.grad(total, [params[k] for k in named])
        return float(total.detach()), grads, float(losses["num_matchable"].mean())

    total, grads, matchable = loss_and_grads(trainer)
    ref_total, ref_grads, _ = loss_and_grads(make(False))
    if not abs(total - ref_total) <= 1e-4 * abs(ref_total):
        fail(f"training: first total {total} against the plain path's {ref_total} (rtol 1e-4)")
    for key, g, r in zip(named, grads, ref_grads):
        diff, top = float((g - r).abs().max()), float(r.abs().max())
        if not (top > 0 and diff <= 1e-3 * top + 1e-7):
            fail(f"training: gradient of {key} differs from the plain path's by {diff:.3g} "
                 f"(max |g| {top:.3g}; tolerance 1e-3 max|g| + 1e-7)")
        log(f"[train] first step: d total / d {key} equals the plain path's within "
            f"{diff:.3g} (max |g| {top:.3g}; tolerance 1e-3 max|g| + 1e-7)")
    log(f"[train] first step: total {total:.6f}, plain path {ref_total:.6f} (rtol 1e-4); "
        f"ground-truth positives {matchable:.1f} of {TRAIN_N} keypoints "
        f"({matchable / TRAIN_N:.3f})")

    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    history = trainer.train(batches, steps=2)  # warm-up
    starts = []

    def feed(n):
        for i in range(n):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            yield batches[i % len(batches)]

    steps = 5
    marks.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    t0 = time.perf_counter()
    history += trainer.train(feed(steps), steps=steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = read_train_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = {"K5": 2 * layers, "K6b": 2 * layers, "K6a": 0, "K7b self": layers,
                "K7b cross": 2 * layers}
    log(f"[train] launches in {steps} steps: {counts}")
    if counts != {k: v * steps for k, v in per_step.items()}:
        fail(f"training: expected {per_step} launches a step (checkpointing runs each "
             f"forward twice), got {counts} in {steps} steps")
    for i, losses in enumerate(history):
        if not all(math.isfinite(v) for v in losses.values()):
            fail(f"training: non-finite loss at step {i}: {losses}")
        if losses["skipped_nonfinite"] != 0:
            fail(f"training: step {i} was skipped")
    if trainer.state.step != 2 + steps or trainer.state.optimizer.count != 2 + steps:
        fail("training: the step counters did not advance once a step")
    phases = [[a.elapsed_time(z) for a, z in zip([starts[i]] + marks[3 * i:3 * i + 2],
                                                 marks[3 * i:3 * i + 3])] for i in range(steps)]
    fwd_ms, bwd_ms, opt_ms = (sum(p[j] for p in phases) / steps for j in range(3))
    after = trainer.model.state_dict()
    for key, old in before.items():
        same = torch.equal(old, after[key])
        if key.startswith("matcher.") and same:
            fail(f"training: parameter {key} did not change")
        if key.startswith("extractor.") and not same:
            fail(f"training: frozen extractor tensor {key} changed")
    with torch.no_grad():
        views = [trainer.model.extractor(batches[0][v]) for v in ("view0", "view1")]
    feats = {f"{k}{i}": t for i, view in enumerate(views) for k, t in view.items()}
    ext_ms = timed(lambda: [trainer.model.extractor(batches[0][v]) for v in ("view0", "view1")], 3)
    gt_ms = timed(lambda: trainer.model.ground_truth({**batches[0], **feats}), 3)
    log(f"[train] {step_ms:.2f} ms/step, {b * 1e3 / step_ms:.2f} pairs/s trained at "
        f"{h}x{w} / {TRAIN_N} keypoints / batch {b}, fp32, {layers} layers checkpointed; "
        f"forward {fwd_ms:.2f} ms (of it extractor {ext_ms:.2f}, ground truth {gt_ms:.2f}), "
        f"backward {bwd_ms:.2f} ms, veto + optimizer {opt_ms:.2f} ms; "
        f"peak memory {peak / 2**20:.0f} MiB; losses total "
        + " ".join(f"{x['total']:.4f}" for x in history))

    # the veto: NaN descriptors (a NaN image) must leave everything as it was
    opt = trainer.state.optimizer
    before = [v.clone() for v in trainer.model.state_dict().values()] + \
        [t.clone() for t in opt.mu + opt.nu]
    poisoned = {**batches[1], "view0": {**batches[1]["view0"],
                                        "image": torch.full_like(batches[1]["view0"]["image"],
                                                                 float("nan"))}}
    out = trainer.train([poisoned], steps=1)[0]
    after = list(trainer.model.state_dict().values()) + opt.mu + opt.nu
    if out["skipped_nonfinite"] != 1 or opt.count != 2 + steps or trainer.state.step != 3 + steps:
        fail(f"training: the poisoned batch was not vetoed: {out}, count {opt.count}")
    if not all(torch.equal(a, z) for a, z in zip(before, after)):
        fail("training: the vetoed step changed a parameter or an Adam moment")
    log("[train] veto: a NaN batch reports skipped_nonfinite = 1 and leaves parameters, "
        "Adam moments and Adam's count bit-identical")

    # m != n: the matcher alone on 512 x 384 keypoints takes the two-array path
    matcher = trainer.model.matcher
    data = {k: (t[:, :TRAIN_N1] if k.endswith("1") else t) for k, t in feats.items()}
    data = {**batches[0], **data}
    data.update(trainer.model.ground_truth(data))
    params = dict(matcher.named_parameters())
    state = TrainState(0, params, make_optimizer(trainer.conf.train, params))
    reset_train_counts()
    state, losses = make_train_step(matcher)(state, data)
    torch.cuda.synchronize()
    counts2 = read_train_counts()
    expect = {"K5": 4 * layers, "K6b": 0, "K6a": 2 * layers, "K7b self": 2 * layers,
              "K7b cross": 2 * layers}
    log(f"[train] m != n step ({TRAIN_N} x {TRAIN_N1}): launches {counts2}, "
        f"total {float(losses['total']):.4f}")
    if counts2 != expect:
        fail(f"training, m != n: expected {expect} launches, got {counts2}")
    if not math.isfinite(float(losses["total"])) or float(losses["skipped_nonfinite"]) != 0:
        fail(f"training, m != n: {losses}")
    per_step["K6a"] = counts2["K6a"]
    return per_step


# ------------------------------ phase 3: the per-head attention and block 0
HEADS_B, HEADS_N = 8, 1024  # SuperGlue's attention at the main shape: (8, 4, 1024, 64)


def heads_inputs(gen, b, *lengths):
    import torch

    xs = [torch.randn(b, H, n, DH, generator=gen, device="cuda") for n in lengths]
    masks = {n: torch.rand(b, n, generator=gen, device="cuda") > 0.2 for n in set(lengths)}
    return xs, masks


def check_heads_attention(seed):
    """K7a at (8, 4, 1024, 64) fp32 through `ops.attention.masked_attention`,
    forward and gradients (K7b on the per-head layout); Nq != Nk once."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import attention as ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, n = HEADS_B, HEADS_N
    err_f = err_b = 0.0
    for nq, nk in ((n, 768), (n, n)):
        (q, k, v, do), masks = heads_inputs(gen, b, nq, nk, nk, nq)
        mq = masks[nq]
        mk = masks[nk] if nk != nq else torch.rand(b, nk, generator=gen, device="cuda") > 0.2
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.masked_attention(*leaves, mq, mk)
        grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
        torch.cuda.synchronize()
        fn = lambda a, b_, c: ops.attention_heads(a, b_, c, mq, mk, DH**-0.5)
        err_f = max(err_f, compare(out, fn(q, k, v), "float32", f"K7a forward {nq} x {nk}"))
        if float(out.detach().transpose(1, 2)[~mq].abs().max()) != 0.0:
            fail("K7a: an invalid query row is not exactly zero")
        err_b = max(err_b, max(
            compare(g, r, "float32", f"K7a gradient d{w} {nq} x {nk}")
            for g, r, w in zip(grads, autograd_reference(fn, (q, k, v), (do,)), "qkv")))
    log(f"[kernel] K7a / K7b per-head form: forward max abs err {err_f:.3g}, gradients "
        f"{err_b:.3g} (atol %g + rtol %g)" % TOL["float32"])
    ms = timed(lambda: ops.masked_attention(q, k, v, mq, mk), 10)
    ms_b = timed(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 10)
    plain_ms = timed(lambda: fn(q, k, v), 3, warmup=1)
    amask = mk[:, None, None, :]
    lib_ms = timed(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask), 10)
    pairs = float((mq.sum(1).double() * mk.sum(1).double()).sum())
    act = b * n * D * 4
    bms, by = attention_bound(pairs, 2, 4 * act + 2 * b * n + b * H * n * 4)
    log(f"[kernel] K7b on the per-head layout, one direction (8, 4, 1024, 64) f32: "
        f"{ms_b:.4f} ms")
    return dict(max_abs_err=err_f, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, tol="atol %g + rtol %g" % TOL["float32"])


def check_heads_cross(seed):
    """K7c at (8, 4, 1024, 64) x (8, 4, 1024, 64) fp32 through
    `ops.attention.cross_attention_bidirectional`, forward and gradients; M != N
    once. Returns its row and its launches through that entry point."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import attention as ops
    from gluefactory_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, n = HEADS_B, HEADS_N
    err_f = err_b = 0.0
    for m_, n_ in ((768, n), (n, n)):
        (qk0, v0, g0, qk1, v1, g1), masks = heads_inputs(gen, b, m_, m_, m_, n_, n_, n_)
        mask0 = masks[m_]
        mask1 = masks[n_] if n_ != m_ else torch.rand(b, n_, generator=gen, device="cuda") > 0.2
        args = (qk0, qk1, v0, v1)
        leaves = [t.clone().requires_grad_() for t in args]
        out = ops.cross_attention_bidirectional(*leaves, mask0, mask1)
        grads = torch.autograd.grad(out, leaves, (g0, g1))
        torch.cuda.synchronize()
        fn = lambda *a: ops.cross_attention_heads(*a, mask0, mask1)
        err_f = max(err_f, max(compare(o, r, "float32", f"K7c forward m{i} {m_} x {n_}")
                               for i, (o, r) in enumerate(zip(out, fn(*args)))))
        err_b = max(err_b, max(
            compare(g, r, "float32", f"K7c gradient {i} {m_} x {n_}")
            for i, (g, r) in enumerate(zip(grads, autograd_reference(fn, args, (g0, g1))))))
    log(f"[kernel] K7c: forward max abs err {err_f:.3g}, gradients (dqk, dv) {err_b:.3g} "
        f"(atol %g + rtol %g)" % TOL["float32"])
    # the entry point's own launch, counted apart from the comparisons above
    fa.fused_cross_attention.launches = 0
    ops.cross_attention_bidirectional(*args, mask0, mask1)
    torch.cuda.synchronize()
    launches = fa.fused_cross_attention.launches
    ms = timed(lambda: ops.cross_attention_bidirectional(*args, mask0, mask1), 10)
    plain_ms = timed(lambda: fn(*args), 3, warmup=1)
    a0, a1 = mask0[:, None, None, :], mask1[:, None, None, :]
    lib_ms = timed(lambda: (F.scaled_dot_product_attention(qk0, qk1, v1, attn_mask=a1),
                            F.scaled_dot_product_attention(qk1, qk0, v0, attn_mask=a0)), 10)
    pairs = float((mask0.sum(1).double() * mask1.sum(1).double()).sum())
    act = b * n * D * 4
    bms, by = attention_bound(pairs, 3, 6 * act + 2 * b * n + 2 * b * H * n * 4)
    row = dict(max_abs_err=err_f, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
               bound_by=by, tol="atol %g + rtol %g" % TOL["float32"])
    return row, launches


def check_block0(seed):
    """K8 with the committed weights of SuperPoint's first block against its
    plain version, at the two shapes the serving path gives it: one view of a
    batch-8 pair batch, (8, 480, 640, 1), which the row times and bounds, and
    the two stacked views of a single pair, (2, 480, 640, 1). The yardstick is
    the same block through the port's bf16 cuDNN trunk, which the fused path
    never calls."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import block0_conv as b0

    ext = pipeline(1024).extractor
    weights = [t.detach().float().contiguous()
               for t in (*ext.blocks[0].raw(), *ext.blocks[1].raw())]
    img0, img1, _ = synthetic_pair(seed, 8, 480, 640)

    def held(image):
        out = b0.block0_fused(image, *weights)
        torch.cuda.synchronize()
        ref = b0.block0_plain(image, *weights)
        err = compare(out, ref, "bfloat16", f"K8 block0 {tuple(image.shape)}")
        mean = float((out.float() - ref.float()).abs().mean())
        if mean > 2e-3:
            fail(f"K8 {tuple(image.shape)}: mean abs err {mean:.3g} against the plain "
                 f"version (> 2e-3)")
        return err, mean, timed(lambda: b0.block0_fused(image, *weights), 5)

    pair = torch.cat([img0[:1], img1[:1]]).contiguous()
    err1, mean1, ms1 = held(pair)
    log(f"[kernel] K8 at (2, 480, 640, 1), the stacked views of one pair: max abs err "
        f"{err1:.3g}, mean {mean1:.3g}; {ms1:.4f} ms")
    image = img0.contiguous()
    err, mean, ms = held(image)
    plain_ms = timed(lambda: b0.block0_plain(image, *weights), 3, warmup=1)
    x = image.permute(0, 3, 1, 2).bfloat16()
    with torch.no_grad():
        lib_ms = timed(lambda: F.max_pool2d(ext.blocks[1](ext.blocks[0](x)), 2, 2), 5)
    b, h, w, _ = image.shape
    flops = 2.0 * 9 * 64 * (1 + 64) * b * h * w
    nbytes = b * h * w * 4 + b * (h // 2) * (w // 2) * 64 * 2 + (9 * 64 * 65 + 6 * 64) * 4
    bms, by = bound(flops, nbytes, PEAK_BF16)
    log(f"[kernel] K8 at (8, 480, 640, 1): mean abs err {mean:.3g}; "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    return dict(max_abs_err=max(err, err1), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by,
                tol="atol %g + rtol %g, mean abs err <= 2e-3" % TOL["bfloat16"])


# ------------------------------------------------------------------ phase 6
ADAPTIVE = {"depth_confidence": 0.95, "width_confidence": 0.99, "width_capacity": 0.5}


def serving_counters():
    """K8, K1, K2, K4, K5, K6a: what the adaptive serving path may launch."""
    from gluefactory_tpu_torch.ops import block0_conv as b0
    from gluefactory_tpu_torch.ops import fused_attention as fa
    from gluefactory_tpu_torch.ops import lightglue_block as lb
    from gluefactory_tpu_torch.ops import log_assignment as la

    return (b0.block0_fused, lb.fused_self_block, lb.fused_cross_block, la.fused_log_assignment,
            fa.fused_attention_packed, fa.fused_cross_attention_packed)


def counted(pipe, data):
    """One forward with the serving counters set to 0 just before and read
    just after: (output, [K8, K1, K2, K4, K5, K6a launches])."""
    import torch

    torch.cuda.synchronize()
    for fn in serving_counters():
        fn.launches = 0
    out = pipe(data)
    torch.cuda.synchronize()
    return out, [fn.launches for fn in serving_counters()]


def check_adaptive_output(out, counts, views, label):
    """The launch counts against the exit layer, finiteness, and that no
    padded or pruned keypoint is matched. Returns the exit layer."""
    import torch

    stop = int(out["stop_layer"])
    expect = [views, stop + 1, stop + 1, 1, 0, 0]
    log(f"[{label}] stop_layer {stop}; launches K8 {counts[0]}, K1 {counts[1]}, K2 {counts[2]}, "
        f"K4 {counts[3]}, K5 {counts[4]}, K6a {counts[5]}")
    if counts != expect:
        fail(f"{label}: expected launches {expect} (K8 once an extractor call, K1 = K2 = "
             f"stop_layer + 1, K4 = 1, no unfused layer), got {counts}")
    for key in ("matches0", "matching_scores0", "log_assignment", "descriptors0", "prune0"):
        if not torch_finite(out[key]):
            fail(f"{label}: non-finite {key}")
    for i in "01":
        dead = ~out[f"keypoint_mask{i}"] | (out[f"prune{i}"] < stop + 2)
        if bool((out[f"matches{i}"][dead] >= 0).any()):
            fail(f"{label}: a padded or pruned keypoint of view {i} was matched")
    if int((out["matches0"] >= 0).sum()) == 0:
        fail(f"{label}: no matches")
    return stop


def pruned_share(out):
    stop = int(out["stop_layer"])
    valid = out["keypoint_mask0"]
    return float(((out["prune0"] < stop + 2) & valid).sum()) / max(int(valid.sum()), 1)


def run_adaptive_serving():
    """Phase 6; returns K8's launches in the adaptive b8 forward."""
    import torch

    b, h, w, k = 8, 480, 640, 1024
    img0, img1, hs = synthetic_pair(3, b, h, w, difficulty=0.15)
    size = torch.tensor([[float(w), float(h)]] * b, device="cuda")
    data = {"view0": {"image": img0, "image_size": size},
            "view1": {"image": img1, "image_size": size}}
    data1 = {v: {kk: t[:1] for kk, t in d.items()} for v, d in data.items()}
    fused0 = {"fused_block0": True}

    full = pipeline(k)
    adaptive = pipeline(k, extractor=fused0, matcher=ADAPTIVE)
    out, counts = counted(adaptive, data)
    stop8 = check_adaptive_output(out, counts, 2, "adaptive b8")
    k8_launches = counts[0]
    out1, counts1 = counted(adaptive, data1)
    stop1 = check_adaptive_output(out1, counts1, 1, "adaptive b1")
    comp8, comp = int(out["compact_layer"]), int(out1["compact_layer"])
    log(f"[adaptive] exit layer {stop8} at b8, {stop1} at b1 (of 0..8); keypoints pruned by the "
        f"exit: {pruned_share(out):.4f} at b8, {pruned_share(out1):.4f} at b1; compact phase "
        f"from layer {comp8} at b8, {comp} at b1 (-1: the active sets never fit 512)")

    # fp32 against the port's plain path on the card, on the same extracted features
    fp32 = pipeline(k, extractor=fused0, matcher={**ADAPTIVE, "mp": False})
    got = fp32(data)
    feats = {key: got[key] for key in got if key[:-1] in (
        "keypoints", "keypoint_scores", "descriptors", "keypoint_mask")}
    with plain_path():
        ref = fp32.matcher({**data, **feats})
    valid = got["keypoint_mask0"]
    agree = float((got["matches0"] == ref["matches0"])[valid].float().mean())
    log(f"[adaptive fp32] stop_layer {int(got['stop_layer'])} (plain path "
        f"{int(ref['stop_layer'])}); prune0 / prune1 equal: "
        f"{bool(torch.equal(got['prune0'], ref['prune0']))} / "
        f"{bool(torch.equal(got['prune1'], ref['prune1']))}; matches0 equal on {agree:.4f} "
        f"of valid keypoints")
    if int(got["stop_layer"]) != int(ref["stop_layer"]):
        fail("adaptive fp32: stop_layer differs from the plain path's")
    if not (torch.equal(got["prune0"], ref["prune0"]) and torch.equal(got["prune1"], ref["prune1"])):
        fail("adaptive fp32: prune counts differ from the plain path's")
    if agree < 0.99:
        fail(f"adaptive fp32: matches0 agrees with the plain path on {agree:.4f} < 0.99")

    # bf16: a hard threshold on bf16 confidences may move the exit by a layer
    got = adaptive(data)
    feats = {key: got[key] for key in feats}
    with plain_path():
        ref = adaptive.matcher({**data, **feats})
    agree = float((got["matches0"] == ref["matches0"])[got["keypoint_mask0"]].float().mean())
    gap = abs(int(got["stop_layer"]) - int(ref["stop_layer"]))
    log(f"[adaptive bf16] stop_layer {int(got['stop_layer'])} (plain path "
        f"{int(ref['stop_layer'])}); matches0 equal on {agree:.4f} of valid keypoints")
    if gap > 1 or agree < 0.95:
        fail(f"adaptive bf16: stop_layer {gap} apart (> 1) or matches0 agreement {agree:.4f} < 0.95")

    # the compact phase: with under 512 valid keypoints a side the active sets fit the
    # capacity at once, and every layer runs on gathered (B, 512) buffers
    few = {**feats, "keypoint_mask0": feats["keypoint_mask0"].clone(),
           "keypoint_mask1": feats["keypoint_mask1"].clone()}
    few["keypoint_mask0"][:, 500:] = False
    few["keypoint_mask1"][:, 480:] = False
    for fn in serving_counters():
        fn.launches = 0
    got = fp32.matcher({**data, **few})
    torch.cuda.synchronize()
    counts = [fn.launches for fn in serving_counters()]
    stop, at = int(got["stop_layer"]), int(got["compact_layer"])
    with plain_path():
        ref = fp32.matcher({**data, **few})
    agree = float((got["matches0"] == ref["matches0"])[few["keypoint_mask0"]].float().mean())
    log(f"[adaptive compact] 500 x 480 valid keypoints, fp32: compact from layer {at}, "
        f"stop_layer {stop} (plain path {int(ref['stop_layer'])}), launches K1 {counts[1]}, "
        f"K2 {counts[2]}, K4 {counts[3]}; matches0 equal on {agree:.4f} of valid keypoints")
    if at != 0 or counts[1:] != [stop + 1, stop + 1, 1, 0, 0]:
        fail(f"adaptive compact: expected the compact phase from layer 0 and K1 = K2 = "
             f"{stop + 1} launches, got layer {at} and {counts}")
    if (stop != int(ref["stop_layer"]) or agree < 0.99
            or bool((got["matches0"][~few["keypoint_mask0"]] >= 0).any())):
        fail("adaptive compact: disagrees with the plain path, or matched a padded keypoint")

    # speed on the same pairs: full depth, adaptive, and the adaptive loop that never exits
    plain_ext = pipeline(k, matcher=ADAPTIVE)
    never = pipeline(k, matcher={"depth_confidence": 2.0})  # a share of tokens never passes 1
    if int(never(data)["stop_layer"]) != 8:
        fail("the unreachable depth_confidence exited early")
    pipes = (("full depth", full), ("adaptive, fused block 0", adaptive),
             ("adaptive, cuDNN block 0", plain_ext), ("adaptive loop, no exit", never))
    # host-clock times spread from round to round: measure the pipelines in turns and
    # keep each one's median
    rounds = {name: ([], []) for name, _ in pipes}
    for _ in range(5):
        for name, pipe in pipes:
            rounds[name][0].append(8000.0 / pairs_per_s(pipe, data, iters=4))
            rounds[name][1].append(1000.0 / pairs_per_s(pipe, data1, iters=10))
    med = lambda xs: sorted(xs)[len(xs) // 2]
    rows = {}
    for name, pipe in pipes:
        b8s, b1s = rounds[name]
        res, res1 = pipe(data), pipe(data1)
        rows[name] = (med(b8s), med(b1s))
        log(f"[adaptive] {name}: {8000.0 / med(b8s):.2f} pairs/s at b8 ({med(b8s):.2f} ms a "
            f"batch, {min(b8s):.2f}-{max(b8s):.2f} over 5 rounds), b1 latency {med(b1s):.2f} ms "
            f"({min(b1s):.2f}-{max(b1s):.2f}); exit layer {int(res['stop_layer'])} at b8, "
            f"{int(res1['stop_layer'])} at b1; precision@3px {precision(res, hs):.4f}, "
            f"matches {int((res['matches0'] >= 0).sum())}")
    log(f"[adaptive] the adaptive loop's own cost (its confidence heads and one host read a "
        f"layer; no exit, against full depth): "
        f"{rows['adaptive loop, no exit'][0] - rows['full depth'][0]:+.2f} ms a b8 batch, "
        f"{rows['adaptive loop, no exit'][1] - rows['full depth'][1]:+.2f} ms at b1")
    # the same full-depth pipeline at b1 without the others in between, on this phase's
    # pair and on phase 4's: tells the pair's share of a host-clock difference between the
    # two phases from the share of the interleaving
    img0, img1, _ = synthetic_pair(1, b, h, w)
    data4 = {"view0": {"image": img0[:1], "image_size": size[:1]},
             "view1": {"image": img1[:1], "image_size": size[:1]}}
    alone = {name: sorted(1000.0 / pairs_per_s(full, d, iters=10) for _ in range(5))
             for name, d in (("this phase's pair", data1), ("phase 4's pair", data4))}
    log("[adaptive] full depth at b1 alone, 5 x 10 forwards: " + "; ".join(
        f"{name} {ms[2]:.2f} ms ({ms[0]:.2f}-{ms[-1]:.2f})" for name, ms in alone.items())
        + f"; in turns with the other pipelines {rows['full depth'][1]:.2f} ms")
    views = lambda p: [p.extractor(data[v]) for v in ("view0", "view1")]
    ext_plain = timed(lambda: views(full), 5)
    ext_fused = timed(lambda: views(adaptive), 5)
    log(f"[adaptive] extractor, both views of a b8 batch: {ext_plain:.2f} ms with the cuDNN "
        f"block 0, {ext_fused:.2f} ms with fused_block0")
    return k8_launches


# ------------------------------------------------------------------ phase 7
def run_superglue():
    """Phase 7; returns K7a's launches in one SuperGlue forward."""
    import torch

    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.models.matchers import superglue as sgmod
    from gluefactory_tpu_torch.ops import attention as ops
    from gluefactory_tpu_torch.ops import fused_attention as fa

    b, h, w, k = 8, 480, 640, 1024
    img0, img1, _ = synthetic_pair(1, b, h, w)  # phase 4's pairs
    size = torch.tensor([[float(w), float(h)]] * b, device="cuda")
    ext = pipeline(k).extractor
    data = {"view0": {"image_size": size}, "view1": {"image_size": size}}
    for i, img in enumerate((img0, img1)):
        data.update({f"{key}{i}": t for key, t in ext({"image": img}).items()})
    model = get_model("superglue")({}, device="cuda").eval()
    conf = model.conf
    if (conf.GNN_layers, conf.descriptor_dim, conf.num_heads, conf.sinkhorn_iterations) != (
            9, D, H, 50):
        fail("SuperGlue is not at 9 layer pairs x 256, 4 heads, 50 Sinkhorn iterations")
    torch.cuda.synchronize()
    fa.fused_attention.launches = 0
    out = model(data)
    torch.cuda.synchronize()
    launches = fa.fused_attention.launches
    log(f"[superglue] K7a launches a forward: {launches}")
    if launches != 36:
        fail(f"SuperGlue: expected 36 K7a launches a forward (9 x (2 self + 2 cross)), got {launches}")
    for key in ("matches0", "matching_scores0", "log_assignment"):
        if not torch_finite(out[key]):
            fail(f"SuperGlue: non-finite {key}")
    if tuple(out["log_assignment"].shape) != (b, k + 1, k + 1):
        fail(f"SuperGlue: log_assignment is {tuple(out['log_assignment'].shape)}")
    if bool((out["matches0"][~data["keypoint_mask0"]] >= 0).any()):
        fail("SuperGlue: a padded keypoint was matched")
    # against the plain path on the card
    saved = sgmod.masked_attention
    sgmod.masked_attention = lambda q, k_, v, mq, mk: ops.attention_heads(
        q, k_, v, mq, mk, q.shape[-1] ** -0.5).to(q.dtype)
    try:
        ref = model(data)
    finally:
        sgmod.masked_attention = saved
    if fa.fused_attention.launches != 36:
        fail("SuperGlue: the plain path launched the kernel")
    la_err = float((out["log_assignment"] - ref["log_assignment"]).abs().max())
    agree = float((out["matches0"] == ref["matches0"])[data["keypoint_mask0"]].float().mean())
    log(f"[superglue] against the plain path: log_assignment within {la_err:.3g} (bar 1e-3), "
        f"matches0 equal on {agree:.4f} of valid keypoints (bar 0.99); "
        f"{int((out['matches0'] >= 0).sum())} matches from seeded weights")
    if not la_err <= 1e-3 or agree < 0.99:
        fail("SuperGlue disagrees with its plain path")
    ms = timed(lambda: model(data), 5)
    scores = torch.randn(b, k, k, device="cuda")
    sink = timed(lambda: sgmod.log_optimal_transport(
        scores, model.bin_score, 50, data["keypoint_mask0"], data["keypoint_mask1"]), 5)
    log(f"[superglue] {ms:.2f} ms a b8 batch ({8000.0 / ms:.2f} pairs/s, features given); "
        f"Sinkhorn (50 iterations) {sink:.2f} ms, {sink / ms:.3f} of it")
    return launches, ms


# ---------------------------------------------------------------------- main
def main() -> int:
    global TRAIN_B
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--train-batch", type=int, default=TRAIN_B,
                        help="pairs a training step takes (default %(default)s)")
    TRAIN_B = parser.parse_args().train_batch
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
    build_report()
    check_tensor_cores()

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
        # the compact width of the adaptive path and a ragged N beside the main shape
        r = check_block(kind_, s, n, seed=i, also=(512, 1000) if n == 1024 else ())
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces, **r))
    for i, (b, n) in enumerate(((8, 1024), (4, 2048))):
        r = check_assignment(b, n, n, seed=10 + i)
        tag = "K4" if n == 1024 else "K4 (MegaDepth shape)"
        kernels.append(dict(
            name=f"{tag} fused_log_assignment B={b} M=N={n} f32", route="cuda", source=src_asg,
            replaces="gluefactory_tpu/ops/pallas_assignment.py:200,225", **r))
    att = {**check_self_attention(20), **check_cross_attention("stacked", 21),
           **check_cross_attention("packed", 22)}
    s2, n5, n6 = 2 * TRAIN_B, TRAIN_N, TRAIN_N1
    att_rows = [
        ("K5", f"K5 fused_attention_packed ({s2}, {n5}, 256) f32", "383"),
        ("K6b", f"K6b fused_cross_attention_stacked ({s2}, {n5}, 256) f32", "744"),
        ("K6a", f"K6a fused_cross_attention_packed B={TRAIN_B} M={n5} N={n6} f32", "691"),
        ("K7b self", f"K7b attention backward, self form ({s2}, {n5}, 256) f32", "222"),
        ("K7b cross", f"K7b attention backward, cross form B={TRAIN_B} {n5} x {n5} f32", "222"),
    ]
    for key, name, line in att_rows:
        kernels.append(dict(name=name, key=key, route="cuda", source=SRC_ATT,
                            replaces=f"{PAL_ATT}:{line}", **att[key]))
    pal_conv = "gluefactory_tpu/ops/pallas_conv.py:222"
    kernels.append(dict(
        name="K8 block0_fused (8, 480, 640, 1) f32 -> (8, 240, 320, 64) bf16", key="K8",
        route="cuda", source="gluefactory_tpu_torch/csrc/block0_conv.cu", replaces=pal_conv,
        **check_block0(23)))
    kernels.append(dict(
        name=f"K7a fused_attention ({HEADS_B}, {H}, {HEADS_N}, {DH}) f32", key="K7a",
        route="cuda", source=SRC_ATT, replaces=f"{PAL_ATT}:116", **check_heads_attention(24)))
    k7c_row, k7c_launches = check_heads_cross(25)
    kernels.append(dict(
        name=f"K7c fused_cross_attention ({HEADS_B}, {H}, {HEADS_N}, {DH}) x same f32", key="K7c",
        route="cuda", source=SRC_ATT, replaces=f"{PAL_ATT}:567", **k7c_row))
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
    matcher_ms = sum(k["ms"] * k["launches"] for k in kernels
                     if "key" not in k and "1024" in k["name"])
    log(f"[main b8] per batch: {8000.0 / pps:.2f} ms end to end; extractor {ext_ms:.2f} ms "
        f"(both views); matcher kernels {matcher_ms:.2f} ms (kernel_ms x launches)")

    # the MegaDepth protocol shape through the same kernels (the K3 rows)
    pipe_md, data_md, out_md, hs_md, counts_md = run_main_path(
        4, 1200, 1600, 2048, seed=2, label="megadepth b4")
    set_launches(kernels, 2048, counts_md)
    md_pps = pairs_per_s(pipe_md, data_md, iters=3)
    log(f"[megadepth b4] {1000.0 / md_pps:.2f} ms/pair ({md_pps:.2f} pairs/s); "
        f"precision@3px {precision(out_md, hs_md):.4f}")
    del pipe, data, out, ref, pipe_md, data_md, out_md
    torch.cuda.empty_cache()

    # 5. training
    per_step = run_training()
    step_ms = sum(k["ms"] * per_step[k["key"]] for k in kernels
                  if k.get("key") in per_step and k["key"] != "K6a")
    log(f"[train] attention kernels per step (kernel_ms x launches, m == n): {step_ms:.2f} ms")
    torch.cuda.empty_cache()

    # 6. adaptive serving; 7. SuperGlue
    per_step["K8"] = run_adaptive_serving()
    torch.cuda.empty_cache()
    per_step["K7a"], sg_ms = run_superglue()
    per_step["K7c"] = k7c_launches
    k7a_ms = next(k["ms"] for k in kernels if k.get("key") == "K7a")
    log(f"[superglue] K7a kernels (kernel_ms x launches): {k7a_ms * per_step['K7a']:.2f} ms, "
        f"{k7a_ms * per_step['K7a'] / sg_ms:.3f} of the forward")
    for k in kernels:
        if "key" in k:
            k["launches"] = per_step[k["key"]]
        if k.get("launches", 0) < 1:
            fail(f"{k['name']}: no launch on its path")

    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        more = ""
        if "split_ms" in k:
            more = (" split proj/attention/ffn " + "/".join(f"{t:.4f}" for t in k["split_ms"])
                    + f" torch_bf16_ms {k['torch_ms']:.4f}")
        log(f"[kernel] {k['name']}: kernel_ms {k['ms']:.4f} plain_ms {k['plain_ms']:.4f} "
            f"library_ms {lib} bound_ms {k['bound_ms']:.4f} ({k['bound_by']}) "
            f"launches {k['launches']}{more}")
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
