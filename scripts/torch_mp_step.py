#!/usr/bin/env python3
"""The `matcher.mp: True` training step of chip_smoke.py's phase 13a on one
CUDA card, timed and profiled, and its first step against the plain path
over several batches:

    python3 scripts/torch_mp_step.py [--parent DIR] [--steps N] [--seeds N]

Time: the trainer of the homography configuration at its width (batch 32,
480 x 640, 512 keypoints, LightGlue 9 x 256 checkpointed) with `matcher.mp:
true` on phase 13a's three batches: `--steps` steps after two warm-up steps,
each timed by the host clock around a synchronised step (median and range),
then `--steps` more under torch.profiler (chip_smoke.profile_steps): the
device time a step of every kernel, of the attention forwards and of K7b's
backward kernels (csrc/attention.cu), and the device's idle share of the
median timed step. With `--parent DIR`, another checkout
(e.g. unpacked with `git archive`), its step is timed in the same call, in
the order parent, this, this, parent, each run in a process of its own that
imports and builds that checkout's package.

First step (`--seeds N`, this checkout): on N batches (seeds 40.., 40 is
phase 13a's), the gap of the total loss (relative) and of two gradients (as
a share of the plain path's max|g|) between the kernel path and the plain
path (`matcher.flash: false`), as phase 13a's `hold_first_step` reads it,
with the plain attention rounding as it is (`port`) and as the alternatives
of `round_as`, and the gaps between those plain paths themselves: how far
13a's 1e-4 bar stands above the choice of rounding.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ROUNDINGS = ("port", "xla-jit", "xla-eager", "xla-scale", "fp32-p")
NAMED = ("matcher.self_Wqkv_w", "matcher.assign_proj_w")


def round_as(rounding):
    """Swap the port's plain bf16 attention rounding (ops/attention.py) for
    an alternative: `fp32-p` keeps the probabilities in fp32; the others
    change the bf16 cross form's scale of qk by Dh**-0.25 a side: `xla-jit`
    multiplies by that scale rounded to bf16 in fp32, as the JAX package's
    XLA cross form does jitted (its bf16 operand makes the Python scale a
    bf16 constant; XLA's compiler drops the rounding of the product);
    `xla-eager` also rounds the product to bf16, as the XLA cross form does
    op by op; `xla-scale` rounds the product by the exact scale to bf16.
    `port` leaves it as it is. Returns a function that puts the port's
    back."""
    import torch

    from gluefactory_tpu_torch.ops import attention as plain

    saved = plain._as_values, plain.cross_attention_heads
    if rounding == "fp32-p":
        plain._as_values = lambda attn, v: attn
    elif rounding != "port":
        def scaled(qk, s):
            if rounding == "xla-scale":
                return (qk * s).float()
            qk = qk.float() * float(torch.tensor(s).to(qk.dtype))
            return qk.to(torch.bfloat16).float() if rounding == "xla-eager" else qk

        def cross_attention_heads(qk0, qk1, v0, v1, mask0=None, mask1=None):
            b, _, m, dh = qk0.shape
            s = dh**-0.25
            sim = torch.einsum("bhid,bhjd->bhij", scaled(qk0, s), scaled(qk1, s))
            pair = plain._pair_mask(mask0, mask1, b, m, qk1.shape[2], qk0.device)
            attn01 = plain.masked_softmax(sim, pair, dim=-1)
            attn10 = plain.masked_softmax(sim, pair, dim=-2)
            return (torch.einsum("bhij,bhjd->bhid", plain._as_values(attn01, v1), v1.float()),
                    torch.einsum("bhij,bhid->bhjd", plain._as_values(attn10, v0), v0.float()))

        plain.cross_attention_heads = cross_attention_heads

    def restore():
        plain._as_values, plain.cross_attention_heads = saved

    return restore


def time_steps(cs, steps):
    """Per-step ms of `steps` mp steps, then the device times of `steps`
    profiled ones."""
    import torch

    batches = [cs.training_batch(40 + i, cs.TRAIN_B, 480, 640) for i in range(3)]
    trainer = cs.make_trainer(cs.train_conf(matcher={"mp": True}))
    trainer.train_steps(batches, steps=2)  # warm-up
    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_steps(batches[i % 3:i % 3 + 1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    # this checkout's profile_steps, whichever checkout's trainer it profiles
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    prof = here.profile_steps(trainer, batches, steps)
    return dict(step_ms=ms, **prof, idle=1 - prof["device_ms"] / statistics.median(ms))


def first_step_gaps(cs, seeds):
    """The first step's gaps, kernel path against the plain roundings and
    the plain roundings against each other, on batches of seeds 40.."""
    import torch

    def loss_and_grads(tr, batch):
        params = dict(tr.model.named_parameters())
        losses, _ = tr.model.loss(tr.model(batch), batch)
        total = losses["total"].mean()
        grads = torch.autograd.grad(total, [params[k] for k in NAMED])
        return float(total.detach()), [g.detach() for g in grads]

    kernel = cs.make_trainer(cs.train_conf(matcher={"mp": True}))
    plain = cs.make_trainer(cs.train_conf(matcher={"mp": True, "flash": False}))
    pairs = [("kernel", r) for r in ROUNDINGS] + [("port", r) for r in ROUNDINGS[1:]]
    gaps = {f"{a} vs {b}": [] for a, b in pairs}
    for seed in range(40, 40 + seeds):
        batch = cs.training_batch(seed, cs.TRAIN_B, 480, 640)
        got = {"kernel": loss_and_grads(kernel, batch)}
        for r in ROUNDINGS:
            restore = round_as(r)
            got[r] = loss_and_grads(plain, batch)
            restore()
        for a, b in pairs:
            (ta, ga), (tb, gb) = got[a], got[b]
            grad = [float((x - y).abs().max() / y.abs().max()) for x, y in zip(ga, gb)]
            gaps[f"{a} vs {b}"].append(dict(seed=seed, total=abs(ta - tb) / abs(tb), grads=grad))
            print(f"first step, seed {seed}, {a} vs {b}: total rel {abs(ta - tb) / abs(tb):.3g}"
                  f" (13a bar 1e-4); gradients " + ", ".join(
                      f"{k} {x:.3g} of max|g|" for k, x in zip(NAMED, grad))
                  + " (13a bar 0.05)", flush=True)
    return gaps


def worker(tree: Path, steps: int, seeds: int) -> int:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from gluefactory_tpu_torch import _ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _ext.build_all()
    out = {"tree": str(tree), **time_steps(cs, steps)}
    if seeds:
        out["first_step"] = first_step_gaps(cs, seeds)
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="another checkout whose mp step is timed in the same call")
    parser.add_argument("--steps", type=int, default=10, help="timed steps a run")
    parser.add_argument("--seeds", type=int, default=0, help="batches of the first-step gaps")
    parser.add_argument("--tree", type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.tree is not None:
        return worker(args.tree, args.steps, args.seeds)
    import torch

    if not torch.cuda.is_available():
        print("torch_mp_step: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    order = [ROOT] if args.parent is None else [args.parent, ROOT, ROOT, args.parent]
    runs = {}
    for i, tree in enumerate(order):
        seeds = args.seeds if tree == ROOT and str(ROOT) not in runs else 0
        proc = subprocess.run([sys.executable, __file__, "--tree", str(tree), "--steps",
                               str(args.steps), "--seeds", str(seeds)],
                              capture_output=True, text=True, timeout=1800)
        lines = proc.stdout.splitlines()
        print("\n".join(x for x in lines if not x.startswith("RESULT ")), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(next(x for x in lines if x.startswith("RESULT "))[7:])
        runs.setdefault(str(tree), []).append(res)
        print(f"run {i} {'parent' if tree != ROOT else 'this'}: step ms "
              + " ".join(f"{x:.2f}" for x in res["step_ms"])
              + f"; profiled a step: kernels {res['device_ms']:.2f} ms device time, attention "
              f"forwards {res['fwd_ms']:.2f}, K7b {res['bwd_ms']:.2f}, wall "
              f"{res['profiled_wall_ms']:.2f}, idle {res['idle']:.3f}", flush=True)
    for tree, rs in runs.items():
        ms = [x for r in rs for x in r["step_ms"]]
        med = lambda k: statistics.median(r[k] for r in rs)
        print(f"{'parent' if tree != str(ROOT) else 'this'} ({len(rs)} runs): step median "
              f"{statistics.median(ms):.2f} ms (range {min(ms):.2f}-{max(ms):.2f}); a step's "
              f"attention forwards {med('fwd_ms'):.2f} ms and K7b {med('bwd_ms'):.2f} ms of "
              f"{med('device_ms'):.2f} ms of kernels (device time, median of runs); idle "
              f"{med('idle'):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
