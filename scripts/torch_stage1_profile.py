#!/usr/bin/env python3
"""Where a step of the detector's pretraining (stage 1 of the hermetic
loop) spends its time on the card.

    python3 scripts/torch_stage1_profile.py [--steps N]

Builds `configs/superpoint-open_synthetic_pretrain.json` at its width (8
SyntheticShapes pairs of 240 x 320, SuperPoint-open 64-64-128-128-256 with
256-D descriptors, fp32, batch-mode BatchNorm), takes one batch from its
loader, and runs the trainer's step on it: the median host-clock time of a
step (synchronised), its forward / backward / optimizer split (CUDA events
through the step's `mark`), then N steps under torch.profiler: the summed
device time of the kernels against the steps' wall time (the card's idle
share), and the kernels grouped by kind (convolutions, BatchNorm's
elementwise passes and reductions, the losses, the optimizer) with the
most device time. Prints the card's name and power limit first. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def kind(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("conv", "cudnn", "implicit", "winograd", "fft", "sm90_x", "gemm",
                            "wgrad", "dgrad", "fprop")):
        return "convolution (cuDNN / GEMM)"
    if any(k in n for k in ("reduce", "sum", "mean")):
        return "reductions (BatchNorm statistics, losses)"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer (foreach)"
    if any(k in n for k in ("max_pool", "pool")):
        return "max pool"
    if any(k in n for k in ("elementwise", "vectorized", "unrolled", "index", "where", "clamp")):
        return "elementwise (BatchNorm, ReLU, losses)"
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_stage1_profile: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}")

    from gluefactory_tpu_torch.train.step import make_train_step
    from gluefactory_tpu_torch.train.trainer import Trainer
    from gluefactory_tpu_torch.utils.config import load_conf
    from gluefactory_tpu_torch.utils.tensor import batch_to_device

    trainer = Trainer(load_conf("superpoint-open_synthetic_pretrain"), device="cuda")
    trainer.build()
    batch = batch_to_device(next(iter(trainer.dataset.get_data_loader("train"))), "cuda")
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    step = make_train_step(trainer.model, mark)
    times, splits = [], []
    for i in range(3 + 10):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        events.clear()
        t0 = time.perf_counter()
        trainer.state, _ = step(trainer.state, batch)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
            marks = [start] + events
            splits.append([a.elapsed_time(b) for a, b in zip(marks, marks[1:])])
    times.sort()
    split = [sorted(s[j] for s in splits)[len(splits) // 2] for j in range(3)]
    print(f"step: median {times[len(times) // 2]:.2f} ms (min {times[0]:.2f}, max {times[-1]:.2f}) "
          f"of {len(times)}; forward + loss {split[0]:.2f}, backward {split[1]:.2f}, veto + "
          f"optimizer {split[2]:.2f} ms (CUDA events, medians)")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.state, _ = step(trainer.state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_kind = collections.defaultdict(float)
    per_name = collections.defaultdict(float)
    device = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = ev.device_time_total / 1e3 if hasattr(ev, "device_time_total") else \
                ev.cuda_time_total / 1e3
            device += t
            per_kind[kind(ev.name)] += t
            per_name[ev.name] += t
    n = args.steps
    print(f"profiled {n} steps: wall {wall / n:.2f} ms a step, kernels {device / n:.2f} ms a step "
          f"(device busy {device / wall:.3f}, idle {1 - device / wall:.3f} of the wall time)")
    for k, t in sorted(per_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {t / n:.2f} ms a step ({t / max(device, 1e-9):.3f} of the kernels)")
    for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {t / n:.3f} ms  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
