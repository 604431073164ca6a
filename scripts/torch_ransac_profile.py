#!/usr/bin/env python3
"""Where one homography or relative-pose RANSAC call of the port spends its
time on the card.

    python3 scripts/torch_ransac_profile.py [--matches N] [--cpu-ops] [--relpose]

On synthetic correspondences (N matches, half of them outliers, padded to
the estimator's bucket; with `--relpose` a random 3D scene seen by two
cameras at f = 500 px and the relative-pose estimator, K = 8192, at 1 px):
the median host-clock time of one estimator call (homographies: K = 1024
hypotheses, two rounds, synchronised), the kernels it launches and
their summed device time (torch.profiler), the host reads it makes (the
eigensolver's status checks, `cudaStreamSynchronize`) and the host time
blocked in them, the ops with the most host time, the round trip of one
scalar read on an idle card, and the batched 9x9 eigensolve alone in float64
and float32 at the call's two batch sizes (K hypotheses, 12 candidates).
Prints the card's name and power limit first. Needs a CUDA device.

`--cpu-ops` instead counts the aten ops one call dispatches (at one
threshold and at the sweep of six), on the CPU: a count, not a time.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def host_ms(fn, iters=20, warmup=3):
    import torch

    times = []
    for i in range(warmup + iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def correspondences(n):
    import numpy as np

    rng = np.random.RandomState(0)
    H = np.array([[1.02, 0.05, 12], [-0.03, 0.98, -7], [2e-5, -1e-5, 1.0]])
    p0 = rng.uniform(0, [640, 480], (n, 2))
    h = np.c_[p0, np.ones(n)] @ H.T
    p1 = h[:, :2] / h[:, 2:] + rng.randn(n, 2) * 0.5
    p1[: n // 2] = rng.uniform(0, [640, 480], (n // 2, 2))
    return {"m_kpts0": p0.astype(np.float32), "m_kpts1": p1.astype(np.float32)}


def pose_correspondences(n):
    import numpy as np
    import torch

    from gluefactory_tpu_torch.geometry.wrappers import Camera

    rng = np.random.RandomState(0)
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, n)]
    c, s = np.cos(0.1), np.sin(0.1)  # 5.7 degrees about y
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    X1 = X @ R.T + [0.5, 0.1, 0.05]
    px = lambda P: P[:, :2] / P[:, 2:] * 500.0 + [320, 240] + rng.randn(n, 2) * 0.5
    p0, p1 = px(X), px(X1)
    p1[: n // 2] = rng.uniform(0, [640, 480], (n // 2, 2))
    cam = Camera(torch.tensor([640.0, 480.0, 500.0, 500.0, 320.0, 240.0]))
    return {"m_kpts0": p0.astype(np.float32), "m_kpts1": p1.astype(np.float32),
            "camera0": cam, "camera1": cam}


def make_estimator(relpose, th, device):
    """(estimator, data maker, hypotheses) of the homography or the
    relative-pose estimator."""
    if relpose:
        from gluefactory_tpu_torch.estimators.relative_pose.torch_ransac import (
            TorchRansacRelativePose)

        return TorchRansacRelativePose({"ransac_th": th}, device=device), pose_correspondences, 8192
    from gluefactory_tpu_torch.estimators.homography.torch_ransac import TorchRansacHomography

    return TorchRansacHomography({"ransac_th": th}, device=device), correspondences, 1024


def count_ops(n, relpose=False) -> int:
    """The aten ops one estimator call dispatches on the CPU (each is a
    kernel launch, or a view, on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    for th in (1.0 if relpose else 3.0, [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]):
        est, make, _ = make_estimator(relpose, th, "cpu")
        data = make(n)
        with Count() as c:
            est(data)
        print(f"[ransac] one call, {n} matches, {len(th) if isinstance(th, list) else 1} "
              f"threshold(s): {c.ops} aten ops dispatched")
    return 0


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--matches", type=int, default=200)
    parser.add_argument("--cpu-ops", action="store_true")
    parser.add_argument("--relpose", action="store_true")
    args = parser.parse_args()
    n = args.matches
    if args.cpu_ops:
        return count_ops(n, args.relpose)
    if not torch.cuda.is_available():
        print("torch_ransac_profile: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}")

    est, make, k = make_estimator(args.relpose, 1.0 if args.relpose else 3.0, "cuda")
    data = make(n)
    call = lambda: bool(est(data)["success"])
    med, lo, hi = host_ms(call)
    kind = "relative pose" if args.relpose else "homography"
    print(f"[ransac] one {kind} call, {n} matches, K = {k}, two rounds: median {med:.2f} ms "
          f"({lo:.2f}-{hi:.2f}) of 20")

    from torch.profiler import ProfilerActivity, profile

    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    launches = sum(e.count for e in kernels) / calls
    device_ms = sum(e.self_device_time_total for e in kernels) / calls / 1e3
    print(f"[ransac] per call: {launches:.0f} kernel launches, {device_ms:.2f} ms of device "
          f"time (the rest of the call's time is the host's)")
    syncs = [e for e in events if e.key == "cudaStreamSynchronize"]
    if syncs:
        reads = sum(e.count for e in syncs) / calls
        blocked = sum(e.cpu_time_total for e in syncs) / calls / 1e3
        print(f"[ransac] per call: {reads:.0f} host reads (cudaStreamSynchronize; the "
              f"eigensolver's status checks and the read of success), {blocked:.3f} ms of "
              f"host time blocked in them")
    else:
        print("[ransac] host reads: the profiler recorded no cudaStreamSynchronize")
    print("[ransac] ops by host time per call (ms, calls):")
    ops = sorted((e for e in events if e.key.startswith("aten::") or "linalg" in e.key),
                 key=lambda e: -e.self_cpu_time_total)
    for e in ops[:15]:
        print(f"    {e.key:40s} {e.self_cpu_time_total / calls / 1e3:8.3f} ms "
              f"{e.count / calls:6.0f}")
    print("[ransac] kernels by device time per call (ms, launches):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.key[:60]:60s} {e.self_device_time_total / calls / 1e3:8.3f} ms "
              f"{e.count / calls:6.0f}")

    one = torch.zeros(1, device="cuda")
    med, lo, hi = host_ms(lambda: one.add_(1).item(), iters=200)
    print(f"[read] one launch and a read of its scalar on an idle card: median {med:.3f} ms "
          f"({lo:.3f}-{hi:.3f}) of 200, host clock")
    for batch in (k, 12):
        A = torch.randn(batch, 9, 20, device="cuda", dtype=torch.float64)
        A = A @ A.transpose(-1, -2)
        for dtype in (torch.float64, torch.float32):
            a = A.to(dtype)
            med, lo, hi = host_ms(lambda: torch.linalg.eigh(a))
            print(f"[eigh] ({batch}, 9, 9) {str(dtype)[6:]}: median {med:.3f} ms "
                  f"({lo:.3f}-{hi:.3f}), host clock, synchronised")
    return 0


if __name__ == "__main__":
    sys.exit(main())
