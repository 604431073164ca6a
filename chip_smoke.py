#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SuperPoint-open + LightGlue (full depth,
adaptive, training), SuperGlue, the benchmarks (HPatches, synthetic_pose,
MP, MegaDepth-1500, ETH3D), the multispectral slice, the hermetic loop (the
detector's pretraining -> LightGlue -> HPatches), the other training paths
(bf16, a trainable extractor, SuperGlue, two processes), the other
extractors and the MegaDepth training recipe on one GPU.

    python3 chip_smoke.py [--train-batch PAIRS]

`--train-batch` (default 32) sets the pairs a training step takes in phases
3 and 5. Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel of gluefactory_tpu_torch/csrc with nvcc (sm_90a);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (the block kernels also at N = 512 and 1000)
     and at those of phase 8 (the fp32 blocks at N = 512 and 256, K4 at
     512 and 256 a side, K8 in the 864 x 480 eval box), with its time, the
     plain version's, a library yardstick's and the bound the work allows;
     for the blocks also the time of each of their three launches and of
     the same block as bf16 torch calls; the bf16 attention forwards are
     held by ATT_BF16, a bar on every output and on the mean abs err, the
     bf16 backward (K7b: self, cross and per-head forms) by K7B_BF16, the
     same on the scale of each gradient, with exact zeros at invalid rows
     and keys and two calls bit for bit. The build log's registers and
     spills are printed (a spill of a bf16 tensor-core kernel fails), and
     the bf16 block kernels, the attention forwards (K5, K6a, K6b, K7a, K7c
     and the block attention) and backward (K7b), block 0 (K8) and the log
     assignment's product (K4) must show HMMA (tensor-core) instructions in
     their SASS, the bf16 forwards and backward HMMA.16816.F32.BF16 and no
     TF32 one;
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
     attention launches a forward, agreement with the plain path;
  8. HPatches evaluation: a 50-pair tree in HPatches' layout (4
     illumination and 6 viewpoint scenes, two of them resized by the
     preprocessing) through `HPatchesPipeline(conf).run` with the RANSAC
     threshold sweep, for full-depth LightGlue in fp32 (K1 = K2 = 9, K4 = 1
     launches a pair), the nearest-neighbour baseline (LightGlue's DLT AUC
     at 3 px above it, its median DLT error under 10 px) and adaptive
     LightGlue with the fused block 0 (the exit-layer histogram); every
     summary finite; the card's RANSAC core against the CPU's on the same
     noise (H within 0.05 px on 8 pairs); export pairs/s, eval seconds, one
     RANSAC call's ms;
  9. the training entry point: the JSON training configuration at full
     width (frozen SuperPoint-open, 512 keypoints, LightGlue 9 x 256 fp32
     checkpointed, 640 x 480 patches of a pool of 256 synthetic textures at
     960 x 720, the committed weights grafted by `train.load_experiment`)
     at the phase 5 batch: run A through `Trainer.build()` / `train()`, 2
     epochs of 3 steps, validation on 32 pairs every 2 iterations and at
     each epoch's end, checkpoints pruned to the last 2, the synthetic
     benchmark (10 pairs) at each epoch's end; run B through
     `train.__main__.main`: epoch 0, then --restore and epoch 1 (launches
     a step, a validation and a benchmark; finite losses and summaries; the
     checkpoint layout; run B's parameters within 1e-6 of run A's; ms a
     step with the loader, the loader's pairs/s alone, validation, save,
     restore and benchmark times);
 10. pose and depth: (a) the depth fine-tune configuration
     (configs/superpoint-open+lightglue_depth.json: synthetic 3D pairs at
     480 x 368, 512 keypoints, batch 4, `depth_matcher` with th_epi 5, the
     committed homography weights grafted) through the trainer for 3 steps,
     then one step at the MegaDepth recipe's extractor settings (2048
     keypoints forced, threshold 0, batch 8 at 640 x 480): launches (18 K5,
     18 K6b, 27 K7b a step), finite losses, the ground-truth labels on the
     card equal to the CPU's on the same keypoints, the first step within
     1e-4 of the plain path and two gradients within 1e-3 max|g|, ms a step
     and peak memory; the loader's pairs/s alone; (b) the synthetic_pose
     benchmark (20 test pairs at 640 x 480, 512 keypoints, fp32, RANSAC at
     1 px) for the mutual NN, LightGlue with the homography-only weights and
     with the depth-fine-tuned weights (K1 = K2 = 9, K4 = 1 a pair): export
     pairs/s, eval seconds, AUC@5/10/20, mAA, inlier and epipolar medians;
     the depth-fine-tuned weights above the homography-only ones by the JAX
     package's bars; the card's RANSAC core against the CPU's on the same
     noise (on the pairs whose CPU estimate moves by at most 0.25 deg under
     a 1e-7 change of its input, at least 5: rel_pose_error within 0.5 deg,
     their mAA within 0.02); one estimator
     call's ms, launches and host reads (one threshold, the sweep of six). The kernel rows add K5, K6b and K7b at the
     2048-keypoint training shape;
 11. the multispectral slice: (a) configs/superpoint-open+lightglue_MP.json
     through the trainer at its width (batch 32 optical/thermal pairs at
     256 x 320, 512 keypoints forced, LightGlue 9 x 256 fp32 checkpointed,
     the committed weights grafted), cut to 3 steps, one validation and the
     MP benchmark on its 7 test pairs: the first step within 1e-4 of the
     plain path and two gradients within 1e-3 max|g|, launches (18 K5, 18
     K6b, 27 K7b a step; 9 K5 + 9 K6b the validation; K1 = K2 = 9, K4 = 1 a
     benchmark pair), ms a step alone and fed by the loader, the loader's
     pairs/s alone, peak memory; (b) `python -m gluefactory_tpu_torch.eval.MP`
     (its `main`) on the 7 test pairs at 256 x 320, RANSAC at 0.5 px, for
     SuperPoint-open (the committed weights), MultiPoint and XPoint (swin)
     (seeded weights) feeding the committed LightGlue in fp32: K1 = K2 = 9,
     K4 = 1 a pair, `matches0` equal to the plain path on >= 99% and their
     scores within 1e-3, H-AUC at 1/3/5 px (DLT, RANSAC), precision@3px,
     export pairs/s and eval seconds; MultiPoint's thermal view through the
     thermal encoder inside the stacked extraction of both views; (c) the
     forwards of SuperPoint-open, MultiPoint, XPoint and
     SuperPoint-MagicLeap at b8, 256 x 320;
 12. the hermetic loop: (a) stage 1, configs/superpoint-open_synthetic_pretrain.json
     at its width (8 SyntheticShapes pairs of 240 x 320 rendered at 480 x
     640 a step, SuperPoint-open 64-64-128-128-256 with 256-D descriptors,
     fp32, batch-mode BatchNorm) through the trainer for 2 epochs of 4
     steps, a validation of 16 pairs and a checkpoint at each epoch's end:
     the first step's losses within 1e-4 of the port's CPU run on the same
     batch and weights, the heads' last BatchNorm-scale gradients within
     1e-3 max|g| of it, the trunk's first and the detector's 3 x 3 conv
     gradients within 0.05 max|g| of float64 on the card (fp32 on either
     device is 0.3-2.5% off there), the running statistics within 1e-5,
     finite losses; then a non-finite batch and a validation, each leaving
     the parameters and running statistics bit for bit; ms a step alone and
     fed by the loader, the loader's pairs/s alone, peak memory; (b) stage 2,
     configs/superpoint-open-trained+lightglue_homography.json at its width
     (8 pairs of 480 x 368, 384 keypoints, LightGlue 9 x 256 fp32
     checkpointed) with stage 1's best checkpoint grafted into its extractor
     (bit for bit), cut to 3 steps and a validation: the first step within
     1e-4 of the plain path and two gradients within 1e-3 max|g|, 18 K5 + 18
     K6b + 27 K7b a step, ms a step, peak memory; (c) stage 3, the HPatches
     benchmark on phase 8's 50-pair tree with stage 2's experiment in fp32:
     K1 = K2 = 9 and K4 = 1 a pair, keypoints on every pair, the summaries
     finite but the median errors (infinite while the three-step LightGlue
     matches nothing), export pairs/s, eval seconds, H-AUC without a bar.
     The kernel rows add K5, K6b and K7b at stage 2's shape, (16, 384, 256);
 13. the training paths that LightGlue training lacked, on three batches of
     phase 5's shape (32 pairs at 480 x 640, 512 keypoints): (a) `mp: true`
     (LightGlue 9 x 256 in bf16, checkpointed): 18 K5 + 18 K6b + 27 K7b a
     step, all bf16, the first step's total and two gradients against the
     bf16 plain path (MP_PLAIN) and against the fp32 step (MP_GAP: twice the
     JAX package's own bf16-to-fp32 gap, scripts/torch_mp_gap.py), ms a
     step and peak memory beside phase 5's, the bf16 attention kernels'
     share of the step, one m != n step (512 x 384: 18 bf16 K6a); (b)
     `extractor.trainable: true`:
     `fused_block0: True` raises, the first and the descriptor head's last
     conv gradients on a b2 batch (fp32 extractor) within 0.05 max|g| of
     the float64 extractor's on the same keypoints and upstream gradient,
     18 K5 + 18 K6b + 27 K7b a step, the extractor's parameters moved and
     its running statistics not, ms a step and peak memory; (c) SuperGlue
     (9 layer pairs x 256, 4 heads, 50 Sinkhorn iterations, seeded) as the
     trained matcher: 36 K7a + 36 per-head K7b a step, the first step
     within 1e-4 of the plain attention and two gradients within 1e-3
     max|g|, the loss falling over five steps on one batch, ms a step, peak
     memory, the Sinkhorn iterations' share; (d) two processes on the one
     card (gloo, named: NCCL takes one rank a device), 16 pairs a rank,
     started as `chip_smoke.py --ddp-rank R ...`, against one process at
     32 on the same global batches for DDP_STEPS steps: the reduced
     gradients within 1e-4 max|g|, the parameters within DDP_ATOL, a NaN
     slice on rank 1 alone skipped on both ranks, ms a step with the
     all-reduce and the all-reduce's own ms. The kernel rows add the bf16
     K5, K6b and K7b at (64, 512, 256) and K6a at 512 x 384 (13a's; the
     kernels and SDPA in bf16 timed by CUDA events and by device time) and
     K7a and the per-head K7b at (32, 4, 512, 64) (13c's).
 14. the other extractors: the sift_tpu training recipe through the trainer
     (sift_tpu on the card against the CPU), the cached `features.do` mode,
     ALIKED, DISK and DISK-official feeding LightGlue, each against the CPU
     on one image, and steps of aliked+lightglue_homography;
 15. the benchmarks of the paper's protocol: (a) the port's JPEG / PNG
     decoders on this host (csrc/image_decode.cpp, host C++): the committed
     corpus (tests/data/codecs) decoded to the digests cv2 gave where it was
     written, ms of a 1600 x 1200 JPEG and of a 6048 x 4032 16-bit PNG
     decode; (b) MegaDepth-1500 through `eval.megadepth1500.main` on an
     8-pair tree (pair 0 the committed JPEG pair, the others rendered here
     at 1600 x 1200 with known K and T): SuperPoint-open with the committed
     weights, 2048 keypoints at threshold 0, LightGlue 9 x 256 fp32, RANSAC
     at 1 px, resize 1600 and pad 1600 x 1600: K1 = K2 = 9 and K4 = 1 a
     pair, pair 0's matches0 equal to the plain path on >= 99% and its log
     assignment within 1e-3 + 1e-4 |value|, AUC@5/10/20, mAA and the
     epipolar precisions finite; export pairs/s, the loader's pairs/s alone,
     eval seconds, peak memory; then superpoint-open+NN.json on the same
     tree, its summaries finite; (c) ETH3D through `ETH3DPipeline`: one
     scene of 5 views rendered at 1512 x 1008, downsize 2 (the 756 x 504
     the protocol gives 6048 x 4032 / 8), 16-bit PNG depth, COLMAP text:
     K1 = K2 = 9 and K4 = 1 a pair, a finite AP, pair 0's ground truth on
     the card equal to the CPU's depth_matcher on the same keypoints;
     export pairs/s. The kernel rows add the fp32 K1 / K2 at (2, 2048, 256)
     and K4 at B = 1, 2048 x 2048;
 16. the MegaDepth training recipe: (a) the port's HDF5 writer and reader
     (utils/hdf5.py) on a 1600 x 1200 float32 depth file and a cache of
     1000 image groups, bit for bit, ms of a depth read; (b) a scene in
     MegaDepth's layout written here (28 views rendered at 1600 x 1200,
     landscape and portrait, PNG with HDF5 depth; the committed JPEG pair
     and a view without an image as None entries; overlaps spread so that
     the configuration's 3 bins of 300 pairs keep theirs); (c)
     configs/superpoint-open+lightglue_megadepth.json through the trainer at
     its shape (1024 px square-padded, 2048 keypoints forced, 32 pairs,
     LightGlue 9 x 256 fp32 checkpointed, the committed weights grafted):
     the loader alone in pairs/s, the ground truth of 8 pairs on the card
     equal to the CPU's, the first step within 1e-4 of the plain path and two
     gradients within 1e-3 max|g|, 3 timed steps (18 K5, 18 K6b, 27 K7b a
     step), ms a step, peak memory, a step fed by the loader; a batch that
     does not fit is logged and halved; (d) one `views: 3` batch of 8
     triplets through `triplet_pipeline` (9 K1, 9 K2, 1 K4) against three
     two-view calls fed the same features, matches equal on >= 99%; (e)
     export_megadepth --method sp over the scene, read back, then a step of
     8 pairs with `load_features.do` in which the extractor runs no
     forward; (f) an MP batch from an HDF5 file the port's writer wrote. The
     kernel rows add K5, K6b and K7b at the recipe's (64, 2048, 256).
The last three lines of standard output are the card's name and power
limit, the kernels' JSON record and the result JSON. Without CUDA, or
without the package beside it, it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
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
# the bf16 attention forwards (K5, K6b, K6a) against their plain versions, on
# unit randn inputs whose outputs are ~0.065 (std ~0.08): atol + rtol |ref|
# for every output and a bar on the mean abs err, from the readings of
# scripts/torch_fwd_k4_variants.py on the H100: max 1.3e-3-4.8e-3, mean
# 7.1e-5-1.4e-4 for the tile; its control, the tile with one key tile
# skipped, max 0.30-0.81, mean 9.0e-3-2.5e-2
ATT_BF16 = (2**-6, 2**-6, 2**-10)
# the bf16 attention backward (K7b in its self, cross and per-head forms)
# against fp32 autograd of the plain version on the same bf16 inputs: every
# gradient within atol c max|ref| + rtol |ref|, and its mean abs err within
# m max|ref|, max|ref| that gradient's own (on unit randn inputs a gradient
# has std ~0.07 and max|ref| ~0.8: the general bf16 bar TOL passes a kernel
# that drops a loop tile). Readings of scripts/torch_k7b_k8_variants.py on
# the H100 at (64, 512, 256) and 32 pairs of 512 x 512: the kernels' worst
# max abs err 2.6e-3 (self) and 5.7e-3 (cross) of max|ref|, mean 9.4e-5 and
# 1.2e-4 of max|ref|; the controls (a query tile skipped in dk/dv, a key
# tile in dq) max 0.55-1.03, mean 5.9e-3-1.2e-2 of max|ref|: outside by
# 35-66x and 6-12x
K7B_BF16 = (2**-6, 2**-7, 2**-10)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, iters: int, warmup: int = 2, reps: int = 1) -> float:
    """Milliseconds per call on the card, by CUDA events: the median over
    `reps` windows of `iters` calls, Python's garbage collector held off."""
    import gc

    import torch

    for _ in range(warmup):
        fn()
    times = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / iters)
    finally:
        if collecting:
            gc.enable()
    return sorted(times)[reps // 2]


def timed_median(fn, iters: int, warmup: int = 2) -> float:
    """`timed` over five windows, for the attention rows: at 0.1-0.3 ms a
    call the autograd call's host time can outlast its kernels, and it
    varies from window to window (one window of 10 calls read 2.8-3.8x the
    device time, SDPA's backward too)."""
    return timed(fn, iters, warmup, reps=5)


def profiled(run, attempts: int = 3):
    """torch.profiler (CPU and CUDA activities) around `run()`, synchronised:
    the profile and its CUDA kernel events, or None when the profiler recorded
    no kernel in `attempts` tries. CUPTI's tracing has come up empty on some
    machines (the first session of a process included); the callers then time
    by CUDA events and say so."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.device_time_total for e in kernels) > 0:
            return prof, kernels
    log(f"[profiler] torch.profiler recorded no kernel in {attempts} tries: the time below "
        "is by CUDA events, launches and the device split not measured")
    return None


def device_ms(fn, iters: int, warmup: int = 2, top: int = 0):
    """Milliseconds per call of the kernels' own device time (their sum, by
    torch.profiler), without the host's gaps between launches: for a shape
    at which one call's Python and launch overhead outlasts its kernels.
    With `top`, (those ms, the launches a call, the `top` kernels by device
    time as (name, ms a call)). Where the profiler records no kernel, the ms
    are by CUDA events (`timed`), and the launches None."""
    import collections

    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()

    got = profiled(run)
    if got is None:
        ms = timed(fn, iters, warmup=0)
        return (ms, None, []) if top else ms
    kernels = got[1]
    total = sum(e.device_time_total for e in kernels)
    if not top:
        return total / 1e3 / iters
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:48]] += e.device_time_total
    return (total / 1e3 / iters, len(kernels) / iters,
            [(name, t / 1e3 / iters) for name, t in by_name.most_common(top)])


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


def attention_bar(out, ref):
    """(max abs err, mean abs err, within ATT_BF16) of a bf16 attention
    forward against its plain version."""
    atol, rtol, mean_tol = ATT_BF16
    out, ref = out.detach().float(), ref.detach().float()
    diff = (out - ref).abs()
    ok = torch_finite(out) and not bool((diff > atol + rtol * ref.abs()).any())
    return float(diff.max()), float(diff.mean()), ok and float(diff.mean()) <= mean_tol


def compare_attention(out, ref, what: str) -> float:
    err, mean, ok = attention_bar(out, ref)
    if not ok:
        fail(f"{what}: max abs err {err:.4g}, mean abs err {mean:.4g} outside atol %g + rtol "
             "%g, mean %g" % ATT_BF16)
    log(f"[kernel] {what}: max abs err {err:.4g}, mean abs err {mean:.4g} (atol %g + rtol %g, "
        "mean %g)" % ATT_BF16)
    return err


def k7b_bar(grads, refs):
    """(max abs err, worst max abs err and worst mean abs err as shares of
    the gradient's max|ref|, within K7B_BF16) of the bf16 backward's
    gradients against their fp32 references."""
    c, rtol, m = K7B_BF16
    err = rel = mean = 0.0
    ok = True
    for g, r in zip(grads, refs):
        g, r = g.detach().float(), r.detach().float()
        top = max(float(r.abs().max()), 1e-30)
        diff = (g - r).abs()
        ok = ok and torch_finite(g) and not bool((diff > c * top + rtol * r.abs()).any()) \
            and float(diff.mean()) <= m * top
        err = max(err, float(diff.max()))
        rel, mean = max(rel, float(diff.max()) / top), max(mean, float(diff.mean()) / top)
    return err, rel, mean, ok


def compare_k7b(grads, refs, what: str) -> float:
    err, rel, mean, ok = k7b_bar(grads, refs)
    msg = (f"{what}: max abs err {err:.4g}; worst max err {rel:.4g} and mean err {mean:.4g} of "
           "max|ref| (bar: atol %g max|ref| + rtol %g, mean %g max|ref|)" % K7B_BF16)
    if not ok:
        fail(msg)
    log(f"[kernel] {msg}")
    return err


def compare_grads(grads, refs, dtype_name: str, what: str) -> float:
    """Max abs err of a backward's gradients against fp32 autograd, held at
    TOL in fp32 and at K7B_BF16 in bf16."""
    if dtype_name == "bfloat16":
        return compare_k7b(grads, refs, what)
    return max(compare(g, r, dtype_name, f"{what} gradient {i}")
               for i, (g, r) in enumerate(zip(grads, refs)))


def check_k7b_exact(grads, again, invalid, what: str) -> None:
    """Fail unless the gradients are exactly 0 where `invalid` (a bool mask
    over each gradient's rows) says so and a second call gave them bit for
    bit."""
    import torch

    for g, a, bad, w in zip(grads, again, invalid, "qkv"):
        if not torch.equal(g, a):
            fail(f"{what} d{w}: two calls are not bit-identical")
        if bool(bad.any()) and float(g[bad].float().abs().max()) != 0.0:
            fail(f"{what} d{w}: the gradient of an invalid row is not exactly zero")


# the bars of the gradients by type
GRAD_TOL = {"float32": "atol %g + rtol %g" % TOL["float32"],
            "bfloat16": "atol %g max|ref| + rtol %g, mean abs err <= %g max|ref|" % K7B_BF16}


def torch_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


# ------------------------------------------------------------------ phase 3
def block_inputs(gen, s, n, masked_frac=0.2, dt="bfloat16"):
    import torch

    dev, dtype = "cuda", getattr(torch, dt)
    x = torch.randn(s, n, D, generator=gen, device=dev).to(dtype)
    ang = torch.rand(s, n, DH // 2, generator=gen, device=dev) * 6
    cos = torch.cos(ang).repeat_interleave(2, -1).to(dtype).contiguous()
    sin = torch.sin(ang).repeat_interleave(2, -1).to(dtype).contiguous()
    mask = torch.rand(s, n, generator=gen, device=dev) > masked_frac
    return x, cos, sin, mask


def block_weights(gen, cross, dt="bfloat16"):
    import torch

    dtype = getattr(torch, dt)

    def w(din, dout):
        return (torch.randn(din, dout, generator=gen, device="cuda") * din**-0.5).to(dtype)

    def b(k):
        return (0.1 * torch.randn(k, generator=gen, device="cuda")).to(dtype)

    pre = [w(D, D), b(D), w(D, D), b(D)] if cross else [w(D, 3 * D), b(3 * D)]
    ln = (1 + 0.1 * torch.randn(2 * D, generator=gen, device="cuda")).to(dtype)
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


def check_block(kind, s, n, seed, also=(), dt="bfloat16"):
    """Self or cross block in `dt`: kernel vs plain, masked and unmasked, at
    N = n and at each N of `also` (same S); times of the block, of each of
    its three launches, of the plain version and of two yardsticks."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch import _ext
    from gluefactory_tpu_torch.ops import lightglue_block as lb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = block_weights(gen, cross=kind == "cross", dt=dt)
    err = 0.0
    for nn in (*also, n):
        x, cos, sin, mask = block_inputs(gen, s, nn, dt=dt)
        if kind == "self":
            kern = lambda m: lb.fused_self_block(x, cos, sin, mask, *w, masked=m)
            plain = lambda m: lb.self_block(x, cos, sin, mask, *w, masked=m)
        else:
            kern = lambda m: lb.fused_cross_block(x, mask, *w, masked=m)
            plain = lambda m: lb.cross_block(x, mask, *w, masked=m)
        for m in (False, True):
            out = kern(m)
            torch.cuda.synchronize()
            err = max(err, compare(out, plain(m), dt, f"{kind} block s={s} n={nn} masked={m}"))
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
    q = torch.randn(s, H, n, DH, generator=gen, device="cuda").to(x.dtype)
    kv = torch.randn(s, H, n, DH, generator=gen, device="cuda").to(x.dtype)
    amask = mask[other][:, None, None, :]
    lib_ms = timed(lambda: F.scaled_dot_product_attention(q, kv, kv, attn_mask=amask), 10)

    nv = mask.sum(1).double()
    es = x.element_size()
    if kind == "self":
        flops = s * n * 20 * D * D + 4 * D * float((nv * nv).sum())
        wbytes = (3 * D * D + D * D + 4 * D * D + 2 * D * D + 3 * D + D + 6 * D) * es
        nbytes = 2 * s * n * D * es + 2 * s * n * DH * es + s * n + wbytes
    else:
        b = s // 2
        flops = s * n * 18 * D * D + 6 * D * float((nv[:b] * nv[b:]).sum())
        wbytes = (2 * D * D + D * D + 4 * D * D + 2 * D * D + 2 * D + D + 6 * D) * es
        nbytes = 2 * s * n * D * es + s * n + wbytes
    bms, by = bound(flops, nbytes, PEAK_BF16 if dt == "bfloat16" else PEAK_FP32_PRODUCT)
    ns = ", ".join(str(k) for k in (*also, n))
    tag = "bf16" if dt == "bfloat16" else "f32"
    log(f"[kernel] {kind} block ({s}, {n}, 256) {tag}: {ms:.4f} ms, {flops / ms / 1e9:.1f} "
        f"TFLOP/s; launches proj {split[0]:.4f}, attention {split[1]:.4f}, FFN tail "
        f"{split[2]:.4f} ms; the block as {tag} torch calls {torch_ms:.4f} ms; held against "
        f"the plain version at N = {ns}, masked and unmasked")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bms, bound_by=by, tol="atol %g + rtol %g" % TOL[dt],
                split_ms=split, torch_ms=torch_ms)


def kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel symbol: the nested names without
    the anonymous namespace, and <float> or <bf16> for a float or bf16
    instantiation."""
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
    if mangled.startswith("If", i):
        return name + "<float>"
    return name + ("<bf16>" if mangled.startswith("I13__nv_bfloat16", i) else "")


def build_report():
    """Registers and spills of every kernel, from the nvcc logs (-Xptxas -v);
    fails if a bf16 tensor-core kernel (BF16_KERNELS) spills."""
    import re

    from gluefactory_tpu_torch import _ext

    for logf in sorted(_ext.BUILD.glob("*.log")):
        fn, spill = None, ""
        bf16_mma = set(BF16_KERNELS.get(logf.stem, ()))
        for line in logf.read_text().splitlines():
            if m := re.search(r"Compiling entry function '([^']+)'", line):
                fn = kernel_name(m.group(1))
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            elif (m := re.search(r"Used (\d+) registers", line)) and fn:
                log(f"[build] {logf.stem} {fn}: {m.group(1)} registers, {spill}")
                if fn in bf16_mma and spill and spill != "spill stores 0 B, loads 0 B":
                    fail(f"{logf.stem} {fn}: a bf16 tensor-core kernel spills ({spill})")
                fn, spill = None, ""


# library: (kernel-name prefixes, kernels with those prefixes), each of which
# must have HMMA (tensor-core) instructions in its SASS
TENSOR_CORE_KERNELS = {
    # the bf16 block kernels and the block attention (the forward tile) in
    # fp32 and bf16
    "lightglue_block": (("tc::", "attn_kernel"), 4),
    # the forwards (K5, K6b, K6a, K7a, K7c), fp32 and bf16, and K7b's dk/dv and
    # dq kernels, fp32 (templates) and bf16 (kernels of their own)
    "attention": (("attn_fwd_kernel", "cross_fwd_stacked_kernel", "cross_fwd_pair_kernel",
                   "attn_fwd_heads_kernel", "cross_fwd_heads_kernel", "attn_bwd_dkv_kernel",
                   "attn_bwd_dq_kernel", "attn_bwd_dkv_bf16_kernel", "attn_bwd_dq_bf16_kernel"),
                  14),
    "block0_conv": (("block0_kernel",), 1),
    "log_assignment": (("sim_kernel",), 1),  # K4's product
}


# the bf16 kernels of the forward tile (attention_fwd.cuh) and of the backward
# (K7b's dk/dv and dq kernels): bf16 mma.sync m16n8k16 (HMMA.16816.F32.BF16),
# no TF32 pass, no spill
BF16_KERNELS = {
    "attention": ("attn_fwd_kernel<bf16>", "cross_fwd_stacked_kernel<bf16>",
                  "cross_fwd_pair_kernel<bf16>", "attn_fwd_heads_kernel<bf16>",
                  "cross_fwd_heads_kernel<bf16>", "attn_bwd_dkv_bf16_kernel",
                  "attn_bwd_dq_bf16_kernel"),
    "lightglue_block": ("attn_kernel<bf16>",),
}


def check_tensor_cores():
    """Fail unless every kernel of TENSOR_CORE_KERNELS has HMMA instructions
    in its SASS (split-TF32 products show as HMMA.1688.F32.TF32, bf16 ones
    as HMMA.16816.F32.BF16), and unless the kernels of BF16_KERNELS run bf16
    HMMA and no TF32 one."""
    from gluefactory_tpu_torch import _ext

    cuobjdump = Path(_ext._nvcc()).parent / "cuobjdump"
    for lib, (prefix, n) in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(_ext._target(lib))],
                              capture_output=True, text=True, timeout=300).stdout
        counts, kinds, fn = {}, {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = kernel_name(line.split("Function :")[1].strip())
                counts[fn], kinds[fn] = 0, set()
            elif fn is not None and "HMMA" in line:
                counts[fn] += 1
                kinds[fn].add(line.split("HMMA")[1].split()[0])
        log(f"[build] {lib} HMMA instructions in the SASS: " + ", ".join(
            f"{k} {v} ({' '.join('HMMA' + x for x in sorted(kinds[k]))})"
            for k, v in sorted(counts.items())))
        tc = {k: v for k, v in counts.items() if k.startswith(prefix)}
        if len(tc) != n or not all(tc.values()):
            fail(f"the {lib} kernels {prefix} do not all use the tensor cores: {tc}")
        for name in BF16_KERNELS.get(lib, ()):
            got = kinds.get(name)
            if got is None or ".16816.F32.BF16" not in got or any("TF32" in x for x in got):
                fail(f"{lib} {name}: expected HMMA.16816.F32.BF16 and no TF32 HMMA, got {got}")


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
TRAIN_CONF = "superpoint-open+lightglue_homography"  # the training configuration
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


def attention_bound(pairs, n_products, tensors_bytes, peak=PEAK_FP32_PRODUCT):
    """Bound of `n_products` N x N x 64 products per head over the valid
    (query, key) pairs, at fp32 accuracy (the training type) unless `peak`
    names another rate (bf16 inputs: PEAK_BF16)."""
    return bound(2.0 * n_products * D * pairs, tensors_bytes, peak)


def log_device_times(tag, kernel, library, ms, lib_ms, what="forward"):
    """Log a bf16 forward (or backward) and its library call by `device_ms`
    beside their CUDA event times: at 0.1-0.3 ms a call's host overhead
    comes close to its kernels."""
    log(f"[kernel] {tag} bf16 {what}: {ms:.4f} ms by events, {device_ms(kernel, 10):.4f} ms "
        f"device time; SDPA bf16 {lib_ms:.4f} ms by events, {device_ms(library, 10):.4f} ms "
        "device time")


def check_self_attention(seed, b=None, n=None, timer=timed_median, bf16_rows=False):
    """K5 and the self form of K7b at (2b, n, 256) (default: the training
    shape, (64, 512, 256)): fp32 (timed by `timer`, the plain version by
    `timed`) and bf16; with `bf16_rows` the bf16 forms are timed too, as
    rows "K5 bf16" and "K7b self bf16" (the `mp: True` step's), the forward
    and its library call by CUDA events and by `device_ms` both."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import attention as plain
    from gluefactory_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    s, n = 2 * (b or TRAIN_B), n or TRAIN_N
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
        err_f = (compare(out, ref, name, f"K5 forward {name}") if dtype == torch.float32
                 else compare_attention(out, ref, "K5 forward bfloat16"))
        if float(out.detach()[~mask].abs().max()) != 0.0:
            fail(f"K5 {name}: an invalid query row is not exactly zero")
        fn = lambda a, b, c: plain.self_attention_packed(a, b, c, mask, H)
        err_b = compare_grads(grads, autograd_reference(fn, (q, k, v), (do,)), name,
                              f"K7b self form {name}")
        if dtype == torch.bfloat16:
            check_k7b_exact(grads, torch.autograd.grad(out, leaves, do, retain_graph=True),
                            (~mask, ~mask, ~mask), "K7b self form bfloat16")
        log(f"[kernel] K5 / K7b self form {name}: forward max abs err {err_f:.3g}, "
            f"gradients {err_b:.3g} ({GRAD_TOL[name]})")
        if dtype != torch.float32 and not bf16_rows:
            continue
        suffix, size, peak = ("", 4, PEAK_FP32_PRODUCT) if dtype == torch.float32 else (
            " bf16", 2, PEAK_BF16)
        ms_f = timer(lambda: fa.fused_attention_packed(q, k, v, mask, mask, H), 10)
        # the backward alone: autograd calls the backward kernels on the saved forward
        ms_b = timer(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 10)
        plain_f = timed(lambda: plain.self_attention_packed(q, k, v, mask, H), 3, warmup=1)
        plain_b = timed(lambda: plain.attention_backward(q, k, v, mask, mask, do, H, DH**-0.5),
                        3, warmup=1)
        lq, lk, lv = (heads(t).requires_grad_() for t in (q, k, v))
        amask = mask[:, None, None, :]
        lib_f = timer(lambda: F.scaled_dot_product_attention(lq.detach(), lk.detach(),
                                                             lv.detach(), attn_mask=amask), 10)
        lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask)
        ldo = heads(do)
        lib_b = timer(lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True), 10)
        if dtype == torch.bfloat16:
            log_device_times("K5", lambda: fa.fused_attention_packed(q, k, v, mask, mask, H),
                             lambda: F.scaled_dot_product_attention(
                                 lq.detach(), lk.detach(), lv.detach(), attn_mask=amask),
                             ms_f, lib_f)
            log_device_times(
                "K7b self", lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True), ms_b,
                lib_b, "backward")
        nv = mask.sum(1).double()
        pairs = float((nv * nv).sum())
        act = s * n * D * size
        bf, byf = attention_bound(pairs, 2, 4 * act + s * n + s * H * n * 4, peak)
        bb, byb = attention_bound(pairs, 5, 8 * act + s * n + s * H * n * 4, peak)
        tol = "atol %g + rtol %g" % TOL[name]
        tol_f = tol if dtype == torch.float32 else (
            "atol %g + rtol %g, mean abs err <= %g" % ATT_BF16)
        rows["K5" + suffix] = dict(max_abs_err=err_f, ms=ms_f, plain_ms=plain_f,
                                   library_ms=lib_f, bound_ms=bf, bound_by=byf, tol=tol_f)
        rows["K7b self" + suffix] = dict(max_abs_err=err_b, ms=ms_b, plain_ms=plain_b,
                                         library_ms=lib_b, bound_ms=bb, bound_by=byb,
                                         tol=GRAD_TOL[name])
    return rows


def check_cross_attention(form, seed, b=None, n=None, timer=timed_median, bf16_rows=False):
    """K6b (stacked, N = 512, or n) or K6a (two arrays, 512 x 384) with the
    gradients of the shared projection, fp32 (timed by `timer`, the plain
    version by `timed`) and bf16; for the stacked form also the cross form
    of K7b alone. `b` pairs (default: the training batch). With `bf16_rows`
    the bf16 forms are timed too, as rows with the suffix " bf16", the
    forward and its library calls by CUDA events and by `device_ms` both."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import attention as plain
    from gluefactory_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, m = b or TRAIN_B, n or TRAIN_N
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
        err_f = max(compare(o, r, name, f"{tag} forward m{i} {name}") if dtype == torch.float32
                    else compare_attention(o, r, f"{tag} forward m{i} bfloat16")
                    for i, (o, r) in enumerate(zip(out, ref)))
        fn = lambda *a: ref_fn(*a, *mk, H)
        err_b = compare_grads(grads, autograd_reference(fn, args, (g0, g1)), name,
                              f"{tag} (dqk, dv) {name}")
        log(f"[kernel] {tag} {name}: forward max abs err {err_f:.3g}, gradients (dqk, dv) "
            f"{err_b:.3g} ({GRAD_TOL[name]})")
        if dtype != torch.float32 and not bf16_rows:
            continue
        suffix, size, peak = ("", 4, PEAK_FP32_PRODUCT) if dtype == torch.float32 else (
            " bf16", 2, PEAK_BF16)
        ms_f = timer(lambda: kern(*args, *mk, H), 10)
        plain_f = timed(lambda: ref_fn(*args, *mk, H), 3, warmup=1)
        # yardstick: the two directions as scaled_dot_product_attention calls
        # (one call over the stacked sets when both have the same length)
        h0, h1, hv0, hv1 = heads(qk0), heads(qk1), heads(v0), heads(v1)
        a0, a1 = mask0[:, None, None, :], mask1[:, None, None, :]
        if form == "stacked":
            hq, hk, hv = torch.cat([h0, h1]), torch.cat([h1, h0]), torch.cat([hv1, hv0])
            am = torch.cat([a1, a0])
            lib_fn = lambda: F.scaled_dot_product_attention(hq, hk, hv, attn_mask=am)
        else:
            lib_fn = lambda: (F.scaled_dot_product_attention(h0, h1, hv1, attn_mask=a1),
                              F.scaled_dot_product_attention(h1, h0, hv0, attn_mask=a0))
        lib_f = timer(lib_fn, 10)
        if dtype == torch.bfloat16:
            log_device_times(tag, lambda: kern(*args, *mk, H), lib_fn, ms_f, lib_f)
        pairs = float((mask0.sum(1).double() * mask1.sum(1).double()).sum())
        act0, act1 = b * m * D * size, b * n * D * size
        # one similarity and two message products serve both directions
        bf, byf = attention_bound(pairs, 3, 3 * (act0 + act1) + b * (m + n) * (1 + H * 4), peak)
        tol = "atol %g + rtol %g" % TOL[name]
        tol_f = tol if dtype == torch.float32 else (
            "atol %g + rtol %g, mean abs err <= %g" % ATT_BF16)
        rows[tag + suffix] = dict(max_abs_err=err_f, ms=ms_f, plain_ms=plain_f,
                                  library_ms=lib_f, bound_ms=bf, bound_by=byf, tol=tol_f)
        if form != "stacked":
            continue
        # K7b, cross form: one direction, queries of set 0 against keys of set 1
        direction = lambda q, k, v: plain.masked_attention_packed(q, k, v, mask0, mask1, H, DH**-0.5)
        one = [t.clone().requires_grad_() for t in (qk0, qk1, v1)]
        out01 = fa.fused_attention_packed(*one, mask0, mask1, H)
        got = torch.autograd.grad(out01, one, g0, retain_graph=True)
        err = compare_grads(got, autograd_reference(direction, (qk0, qk1, v1), (g0,)), name,
                            f"K7b cross form {name}")
        if dtype == torch.bfloat16:
            check_k7b_exact(got, torch.autograd.grad(out01, one, g0, retain_graph=True),
                            (~mask0, ~mask1, ~mask1), "K7b cross form bfloat16")
        ms_b = timer(lambda: torch.autograd.grad(out01, one, g0, retain_graph=True), 10)
        plain_b = timed(lambda: plain.attention_backward(qk0, qk1, v1, mask0, mask1, g0, H,
                                                         DH**-0.5), 3, warmup=1)
        lq, lk, lv = (t.requires_grad_() for t in (h0, h1, hv1))
        lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=a1)
        ldo = heads(g0)
        lib_b = timer(lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True), 10)
        if dtype == torch.bfloat16:
            log_device_times(
                "K7b cross", lambda: torch.autograd.grad(out01, one, g0, retain_graph=True),
                lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True), ms_b,
                lib_b, "backward")
        bb, byb = attention_bound(pairs, 5, 8 * act0 + b * (m + n) + b * H * m * 4, peak)
        rows["K7b cross" + suffix] = dict(max_abs_err=err, ms=ms_b, plain_ms=plain_b,
                                          library_ms=lib_b, bound_ms=bb, bound_by=byb,
                                          tol=GRAD_TOL[name])
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

    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = texture(gen, b, h, w)
    hs = torch.from_numpy(np.stack([homography(seed * 100 + i, h, w, difficulty)
                                    for i in range(b)]))
    hs = hs.to("cuda")
    to_bhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()
    return to_bhwc(img), to_bhwc(warp(img, hs)), hs


def texture(gen, b, h, w):
    """(B, 1, H, W) images in [0, 1]: bicubic low frequencies plus blocks."""
    import torch
    import torch.nn.functional as F

    coarse = torch.rand(b, 1, h // 24, w // 24, generator=gen, device="cuda")
    img = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
    fine = torch.rand(b, 1, h // 6, w // 6, generator=gen, device="cuda")
    img = img + 0.6 * F.interpolate(fine, size=(h, w), mode="nearest")
    return (img - img.amin((2, 3), keepdim=True)) / (
        img.amax((2, 3), keepdim=True) - img.amin((2, 3), keepdim=True))


def warp(img, hs):
    """(B, 1, H, W) images warped by (B, 3, 3) float64 homographies
    (image -> warped), bilinear, zeros outside."""
    import torch
    import torch.nn.functional as F

    b, _, h, w = img.shape
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float64) + 0.5,
                            torch.arange(w, device="cuda", dtype=torch.float64) + 0.5,
                            indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = torch.einsum("bij,nj->bni", torch.linalg.inv(hs), pts)
    src = src[..., :2] / src[..., 2:]
    grid = torch.stack([src[..., 0] / w * 2 - 1, src[..., 1] / h * 2 - 1], -1)
    grid = grid.reshape(b, h, w, 2).float()
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


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
    """Phase 5; returns the launches per training step of each attention
    kernel, ms a step and peak MiB."""
    import torch

    from gluefactory_tpu_torch.train.trainer import Trainer
    from gluefactory_tpu_torch.utils.config import load_conf
    from gluefactory_tpu_torch.weights import load_hermetic

    b, h, w, layers = TRAIN_B, 480, 640, 9
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def make(flash, mark=None):
        conf = load_conf(TRAIN_CONF)
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
    history = trainer.train_steps(batches, steps=2)  # warm-up
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
    history += trainer.train_steps(feed(steps), steps=steps)
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
    out = trainer.train_steps([poisoned], steps=1)[0]
    after = list(trainer.model.state_dict().values()) + opt.mu + opt.nu
    if out["skipped_nonfinite"] != 1 or opt.count != 2 + steps or trainer.state.step != 3 + steps:
        fail(f"training: the poisoned batch was not vetoed: {out}, count {opt.count}")
    if not all(torch.equal(a, z) for a, z in zip(before, after)):
        fail("training: the vetoed step changed a parameter or an Adam moment")
    log("[train] veto: a NaN batch reports skipped_nonfinite = 1 and leaves parameters, "
        "Adam moments and Adam's count bit-identical")

    per_step["K6a"] = mn_step(trainer, batches[0], "train")
    return per_step, step_ms, peak / 2**20


def mn_step(trainer, batch, label, layers=9):
    """One step of the trainer's matcher alone on 512 x 384 keypoints of
    `batch` (m != n takes the two-array cross attention, K6a); fails unless
    its launches are those of `layers` checkpointed layers. Returns K6a's
    launches."""
    import torch

    from gluefactory_tpu_torch.train.step import TrainState, make_optimizer, make_train_step

    with torch.no_grad():
        views = [trainer.model.extractor(batch[v]) for v in ("view0", "view1")]
    data = {f"{k}{i}": (t[:, :TRAIN_N1] if i else t)
            for i, view in enumerate(views) for k, t in view.items()}
    data = {**batch, **data}
    data.update(trainer.model.ground_truth(data))
    matcher = trainer.model.matcher
    params = dict(matcher.named_parameters())
    state = TrainState(0, params, make_optimizer(trainer.conf.train, params))
    reset_train_counts()
    state, losses = make_train_step(matcher)(state, data)
    torch.cuda.synchronize()
    counts = read_train_counts()
    expect = {"K5": 4 * layers, "K6b": 0, "K6a": 2 * layers, "K7b self": 2 * layers,
              "K7b cross": 2 * layers}
    log(f"[{label}] m != n step ({TRAIN_N} x {TRAIN_N1}): launches {counts}, "
        f"total {float(losses['total']):.4f}")
    if counts != expect:
        fail(f"{label}, m != n: expected {expect} launches, got {counts}")
    if not math.isfinite(float(losses["total"])) or float(losses["skipped_nonfinite"]) != 0:
        fail(f"{label}, m != n: {losses}")
    return counts["K6a"]


# ------------------------------ phase 3: the per-head attention and block 0
HEADS_B, HEADS_N = 8, 1024  # SuperGlue's attention at the main shape: (8, 4, 1024, 64)


def heads_inputs(gen, b, *lengths):
    import torch

    xs = [torch.randn(b, H, n, DH, generator=gen, device="cuda") for n in lengths]
    masks = {n: torch.rand(b, n, generator=gen, device="cuda") > 0.2 for n in set(lengths)}
    return xs, masks


def check_heads_attention(seed, b=HEADS_B, n=HEADS_N):
    """K7a at (b, 4, n, 64) fp32 (default (8, 4, 1024, 64)) through
    `ops.attention.masked_attention`, forward and gradients (K7b on the
    per-head layout); Nq != Nk once. Returns the rows of K7a and of K7b
    (one direction, the backward alone)."""
    import torch
    import torch.nn.functional as F

    from gluefactory_tpu_torch.ops import attention as ops

    gen = torch.Generator(device="cuda").manual_seed(seed)
    err_f = err_b = 0.0
    for nq, nk in ((n, 3 * n // 4), (n, n)):
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
    plain_b = timed(lambda: ops.attention_backward_heads(q, k, v, mq, mk, do, DH**-0.5), 3,
                    warmup=1)
    amask = mk[:, None, None, :]
    lib_ms = timed(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask), 10)
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask)
    lib_b = timed(lambda: torch.autograd.grad(lout, (lq, lk, lv), do, retain_graph=True), 10)
    pairs = float((mq.sum(1).double() * mk.sum(1).double()).sum())
    act = b * n * D * 4
    bms, by = attention_bound(pairs, 2, 4 * act + 2 * b * n + b * H * n * 4)
    bmb, byb = attention_bound(pairs, 5, 8 * act + 2 * b * n + b * H * n * 4)
    tol = "atol %g + rtol %g" % TOL["float32"]
    log(f"[kernel] K7b on the per-head layout, one direction ({b}, {H}, {n}, {DH}) f32: "
        f"{ms_b:.4f} ms")
    return (dict(max_abs_err=err_f, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                 bound_by=by, tol=tol),
            dict(max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, library_ms=lib_b, bound_ms=bmb,
                 bound_by=byb, tol=tol))


def check_heads_k7b_bf16(seed, b=TRAIN_B, n=TRAIN_N):
    """K7b in bf16 on the per-head layout, (b, 4, n, 64) queries against 3n/4
    keys, through `fused_attention` (SuperGlue trains in fp32, so no path
    runs this form; it is held here alone): the gradients within K7B_BF16 of
    fp32 autograd, exactly 0 at invalid rows and keys, two calls bit for
    bit."""
    import torch

    from gluefactory_tpu_torch.ops import attention as ops
    from gluefactory_tpu_torch.ops import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    nk = 3 * n // 4
    xs, masks = heads_inputs(gen, b, n, nk, nk, n)
    q, k, v, do = (t.bfloat16() for t in xs)
    mq, mk = masks[n], masks[nk]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.fused_attention(*leaves, mq, mk)
    grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    fn = lambda a, b_, c: ops.attention_heads(a, b_, c, mq, mk, DH**-0.5)
    what = f"K7b per-head form ({b}, {H}, {n}, {DH}) x {nk} keys bfloat16"
    compare_k7b(grads, autograd_reference(fn, (q, k, v), (do,)), what)
    rows = lambda m: (~m)[:, None, :].expand(b, H, m.shape[1])
    check_k7b_exact(grads, torch.autograd.grad(out, leaves, do),
                    (rows(mq), rows(mk), rows(mk)), what)


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
    plain version, at the shapes the serving and eval paths give it: one view
    of a batch-8 pair batch, (8, 480, 640, 1), which the row times and bounds,
    the two stacked views of a single pair, (2, 480, 640, 1), and a pair in
    the HPatches eval box, (2, 480, 864, 1): views 640 and 800 wide, zero
    padding to their right. The yardstick is the same block through the
    port's bf16 cuDNN trunk, which the fused path never calls."""
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
    box = torch.zeros(2, 480, 864, 1, device="cuda")
    box[0, :, :640] = img0[0]
    box[1, :, :800] = synthetic_pair(seed + 1, 1, 480, 800)[1][0]
    err2, mean2, ms2 = held(box)
    log(f"[kernel] K8 at (2, 480, 864, 1), one pair in the HPatches eval box (views 640 and "
        f"800 wide, zero padding): max abs err {err2:.3g}, mean {mean2:.3g}; {ms2:.4f} ms")
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
    return dict(max_abs_err=max(err, err1, err2), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
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


# ------------------------------------------------------------------ phase 8
# the HPatches-layout tree: (scene, kind, height, width); 5 pairs a scene
HP_SCENES = ([(f"i_synth{i}", "i", 480, 640) for i in range(4)]
             + [(f"v_synth{i}", "v", 480, 640) for i in range(4)]
             + [("v_wide", "v", 420, 700), ("v_large", "v", 600, 800)])
HP_EXTRACTOR = {"name": "superpoint_open", "max_num_keypoints": 512,
                "detection_threshold": 0.005, "dtype": None}
HP_LIGHTGLUE = {"name": "lightglue", "filter_threshold": 0.1, "collect_layers": False}
HP_SUMMARIES = ("mprec@1px", "mprec@3px", "mnum_matches", "mnum_keypoints", "mH_error_dlt",
                "H_error_ransac@1px", "H_error_ransac@3px", "H_error_ransac@5px",
                "H_error_ransac_mAA", "mH_error_ransac", "mransac_inl", "mransac_inl%",
                "H_error_dlt@1px", "H_error_dlt@3px", "H_error_dlt@5px")


def write_ppm(path, img):
    """A binary PPM (P6) of an (H, W) image in [0, 1], grey in all channels."""
    import numpy as np

    h, w = img.shape
    rgb = np.repeat((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)[..., None], 3, -1)
    path.write_bytes(b"P6\n%d %d\n255\n" % (w, h) + rgb.tobytes())


def build_hpatches_tree(root):
    """HPatches' on-disk layout under `root`: <scene>/{1..6}.ppm and H_1_{2..6};
    i_* scenes keep the geometry (identity H) under gain and bias jitter,
    v_* scenes are seeded homography warps of image 1 (grid_sample)."""
    import numpy as np
    import torch

    for k, (scene, kind, h, w) in enumerate(HP_SCENES):
        sdir = root / scene
        sdir.mkdir(parents=True)
        gen = torch.Generator(device="cuda").manual_seed(100 + k)
        base = texture(gen, 1, h, w)
        if kind == "i":
            hs = torch.eye(3, dtype=torch.float64, device="cuda").expand(5, 3, 3)
            gain = 0.7 + 0.6 * torch.rand(5, 1, 1, 1, generator=gen, device="cuda")
            bias = 0.1 * torch.rand(5, 1, 1, 1, generator=gen, device="cuda") - 0.05
            imgs = (base * gain + bias).clamp(0, 1)
        else:
            hs = torch.from_numpy(np.stack([homography(1000 * k + i, h, w)
                                            for i in range(5)])).cuda()
            imgs = warp(base.expand(5, 1, h, w).contiguous(), hs)
        write_ppm(sdir / "1.ppm", base[0, 0].cpu().numpy())
        for i in range(5):
            write_ppm(sdir / f"{i + 2}.ppm", imgs[i, 0].cpu().numpy())
            np.savetxt(sdir / f"H_1_{i + 2}", hs[i].cpu().numpy())


def hpatches_counters():
    from gluefactory_tpu_torch.ops import block0_conv as b0
    from gluefactory_tpu_torch.ops import lightglue_block as lb
    from gluefactory_tpu_torch.ops import log_assignment as la

    return b0.block0_fused, lb.fused_self_block, lb.fused_cross_block, la.fused_log_assignment


def run_hpatches(root, out, name, matcher, extractor=None, checkpoint=None, finite=None):
    """HPatchesPipeline(conf).run on the card with the K8, K1, K2, K4 counts
    set to 0 just before and read just after, with the committed weights or
    `checkpoint` (an experiment); the summaries of `finite` (default: all)
    must be finite. Returns (summaries, pipeline, counts)."""
    import torch

    from gluefactory_tpu_torch.eval.hpatches import HPatchesPipeline
    from gluefactory_tpu_torch.weights import HERMETIC

    conf = {"data": {"data_dir": str(root)}, "eval": {"ransac_th": -1},
            "model": {"extractor": {**HP_EXTRACTOR, **(extractor or {})}, "matcher": matcher,
                      "checkpoint": checkpoint or str(HERMETIC)}}
    pipe = HPatchesPipeline(conf, device="cuda")
    torch.cuda.synchronize()
    for fn in hpatches_counters():
        fn.launches = 0
    summaries, _, _ = pipe.run(out / name)
    torch.cuda.synchronize()
    counts = [fn.launches for fn in hpatches_counters()]
    n = len(HP_SCENES) * 5
    log(f"[hpatches {name}] export {n / pipe.timings['export_s']:.2f} pairs/s "
        f"({pipe.timings['export_s']:.2f} s for {n} pairs), eval phase "
        f"{pipe.timings['eval_s']:.2f} s; launches K8 {counts[0]}, K1 {counts[1]}, "
        f"K2 {counts[2]}, K4 {counts[3]}")
    log(f"[hpatches {name}] summaries " + json.dumps(summaries))
    bad = [k for k in (finite or summaries) if not math.isfinite(summaries[k])]
    if bad:
        fail(f"hpatches {name}: non-finite summaries {bad}")
    return summaries, pipe, counts


def check_ransac_devices(pred_file, th=3.0, pairs=8):
    """The card's RANSAC core against the CPU's on the same Gumbel noise, on
    the matches of `pairs` exported pairs; returns the median ms of one
    estimator call on the card (host clock, synchronised) at one threshold
    and at the sweep of six."""
    import numpy as np
    import torch

    from gluefactory_tpu_torch.estimators.homography.torch_ransac import (
        TorchRansacHomography, pad_to_bucket)
    from gluefactory_tpu_torch.estimators.ransac import gumbel, ransac_homography_core
    from gluefactory_tpu_torch.eval.utils import get_matches_scores
    from gluefactory_tpu_torch.geometry.homography import homography_corner_error
    from gluefactory_tpu_torch.utils.export_predictions import load_predictions

    preds = load_predictions(pred_file)
    names = sorted(preds)[::max(len(preds) // pairs, 1)][:pairs]
    worst, sizes = 0.0, []
    for k, name in enumerate(names):
        p = preds[name]
        pts0, pts1, _ = get_matches_scores(p["keypoints0"], p["keypoints1"], p["matches0"],
                                           p["matching_scores0"])
        k0, k1, valid = pad_to_bucket(torch.from_numpy(pts0), torch.from_numpy(pts1),
                                      torch.ones(len(pts0), dtype=torch.bool))
        gen = torch.Generator().manual_seed(k)
        noise = [gumbel((1024, k0.shape[0]), gen, "cpu") for _ in range(2)]
        cpu = ransac_homography_core(k0, k1, valid, noise, th)
        dev = ransac_homography_core(k0.cuda(), k1.cuda(), valid.cuda(),
                                     [g.cuda() for g in noise], th)
        size = torch.tensor([864.0, 480.0], dtype=torch.float64)
        diff = float(homography_corner_error(dev.model.cpu().double(), cpu.model.double(), size))
        worst = max(worst, diff)
        sizes.append(len(pts0))
        if diff > 0.05 or bool(dev.success) != bool(cpu.success):
            fail(f"RANSAC on the card against the CPU, pair {name}: H {diff:.4f} px apart "
                 f"(> 0.05) or success {bool(dev.success)} != {bool(cpu.success)}")
    log(f"[hpatches ransac] the card's RANSAC core and the CPU's, same noise, {len(names)} "
        f"pairs ({min(sizes)}-{max(sizes)} matches): H at most {worst:.2e} px apart, "
        f"success equal")
    # one estimator call (K = 1024, two rounds) on the card, on the last pair's matches,
    # at one threshold and at the eval's sweep of six
    data = {"m_kpts0": pts0, "m_kpts1": pts1}
    out = []
    for ths in (th, [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]):
        est = TorchRansacHomography({"ransac_th": ths}, device="cuda")
        times = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est(data)["success"].cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        times = sorted(times[2:])
        out.append(times[len(times) // 2])
        log(f"[hpatches ransac] one call on the card, {len(pts0)} matches (bucket "
            f"{k0.shape[0]}), K = 1024, two rounds, {np.size(ths)} threshold(s): median "
            f"{out[-1]:.2f} ms of 10 ({times[0]:.2f}-{times[-1]:.2f})")
    return out


def run_hpatches_eval():
    """Phase 8; returns the K1, K2, K4 launches of the full-depth run."""
    import collections
    import shutil

    import numpy as np

    from gluefactory_tpu_torch.utils.export_predictions import load_predictions

    work = ROOT / "outputs" / "chip_smoke_hpatches"
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        data = work / "data" / "hpatches-sequences-release"
        build_hpatches_tree(data)
        n = len(HP_SCENES) * 5
        log(f"[hpatches] tree of {len(HP_SCENES)} scenes, {n} pairs, written in "
            f"{time.perf_counter() - t0:.2f} s")
        s_lg, lg, counts = run_hpatches(data, work, "lightglue", HP_LIGHTGLUE)
        if counts != [0, 9 * n, 9 * n, n]:
            fail(f"hpatches lightglue: expected K1 = K2 = 9 and K4 = 1 launches a pair and no "
                 f"K8, got {counts} over {n} pairs")
        s_nn, _, _ = run_hpatches(data, work, "nn", {"name": "nearest_neighbor_matcher",
                                                     "mutual_check": True})
        if not (s_lg["H_error_dlt@3px"] > s_nn["H_error_dlt@3px"] and s_lg["mH_error_dlt"] < 10):
            fail(f"hpatches: LightGlue's H_error_dlt@3px {s_lg['H_error_dlt@3px']} not above "
                 f"NN's {s_nn['H_error_dlt@3px']}, or mH_error_dlt {s_lg['mH_error_dlt']} >= 10")
        _, ad, ad_counts = run_hpatches(
            data, work, "adaptive", {**HP_LIGHTGLUE, **ADAPTIVE}, {"fused_block0": True})
        stops = [int(p["stop_layer"]) for p in
                 load_predictions(work / "adaptive" / "predictions.npz").values()]
        hist = collections.Counter(stops)
        log("[hpatches adaptive] stop_layer histogram over the pairs: " + ", ".join(
            f"{layer}: {hist[layer]}" for layer in sorted(hist)) + f"; mean {np.mean(stops):.2f}")
        layers = sum(s + 1 for s in stops)
        if ad_counts != [n, layers, layers, n]:
            fail(f"hpatches adaptive: expected K8 = K4 = {n}, K1 = K2 = {layers} "
                 f"(stop_layer + 1 a pair), got {ad_counts}")
        one_ms, sweep_ms = check_ransac_devices(work / "lightglue" / "predictions.npz")
        export_ms = lg.timings["export_s"] / n * 1e3
        eval_ms = lg.timings["eval_s"] / n * 1e3
        log(f"[hpatches] lightglue, per pair: export {export_ms:.2f} ms, eval {eval_ms:.2f} ms "
            f"(precision, 1 DLT and one RANSAC call for the 6 thresholds, {sweep_ms:.2f} ms; "
            f"one threshold alone {one_ms:.2f} ms)")
        return {"K1 eval": counts[1], "K2 eval": counts[2], "K4 eval": counts[3]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------------ phase 9
TRAIN_EPOCHS, TRAIN_STEPS, VAL_PAIRS, BENCH_PAIRS = 2, 3, 32, 10


def entry_conf(init):
    """The training configuration at full width, cut to TRAIN_B pairs a step
    (its batch of 128 is the global one), TRAIN_STEPS steps an epoch and a
    VAL_PAIRS-pair val split; the committed weights grafted from `init`."""
    from gluefactory_tpu_torch.utils.config import load_conf, merge

    # one pair a batch, the shapes phase 3 holds K1, K2 and K4 at
    bench = {"data": {"val_size": BENCH_PAIRS, "val_batch_size": 1},
             "model": {"extractor": {"max_num_keypoints": TRAIN_N}}}
    return merge(load_conf(TRAIN_CONF), {
        "data": {"batch_size": TRAIN_B, "train_size": TRAIN_STEPS * TRAIN_B,
                 "val_size": VAL_PAIRS},
        "train": {"epochs": TRAIN_EPOCHS, "eval_every_iter": 2, "keep_last_checkpoints": 2,
                  "log_every_iter": 1, "load_experiment": init,
                  "benchmarks": {"synthetic": bench}},
    })


def entry_counts():
    return {**read_train_counts(), **dict(zip(("K1", "K2", "K4"), read_counts()))}


def reset_entry_counts():
    reset_train_counts()
    reset_counts()


def run_training_entry():
    """Phase 9: the training entry point on the card. Run A: Trainer.build()
    and train() for TRAIN_EPOCHS epochs with validation, checkpoints and the
    synthetic benchmark; run B: `train.__main__.main` for the first epoch,
    then again with --restore for the second. Returns the per-step launches."""
    import shutil
    import statistics

    import torch

    import gluefactory_tpu_torch.eval as gf_eval
    from gluefactory_tpu_torch.datasets.homographies import HomographyDataset
    from gluefactory_tpu_torch.train import __main__ as cli
    from gluefactory_tpu_torch.train import trainer as tmod
    from gluefactory_tpu_torch.utils import experiments as exps
    from gluefactory_tpu_torch.utils.config import save_conf
    from gluefactory_tpu_torch.weights import load_hermetic

    t_phase = time.perf_counter()
    work = ROOT / "outputs" / "chip_smoke_training"
    shutil.rmtree(work, ignore_errors=True)
    exps.TRAINING_PATH = work
    timing = {"save": [], "restore": [], "validation": [], "benchmark": []}

    def timed_call(key, fn):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timing[key].append(time.perf_counter() - t0)
            return out
        return wrapped

    saved = (tmod.save_experiment, tmod.load_checkpoint, gf_eval.run_benchmark)
    written = set()

    def save(experiment, state, conf, epoch, iter_i, **k):
        if experiment == "run_a" and not k.get("interrupted"):
            written.add((epoch, iter_i))
        return timed_call("save", saved[0])(experiment, state, conf, epoch, iter_i, **k)

    tmod.save_experiment = save
    tmod.load_checkpoint = timed_call("restore", saved[1])
    bench_runs = []

    def counted_benchmark(*a, **k):
        torch.cuda.synchronize()
        reset_entry_counts()
        summaries, figures = timed_call("benchmark", saved[2])(*a, **k)
        bench_runs.append((entry_counts(), summaries))
        return summaries, figures

    gf_eval.run_benchmark = counted_benchmark
    try:
        exps.save_experiment("chip_smoke_init", {"model": load_hermetic(device="cpu")}, {}, 0, 0,
                             is_best=True)
        conf = entry_conf("chip_smoke_init")

        # run A, through the Trainer
        trainer = tmod.Trainer(conf, "run_a", exps.experiment_dir("run_a"), device="cuda")
        trainer.build()
        steps, evals = [], []

        def step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reset_entry_counts()
            state, losses = step_fn(state, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps.append((t0, t1, entry_counts(), {k: float(v) for k, v in losses.items()}))
            return state, losses

        def evaluate(epoch, it):
            reset_entry_counts()
            t0 = time.perf_counter()
            results = eval_fn(epoch, it)
            torch.cuda.synchronize()
            timing["validation"].append(time.perf_counter() - t0)
            evals.append((entry_counts(), results))
            return results

        step_fn, eval_fn = trainer.train_step, trainer.do_evaluation
        trainer.train_step, trainer.do_evaluation = step, evaluate
        t_a = time.perf_counter()
        trainer.train()
        t_a = time.perf_counter() - t_a
        per_step = {"K5": 2 * 9, "K6b": 2 * 9, "K6a": 0, "K7b self": 9, "K7b cross": 2 * 9,
                    "K1": 0, "K2": 0, "K4": 0}
        if len(steps) != TRAIN_EPOCHS * TRAIN_STEPS:
            fail(f"training entry: {len(steps)} steps, expected {TRAIN_EPOCHS * TRAIN_STEPS}")
        for i, (_, _, counts, losses) in enumerate(steps):
            if counts != per_step:
                fail(f"training entry, step {i}: launches {counts}, expected {per_step}")
            if not all(math.isfinite(v) for v in losses.values()) or losses["skipped_nonfinite"]:
                fail(f"training entry, step {i}: {losses}")
        n_val = VAL_PAIRS // TRAIN_B
        for counts, results in evals:
            if not (counts["K5"] == counts["K6b"] == 9 * n_val and counts["K7b self"] == 0
                    and counts["K7b cross"] == 0 and counts["K6a"] == 0):
                fail(f"training entry, validation: launches {counts}, expected K5 = K6b = "
                     f"{9 * n_val} and no K7b or K6a")
            if not math.isfinite(results["loss/total"]):
                fail(f"training entry, validation: {results}")
        if len(evals) != 5:
            fail(f"training entry: {len(evals)} validations, expected 5 (iterations 2, 3, 4, 6, "
                 "6 at the end of epoch 1)")
        if len(bench_runs) != TRAIN_EPOCHS:
            fail(f"training entry: {len(bench_runs)} benchmark runs, expected one an epoch "
                 "(a failed benchmark only logs a warning)")
        for counts, summaries in bench_runs:
            want = {"K1": 9 * BENCH_PAIRS, "K2": 9 * BENCH_PAIRS, "K4": BENCH_PAIRS}
            if {k: counts[k] for k in want} != want or counts["K7b self"] or counts["K5"]:
                fail(f"training entry, benchmark: launches {counts}, expected {want} "
                     "and no training kernel")
            bad = [k for k, v in summaries.items() if not math.isfinite(v)]
            if bad:
                fail(f"training entry, benchmark: non-finite summaries {bad}")
        cps = exps.list_checkpoints(exps.experiment_dir("run_a"))
        best = exps.get_best_checkpoint("run_a")
        meta = json.loads((cps[-1][1] / "meta.json").read_text())
        if ([c[0] for c in cps] != sorted(written)[-2:] or cps[-1][0] != (1, 6)
                or meta["epoch"] != 1 or meta["iter"] != 6
                or not (best / "state.pt").exists() or meta["best_eval"] is None):
            fail(f"training entry: checkpoints {[c[1].name for c in cps]}, best {best}, meta "
                 f"{ {k: meta[k] for k in ('epoch', 'iter', 'best_eval')} }")

        # run B: the command line, one epoch, then --restore for the second
        conf_file = work / "run_b.json"
        save_conf(conf, conf_file)
        args = ["run_b", "--conf", str(conf_file), "train.benchmarks=null"]
        cli.main([*args, "train.epochs=1"])
        restored = cli.main([*args, "--restore"])
        diff = max(float((restored.model.state_dict()[k].float() - v.float()).abs().max())
                   for k, v in trainer.model.state_dict().items())
        bitwise = all(torch.equal(restored.model.state_dict()[k], v)
                      for k, v in trainer.model.state_dict().items())
        if diff > 1e-6 or restored.state.optimizer.count != trainer.state.optimizer.count:
            fail(f"training entry: resumed parameters {diff:.3g} from the uninterrupted run's "
                 f"(bar 1e-6), Adam count {restored.state.optimizer.count} against "
                 f"{trainer.state.optimizer.count}")

        # the loader alone, then steps fed by it, on warm textures (after the
        # comparison: these steps move run A's parameters)
        step_only = [z - a for a, z, _, _ in steps]
        ds = HomographyDataset(conf["data"])
        t0 = time.perf_counter()
        n = sum(batch["view0"]["image"].shape[0]
                for batch in ds.get_data_loader("train", epoch=TRAIN_EPOCHS))
        loader_pps = n / (time.perf_counter() - t0)
        trainer.train_step = step_fn
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fed = trainer.train_steps(ds.get_data_loader("train", epoch=TRAIN_EPOCHS + 1))
        torch.cuda.synchronize()
        with_loader_ms = (time.perf_counter() - t0) * 1e3 / len(fed)
        med = lambda xs: statistics.median(xs) * 1e3
        log(f"[train entry] run A ({TRAIN_EPOCHS} epochs x {TRAIN_STEPS} steps of {TRAIN_B} pairs, "
            f"{VAL_PAIRS}-pair validation at iterations 2, 3, 4, 6, 6, synthetic benchmark of "
            f"{BENCH_PAIRS} pairs an epoch) {t_a:.2f} s; launches a step {per_step}, a "
            f"validation {evals[0][0]['K5']} K5 + {evals[0][0]['K6b']} K6b, a benchmark "
            f"{ {k: bench_runs[0][0][k] for k in ('K1', 'K2', 'K4')} }")
        log(f"[train entry] losses total " + " ".join(f"{s[3]['total']:.4f}" for s in steps)
            + "; val loss/total " + " ".join(f"{r['loss/total']:.4f}" for _, r in evals)
            + "; benchmark H_error_dlt@3px "
            + " ".join(f"{s['H_error_dlt@3px']:.4f}" for _, s in bench_runs))
        log(f"[train entry] ms a step with the loader {with_loader_ms:.2f} ({len(fed)} steps "
            f"fed by the train loader, from its start); the step alone {med(step_only):.2f} "
            f"(median of {len(step_only)}, run A; phase 5: the step on batches in memory); the "
            f"loader alone {loader_pps:.2f} pairs/s ({n} pairs, "
            f"{conf['data']['num_workers']} workers, warm textures), "
            f"{TRAIN_B / loader_pps * 1e3:.2f} ms a batch")
        log(f"[train entry] validation {med(timing['validation']):.2f} ms (median of "
            f"{len(timing['validation'])}, {VAL_PAIRS} pairs); checkpoint save "
            f"{med(timing['save']):.2f} ms (median of {len(timing['save'])}), restore "
            f"{med(timing['restore']):.2f} ms; benchmark "
            + " ".join(f"{t:.2f}" for t in timing["benchmark"]) + " s")
        log(f"[train entry] run B (epoch 0, --restore, epoch 1) against run A: final parameters "
            f"max abs diff {diff:.3g} (bar 1e-6), bitwise {bitwise}, Adam count "
            f"{restored.state.optimizer.count}; checkpoints "
            f"{[c[1].name for c in cps]} + checkpoint_best; phase {time.perf_counter() - t_phase:.1f} s")
        return per_step
    finally:
        tmod.save_experiment, tmod.load_checkpoint, gf_eval.run_benchmark = saved
        shutil.rmtree(work, ignore_errors=True)


# ----------------------------------------------------------------- phase 10
DEPTH_CONF = "superpoint-open+lightglue_depth"  # the depth fine-tune configuration
DEPTH_STEPS = 3  # timed steps at the configuration's shape
MD_B, MD_N = 8, 2048  # the MegaDepth recipe's step: pairs at 640 x 480, keypoints
POSE_PAIRS = 20  # the synthetic_pose test split
POSE_DRAWS = 2  # RANSAC draws a pair in the card-against-CPU comparison
WEIGHTS = ROOT / "weights" / "hermetic"
GT_KEYS = ("gt_matches0", "gt_matches1", "gt_assignment")


def depth_conf(**over):
    """The depth fine-tune configuration, `over` laid over it."""
    from gluefactory_tpu_torch.utils.config import load_conf, merge

    return merge(load_conf(DEPTH_CONF), over)


def depth_trainer(conf, flash):
    """A built trainer: the dataset, and the committed homography weights
    grafted by the configuration's `train.load_experiment`."""
    from gluefactory_tpu_torch.train.trainer import Trainer
    from gluefactory_tpu_torch.utils.config import merge

    trainer = Trainer(merge(conf, {"model": {"matcher": {"flash": flash}}}), device="cuda")
    trainer.build()
    return trainer


def check_depth_training(conf, label, steps):
    """Phase 10a on one configuration: batches from the trainer's own
    loader; the ground truth on the card against the CPU on the same
    keypoints; the first step's loss and two gradients against the plain
    path (`flash: False`); `steps` steps with the attention counts set to 0
    just before and read just after. Returns (launches a step, ms a step,
    peak MiB, ground-truth positives a pair)."""
    import torch

    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.utils.tensor import batch_to_device

    trainer = depth_trainer(conf, True)
    mconf, econf = trainer.model.matcher.conf, trainer.model.extractor.conf
    if (mconf.n_layers, mconf.descriptor_dim, mconf.mp, mconf.checkpointed) != (9, D, False, True):
        fail(f"{label}: LightGlue is not 9 x 256, fp32, checkpointed")
    loader = trainer.dataset.get_data_loader("train", epoch=0)
    batches = [batch_to_device(next(loader), "cuda") for _ in range(steps)]
    del loader
    b, n = batches[0]["view0"]["image"].shape[0], int(econf.max_num_keypoints)
    first = batches[0]
    with torch.no_grad():
        feats = {f"{k}{i}": t for i, v in enumerate(("view0", "view1"))
                 for k, t in trainer.model.extractor(first[v]).items()}
    if feats["keypoints0"].shape[1] != n:
        fail(f"{label}: {feats['keypoints0'].shape[1]} keypoints, expected {n}")
    gt = trainer.model.ground_truth({**first, **feats})
    cpu_gt = get_model("depth_matcher")(dict(conf["model"]["ground_truth"]), device="cpu")(
        batch_to_device({**first, **feats}, "cpu"))
    for k in GT_KEYS:
        if not torch.equal(gt[k].cpu(), cpu_gt[k]):
            fail(f"{label}: {k} on the card differs from the CPU's on "
                 f"{int((gt[k].cpu() != cpu_gt[k]).sum())} entries")
    positives = float((gt["gt_matches0"] >= 0).sum(-1).float().mean())

    named = ("matcher.self_Wqkv_w", "matcher.assign_proj_w")

    def loss_and_grads(tr):
        params = dict(tr.model.named_parameters())
        losses, _ = tr.model.loss(tr.model(first), first)
        total = losses["total"].mean()
        return float(total.detach()), torch.autograd.grad(total, [params[k] for k in named])

    total, grads = loss_and_grads(trainer)
    plain = depth_trainer(conf, False)
    ref_total, ref_grads = loss_and_grads(plain)
    del plain
    torch.cuda.empty_cache()
    if not abs(total - ref_total) <= 1e-4 * abs(ref_total):
        fail(f"{label}: first total {total} against the plain path's {ref_total} (rtol 1e-4)")
    worst = []
    for key, g, r in zip(named, grads, ref_grads):
        diff, top = float((g - r).abs().max()), float(r.abs().max())
        if not (top > 0 and diff <= 1e-3 * top + 1e-7):
            fail(f"{label}: gradient of {key} {diff:.3g} from the plain path's (max |g| {top:.3g})")
        worst.append(f"{key} {diff:.3g} (max |g| {top:.3g})")
    log(f"[{label}] {b} pairs x {n} keypoints: ground truth on the card equal to the CPU's "
        f"({', '.join(GT_KEYS)}), {positives:.1f} positives a pair; first total {total:.6f}, "
        f"plain path {ref_total:.6f} (rtol 1e-4); gradients " + "; ".join(worst)
        + " (bar 1e-3 max|g| + 1e-7)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    t0 = time.perf_counter()
    history = trainer.train_steps(batches, steps=steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = read_train_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    per_step = {"K5": 18, "K6b": 18, "K6a": 0, "K7b self": 9, "K7b cross": 18}
    if counts != {k: v * steps for k, v in per_step.items()}:
        fail(f"{label}: expected {per_step} launches a step, got {counts} in {steps} steps")
    for i, losses in enumerate(history):
        if not all(math.isfinite(v) for v in losses.values()) or losses["skipped_nonfinite"]:
            fail(f"{label}: step {i}: {losses}")
    log(f"[{label}] {steps} step(s): {step_ms:.2f} ms a step ({b * 1e3 / step_ms:.2f} pairs/s "
        f"trained), peak memory {peak:.0f} MiB, launches {counts}; losses total "
        + " ".join(f"{x['total']:.4f}" for x in history))
    del trainer, batches, gt, feats
    torch.cuda.empty_cache()
    return per_step, step_ms, peak, positives


def pose_conf(matcher, weights, **data):
    """The synthetic_pose configuration of the depth fine-tune's evaluation:
    20 test pairs at 640 x 480, 512 keypoints at 0.005, fp32, RANSAC 1 px."""
    return {"data": {"image_size": [640, 480], "test_size": POSE_PAIRS, "num_workers": 4, **data},
            "eval": {"ransac_th": 1.0},
            "model": {"extractor": HP_EXTRACTOR, "matcher": matcher,
                      "checkpoint": str(WEIGHTS / weights)}}


def run_pose_model(work, name, matcher, weights):
    """SyntheticPosePipeline(conf).run on the card with K1, K2, K4 counted;
    returns (summaries, pipeline, counts)."""
    import torch

    from gluefactory_tpu_torch.eval.synthetic_pose import SyntheticPosePipeline

    pipe = SyntheticPosePipeline(pose_conf(matcher, weights), device="cuda")
    counters_ = hpatches_counters()[1:]
    torch.cuda.synchronize()
    for fn in counters_:
        fn.launches = 0
    summaries, _, _ = pipe.run(work / name, overwrite=True)
    torch.cuda.synchronize()
    counts = [fn.launches for fn in counters_]
    t = pipe.timings
    keys = ("rel_pose_error@5°", "rel_pose_error@10°", "rel_pose_error@20°", "rel_pose_error_mAA",
            "mransac_inl%", "mepi_prec@1e-4", "mepi_prec@5e-4", "mepi_prec@1e-3", "mnum_matches")
    log(f"[synthetic_pose {name}] export {POSE_PAIRS / t['export_s']:.2f} pairs/s "
        f"({t['export_s']:.2f} s), eval phase {t['eval_s']:.2f} s; launches K1 {counts[0]}, "
        f"K2 {counts[1]}, K4 {counts[2]}; " + ", ".join(f"{k} {summaries[k]:.4f}" for k in keys))
    bad = [k for k, v in summaries.items() if not math.isfinite(v)]
    if bad:
        fail(f"synthetic_pose {name}: non-finite summaries {bad}")
    return summaries, pipe, counts


def call_profile(fn, calls=3):
    """(kernel launches, device ms, host reads) a call of `fn`, by
    torch.profiler; (None, ms by CUDA events, None) where it records no
    kernel."""
    def run():
        for _ in range(calls):
            fn()

    got = profiled(run)
    if got is None:
        return None, timed(fn, calls, warmup=0), None
    events = got[0].key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    reads = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    return (sum(e.count for e in kernels) / calls,
            sum(e.self_device_time_total for e in kernels) / calls / 1e3, reads / calls)


def check_pose_ransac(pipe, pred_file):
    """The card's relative-pose RANSAC core against the CPU's on the same
    noise, on every exported pair under POSE_DRAWS draws (all rounds from
    one generator seeded by the pair's index). The estimate is not
    continuous at fp32 where near-equal candidates compete (ROADMAP Queue
    3a), so the bars over all estimates are set by the CPU's own spread: the
    CPU's core rerun with view 0's points scaled by 1 +- 1e-7. The share of
    estimates whose rel_pose_error the card gives within 0.5 degrees of the
    CPU's is at least the smaller share of the two reruns less 0.1, and the
    card's mAA is within 0.02 + the larger mAA shift of the reruns of the
    CPU's. On the estimates that are stable at fp32 on both devices (both
    reruns within 0.25 degrees on the CPU and on the card, at least 5),
    every card error is within 0.5 degrees and their mAA within 0.02. Then
    one estimator call's ms, launches and host reads at one threshold and at
    the sweep of six."""
    import numpy as np
    import torch

    from gluefactory_tpu_torch.estimators.homography.torch_ransac import pad_to_bucket
    from gluefactory_tpu_torch.estimators.ransac import gumbel, ransac_relative_pose_core
    from gluefactory_tpu_torch.estimators.relative_pose.torch_ransac import TorchRansacRelativePose
    from gluefactory_tpu_torch.eval.utils import get_matches_scores
    from gluefactory_tpu_torch.geometry.epipolar import relative_pose_error
    from gluefactory_tpu_torch.utils.export_predictions import load_predictions
    from gluefactory_tpu_torch.utils.tensor import index_batch
    from gluefactory_tpu_torch.utils.tools import AUCMetric

    preds = load_predictions(pred_file)
    reruns = (("+1e-7", 1e-7), ("-1e-7", -1e-7))
    errs = {k: [] for k in ("cpu", "cuda", "+1e-7", "-1e-7", "cuda+1e-7", "cuda-1e-7")}
    t_cpu = 0.0

    def pose_error(r, T):
        if not bool(r.success):
            return float("inf")
        t_err, r_err = relative_pose_error(T, r.R.cpu(), r.t.cpu())
        return float(torch.maximum(t_err, r_err))

    for i, batch in enumerate(pipe.get_eval_data()):
        data = next(index_batch(batch))
        p = preds[batch["name"][0]]
        pts0, pts1, _ = get_matches_scores(p["keypoints0"], p["keypoints1"], p["matches0"],
                                           p["matching_scores0"])
        if len(pts0) < 8:
            for v in errs.values():
                v.extend([float("inf")] * POSE_DRAWS)
            continue
        k0, k1, valid = pad_to_bucket(torch.from_numpy(pts0), torch.from_numpy(pts1),
                                      torch.ones(len(pts0), dtype=torch.bool))
        cam0, cam1 = data["view0"]["camera"], data["view1"]["camera"]
        n0, n1 = cam0.normalize(k0[None])[0], cam1.normalize(k1[None])[0]
        th = 1.0 / ((cam0.f.mean() + cam1.f.mean()) / 2)
        gen = torch.Generator().manual_seed(i)
        for _ in range(POSE_DRAWS):
            noise = [gumbel((8192, k0.shape[0]), gen, "cpu") for _ in range(2)]
            t0 = time.perf_counter()
            cpu = ransac_relative_pose_core(n0, n1, valid, noise, th, refine_iters=4)
            t_cpu += time.perf_counter() - t0
            dev_in = (n0.cuda(), n1.cuda(), valid.cuda(), [g.cuda() for g in noise])
            for key, eps in reruns:
                errs[key].append(pose_error(ransac_relative_pose_core(
                    n0 * (1 + eps), n1, valid, noise, th, refine_iters=4), data["T_0to1"]))
                errs["cuda" + key].append(pose_error(ransac_relative_pose_core(
                    dev_in[0] * (1 + eps), *dev_in[1:], th.cuda(), refine_iters=4),
                    data["T_0to1"]))
            dev = ransac_relative_pose_core(*dev_in, th.cuda(), refine_iters=4)
            errs["cpu"].append(pose_error(cpu, data["T_0to1"]))
            errs["cuda"].append(pose_error(dev, data["T_0to1"]))
    e = {k: np.array(v) for k, v in errs.items()}
    n_pairs, n_est = i + 1, len(e["cpu"])

    def near(a, b, tol):
        return (np.abs(a - b) <= tol) | (np.isinf(a) & np.isinf(b))

    def maa(x):
        return float(np.mean(AUCMetric([5, 10, 20], list(x)).compute()))

    sides = (("cpu", ""), ("cuda", "cuda"))
    stable = np.all([near(e[pre + k], e[base], 0.25) for base, pre in sides for k, _ in reruns], 0)
    same = near(e["cuda"], e["cpu"], 0.5)
    rerun_share = min(near(e[k], e["cpu"], 0.5).mean() for k, _ in reruns)
    rerun_shift = max(abs(maa(e[k]) - maa(e["cpu"])) for k, _ in reruns)
    maa_bar = 0.02 + rerun_shift
    log(f"[synthetic_pose ransac] the card's RANSAC core and the CPU's, same noise, "
        f"{n_pairs} pairs x {POSE_DRAWS} draws at 1 px: rel_pose_error within 0.5 deg on "
        f"{int(same.sum())} of {n_est} (bar {max(rerun_share - 0.1, 0) * n_est:.0f}: the CPU's "
        f"reruns at 1 +- 1e-7 agree with it on {rerun_share * n_est:.0f}, less "
        f"{0.1 * n_est:.0f}); mAA of all "
        f"{maa(e['cuda']):.4f} against {maa(e['cpu']):.4f} (bar {maa_bar:.4f}: 0.02 + the "
        f"reruns' largest shift {rerun_shift:.4f}; reruns {maa(e['+1e-7']):.4f}, "
        f"{maa(e['-1e-7']):.4f}); "
        f"{int(stable.sum())} estimates stable at fp32 on both devices (bar 5), within 0.5 "
        f"deg on {int(same[stable].sum())} of them (bar all), their mAA "
        f"{maa(e['cuda'][stable]):.4f} against {maa(e['cpu'][stable]):.4f} (bar 0.02); the CPU "
        f"core {t_cpu / n_est * 1e3:.1f} ms a call")
    if (same.mean() < rerun_share - 0.1 or abs(maa(e["cuda"]) - maa(e["cpu"])) > maa_bar
            or stable.sum() < 5 or not same[stable].all()
            or abs(maa(e["cuda"][stable]) - maa(e["cpu"][stable])) > 0.02):
        fail("synthetic_pose: the card's RANSAC disagrees with the CPU's")
    # one estimator call (K = 8192, two rounds) on the last pair's matches
    data = {"m_kpts0": pts0, "m_kpts1": pts1, "camera0": cam0, "camera1": cam1}
    out = {}
    for ths in (1.0, [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]):
        est = TorchRansacRelativePose({"ransac_th": ths}, device="cuda")
        call = lambda: est(data)["success"].cpu()
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
        times = sorted(times[2:])
        launches, dev_ms, reads = call_profile(call)
        tag = "one threshold" if ths == 1.0 else "the sweep of six"
        out[tag] = times[len(times) // 2]
        profile = (f"{launches:.0f} kernel launches, {dev_ms:.2f} ms of device time, "
                   f"{reads:.0f} host reads (cudaStreamSynchronize) a call"
                   if launches is not None else f"{dev_ms:.2f} ms by CUDA events a call, "
                   "launches and host reads not measured")
        log(f"[synthetic_pose ransac] one call on the card, {len(pts0)} matches (bucket "
            f"{k0.shape[0]}), K = 8192, two rounds, {tag}: median {out[tag]:.2f} ms of 8 "
            f"({times[0]:.2f}-{times[-1]:.2f}); {profile}")
    return out


def run_depth_slice():
    """Phase 10: (a) depth-supervised fine-tuning at the configuration's shape
    and one step at the MegaDepth recipe's extractor settings, the loader's
    pairs/s; (b) the synthetic_pose benchmark for NN, homography-only and
    depth-fine-tuned LightGlue, with the JAX package's quality bars and the
    card's RANSAC against the CPU's. Returns the launches of the 2048-keypoint
    step."""
    import shutil

    from gluefactory_tpu_torch.datasets.synthetic_two_view import SyntheticTwoViewDataset

    t_phase = time.perf_counter()
    conf = depth_conf()
    check_depth_training(conf, "depth 480x368/512/b4", DEPTH_STEPS)
    md = depth_conf(data={"image_size": [640, 480], "train_batch_size": MD_B},
                    model={"extractor": {"max_num_keypoints": MD_N, "force_num_keypoints": True,
                                         "detection_threshold": 0.0}})
    md_step, md_ms, md_peak, _ = check_depth_training(md, "depth 640x480/2048/b8", 1)
    # the loader alone: the configuration's batches and workers, from a fresh epoch
    ds = SyntheticTwoViewDataset(conf["data"])
    loader = ds.get_data_loader("train", epoch=1)
    t0 = time.perf_counter()
    n = sum(next(loader)["view0"]["image"].shape[0] for _ in range(4))
    pps = n / (time.perf_counter() - t0)
    del loader
    log(f"[depth loader] {pps:.2f} pairs/s alone ({n} pairs at {conf['data']['image_size']}, "
        f"{conf['data']['num_workers']} workers; a batch of {conf['data']['train_batch_size']} in "
        f"{conf['data']['train_batch_size'] / pps * 1e3:.0f} ms)")

    work = ROOT / "outputs" / "chip_smoke_pose"
    shutil.rmtree(work, ignore_errors=True)
    try:
        runs = {"nn": ({"name": "nearest_neighbor_matcher", "mutual_check": True},
                       "sp_open_lg.npz"),
                "homography_only": (HP_LIGHTGLUE, "sp_open_lg.npz"),
                "depth_finetuned": (HP_LIGHTGLUE, "sp_open_lg_depth.npz")}
        out = {}
        for name, (matcher, weights) in runs.items():
            out[name] = run_pose_model(work, name, matcher, weights)
            want = [0, 0, 0] if name == "nn" else [9 * POSE_PAIRS, 9 * POSE_PAIRS, POSE_PAIRS]
            if out[name][2] != want:
                fail(f"synthetic_pose {name}: launches K1, K2, K4 {out[name][2]}, expected {want}")
        h, d = out["homography_only"][0], out["depth_finetuned"][0]
        gains = [d[k] - h[k] for k in ("rel_pose_error_mAA", "mransac_inl%", "mepi_prec@1e-3")]
        log(f"[synthetic_pose] depth-fine-tuned against homography-only: mAA {gains[0]:+.4f} "
            f"(bar > 0.01), mransac_inl% {gains[1]:+.4f} (bar > 0.02), mepi_prec@1e-3 "
            f"{gains[2]:+.4f} (bar >= 0); NN mAA {out['nn'][0]['rel_pose_error_mAA']:.4f}")
        if not (gains[0] > 0.01 and gains[1] > 0.02 and gains[2] >= 0):
            fail("synthetic_pose: the depth-fine-tuned weights miss the JAX package's bars")
        pipe = out["depth_finetuned"][1]
        ransac_ms = check_pose_ransac(pipe, work / "depth_finetuned" / "predictions.npz")
        log(f"[synthetic_pose] depth-fine-tuned, per pair: export "
            f"{pipe.timings['export_s'] / POSE_PAIRS * 1e3:.2f} ms, eval "
            f"{pipe.timings['eval_s'] / POSE_PAIRS * 1e3:.2f} ms (one RANSAC call "
            f"{ransac_ms['one threshold']:.2f} ms; the sweep of six "
            f"{ransac_ms['the sweep of six']:.2f} ms); 2048-keypoint step {md_ms:.2f} ms, "
            f"peak {md_peak:.0f} MiB; phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {f"{k} 2048": v for k, v in md_step.items()}


# ----------------------------------------------------------------- phase 11
MP_CONF = "superpoint-open+lightglue_MP"  # LightGlue on multispectral pairs
MP_STEPS = 3  # training steps of TRAIN_B pairs
MP_TEST_PAIRS = 7  # the MP benchmark's synthetic test split (64 pairs, 10% test)
MP_EXTRACTORS = {
    "superpoint_open": {"name": "superpoint_open", "max_num_keypoints": 512,
                        "detection_threshold": 0.0, "nms_radius": 3, "dtype": None},
    "multipoint": {"name": "gluefactory_tpu_torch.multipoint.models.multipoint",
                   "max_num_keypoints": 512},
    "xpoint_swin": {"name": "gluefactory_tpu_torch.multipoint.models.xpoint",
                    "backbone": "swin", "max_num_keypoints": 512},
}
MP_LIGHTGLUE = {"name": "lightglue", "filter_threshold": 0.1}
# summaries that are finite whatever the matches: a pair without a homography
# has an infinite error, which the medians of seeded extractors show
MP_FINITE = ("H_error_dlt@1px", "H_error_dlt@3px", "H_error_dlt@5px", "H_error_ransac@1px",
             "H_error_ransac@3px", "H_error_ransac@5px", "H_error_ransac_mAA", "mprec@1px",
             "mprec@3px", "mnum_matches", "mnum_keypoints")


def mp_train_conf(init):
    """The MP configuration at its width (batch TRAIN_B, 256 x 320 synthetic
    pairs, 512 keypoints forced, LightGlue 9 x 256 fp32 checkpointed), cut to
    MP_STEPS steps and one validation of TRAIN_B pairs (a pool of 128, three
    quarters for training), the committed weights grafted from `init`, and
    the MP benchmark (its 7 test pairs) with the trained LightGlue in eval
    mode at the end of the epoch."""
    from gluefactory_tpu_torch.utils.config import load_conf, merge

    conf = load_conf(MP_CONF)
    bench = {"model": {"extractor": {**conf["model"]["extractor"], "dtype": None},
                       "matcher": MP_LIGHTGLUE}}
    return merge(conf, {
        "data": {"batch_size": TRAIN_B,
                 "mp": {"synthetic": {"pool": 128}, "train_fraction": 0.75}},
        "train": {"epochs": 1, "log_every_iter": 1, "load_experiment": init,
                  "benchmarks": {"MP": bench}},
    })


def timed_trainer(trainer):
    """Wrap a trainer's step and validation: each step's (start, end,
    launches, losses) and each validation's (launches, results) go to the
    returned lists; `restore()` unwraps."""
    import torch

    steps, evals = [], []
    step_fn, eval_fn = trainer.train_step, trainer.do_evaluation

    def step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_entry_counts()
        state, losses = step_fn(state, batch)
        torch.cuda.synchronize()
        steps.append((t0, time.perf_counter(), entry_counts(),
                      {k: float(v) for k, v in losses.items()}))
        return state, losses

    def evaluate(epoch, it):
        reset_entry_counts()
        results = eval_fn(epoch, it)
        torch.cuda.synchronize()
        evals.append((entry_counts(), results))
        return results

    def restore():
        trainer.train_step, trainer.do_evaluation = step_fn, eval_fn

    trainer.train_step, trainer.do_evaluation = step, evaluate
    return steps, evals, restore


def hold_first_step(trainer, build_plain, first, label, rtol=1e-4, gtol=1e-3,
                    named=("matcher.self_Wqkv_w", "matcher.assign_proj_w"),
                    plain_ctx=contextlib.nullcontext):
    """A training configuration's first step on `first`: its total and two
    gradients (`named`) against the plain path's (`build_plain()`, e.g. a
    trainer with `matcher.flash: False`, run inside `plain_ctx()`) within
    `rtol` and `gtol` max|g| + 1e-7. Returns the account to log."""
    import torch

    def loss_and_grads(tr):
        params = dict(tr.model.named_parameters())
        losses, _ = tr.model.loss(tr.model(first), first)
        total = losses["total"].mean()
        return float(total.detach()), torch.autograd.grad(total, [params[k] for k in named])

    total, grads = loss_and_grads(trainer)
    plain = build_plain()
    with plain_ctx():
        ref_total, ref_grads = loss_and_grads(plain)
    del plain
    torch.cuda.empty_cache()
    if not abs(total - ref_total) <= rtol * abs(ref_total):
        fail(f"{label}: first total {total} against the plain path's {ref_total} (rtol {rtol:g})")
    worst = []
    for key, g, r in zip(named, grads, ref_grads):
        diff, top = float((g - r).abs().max()), float(r.abs().max())
        if not (top > 0 and diff <= gtol * top + 1e-7):
            fail(f"{label}: gradient of {key} {diff:.3g} from the plain path's "
                 f"(max |g| {top:.3g}; bar {gtol:g} max|g|)")
        worst.append(f"{key} {diff:.3g} (max |g| {top:.3g}, {diff / top:.3g} of it)")
    return (f"first total {total:.6f}, plain path {ref_total:.6f} (rel "
            f"{abs(total - ref_total) / abs(ref_total):.3g}, bar {rtol:g}); gradients "
            + "; ".join(worst) + f" (bar {gtol:g} max|g| + 1e-7)")


def check_mp_training(work):
    """Phase 11a: the first step against the plain path, then the trainer's
    epoch with launches counted a step, a validation and the benchmark;
    returns (ms a step alone, ms a step with the loader, peak MiB, loader
    pairs/s, benchmark summaries)."""
    import statistics

    import torch

    import gluefactory_tpu_torch.eval as gf_eval
    from gluefactory_tpu_torch.datasets.mp_image_pairs import MPImagePairs
    from gluefactory_tpu_torch.train import trainer as tmod
    from gluefactory_tpu_torch.utils import experiments as exps
    from gluefactory_tpu_torch.utils.config import merge
    from gluefactory_tpu_torch.utils.tensor import batch_to_device
    from gluefactory_tpu_torch.weights import load_hermetic

    exps.TRAINING_PATH = work
    exps.save_experiment("mp_init", {"model": load_hermetic(device="cpu")}, {}, 0, 0,
                         is_best=True)
    conf = mp_train_conf("mp_init")

    def build(flash, name):
        tr = tmod.Trainer(merge(conf, {"model": {"matcher": {"flash": flash}}}), name,
                          exps.experiment_dir(name), device="cuda")
        tr.build()
        return tr

    trainer = build(True, "mp")
    mconf, econf = trainer.model.matcher.conf, trainer.model.extractor.conf
    if (mconf.n_layers, mconf.descriptor_dim, mconf.mp, mconf.checkpointed) != (9, D, False, True):
        fail("MP training: LightGlue is not 9 x 256, fp32, checkpointed")
    loader = trainer.dataset.get_data_loader("train", epoch=0)
    first = batch_to_device(next(loader), "cuda")
    del loader
    if tuple(first["view0"]["image"].shape) != (TRAIN_B, 256, 320, 1):
        fail(f"MP training: a batch of {tuple(first['view0']['image'].shape)} images")
    optical = (first["view0"]["is_optical"], first["view1"]["is_optical"])
    if not (bool(optical[0].all()) and not bool(optical[1].any())):
        fail("MP training: view0 is not optical or view1 not thermal")
    held = hold_first_step(trainer, lambda: build(False, "mp_plain"), first, "MP training")
    log(f"[mp train] {TRAIN_B} pairs x {econf.max_num_keypoints} keypoints at 256 x 320: "
        + held)

    benches = []
    saved = gf_eval.run_benchmark

    def counted_benchmark(*a, **k):
        torch.cuda.synchronize()
        reset_entry_counts()
        t0 = time.perf_counter()
        summaries, figures = saved(*a, **k)
        torch.cuda.synchronize()
        benches.append((entry_counts(), summaries, time.perf_counter() - t0))
        return summaries, figures

    steps, evals, restore = timed_trainer(trainer)
    gf_eval.run_benchmark = counted_benchmark
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        trainer.train()
        t_run = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        gf_eval.run_benchmark = saved
        restore()
    per_step = {"K5": 18, "K6b": 18, "K6a": 0, "K7b self": 9, "K7b cross": 18,
                "K1": 0, "K2": 0, "K4": 0}
    if len(steps) != MP_STEPS:
        fail(f"MP training: {len(steps)} steps, expected {MP_STEPS}")
    for i, (_, _, counts, losses) in enumerate(steps):
        if counts != per_step:
            fail(f"MP training, step {i}: launches {counts}, expected {per_step}")
        if not all(math.isfinite(v) for v in losses.values()) or losses["skipped_nonfinite"]:
            fail(f"MP training, step {i}: {losses}")
    if len(evals) != 1 or not math.isfinite(evals[0][1]["loss/total"]):
        fail(f"MP training: {len(evals)} validations, expected one with a finite loss")
    counts = evals[0][0]
    if (counts["K5"], counts["K6b"], counts["K7b self"], counts["K7b cross"]) != (9, 9, 0, 0):
        fail(f"MP training, validation: launches {counts}, expected 9 K5 + 9 K6b")
    want = {"K1": 9 * MP_TEST_PAIRS, "K2": 9 * MP_TEST_PAIRS, "K4": MP_TEST_PAIRS}
    if len(benches) != 1:
        fail(f"MP training: {len(benches)} benchmark runs, expected one (a failed one only logs)")
    bcounts, bsum, bench_s = benches[0]
    if {k: bcounts[k] for k in want} != want or bcounts["K5"] or bcounts["K7b self"]:
        fail(f"MP training, benchmark: launches {bcounts}, expected {want} and no training kernel")
    bad = [k for k in MP_FINITE if not math.isfinite(bsum[k])]
    if bad:
        fail(f"MP training, benchmark: non-finite summaries {bad}")
    # a step with the loader: from one step's start to the next's, inside train()
    with_loader = [b[0] - a[0] for a, b in zip(steps, steps[1:])]
    step_only = [z - a for a, z, _, _ in steps]
    # the loader alone, a fresh epoch of the configuration's loader
    ds = MPImagePairs(conf["data"])
    t0 = time.perf_counter()
    n = sum(batch["view0"]["image"].shape[0] for batch in ds.get_data_loader("train", epoch=1))
    pps = n / (time.perf_counter() - t0)
    med = lambda xs: statistics.median(xs) * 1e3
    log(f"[mp train] {MP_STEPS} steps + validation + MP benchmark in {t_run:.2f} s; launches a "
        f"step {per_step}, the validation {counts['K5']} K5 + {counts['K6b']} K6b, the benchmark "
        f"{ {k: bcounts[k] for k in want} } ({bench_s:.2f} s); losses total "
        + " ".join(f"{x[3]['total']:.4f}" for x in steps)
        + f"; val loss/total {evals[0][1]['loss/total']:.4f}")
    log(f"[mp train] ms a step alone {med(step_only):.2f} (median of {len(step_only)}); with the "
        f"loader {med(with_loader):.2f} (median of {len(with_loader)}, step start to step start "
        f"in train()); the loader alone {pps:.2f} pairs/s ({n} pairs, "
        f"{conf['data'].get('num_workers', 0)} workers, {TRAIN_B / pps * 1e3:.0f} ms a batch); "
        f"peak {peak:.0f} MiB")
    del trainer, first
    torch.cuda.empty_cache()
    return med(step_only), med(with_loader), peak, pps, bsum


def mp_checkpoint(work, name):
    """An .npz checkpoint for the MP command line: the extractor's seeded
    initialisation (torch.manual_seed(0)) in the flax layout beside the
    committed LightGlue; None for SuperPoint-open (the committed file)."""
    import numpy as np
    import torch

    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.weights import HERMETIC, params_to_jax

    if name == "superpoint_open":
        return HERMETIC
    torch.manual_seed(0)
    conf = MP_EXTRACTORS[name]
    ext = get_model(conf["name"])(conf, device="cpu")
    tree = params_to_jax({f"extractor.{k}": v for k, v in ext.state_dict().items()})
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}")
            else:
                flat[f"{path}/{k}"[1:]] = v

    walk(tree, "")
    with np.load(str(HERMETIC)) as f:
        flat.update({k: f[k] for k in f.files if "/matcher/" in k})
    path = work / f"{name}_lightglue.npz"
    np.savez(path, **flat)
    return path


def run_mp_cli(work, name, plain=False):
    """`python -m gluefactory_tpu_torch.eval.MP` (its `main`) with the
    extractor `name` and LightGlue, RANSAC at 0.5 px, K1, K2, K4 counted;
    returns (summaries, timings, counts, predictions)."""
    import torch

    from gluefactory_tpu_torch.eval import MP
    from gluefactory_tpu_torch.utils.export_predictions import load_predictions

    runs = []
    run = MP.MPPipeline.run

    def recorded(self, *a, **k):
        runs.append(self)
        return run(self, *a, **k)

    tag = f"{name}_plain" if plain else name
    argv = ["--checkpoint", str(mp_checkpoint(work, name)), "--tag", tag, "eval.ransac_th=0.5",
            "model.extractor=" + json.dumps(MP_EXTRACTORS[name]),
            "model.matcher=" + json.dumps(MP_LIGHTGLUE)]
    MP.EVAL_PATH, MP.MPPipeline.run = work, recorded
    try:
        torch.cuda.synchronize()
        for fn in hpatches_counters()[1:]:
            fn.launches = 0
        with plain_path() if plain else contextlib.nullcontext():
            summaries = MP.main(argv)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in hpatches_counters()[1:]]
    finally:
        MP.MPPipeline.run = run
    return summaries, runs[0].timings, counts, load_predictions(work / "MP" / tag /
                                                                "predictions.npz")


def mp_test_batch():
    """The first pair of the MP test split on the card; logs the pairs/s of
    the split's loader alone (one pass, the dataset built included, as the
    export runs it)."""
    from gluefactory_tpu_torch.eval.MP import MPPipeline
    from gluefactory_tpu_torch.utils.tensor import batch_to_device

    t0 = time.perf_counter()
    batches = list(MPPipeline(device="cuda").get_dataloader())
    pps = len(batches) / (time.perf_counter() - t0)
    log(f"[mp loader] the export's loader alone: {pps:.2f} pairs/s ({len(batches)} pairs)")
    return batch_to_device(batches[0], "cuda")


def check_mp_routing(batch):
    """MultiPoint on the first MP test pair on the card: the thermal view
    goes through the thermal encoder, also inside the stacked extraction of
    both views (the eval's batch of one pair)."""
    import torch

    from gluefactory_tpu_torch.models import get_model

    torch.manual_seed(0)
    pipe = get_model("two_view_pipeline")({"extractor": MP_EXTRACTORS["multipoint"]},
                                          device="cuda").eval()
    ext = pipe.extractor
    with torch.no_grad():
        stacked = pipe(batch)["logits1"]
        img = batch["view1"]["image"].permute(0, 3, 1, 2)
        thermal = ext.detector_head(ext.encoder_thermal(img, False), False).permute(0, 2, 3, 1)
        optical = ext.detector_head(ext.encoder_optical(img, False), False).permute(0, 2, 3, 1)
    if not pipe._can_batch_extract(batch):
        fail("MP routing: the eval batch is not extracted in one call")
    d_thermal = float((stacked - thermal).abs().max())
    d_optical = float((stacked - optical).abs().max())
    log(f"[mp routing] MultiPoint, view1 in the stacked call: {d_thermal:.2e} from the thermal "
        f"encoder alone, {d_optical:.2e} from the optical one; is_optical "
        f"{batch['view0']['is_optical'].tolist()} / {batch['view1']['is_optical'].tolist()}")
    if not (d_thermal <= 1e-4 and d_optical > 1e-3):
        fail("MP routing: the thermal view did not go through the thermal encoder")


def hold_mp_assignment(work, name, batch):
    """LightGlue's log assignment on the first MP test pair, the kernels
    against the plain path, with the CLI's extractor and weights. It is dense,
    so it holds K1, K2 and K4 also where seeded extractors give no match."""
    import torch

    from gluefactory_tpu_torch.eval.export_helper import load_model

    conf = {"name": "two_view_pipeline", "extractor": MP_EXTRACTORS[name],
            "matcher": MP_LIGHTGLUE}
    pipe = load_model(conf, mp_checkpoint(work, name), "cuda")
    with torch.no_grad():
        out = pipe(batch)["log_assignment"]
        with plain_path():
            ref = pipe(batch)["log_assignment"]
    finite = torch.isfinite(ref)
    if not bool((torch.isfinite(out) == finite).all()) or not bool(finite.any()):
        fail(f"MP {name}: the log assignment's finite entries differ from the plain path's")
    diff = (out - ref)[finite].abs()
    err = float(diff.max())
    excess = float((diff - 1e-4 * ref[finite].abs()).max())
    rows = (out[:, :-1].amax(-1) - ref[:, :-1].amax(-1)).abs().max()
    log(f"[mp {name}] log assignment {tuple(out.shape)} against the plain path: within "
        f"{err:.3g} (bar 1e-3 + 1e-4 |value|, {excess:.3g} above 1e-4 |value|), |values| up to "
        f"{float(ref[finite].abs().max()):.3g}, row maxima within {float(rows):.3g}")
    if not excess <= 1e-3:
        fail(f"MP {name}: log assignment {err:.3g} from the plain path (bar 1e-3 + 1e-4 |value|)")


def mp_forward_ms():
    """Forward ms of each extractor at b8, 256 x 320 (CUDA events)."""
    import torch

    from gluefactory_tpu_torch.models import get_model

    gen = torch.Generator(device="cuda").manual_seed(11)
    img = texture(gen, 8, 256, 320).permute(0, 2, 3, 1).contiguous()
    data = {"image": img, "is_optical": torch.tensor([True, False] * 4, device="cuda")}
    confs = {**MP_EXTRACTORS,
             "superpoint_open bf16": {**MP_EXTRACTORS["superpoint_open"], "dtype": "bfloat16"},
             "superpoint_magicleap": {"name": "superpoint_magicleap", "max_num_keypoints": 512,
                                      "detection_threshold": 0.0, "nms_radius": 3}}
    out = {}
    for name, conf in confs.items():
        torch.manual_seed(0)
        model = get_model(conf["name"])(conf, device="cuda").eval()
        with torch.no_grad():
            pred = model(data)
            if not all(torch_finite(pred[k]) for k in ("keypoints", "descriptors")):
                fail(f"MP forward {name}: non-finite outputs")
            out[name] = timed(lambda: model(data), 5)
        del model
    log("[mp forward] b8 at 256 x 320, 512 keypoints, fp32 unless said (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def run_mp_slice():
    """Phase 11: (a) LightGlue training on MP pairs with its MP benchmark;
    (b) the MP benchmark by its command line for SuperPoint-open, MultiPoint
    and XPoint (swin) feeding LightGlue, each against the plain path; the
    thermal routing; (c) the extractors' forwards."""
    import shutil

    t_phase = time.perf_counter()
    work = ROOT / "outputs" / "chip_smoke_mp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        check_mp_training(work)
        batch = mp_test_batch()
        check_mp_routing(batch)
        for name in MP_EXTRACTORS:
            s, t, counts, pred = run_mp_cli(work, name)
            want = [9 * MP_TEST_PAIRS, 9 * MP_TEST_PAIRS, MP_TEST_PAIRS]
            if counts != want:
                fail(f"MP {name}: launches K1, K2, K4 {counts}, expected {want}")
            _, _, plain_counts, ref = run_mp_cli(work, name, plain=True)
            if plain_counts != [0, 0, 0]:
                fail(f"MP {name}: the plain path launched {plain_counts}")
            eq = [(p["matches0"] == ref[k]["matches0"]).mean() for k, p in pred.items()]
            agree = float(sum(eq) / len(eq))
            # the scores of the matches both paths made (0 where neither matched)
            score_diff = max(float(abs(p["matching_scores0"] - ref[k]["matching_scores0"])[
                p["matches0"] == ref[k]["matches0"]].max()) for k, p in pred.items())
            bad = [k for k in MP_FINITE if not math.isfinite(s[k])]
            if agree < 0.99 or score_diff > 1e-3 or bad or len(pred) != MP_TEST_PAIRS:
                fail(f"MP {name}: matches0 equal to the plain path on {agree:.4f} (bar 0.99), "
                     f"their scores {score_diff:.3g} apart (bar 1e-3), non-finite summaries "
                     f"{bad}, {len(pred)} pairs")
            keys = ("H_error_dlt@1px", "H_error_dlt@3px", "H_error_dlt@5px", "H_error_ransac@1px",
                    "H_error_ransac@3px", "H_error_ransac@5px", "mprec@3px", "mnum_matches")
            log(f"[mp {name}] export {MP_TEST_PAIRS / t['export_s']:.2f} pairs/s "
                f"({t['export_s']:.2f} s), eval phase {t['eval_s']:.2f} s; launches K1 "
                f"{counts[0]}, K2 {counts[1]}, K4 {counts[2]}; matches0 equal to the plain path "
                f"on {agree:.4f}, their scores within {score_diff:.3g}; "
                + ", ".join(f"{k} {s[k]:.4f}" for k in keys)
                + f", mH_error_dlt {s['mH_error_dlt']}, mH_error_ransac {s['mH_error_ransac']}")
            hold_mp_assignment(work, name, batch)
        mp_forward_ms()
        log(f"[mp] phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ----------------------------------------------------------------- phase 12
S1_CONF = "superpoint-open_synthetic_pretrain"  # stage 1: the detector on SyntheticShapes
S2_CONF = "superpoint-open-trained+lightglue_homography"  # stage 2: LightGlue on top
S1_EPOCHS, S1_STEPS, S1_VAL = 2, 4, 16  # epochs of steps of the configuration's 8 pairs
# the heads' last BatchNorm scales, held card against CPU at 1e-3 max|g|; the trunk's first
# conv and the detector's 3 x 3 conv, whose fp32 gradients are 0.3-2.5% of max|g| off
# float64 on either device (sums over 1.2M positions through batch-mode BatchNorms), held
# against float64 on the card; every one's distance to float64 is printed
S1_GRADS = ("blocks.9.bn_scale", "blocks.11.bn_scale")
S1_TRUNK = ("blocks.0.conv.weight", "blocks.10.conv.weight")
S2_B, S2_N, S2_STEPS = 8, 384, 3  # stage 2's pairs a step, keypoints, steps run here
S2_EXTRACTOR = {"name": "superpoint_open", "max_num_keypoints": S2_N,
                "detection_threshold": 0.005, "dtype": None}


def stage1_conf():
    """Stage 1 at its width (8 pairs of 240 x 320 rendered at 480 x 640, the
    full SuperPoint-open in fp32 with batch-mode BatchNorm), cut to
    S1_EPOCHS epochs of S1_STEPS steps, a validation of S1_VAL pairs and a
    checkpoint at each epoch's end."""
    from gluefactory_tpu_torch.utils.config import load_conf, merge

    conf = load_conf(S1_CONF)
    b = conf["data"]["train_batch_size"]
    return merge(conf, {"data": {"length": S1_STEPS * b, "val_length": S1_VAL},
                        "train": {"epochs": S1_EPOCHS, "log_every_iter": 1}})


def stage2_conf(flash=True):
    """Stage 2 at its width (8 pairs of 480 x 368 patches, 384 keypoints,
    LightGlue 9 x 256 fp32 checkpointed, the extractor grafted from stage 1
    by `train.load_experiment`), cut to S2_STEPS steps, one validation of 8
    pairs and a pool of 64 synthetic textures."""
    from gluefactory_tpu_torch.utils.config import load_conf, merge

    return merge(load_conf(S2_CONF), {
        "data": {"train_size": S2_STEPS * S2_B, "val_size": S2_B,
                 "synthetic": {"pool": 64}},
        "model": {"matcher": {"flash": flash}},
        "train": {"epochs": 1, "log_every_iter": 1}})


def check_stage1(work):
    """Phase 12a: stage 1's first step on the card against the port's CPU
    run on the same batch and weights, the epochs through `Trainer.train()`,
    then the non-finite veto and a validation, each leaving the parameters
    and running statistics bit for bit. Returns (ms a step alone, with the
    loader, loader pairs/s, peak MiB)."""
    import statistics

    import torch

    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.train import trainer as tmod
    from gluefactory_tpu_torch.utils import experiments as exps
    from gluefactory_tpu_torch.utils.tensor import batch_to_device

    conf = stage1_conf()
    trainer = tmod.Trainer(conf, "sp_open_synth", exps.experiment_dir("sp_open_synth"),
                           device="cuda")
    trainer.build()
    model = trainer.model
    mc = model.conf
    if (list(mc.channels), mc.descriptor_dim, mc.dtype, mc.is_training) != (
            [64, 64, 128, 128, 256], 256, None, True):
        fail(f"stage 1: the extractor is not SuperPoint-open at its width in fp32 training ({mc})")
    first = next(iter(trainer.dataset.get_data_loader("train", epoch=0)))
    if first["image"].shape != first["image2"].shape or first["image"].shape != (8, 240, 320, 1):
        fail(f"stage 1: a batch of {first['image'].shape} / {first['image2'].shape} images")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    stats = [k for k in init if k.endswith(("bn_mean", "bn_var"))]

    def first_step(m, batch):
        params = dict(m.named_parameters())
        losses, _ = m.loss(m(batch), batch)
        grads = torch.autograd.grad(losses["total"].mean(),
                                    [params[k] for k in S1_GRADS + S1_TRUNK])
        state = m.state_dict()
        return ({k: float(v.detach().double().mean()) for k, v in losses.items()},
                [g.double().cpu() for g in grads], {k: state[k].cpu() for k in stats})

    def copy_on(device, dtype=torch.float32):
        m = get_model("superpoint_open")(conf["model"], device=device)
        m.load_state_dict({k: v.to(device) for k, v in init.items()})
        return m.to(dtype)

    t0 = time.perf_counter()
    card = first_step(model, batch_to_device(first, "cuda"))
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = first_step(copy_on("cpu"), batch_to_device(first, "cpu"))
    t_host = time.perf_counter() - t0
    exact = first_step(copy_on("cuda", torch.float64), {
        k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
        for k, v in batch_to_device(first, "cuda").items()})
    model.load_state_dict(init)  # the comparison's forward moved the running statistics
    bad = [k for k in ("detector_loss", "detector_loss2", "descriptor_loss", "total")
           if not (math.isfinite(card[0][k]) and abs(card[0][k] - host[0][k])
                   <= 1e-4 * abs(host[0][k]))]
    if bad:
        fail(f"stage 1: first-step losses {bad} off the CPU run's (rtol 1e-4): card {card[0]}, "
             f"CPU {host[0]}")
    worst = []
    for key, g, r, x in zip(S1_GRADS, card[1], host[1], exact[1]):
        diff, top = float((g - r).abs().max()), float(r.abs().max())
        if not (top > 0 and diff <= 1e-3 * top):
            fail(f"stage 1: gradient of {key} {diff:.3g} from the CPU run's (max |g| {top:.3g})")
        worst.append(f"{key} {diff:.3g} (max |g| {top:.3g}; off float64: card "
                     f"{float((g - x).abs().max()) / top:.3g}, CPU "
                     f"{float((r - x).abs().max()) / top:.3g} of max|g|)")
    n = len(S1_GRADS)
    for key, g, h, r in zip(S1_TRUNK, card[1][n:], host[1][n:], exact[1][n:]):
        top = float(r.abs().max())
        e_card, e_host = float((g - r).abs().max()) / top, float((h - r).abs().max()) / top
        if not e_card <= 0.05:
            fail(f"stage 1: gradient of {key} {e_card:.3g} max|g| off float64 on the card")
        worst.append(f"{key} off float64: card {e_card:.3g}, CPU {e_host:.3g} of max|g| "
                     f"{top:.3g} (bar 0.05 on the card)")
    stat_err = max(float((card[2][k] - host[2][k]).abs().max()) for k in stats)
    if not stat_err <= 1e-5:
        fail(f"stage 1: running statistics after the step {stat_err:.3g} off the CPU run's")
    log(f"[stage1] first step on 8 pairs at 240 x 320 against the CPU run: "
        + ", ".join(f"{k} {card[0][k]:.6f} / {host[0][k]:.6f}"
                    for k in ("detector_loss", "detector_loss2", "descriptor_loss", "total"))
        + f" (rtol 1e-4; float64 total {exact[0]['total']:.6f}); gradients "
        + "; ".join(worst) + " (bar 1e-3 max|g| against the CPU); running "
        f"statistics within {stat_err:.3g} (bar 1e-5); card {t_card:.2f} s, CPU {t_host:.2f} s "
        "(first call, compile and allocation included)")

    steps, evals, restore = timed_trainer(trainer)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        trainer.train()
        t_run = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        restore()
    if len(steps) != S1_EPOCHS * S1_STEPS or len(evals) != S1_EPOCHS:
        fail(f"stage 1: {len(steps)} steps and {len(evals)} validations, expected "
             f"{S1_EPOCHS * S1_STEPS} and {S1_EPOCHS}")
    for i, (_, _, counts, losses) in enumerate(steps):
        if not all(math.isfinite(v) for v in losses.values()) or losses["skipped_nonfinite"]:
            fail(f"stage 1, step {i}: {losses}")
        if any(counts.values()):
            fail(f"stage 1, step {i}: a LightGlue kernel launched {counts}")
    if not all(math.isfinite(r["loss/total"]) for _, r in evals):
        fail(f"stage 1: validation losses {[r['loss/total'] for _, r in evals]}")

    # the veto and a validation leave the parameters and running statistics
    trainer.writer = None  # closed at the end of train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    nan_batch = batch_to_device(first, "cuda")
    nan_batch["image"][0, 10, 10, 0] = float("nan")
    count = trainer.state.optimizer.count
    trainer.state, out = trainer.train_step(trainer.state, nan_batch)
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    if float(out["skipped_nonfinite"]) != 1.0 or moved or trainer.state.optimizer.count != count:
        fail(f"stage 1 veto: skipped {float(out['skipped_nonfinite'])}, moved {moved[:4]}")
    results = trainer.do_evaluation(S1_EPOCHS, trainer.state.step)
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    if moved or not math.isfinite(results["loss/total"]):
        fail(f"stage 1 validation: moved {moved[:4]}, loss {results['loss/total']}")

    with_loader = [b[0] - a[0] for i, (a, b) in enumerate(zip(steps, steps[1:]))
                   if (i + 1) % S1_STEPS]  # within an epoch: no validation in between
    step_only = [z - a for a, z, _, _ in steps]
    t0 = time.perf_counter()
    n = sum(b["image"].shape[0] for b in trainer.dataset.get_data_loader("train", epoch=S1_EPOCHS))
    pps = n / (time.perf_counter() - t0)
    med = lambda xs: statistics.median(xs) * 1e3
    log(f"[stage1] {len(steps)} steps + {len(evals)} validations of {S1_VAL} pairs + checkpoints "
        f"in {t_run:.2f} s; losses total " + " ".join(f"{x[3]['total']:.4f}" for x in steps)
        + "; val loss/total " + " ".join(f"{r['loss/total']:.4f}" for _, r in evals)
        + "; the veto and a validation left the parameters and running statistics bit for bit")
    log(f"[stage1] ms a step alone {med(step_only):.2f} (median of {len(step_only)}); with the "
        f"loader {med(with_loader):.2f} (median of {len(with_loader)}); the loader alone "
        f"{pps:.2f} pairs/s ({n} pairs, {conf['data']['num_workers']} workers); peak {peak:.0f} MiB")
    del trainer, model
    torch.cuda.empty_cache()
    return med(step_only), med(with_loader), pps, peak


def check_stage2():
    """Phase 12b: stage 2 with stage 1's best checkpoint grafted into its
    extractor, the first step against the plain path, then S2_STEPS steps
    and a validation through `Trainer.train()`. Returns (launches a step,
    ms a step, peak MiB)."""
    import statistics

    import torch

    from gluefactory_tpu_torch.train import trainer as tmod
    from gluefactory_tpu_torch.utils import experiments as exps
    from gluefactory_tpu_torch.utils.tensor import batch_to_device

    def build(flash, name):
        tr = tmod.Trainer(stage2_conf(flash), name, exps.experiment_dir(name), device="cuda")
        tr.build()
        return tr

    trainer = build(True, "sp_open_lg")
    mconf, econf = trainer.model.matcher.conf, trainer.model.extractor.conf
    if (mconf.n_layers, mconf.descriptor_dim, mconf.mp, mconf.checkpointed,
            econf.max_num_keypoints) != (9, D, False, True, S2_N):
        fail("stage 2: LightGlue is not 9 x 256, fp32, checkpointed, or not 384 keypoints")
    best, _ = exps.load_checkpoint(exps.get_best_checkpoint("sp_open_synth"), device="cuda")
    own = trainer.model.extractor.state_dict()
    if set(own) != set(best["model"]) or any(not torch.equal(own[k], v)
                                             for k, v in best["model"].items()):
        fail("stage 2: the grafted extractor is not stage 1's best checkpoint bit for bit")
    loader = trainer.dataset.get_data_loader("train", epoch=0)
    first = batch_to_device(next(iter(loader)), "cuda")
    del loader
    held = hold_first_step(trainer, lambda: build(False, "sp_open_lg_plain"), first, "stage 2")
    log(f"[stage2] {len(own)} extractor tensors grafted from stage 1 bit for bit; batch "
        f"{tuple(first['view0']['image'].shape)}, {S2_N} keypoints: " + held)

    steps, evals, restore = timed_trainer(trainer)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        trainer.train()
        t_run = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        restore()
    per_step = {"K5": 18, "K6b": 18, "K6a": 0, "K7b self": 9, "K7b cross": 18,
                "K1": 0, "K2": 0, "K4": 0}
    if len(steps) != S2_STEPS or len(evals) != 1:
        fail(f"stage 2: {len(steps)} steps and {len(evals)} validations")
    for i, (_, _, counts, losses) in enumerate(steps):
        if counts != per_step:
            fail(f"stage 2, step {i}: launches {counts}, expected {per_step}")
        if not all(math.isfinite(v) for v in losses.values()) or losses["skipped_nonfinite"]:
            fail(f"stage 2, step {i}: {losses}")
    counts = evals[0][0]
    if (counts["K5"], counts["K6b"], counts["K7b self"], counts["K7b cross"]) != (9, 9, 0, 0) \
            or not math.isfinite(evals[0][1]["loss/total"]):
        fail(f"stage 2, validation: launches {counts}, results {evals[0][1]}")
    ms = statistics.median(z - a for a, z, _, _ in steps) * 1e3
    log(f"[stage2] {S2_STEPS} steps + validation in {t_run:.2f} s; launches a step {per_step}, "
        f"the validation 9 K5 + 9 K6b; losses total "
        + " ".join(f"{x[3]['total']:.4f}" for x in steps)
        + f"; val loss/total {evals[0][1]['loss/total']:.4f}; ms a step {ms:.2f} (median of "
        f"{len(steps)}); peak {peak:.0f} MiB")
    del trainer, first
    torch.cuda.empty_cache()
    return per_step, ms, peak


def check_stage3(work):
    """Phase 12c: the HPatches benchmark on phase 8's 50-pair tree with stage
    2's checkpoint (its experiment), fp32: K1 = K2 = 9 and K4 = 1 launches a
    pair, finite summaries, keypoints on every pair."""
    from gluefactory_tpu_torch.utils.export_predictions import load_predictions

    data = work / "data" / "hpatches-sequences-release"
    build_hpatches_tree(data)
    n = len(HP_SCENES) * 5
    # a pair without a match has no homography and an infinite error, so the
    # medians are finite only once LightGlue matches (three steps from its
    # seeded start need not): every other summary must be
    finite = [k for k in HP_SUMMARIES if not k.startswith("mH_error")]
    summaries, pipe, counts = run_hpatches(data, work, "stage3", HP_LIGHTGLUE, S2_EXTRACTOR,
                                           checkpoint="sp_open_lg", finite=finite)
    if set(summaries) != set(HP_SUMMARIES):
        fail(f"stage 3: summaries {sorted(summaries)}")
    if counts != [0, 9 * n, 9 * n, n]:
        fail(f"stage 3: expected K1 = K2 = 9 and K4 = 1 launches a pair and no K8, got {counts}")
    pred = load_predictions(work / "stage3" / "predictions.npz")
    kpts = [min(int((p["keypoint_scores0"] > 0).sum()), int((p["keypoint_scores1"] > 0).sum()))
            for p in pred.values()]
    if len(kpts) != n or min(kpts) < 1:
        fail(f"stage 3: the trained detector leaves a pair without keypoints ({kpts})")
    log(f"[stage3] {n} pairs with the stage-2 checkpoint: keypoints a view min {min(kpts)}, "
        f"median {sorted(kpts)[n // 2]} (of {S2_N}); matches a pair {summaries['mnum_matches']}, "
        f"precision@3px {summaries['mprec@3px']:.4f}; H-AUC DLT "
        + ", ".join(f"{k} {summaries[k]:.4f}" for k in ("H_error_dlt@1px", "H_error_dlt@3px",
                                                           "H_error_dlt@5px"))
        + "; RANSAC " + ", ".join(f"{k} {summaries[k]:.4f}" for k in (
            "H_error_ransac@1px", "H_error_ransac@3px", "H_error_ransac@5px"))
        + " (no bar: a few steps of training)")
    return n / pipe.timings["export_s"], pipe.timings["eval_s"]


def run_hermetic_loop():
    """Phase 12: stage 1 -> stage 2 -> stage 3 of the hermetic quality loop;
    returns stage 2's launches a step under the N = 384 kernel rows' keys."""
    import shutil

    from gluefactory_tpu_torch.utils import experiments as exps

    t_phase = time.perf_counter()
    work = ROOT / "outputs" / "chip_smoke_hermetic"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    saved = exps.TRAINING_PATH
    exps.TRAINING_PATH = work
    try:
        s1_ms, s1_loader_ms, s1_pps, s1_peak = check_stage1(work)
        per_step, s2_ms, s2_peak = check_stage2()
        pps, eval_s = check_stage3(work)
        log(f"[hermetic] stage 1: ms a step {s1_ms:.2f} alone, {s1_loader_ms:.2f} with the "
            f"loader, loader {s1_pps:.2f} pairs/s, peak {s1_peak:.0f} MiB; stage 2: ms a step "
            f"{s2_ms:.2f}, peak {s2_peak:.0f} MiB; stage 3: export {pps:.2f} pairs/s, eval "
            f"{eval_s:.2f} s; phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        exps.TRAINING_PATH = saved
        shutil.rmtree(work, ignore_errors=True)
    return {f"{k} 384": v for k, v in per_step.items() if k in ("K5", "K6b", "K7b self",
                                                                  "K7b cross")}


# ----------------------------------------------------------------- phase 13
# twice the JAX package's own bf16-to-fp32 gap at this width on the CPU
# (scripts/torch_mp_gap.py: LightGlue 9 x 256 with the committed weights, 512
# keypoints): a pair's total up to 2.2e-3 relative, the two gradients held
# here up to 7.1% of their max|g|
MP_GAP = (4.4e-3, 0.142)
# the bf16 kernels against the bf16 plain path on the card: measured 2.7e-5
# relative and 0.39% / 1.65% of max|g| (H100 80GB HBM3, 700 W)
MP_PLAIN = (1e-4, 0.05)
SG_NAMED = ("matcher.gnn.0.q.weight", "matcher.final_proj.weight")
EXT_NAMED = ("extractor.blocks.0.conv.weight", "extractor.blocks.9.conv.weight")
DDP_STEPS = 2
# the parameters of two processes against one after DDP_STEPS steps at lr
# 1e-4: measured 2.0e-5 (3.2e-5 where a gradient is rounding noise). The JAX
# package's 1e-5 (tests/test_parallel.py:346) holds for its one-process run on
# the same two-device mesh; here the halves' sums differ from the whole's (the
# frozen extractor's cuDNN convolutions at batch 16 against 32 among them), and
# Adam's step, lr m / sqrt(v), turns a gradient's last bits into up to lr
# where the gradient is small (H100 80GB HBM3, 700 W)
DDP_ATOL = 5e-5


def train_conf(**over):
    """The homography training configuration at its width (512 keypoints,
    LightGlue 9 x 256 checkpointed) with `over` merged into its model."""
    from gluefactory_tpu_torch.utils.config import load_conf, merge

    return merge(load_conf(TRAIN_CONF), {"model": over})


def make_trainer(conf, device="cuda"):
    """A trainer of `conf` with the committed weights where they fit (the
    extractor, and LightGlue when it is the matcher)."""
    from gluefactory_tpu_torch.train.trainer import Trainer, graft_state
    from gluefactory_tpu_torch.weights import load_hermetic

    trainer = Trainer(conf, device=device)
    graft_state(trainer.model, load_hermetic(device=trainer.device))
    return trainer


def step_counts():
    """Launches of the training kernels: K5, K6b, K7b (self and cross form),
    and the per-head K7a and K7b."""
    from gluefactory_tpu_torch.ops import fused_attention as fa

    counts = read_train_counts()
    counts["K7a"] = fa.fused_attention.launches
    return counts


def reset_step_counts():
    from gluefactory_tpu_torch.ops import fused_attention as fa

    reset_train_counts()
    fa.fused_attention.launches = 0


def timed_steps(trainer, batches, steps):
    """`steps` steps on `batches` (cycled) after one warm-up: (ms a step by
    the host clock around synchronised steps, launches of the timed steps,
    peak MiB, the losses of every step)."""
    import torch

    history = trainer.train_steps(batches[:1], steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_step_counts()
    t0 = time.perf_counter()
    history += trainer.train_steps([batches[i % len(batches)] for i in range(steps)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = step_counts()
    for i, losses in enumerate(history):
        if not all(math.isfinite(v) for v in losses.values()) or losses["skipped_nonfinite"]:
            fail(f"step {i}: {losses}")
    return ms, counts, torch.cuda.max_memory_allocated() / 2**20, history


def profile_steps(trainer, batches, steps):
    """`steps` training steps on `batches` (cycled) under torch.profiler:
    the device time a step of every kernel, of the attention forwards (K5,
    K6b, K6a) and of K7b's kernels; None where the profiler records no
    kernel."""
    got = profiled(lambda: trainer.train_steps(
        [batches[i % len(batches)] for i in range(steps)]))
    if got is None:
        return None
    total = fwd = bwd = 0.0
    for e in got[1]:
        t = e.device_time_total / 1e3
        total += t
        fwd += t if any(k in e.name for k in ("attn_fwd_kernel", "cross_fwd_stacked_kernel",
                                              "cross_fwd_pair_kernel")) else 0.0
        bwd += t if "attn_bwd_" in e.name else 0.0
    return dict(device_ms=total / steps, fwd_ms=fwd / steps, bwd_ms=bwd / steps)


def expect_counts(counts, steps, label, **per_step):
    want = {k: 0 for k in counts}
    want.update({k.replace("_", " "): v * steps for k, v in per_step.items()})
    if counts != want:
        fail(f"{label}: expected {want} launches in {steps} steps, got {counts}")


def check_mp_step(batches, fp32_total):
    """Phase 13a: `matcher.mp: true` at the configuration's width."""
    import torch

    trainer = make_trainer(train_conf(matcher={"mp": True}))
    if not trainer.model.matcher.conf.mp:
        fail("mp training: the matcher is not in bf16")
    with torch.no_grad():
        dt = trainer.model(batches[0])["ref_descriptors0"].dtype
    if dt != torch.bfloat16:
        fail(f"mp training: the layers run in {dt}")
    first = hold_first_step(trainer, lambda: make_trainer(train_conf(
        matcher={"mp": True, "flash": False})), batches[0], "mp training", *MP_PLAIN)
    log(f"[train13a] against the bf16 plain path (flash: False) on the card: {first}")
    # against the fp32 step of phase 5 on the same batch (the kernels both)
    ref = make_trainer(train_conf())
    vs32 = hold_first_step(trainer, lambda: ref, batches[0], "mp against fp32", *MP_GAP)
    del ref
    log(f"[train13a] against the fp32 step (phase 5's configuration): {vs32} (bars: twice "
        "the JAX package's own bf16-to-fp32 gap)")
    ms, counts, peak, history = timed_steps(trainer, batches, 3)
    expect_counts(counts, 3, "mp training", K5=18, K6b=18, K7b_self=9, K7b_cross=18)
    log(f"[train13a] {ms:.2f} ms a step (phase 5 fp32: {fp32_total[0]:.2f}), peak {peak:.0f} "
        f"MiB (phase 5: {fp32_total[1]:.0f}); launches a step {counts['K5'] // 3} K5 + "
        f"{counts['K6b'] // 3} K6b + {(counts['K7b self'] + counts['K7b cross']) // 3} K7b, "
        "all bf16; losses total " + " ".join(f"{x['total']:.4f}" for x in history))
    prof = profile_steps(trainer, batches, 2)
    if prof is not None:
        log(f"[train13a] a step's kernels by device time (torch.profiler, 2 steps): "
            f"{prof['device_ms']:.2f} ms, of it the attention forwards {prof['fwd_ms']:.2f} "
            f"and K7b {prof['bwd_ms']:.2f}; device idle {1 - prof['device_ms'] / ms:.3f} of "
            "the timed step")
    per_step = {k: v // 3 for k, v in counts.items()}
    per_step["K6a"] = mn_step(trainer, batches[0], "train13a")  # bf16 K6a
    return per_step, ms, peak


def extractor_vjp(ext, views, kpts, g_desc, names):
    """Gradients of sum <g_desc, descriptors> over the extractor's `names`
    parameters, the descriptors sampled at the given keypoints (no
    selection), in the extractor's own dtype."""
    import torch

    from gluefactory_tpu_torch.models.extractors.superpoint_open import sample_descriptors

    params = dict(ext.named_parameters())
    total = 0
    for image, kp, g in zip(views, kpts, g_desc):
        _, dense = ext._heads(image.permute(0, 3, 1, 2).to(ext.blocks[0].conv.weight.dtype),
                              False)
        desc = sample_descriptors(kp - 0.5, dense.permute(0, 2, 3, 1), ext.stride)
        total = total + (desc.double() * g.double()).sum()
    return torch.autograd.grad(total, [params[k.split(".", 1)[1]] for k in names])


def check_trainable_extractor(batches):
    """Phase 13b: `extractor.trainable: true` at the configuration's width."""
    import torch

    from gluefactory_tpu_torch.models import get_model

    try:
        get_model("two_view_pipeline")(train_conf(extractor={
            "trainable": True, "fused_block0": True})["model"], device="cuda")
        fail("a trainable extractor with fused_block0: True did not raise")
    except ValueError as e:
        log(f"[train13b] fused_block0: True with a trainable extractor raises: {e}")

    # b2, fp32 extractor: its first and last conv gradients against float64
    trainer = make_trainer(train_conf(extractor={"trainable": True, "dtype": None}))
    model = trainer.model
    b2 = {v: ({k: t[:2] for k, t in batches[0][v].items()} if isinstance(batches[0][v], dict)
              else batches[0][v][:2]) for v in batches[0]}
    params = dict(model.named_parameters())
    pred = model(b2)
    losses, _ = model.loss(pred, b2)
    descs = [pred["descriptors0"], pred["descriptors1"]]
    *g_desc, g0, g9 = torch.autograd.grad(losses["total"].mean(),
                                          descs + [params[k] for k in EXT_NAMED])
    views = [b2["view0"]["image"], b2["view1"]["image"]]
    kpts = [pred["keypoints0"], pred["keypoints1"]]
    mine = extractor_vjp(model.extractor, views, kpts, g_desc, EXT_NAMED)
    exact_ext = get_model("superpoint_open")(
        {**model.extractor.conf, "trainable": True}, device="cuda").double()
    exact_ext.load_state_dict(model.extractor.state_dict())
    exact = extractor_vjp(exact_ext, [v.double() for v in views], kpts, g_desc, EXT_NAMED)
    del exact_ext
    worst = []
    for key, g, m, x in zip(EXT_NAMED, (g0, g9), mine, exact):
        top = float(x.abs().max())
        e_path = float((g.double() - m).abs().max()) / top
        e_exact = float((g.double() - x).abs().max()) / top
        if not (top > 0 and e_path <= 1e-4 and e_exact <= 0.05):
            fail(f"trainable extractor: gradient of {key}: {e_path:.3g} max|g| from the "
                 f"sampled-descriptor VJP (bar 1e-4), {e_exact:.3g} from float64 (bar 0.05)")
        worst.append(f"{key} {e_exact:.3g} of max|g| {top:.3g} off float64 (bar 0.05; the "
                     f"pipeline's against its own VJP {e_path:.3g})")
    log(f"[train13b] b2, fp32 extractor: " + "; ".join(worst))
    del trainer, model, pred, losses
    torch.cuda.empty_cache()

    trainer = make_trainer(train_conf(extractor={"trainable": True}))
    ext = trainer.model.extractor
    if not any(k.startswith("extractor.") for k in trainer.state.params) or \
            ext.conf.fused_block0 not in (False, "auto"):
        fail("trainable extractor: its parameters are not in the optimizer")
    before = {k: v.clone() for k, v in ext.state_dict().items()}
    ms, counts, peak, history = timed_steps(trainer, batches, 2)
    expect_counts(counts, 2, "trainable extractor", K5=18, K6b=18, K7b_self=9, K7b_cross=18)
    after = ext.state_dict()
    stats = [k for k in before if k.endswith(("bn_mean", "bn_var"))]
    moved = [k for k in before if k not in stats and torch.equal(before[k], after[k])
             and not k.startswith(("blocks.10.", "blocks.11."))]  # the detector head: no gradient
    if moved or any(not torch.equal(before[k], after[k]) for k in stats):
        fail(f"trainable extractor: unmoved parameters {moved[:4]} or moved statistics")
    log(f"[train13b] {ms:.2f} ms a step, peak {peak:.0f} MiB, extractor ({ext.conf.dtype}) "
        f"and matcher trained, running statistics unchanged; losses total "
        + " ".join(f"{x['total']:.4f}" for x in history))
    return ms, peak


def check_superglue_training(batches):
    """Phase 13c: SuperGlue (9 layer pairs, 256-D, 4 heads, 50 Sinkhorn
    iterations) as the trained matcher of the configuration."""
    import torch

    from gluefactory_tpu_torch.models.matchers import superglue as sgmod
    from gluefactory_tpu_torch.ops import attention as ops

    conf = train_conf(matcher={"name": "superglue", "is_training": True})
    trainer = make_trainer(conf)
    sg = trainer.model.matcher
    if (sg.conf.GNN_layers, sg.conf.descriptor_dim, sg.conf.num_heads,
            sg.conf.sinkhorn_iterations) != (9, D, H, 50):
        fail("SuperGlue training is not at 9 layer pairs x 256, 4 heads, 50 iterations")

    @contextlib.contextmanager
    def plain():
        saved = sgmod.masked_attention
        sgmod.masked_attention = lambda q, k_, v, mq, mk: ops.attention_heads(
            q, k_, v, mq, mk, q.shape[-1] ** -0.5).to(q.dtype)
        try:
            yield
        finally:
            sgmod.masked_attention = saved

    # the same model, its attention through the plain version
    first = hold_first_step(trainer, lambda: trainer, batches[0], "SuperGlue training",
                            named=SG_NAMED, plain_ctx=plain)
    log(f"[train13c] against the plain attention on the card: {first}")
    ms, counts, peak, history = timed_steps(trainer, batches[:1], 5)
    expect_counts(counts, 5, "SuperGlue training", K7a=36, K7b_self=36)
    totals = [x["total"] for x in history]
    if not totals[-1] < totals[0]:
        fail(f"SuperGlue training: the loss did not fall on one batch: {totals}")
    mask = torch.ones(TRAIN_B, TRAIN_N, dtype=torch.bool, device="cuda")
    scores = torch.randn(TRAIN_B, TRAIN_N, TRAIN_N, device="cuda", requires_grad=True)
    sink = timed(lambda: torch.autograd.grad(sgmod.log_optimal_transport(
        scores, sg.bin_score, 50, mask, mask).sum(), scores), 3)
    log(f"[train13c] {ms:.2f} ms a step, peak {peak:.0f} MiB; launches a step "
        f"{counts['K7a'] // 5} K7a + {counts['K7b self'] // 5} per-head K7b; Sinkhorn forward "
        f"+ backward {sink:.2f} ms ({sink / ms:.3f} of the step); losses total on one batch "
        + " ".join(f"{t:.4f}" for t in totals))
    return {"K7a train": counts["K7a"] // 5, "K7b heads": counts["K7b self"] // 5}, ms, sink


def ddp_run(batches, rank=0):
    """The homography configuration for DDP_STEPS steps on `batches`
    (global batches; this process takes its rank's slice), then the veto
    with rank 1's slice poisoned: (state, each step's reduced gradients, ms
    of the last step, all-reduce ms in it, the veto's losses, kept)."""
    import torch

    from gluefactory_tpu_torch.train import distributed, step as step_mod

    world = distributed.world_size()
    trainer = make_trainer(train_conf(), device="cuda:0")
    per = TRAIN_B // world
    mine = [{v: ({k: t[rank * per:(rank + 1) * per] for k, t in b[v].items()}
                 if isinstance(b[v], dict) else b[v][rank * per:(rank + 1) * per]) for v in b}
            for b in batches]
    opt, grads, reduce_ms = trainer.state.optimizer, {}, []
    update, reduce = opt.update, step_mod._all_reduce

    def record(gs):
        grads.update({f"{opt.count}/{k}": g.cpu() for k, g in zip(opt.names, gs)})
        update(gs)

    def timed_reduce(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(*args)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    opt.update, step_mod._all_reduce = record, timed_reduce
    try:
        history = []
        for batch in mine[:DDP_STEPS]:  # the last step is timed: the first loads, tunes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            history += trainer.train_steps([batch])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
        step_grads = dict(grads)  # the steps' own, not the veto's step below
        poisoned = mine[DDP_STEPS]
        if rank == 1:
            poisoned["view0"]["image"][0] = float("nan")
        before = [v.clone() for v in trainer.model.state_dict().values()]
        veto = trainer.train_steps([poisoned])[0]
        kept = all(torch.equal(a, z) for a, z in zip(before, trainer.model.state_dict().values()))
    finally:
        step_mod._all_reduce = reduce
    if any(x["skipped_nonfinite"] for x in history):
        fail(f"two processes, rank {rank}: a step was skipped: {history}")
    return state, step_grads, ms, reduce_ms[DDP_STEPS - 1] if reduce_ms else 0.0, veto, kept


def ddp_rank_main(rank, port, work):
    """One rank of phase 13d, started by `check_two_processes`."""
    import os

    import torch

    from gluefactory_tpu_torch.train import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    # one card: both ranks on cuda:0, so gloo, named (NCCL takes one rank a device)
    distributed.init_distributed("gloo", "cuda:0")
    try:
        batches = torch.load(Path(work) / "batches.pt", map_location="cuda:0")
        state, grads, ms, red, veto, kept = ddp_run(batches, rank)
        torch.save({"state": state, "grads": grads, "ms": ms, "reduce_ms": red,
                    "veto": veto, "kept": kept}, Path(work) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def check_two_processes(batches):
    """Phase 13d: the homography configuration on two processes on the one
    card (gloo), 16 pairs a rank, against one process at 32 on the same
    global batches: each step's reduced gradients within 1e-4 of max|g|, the
    parameters within DDP_ATOL; a NaN slice on rank 1 alone vetoes both
    ranks' step."""
    import shutil
    import socket

    import torch

    work = ROOT / "outputs" / "chip_smoke_ddp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.save([{v: ({k: t.cpu() for k, t in b[v].items()} if isinstance(b[v], dict)
                     else b[v].cpu()) for v in b} for b in batches], work / "batches.pt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--ddp-rank",
                               str(r), "--ddp-port", str(port), "--ddp-dir", str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        fail("two processes: a rank failed:\n" + "\n".join(o[-3000:] for o in outs))
    wall = time.perf_counter() - t0
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(2)]
    one, grads1, ms1, _, veto1, _ = ddp_run(batches)
    shutil.rmtree(work, ignore_errors=True)
    two, grads2 = ranks[0]["state"], ranks[0]["grads"]
    if any(not torch.equal(ranks[1]["state"][k], v) for k, v in two.items()):
        fail("two processes: the ranks' states differ")
    top = max(float(g.abs().max()) for g in grads1.values())
    gerr = max(float((grads2[k] - g).abs().max()) for k, g in grads1.items()) / top
    perr = max(float((two[k].double() - v.double()).abs().max()) for k, v in one.items())
    log(f"[train13d] two processes (gloo, one card, {TRAIN_B // 2} pairs a rank) against one "
        f"at {TRAIN_B}, {DDP_STEPS} steps: the reduced gradients within {gerr:.3g} of max|g| "
        f"(bar 1e-4), the parameters within {perr:.3g} (bar {DDP_ATOL:g})")
    if not (gerr <= 1e-4 and perr <= DDP_ATOL):
        fail("two processes disagree with one")
    vetos = [(r["veto"]["skipped_nonfinite"], r["kept"]) for r in ranks]
    if vetos != [(1.0, True), (1.0, True)] or veto1["skipped_nonfinite"] != 0.0:
        fail(f"two processes: a NaN slice on rank 1 gave (skipped, kept) {vetos}; one "
             f"process {veto1['skipped_nonfinite']}")
    ms2, red = ranks[0]["ms"], ranks[0]["reduce_ms"]
    log(f"[train13d] a NaN slice on rank 1 alone: both ranks skipped and kept their "
        f"parameters bit for bit; ms a step with the all-reduce {ms2:.2f} (two processes "
        f"sharing the card; one process at {TRAIN_B}: {ms1:.2f}), the all-reduce itself "
        f"{red:.2f} ms (gloo through the host); phase {wall:.1f} s for the ranks")
    return ms2, red


def run_training_paths(fp32_ms, fp32_peak):
    """Phase 13 on three batches of phase 5's shape; returns the launches a
    step of the rows it adds."""
    import torch

    t_phase = time.perf_counter()
    batches = [training_batch(40 + i, TRAIN_B, 480, 640) for i in range(3)]
    counts, mp_ms, mp_peak = check_mp_step(batches, (fp32_ms, fp32_peak))
    torch.cuda.empty_cache()
    ext_ms, ext_peak = check_trainable_extractor(batches)
    torch.cuda.empty_cache()
    sg_counts, sg_ms, sink_ms = check_superglue_training(batches)
    torch.cuda.empty_cache()
    ddp_ms, reduce_ms = check_two_processes(batches)
    log(f"[train13] ms a step at batch {TRAIN_B}: fp32 {fp32_ms:.2f} (phase 5), mp {mp_ms:.2f}, "
        f"trainable extractor {ext_ms:.2f} (peak {ext_peak:.0f} MiB), SuperGlue {sg_ms:.2f}, "
        f"two processes {ddp_ms:.2f} (all-reduce {reduce_ms:.2f}); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"K5 bf16": counts["K5"], "K6b bf16": counts["K6b"], "K6a bf16": counts["K6a"],
            "K7b self bf16": counts["K7b self"], "K7b cross bf16": counts["K7b cross"],
            **sg_counts}, mp_ms


# ----------------------------------------------------------------- phase 14
SIFT_CONF = "sift_tpu+lightglue_homography"  # LightGlue on sift_tpu, extracted per view
SIFT_B, SIFT_N, SIFT_WARM, SIFT_STEPS = 16, 384, 2, 5  # pairs, keypoints, warm-up, timed steps
SIFT_BAR_IMAGES = 4  # images of the first batch held card against CPU
CACHED_B, CACHED_N, CACHED_STEPS = 32, 512, 3  # sift+lightglue_homography's widths
# configs/sift+lightglue_homography.yaml of the JAX package, its host SIFT swapped for sift_tpu
CACHED_DATA = {"synthetic": {"do": True, "pool": 128}, "train_batch_size": CACHED_B,
               "val_batch_size": CACHED_B, "num_workers": 0,
               "homography": {"difficulty": 0.6, "translation": 0.8, "max_angle": 45,
                              "patch_shape": [640, 480]},
               "photometric": {"name": "lg", "p": 0.75},
               "features": {"do": True, "name": "sift_tpu", "max_num_keypoints": CACHED_N}}
EXT_B, EXT_N = 8, 1024  # the HPatches override of aliked+NN / disk+NN, at 480 x 640
EXTRACTORS = {  # seeded weights: the repository holds no official ones
    "aliked": {"name": "aliked", "model_name": "aliked-n16", "max_num_keypoints": EXT_N,
               "detection_threshold": 0.0},
    "disk": {"name": "disk", "max_num_keypoints": EXT_N, "detection_threshold": 0.0},
    "disk_official": {"name": "disk_official", "max_num_keypoints": EXT_N},
}
ALIKED_CONF, ALIKED_STEPS = "aliked+lightglue_homography", 3
KP_TOL = 1e-4  # px (and scale): a keypoint of the card identical to the CPU's
RAW_FLOOR = 1e-4  # the squared value above which RootSIFT's raw bins are held
# the training step's launches at m == n (stage 2's and the sift_tpu recipe's)
STEP_COUNTS = {"K5": 18, "K6b": 18, "K6a": 0, "K7b self": 9, "K7b cross": 18,
               "K1": 0, "K2": 0, "K4": 0}


def hold_extractor(ext, images, label):
    """`ext` on the card against the port's CPU run of the same model and
    weights on `images`: at least 99% of each image's valid keypoints
    identical (within KP_TOL in x, y and, where given, the scale), and on
    those the descriptors within 1e-4; for RootSIFT its input (the squared
    descriptor) within 1e-5, its square root not being Lipschitz at 0, and
    the raw descriptors within 1e-4 on the bins whose square exceeds
    RAW_FLOOR (the largest raw difference over all bins is printed).
    Returns the account."""
    import torch

    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.utils.config import to_dict

    cpu = get_model(ext.conf.name)(to_dict(ext.conf), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in ext.state_dict().items()})
    with torch.no_grad():
        out = {k: v.cpu() for k, v in ext({"image": images}).items()}
        ref = cpu({"image": images.cpu()})
    rootsift = bool(ext.conf.get("rootsift", False))
    shares, kp_err, d_err, d_raw, d_full, n_valid = [], 0.0, 0.0, 0.0, 0.0, 0
    for b in range(images.shape[0]):
        key = lambda p: torch.cat([p["keypoints"][b]] + (
            [p["scales"][b][:, None]] if "scales" in p else []), -1)
        valid = ref["keypoint_mask"][b].nonzero()[:, 0]
        r, o = key(ref)[valid], key(out)
        d = (r[:, None] - o[None]).abs().amax(-1) + (~out["keypoint_mask"][b]).float()[None] * 1e9
        dist, j = d.min(1)
        ok = dist < KP_TOL
        shares.append(float(ok.float().mean()))
        n_valid += len(valid)
        i, j = valid[ok], j[ok]
        dr, do = ref["descriptors"][b][i], out["descriptors"][b][j]
        kp_err = max(kp_err, float(dist[ok].max()) if bool(ok.any()) else 0.0)
        d_raw = max(d_raw, float((do - dr).abs().max()))
        full = dr**2 > RAW_FLOOR
        if bool(full.any()):
            d_full = max(d_full, float((do - dr)[full].abs().max()))
        d_err = max(d_err, float((do**2 - dr**2).abs().max()) if rootsift
                    else float((do - dr).abs().max()))
    bar = 1e-5 if rootsift else 1e-4
    what = "squared descriptors (RootSIFT's input)" if rootsift else "descriptors"
    account = (f"{n_valid} valid keypoints on {images.shape[0]} image(s), shared with the CPU "
               f"{min(shares):.4f} (worst image; bar 0.99, within {KP_TOL:g}; largest "
               f"difference {kp_err:.3g}), {what} within {d_err:.3g} (bar {bar:g}; raw "
               f"descriptors {d_raw:.3g}")
    if rootsift:
        account += f", {d_full:.3g} on the bins whose square exceeds {RAW_FLOOR:g}, bar 1e-4)"
    else:
        account += ")"
    if min(shares) < 0.99 or d_err > bar or n_valid == 0 or (rootsift and d_full > 1e-4):
        fail(f"{label}: the card against the CPU: {account}")
    return account


def split_text(split):
    ms, launches, top = split
    if launches is None:
        return f"{ms:.2f} ms by CUDA events a call (launches and split not measured)"
    return (f"{launches:.0f} launches, {ms:.2f} ms of device time a call (" +
            "; ".join(f"{name} {t:.2f}" for name, t in top) + ")")


def extraction_events(ext):
    """CUDA events around each forward of `ext` (no synchronisation); returns
    (the list of [start, end] pairs, a function that removes the hooks)."""
    import torch

    events = []

    def pre(mod, args):
        events.append([torch.cuda.Event(enable_timing=True), None])
        events[-1][0].record()

    def post(mod, args, out):
        events[-1][1] = torch.cuda.Event(enable_timing=True)
        events[-1][1].record()

    hooks = (ext.register_forward_pre_hook(pre), ext.register_forward_hook(post))
    return events, lambda: [h.remove() for h in hooks]


def run_phase14_trainer(conf, name, label, expect_extractor):
    """A trainer of `conf` through `Trainer.build()` / `train()` (one epoch
    and its validation); returns (trainer, steps, evals, seconds, peak MiB,
    the extractor's [start, end] events)."""
    import torch

    from gluefactory_tpu_torch.train import trainer as tmod
    from gluefactory_tpu_torch.utils import experiments as exps

    trainer = tmod.Trainer(conf, name, exps.experiment_dir(name), device="cuda")
    trainer.build()
    m = trainer.model.matcher.conf
    if (m.n_layers, m.descriptor_dim, m.input_dim, m.mp, m.checkpointed) != (9, D, 128, False,
                                                                            True):
        fail(f"{label}: LightGlue is not 9 x 256 from 128-D descriptors, fp32, checkpointed")
    if (trainer.model.extractor is not None) != expect_extractor:
        fail(f"{label}: the extractor is {trainer.model.extractor}")
    events, remove = ([], lambda: None)
    if expect_extractor:
        events, remove = extraction_events(trainer.model.extractor)
    steps, evals, restore = timed_trainer(trainer)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        trainer.train()
        t_run = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        restore()
        remove()
    for i, (_, _, counts, losses) in enumerate(steps):
        if counts != STEP_COUNTS:
            fail(f"{label}, step {i}: launches {counts}, expected {STEP_COUNTS}")
        if not all(math.isfinite(v) for v in losses.values()) or losses["skipped_nonfinite"]:
            fail(f"{label}, step {i}: {losses}")
    if len(evals) != 1 or not math.isfinite(evals[0][1]["loss/total"]):
        fail(f"{label}: validations {[e[1] for e in evals]}")
    return trainer, steps, evals, t_run, peak, events


def check_sift_training():
    """Phase 14a: configs/sift_tpu+lightglue_homography.json at full width
    (16 pairs of 480 x 368, sift_tpu on both views, 384 keypoints, LightGlue
    9 x 256 from 128-D descriptors, fp32, checkpointed) through the trainer:
    sift_tpu on the card against the CPU on 4 images of the first batch,
    then SIFT_WARM + SIFT_STEPS steps and a validation. Returns the launches
    a step."""
    import statistics

    import torch

    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.utils.config import load_conf, merge
    from gluefactory_tpu_torch.utils.tensor import batch_to_device

    conf = merge(load_conf(SIFT_CONF), {
        "data": {"train_size": (SIFT_WARM + SIFT_STEPS) * SIFT_B, "val_size": SIFT_B,
                 "synthetic": {"pool": 64}},
        "train": {"epochs": 1, "log_every_iter": 1}})
    if conf["data"]["train_batch_size"] != SIFT_B or conf["model"]["extractor"] != {
            "name": "sift_tpu", "max_num_keypoints": SIFT_N, "trainable": False}:
        fail(f"14a: the configuration is not {SIFT_B} pairs of sift_tpu at {SIFT_N} keypoints")
    from gluefactory_tpu_torch.datasets import get_dataset

    ds = get_dataset("homographies")(conf["data"], device="cuda")
    first = batch_to_device(next(iter(ds.get_data_loader("train", epoch=0))), "cuda")
    sift = get_model("sift_tpu")({"max_num_keypoints": SIFT_N}, device="cuda")
    held = hold_extractor(sift, first["view0"]["image"][:SIFT_BAR_IMAGES], "14a sift_tpu")
    log(f"[sift14a] sift_tpu at {tuple(first['view0']['image'].shape[1:3])}: " + held)
    # sift_tpu alone on the step's two calls (16 images each), no loader beside it
    views = (first["view0"]["image"], first["view1"]["image"])
    alone = timed(lambda: [sift({"image": v}) for v in views], 3)
    split = device_ms(lambda: sift({"image": views[0]}), 2, warmup=0, top=4)
    log(f"[sift14a] sift_tpu alone on both views of a step: {alone:.2f} ms (CUDA events); one "
        f"view: " + split_text(split))
    del ds, first, sift

    trainer, steps, evals, t_run, peak, events = run_phase14_trainer(
        conf, "sift_tpu_lg", "14a", True)
    if len(steps) != SIFT_WARM + SIFT_STEPS:
        fail(f"14a: {len(steps)} steps")
    ext_ms = [sum(s.elapsed_time(e) for s, e in events[2 * i:2 * i + 2])
              for i in range(SIFT_WARM, len(steps))]
    step_ms = [(z - a) * 1e3 for a, z, _, _ in steps[SIFT_WARM:]]
    ms, ems = statistics.median(step_ms), statistics.median(ext_ms)
    log(f"[sift14a] {len(steps)} steps + validation in {t_run:.2f} s; ms a step {ms:.2f} "
        f"(median of the last {SIFT_STEPS}: " + " ".join(f"{t:.2f}" for t in step_ms)
        + f"), of which sift_tpu on both views {ems:.2f} ms ({ems / ms:.3f} of the step; CUDA "
        f"events); peak {peak:.0f} MiB; launches a step {steps[-1][2]}; val loss/total "
        f"{evals[0][1]['loss/total']:.4f}; losses total "
        + " ".join(f"{x[3]['total']:.4f}" for x in steps))
    del trainer
    torch.cuda.empty_cache()
    return {f"{k} sift": v for k, v in STEP_COUNTS.items() if k in ("K5", "K6b", "K7b self",
                                                                    "K7b cross")}


def check_cached_features():
    """Phase 14b: the cached `features.do` mode at sift+lightglue_homography's
    widths (32 pairs of 640 x 480 from a pool of 128 textures, sift_tpu once
    on each source image at 960 x 720, 512 keypoints, the extractor null):
    the loader alone (its extractions included), then CACHED_STEPS steps and a
    validation fed by the loader on the warm cache."""
    import statistics

    import torch

    from gluefactory_tpu_torch.utils.config import load_conf, merge

    conf = merge(load_conf(SIFT_CONF), {
        "data": {**CACHED_DATA, "train_size": CACHED_STEPS * CACHED_B, "val_size": CACHED_B},
        "model": {"extractor": {"name": None}},
        "train": {"epochs": 1, "log_every_iter": 1}})
    from gluefactory_tpu_torch.datasets import get_dataset

    ds = get_dataset("homographies")(conf["data"], device="cuda")
    t0 = time.perf_counter()
    n = 0
    for batch in ds.get_data_loader("train", epoch=0):
        n += len(batch["idx"])
        cache = batch["view0"]["cache"]
    loader_s = time.perf_counter() - t0
    if cache["keypoints"].shape != (CACHED_B, CACHED_N, 2) or cache["keypoint_mask"].sum() == 0:
        fail(f"14b: a cache of {cache['keypoints'].shape}, {cache['keypoint_mask'].sum()} valid")
    n_src = len(ds._feature_cache)
    trainer, steps, evals, t_run, peak, _ = run_phase14_trainer(conf, "sift_cached_lg", "14b",
                                                                 False)
    ms = statistics.median((z - a) * 1e3 for a, z, _, _ in steps)
    wall = t_run / max(len(steps), 1) * 1e3
    log(f"[cached14b] the loader alone: {n} pairs in {loader_s:.2f} s ({n / loader_s:.2f} pairs/s, "
        f"{n_src} source images through sift_tpu at 960 x 720 included); {len(steps)} steps + "
        f"validation in {t_run:.2f} s ({wall:.2f} ms a step with the loader and the "
        f"validation), ms a step alone {ms:.2f} (median); peak {peak:.0f} MiB; launches a step "
        f"{steps[-1][2]}; losses total " + " ".join(f"{x[3]['total']:.4f}" for x in steps))
    del trainer
    torch.cuda.empty_cache()


def check_extractor_pipelines():
    """Phase 14c: ALIKED (aliked-n16), DISK and DISK-official (seeded) feeding
    LightGlue (input_dim 128, fp32, seeded) in the two-view pipeline at 480 x
    640, batch 8, 1024 keypoints: K1 = K2 = 9 and K4 = 1 a forward, finite
    outputs, ms a batch and the extractor's share, each extractor on the
    card against the CPU on one image; then ALIKED_STEPS steps of
    configs/aliked+lightglue_homography.json at TRAIN_B pairs."""
    import statistics

    import torch

    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.utils.config import load_conf, merge

    img0, img1, _ = synthetic_pair(61, EXT_B, 480, 640)
    size = torch.tensor([[640.0, 480.0]] * EXT_B, device="cuda")
    data = {"view0": {"image": img0, "image_size": size},
            "view1": {"image": img1, "image_size": size}}
    shares = {}
    for name, econf in EXTRACTORS.items():
        pipe = get_model("two_view_pipeline")({
            "extractor": econf, "matcher": {"name": "lightglue", "input_dim": 128,
                                            "filter_threshold": 0.1}}, device="cuda").eval()
        pipe(data)
        torch.cuda.synchronize()
        reset_counts()
        out = pipe(data)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != [9, 9, 1]:
            fail(f"14c {name}: launches K1, K2, K4 {counts}, expected [9, 9, 1]")
        for key in ("keypoints0", "descriptors0", "log_assignment", "matching_scores0"):
            if not torch_finite(out[key]):
                fail(f"14c {name}: non-finite {key}")
        if out["keypoints0"].shape != (EXT_B, EXT_N, 2):
            fail(f"14c {name}: keypoints {tuple(out['keypoints0'].shape)}")
        batch_ms = timed(lambda: pipe(data), 3, warmup=0)
        ext_ms = timed(lambda: [pipe.extractor(data[v]) for v in ("view0", "view1")], 3,
                       warmup=0)
        held = hold_extractor(pipe.extractor, img0[:1], f"14c {name}")
        split = device_ms(lambda: pipe.extractor(data["view0"]), 2, warmup=0, top=4)
        shares[name] = (batch_ms, ext_ms)
        log(f"[ext14c] {name}: {batch_ms:.2f} ms a batch of {EXT_B} pairs, the extractor "
            f"{ext_ms:.2f} ms ({ext_ms / batch_ms:.3f} of it); launches K1 {counts[0]}, K2 "
            f"{counts[1]}, K4 {counts[2]}; valid keypoints {int(out['keypoint_mask0'].sum())}, "
            f"matches {int((out['matches0'] >= 0).sum())}; " + held + "; one view: "
            + split_text(split))
        del pipe, out
        torch.cuda.empty_cache()

    conf = merge(load_conf(ALIKED_CONF), {
        "data": {"batch_size": TRAIN_B, "train_size": ALIKED_STEPS * TRAIN_B,
                 "val_size": TRAIN_B, "synthetic": {"pool": 64}},
        "train": {"epochs": 1, "log_every_iter": 1}})
    trainer, steps, evals, t_run, peak, events = run_phase14_trainer(
        conf, "aliked_lg", "14c ALIKED training", True)
    ext = trainer.model.extractor.conf
    if (ext.model_name, ext.max_num_keypoints) != ("aliked-n16", 512):
        fail(f"14c ALIKED training: the extractor is {ext.model_name} at {ext.max_num_keypoints}")
    ms = statistics.median((z - a) * 1e3 for a, z, _, _ in steps)
    ems = statistics.median(sum(s.elapsed_time(e) for s, e in events[2 * i:2 * i + 2])
                            for i in range(len(steps)))
    log(f"[ext14c] aliked+lightglue_homography: {len(steps)} steps of {TRAIN_B} pairs + "
        f"validation in {t_run:.2f} s; ms a step {ms:.2f} (median), ALIKED on both views "
        f"{ems:.2f} ({ems / ms:.3f} of the step); peak {peak:.0f} MiB; launches a step "
        f"{steps[-1][2]}; losses total " + " ".join(f"{x[3]['total']:.4f}" for x in steps))
    del trainer
    torch.cuda.empty_cache()
    return shares


def run_extractors_phase():
    """Phase 14, with TF32 allowed for cuDNN (PyTorch's default, which the
    training entry point keeps) and for cuBLAS: the extractors' own
    `no_tf32` scope is what holds them to the CPU. The flags as they were
    afterwards. Returns the launches a step of the rows it adds."""
    import torch

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    t_phase = time.perf_counter()
    try:
        counts = check_sift_training()
        check_cached_features()
        check_extractor_pipelines()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    log(f"[ext14] phase {time.perf_counter() - t_phase:.1f} s (TF32 allowed outside the "
        f"extractors)")
    return counts


# ----------------------------------------------------------------- phase 15
CODECS = ROOT / "tests" / "data" / "codecs"
MD_PAIRS, MD_SIZE = 8, (1600, 1200)  # pairs of the MegaDepth-1500 tree, (w, h)
MD_EXTRACTOR = {"name": "superpoint_open", "max_num_keypoints": 2048,
                "detection_threshold": 0.0, "dtype": None}
MD_LIGHTGLUE = {"name": "lightglue", "filter_threshold": 0.1}
ETH_VIEWS, ETH_SIZE, ETH_DOWNSIZE = 5, (1512, 1008), 2  # ETH3D's 6048 x 4032 / 8 fed to the model
ETH_POINTS = 6000  # 3D points on the scene's planes for the COLMAP tracks
MD_SUMMARIES = ("rel_pose_error@5°", "rel_pose_error@10°", "rel_pose_error@20°",
                "rel_pose_error_mAA", "mepi_prec@1e-4", "mepi_prec@5e-4", "mepi_prec@1e-3")


def check_decoders(work):
    """15a: the committed corpus decoded by the port on this host, each mode
    to the sha256 that cv2 gave where the corpus was written; ms of a
    1600 x 1200 JPEG decode and of a 6048 x 4032 16-bit PNG decode (written
    here by `write_png16` and read back exactly)."""
    import hashlib
    import statistics

    import numpy as np

    from gluefactory_tpu_torch import _ext
    from gluefactory_tpu_torch.datasets.image_codecs import decode_jpeg, decode_png
    from gluefactory_tpu_torch.datasets.utils import read_image, read_image_anydepth

    t0 = time.perf_counter()
    _ext.load_host("image_decode")
    log(f"[codecs] csrc/image_decode.cpp built and loaded in {time.perf_counter() - t0:.2f} s")
    manifest = json.loads((CODECS / "manifest.json").read_text())
    checked = 0
    for name, entry in manifest["files"].items():
        for mode, want in entry["decoded"].items():
            path = CODECS / name
            if mode == "anydepth":
                out = read_image_anydepth(path)
            else:  # the uint8 image behind read_image's float32 / 255
                out = (read_image(path, mode == "grey") * 255.0).round().astype(np.uint8)
                out = out[..., 0] if mode == "grey" else out
            got = hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest()
            if list(out.shape) != want["shape"] or got != want["sha256"]:
                fail(f"codecs: {name} ({mode}) decodes to {out.shape} {got[:16]}, cv2 gave "
                     f"{want['shape']} {want['sha256'][:16]}")
            checked += 1

    def median_ms(fn, n):
        times = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    jpeg = (CODECS / "md_pair0_a.jpg").read_bytes()
    jpeg_ms = median_ms(lambda: decode_jpeg(jpeg), 7)
    grey_ms = median_ms(lambda: decode_jpeg(jpeg, True), 7)
    read_ms = median_ms(lambda: read_image(CODECS / "md_pair0_a.jpg"), 7)
    yy, xx = np.mgrid[0:4032, 0:6048]
    depth = (1000 + 700 * np.sin(xx / 97.0) + 500 * np.cos(yy / 61.0) + (xx + yy) % 7).astype(
        np.uint16)
    work.mkdir(parents=True, exist_ok=True)
    write_png16(work / "depth.png", depth)
    png = (work / "depth.png").read_bytes()
    back = decode_png(png, "anydepth")
    if back.dtype != np.uint16 or not np.array_equal(back, depth):
        fail("codecs: the 6048 x 4032 16-bit PNG does not read back exactly")
    png_ms = median_ms(lambda: decode_png(png, "anydepth"), 3)
    log(f"[codecs] the committed corpus: {checked} decodes equal cv2's digests; 1600 x 1200 "
        f"4:2:0 JPEG {jpeg_ms:.2f} ms to RGB, {grey_ms:.2f} ms to grey, read_image (file, "
        f"float32) {read_ms:.2f} ms; 6048 x 4032 16-bit PNG ({len(png) / 2**20:.1f} MiB) "
        f"{png_ms:.2f} ms (median, host clock, on the host's CPU)")


def pair_line(n0, n1, K0, K1, T):
    return " ".join([n0, n1] + [f"{x:.9g}" for x in (*K0.ravel(), *K1.ravel(), *T.ravel())])


def build_megadepth_tree(root):
    """megadepth1500/{images, pairs_calibrated.txt}: 36-field lines, pair 0
    the committed JPEG pair, pairs 1 .. MD_PAIRS - 1 items of the synthetic
    two-view renderer's test split at MD_SIZE (known K and T_0to1), rendered
    on threads and written as PPM."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from gluefactory_tpu_torch.datasets.synthetic_two_view import SyntheticTwoViewDataset

    images = root / "megadepth1500" / "images"
    (images / "jpeg").mkdir(parents=True)
    manifest = json.loads((CODECS / "manifest.json").read_text())["megadepth_pair0"]
    lines = []
    for name in manifest["images"]:
        (images / "jpeg" / name).write_bytes((CODECS / name).read_bytes())
    lines.append(pair_line(*(f"jpeg/{n}" for n in manifest["images"]),
                           np.array(manifest["K0"]), np.array(manifest["K1"]),
                           np.array(manifest["T_0to1"])))
    split = SyntheticTwoViewDataset({"image_size": list(MD_SIZE),
                                     "test_size": MD_PAIRS}).get_dataset("test")
    with ThreadPoolExecutor(4) as pool:
        items = list(pool.map(split.__getitem__, range(1, MD_PAIRS)))
    for i, item in enumerate(items, 1):
        names = [f"ppm/{i}_{v}.ppm" for v in "ab"]
        (images / "ppm").mkdir(exist_ok=True)
        for v, name in enumerate(names):
            write_ppm(images / name, item[f"view{v}"]["image"][..., 0])
        K = item["view0"]["camera"].calibration_matrix().numpy()
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = item["T_0to1"].R.numpy(), item["T_0to1"].t.numpy()
        lines.append(pair_line(*names, K, K, T))
    (root / "megadepth1500" / "pairs_calibrated.txt").write_text("\n".join(lines) + "\n")


def run_megadepth_cli(work, tag, argv):
    """`python -m gluefactory_tpu_torch.eval.megadepth1500` (its `main`) on
    the tree, K1, K2, K4 counted and peak memory; returns (summaries,
    pipeline, counts, peak MiB)."""
    import torch

    from gluefactory_tpu_torch.eval import megadepth1500 as md

    runs, run = [], md.MegaDepth1500Pipeline.run

    def recorded(self, *a, **k):
        runs.append(self)
        return run(self, *a, **k)

    root = work / "data" / "megadepth1500"
    argv = ["--tag", tag, f"data.pairs={json.dumps(str(root / 'pairs_calibrated.txt'))}",
            f"data.root={json.dumps(str(root / 'images'))}", *argv]
    md.EVAL_PATH, md.MegaDepth1500Pipeline.run = work, recorded
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in hpatches_counters()[1:]:
            fn.launches = 0
        summaries = md.main(argv)
        torch.cuda.synchronize()
        counts = [fn.launches for fn in hpatches_counters()[1:]]
    finally:
        md.MegaDepth1500Pipeline.run = run
    peak = torch.cuda.max_memory_allocated() / 2**20
    pipe = runs[0]
    log(f"[md1500 {tag}] export {MD_PAIRS / pipe.timings['export_s']:.2f} pairs/s "
        f"({pipe.timings['export_s']:.2f} s for {MD_PAIRS} pairs), eval phase "
        f"{pipe.timings['eval_s']:.2f} s, peak memory {peak:.0f} MiB; launches K1 {counts[0]}, "
        f"K2 {counts[1]}, K4 {counts[2]}")
    log(f"[md1500 {tag}] summaries " + json.dumps(summaries))
    return summaries, pipe, counts, peak


def hold_pair0(pipe):
    """The first pair of the tree (the committed JPEG pair) through the
    pipeline of the run, kernels against the plain path: matches0 equal on
    >= 99% of view 0's keypoints, the log assignment within 1e-3 + 1e-4
    |value| (as phase 11's MP benchmark); and the loader alone (pairs/s), on
    the tree and on a JPEG-only tree (pair 0's line repeated as often, the
    files read warm from the page cache), as MegaDepth-1500 is all JPEG."""
    import torch

    from gluefactory_tpu_torch.eval.export_helper import load_model
    from gluefactory_tpu_torch.utils.config import Config, merge
    from gluefactory_tpu_torch.utils.tensor import batch_to_device

    t0 = time.perf_counter()
    batches = list(pipe.get_dataloader())
    loader_pps = len(batches) / (time.perf_counter() - t0)
    pairs = Path(pipe.conf.data.pairs)
    jpeg_pairs = pairs.with_name("pairs_jpeg.txt")
    jpeg_pairs.write_text((pairs.read_text().splitlines()[0] + "\n") * len(batches))
    t0 = time.perf_counter()
    n_jpeg = sum(1 for _ in pipe.get_dataloader(Config(merge(pipe.conf.data,
                                                             {"pairs": str(jpeg_pairs)}))))
    jpeg_pps = n_jpeg / (time.perf_counter() - t0)
    conf = dict(pipe.conf.model)
    model = load_model({k: v for k, v in conf.items() if k != "checkpoint"}, conf["checkpoint"],
                       "cuda")
    batch = batch_to_device(batches[0], "cuda")
    with torch.no_grad():
        out = model(batch)
        with plain_path():
            ref = model(batch)
    agree = float((out["matches0"] == ref["matches0"]).float().mean())
    la, lr = out["log_assignment"], ref["log_assignment"]
    finite = torch.isfinite(lr)
    if not bool((torch.isfinite(la) == finite).all()):
        fail("md1500 pair 0: the log assignment's finite entries differ from the plain path's")
    diff = (la - lr)[finite].abs()
    excess = float((diff - 1e-4 * lr[finite].abs()).max())
    log(f"[md1500 pair 0] {batches[0]['name'][0]}: matches0 equal to the plain path on "
        f"{agree:.4f} of {out['matches0'].shape[1]} keypoints ({int((out['matches0'] > -1).sum())} "
        f"matches); log assignment {tuple(la.shape)} within {float(diff.max()):.3g} "
        f"({excess:.3g} above 1e-4 |value|, bar 1e-3); the loader alone {loader_pps:.2f} "
        f"pairs/s ({len(batches)} pairs: decode, resize to 1600, pad), on the JPEG-only tree "
        f"{jpeg_pps:.2f} pairs/s ({n_jpeg} pairs of the committed 1600 x 1200 JPEGs)")
    if n_jpeg != len(batches):
        fail(f"md1500: the JPEG-only tree gave {n_jpeg} pairs, expected {len(batches)}")
    if agree < 0.99:
        fail(f"md1500 pair 0: matches0 equal to the plain path on {agree:.4f} < 0.99")
    if not excess <= 1e-3:
        fail(f"md1500 pair 0: log assignment {float(diff.max()):.3g} from the plain path")
    with torch.no_grad():
        pair_ms = timed(lambda: model(batch), 5)
        ext_ms = timed(lambda: [model.extractor(batch[v]) for v in ("view0", "view1")], 5)
    log(f"[md1500 pair 0] warm forward {pair_ms:.2f} ms a pair (CUDA events): the extractor "
        f"on both 1600 x 1600 boxes {ext_ms:.2f} ms, the rest (LightGlue, filtering) "
        f"{pair_ms - ext_ms:.2f} ms")
    del model, batches


def run_megadepth1500(work):
    """15b; returns the K1, K2, K4 launches of the LightGlue run."""
    from gluefactory_tpu_torch.weights import HERMETIC

    t0 = time.perf_counter()
    build_megadepth_tree(work / "data")
    log(f"[md1500] tree of {MD_PAIRS} calibrated pairs at {MD_SIZE[0]} x {MD_SIZE[1]} (pair 0 "
        f"the committed JPEGs, the others rendered here as PPM) in "
        f"{time.perf_counter() - t0:.2f} s")
    s, pipe, counts, _ = run_megadepth_cli(work, "lightglue", [
        "--checkpoint", str(HERMETIC), "eval.ransac_th=1.0",
        "model.extractor=" + json.dumps(MD_EXTRACTOR),
        "model.matcher=" + json.dumps(MD_LIGHTGLUE)])
    if counts != [9 * MD_PAIRS, 9 * MD_PAIRS, MD_PAIRS]:
        fail(f"md1500: expected K1 = K2 = 9 and K4 = 1 launches a pair, got {counts}")
    bad = [k for k in MD_SUMMARIES if not math.isfinite(s[k])]
    if bad:
        fail(f"md1500: non-finite summaries {bad}")
    if pipe.conf.data.preprocessing.resize != 1600 or list(pipe.conf.data.preprocessing.pad_to) != [
            1600, 1600]:
        fail("md1500: the data block is not resize 1600 / pad_to [1600, 1600]")
    hold_pair0(pipe)
    nn, _, nn_counts, _ = run_megadepth_cli(work, "superpoint-open+NN", [
        "--conf", str(ROOT / "gluefactory_tpu_torch" / "configs" / "superpoint-open+NN.json"),
        "--checkpoint", str(HERMETIC)])
    bad = [k for k, v in nn.items() if not math.isfinite(v)]
    if bad or nn_counts != [0, 0, 0]:
        fail(f"md1500 superpoint-open+NN: non-finite summaries {bad} or launches {nn_counts}")
    return {"K1 md": counts[0], "K2 md": counts[1], "K4 md": counts[2]}


def rotmat2qvec(R):
    """(w, x, y, z) of a rotation matrix (COLMAP's convention)."""
    import numpy as np

    w = math.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def write_png16(path, depth, bits=16):
    """A 16-bit (or, with `bits=8`, 8-bit) grey PNG, filter 0, with zlib."""
    import struct
    import zlib

    h, w = depth.shape
    rows = depth.astype(">u2" if bits == 16 else "u1")
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, 0,
                                                                      0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def build_eth3d_tree(root):
    """One scene in ETH3D's layout: ETH_VIEWS views of a back plane and
    three front planes (the synthetic two-view renderer's scene), rendered
    at ETH_SIZE and written as PPM, their 16-bit depth (metres x 256) as
    PNG at the same size, COLMAP cameras.txt / images.txt with the tracks
    of ETH_POINTS points on the planes (visible where in the image and not
    occluded). Returns the pairs above the default min_covisibility (500)."""
    import numpy as np

    from gluefactory_tpu_torch.datasets.homographies import generate_texture_image
    from gluefactory_tpu_torch.datasets.synthetic_two_view import render_view

    scene = root / "ETH3D_undistorted" / "synthetic"
    dirs = [scene / "images" / "dslr_images_undistorted",
            scene / "ground_truth_depth" / "undistorted_depth",
            scene / "dslr_calibration_undistorted"]
    for d in dirs:
        d.mkdir(parents=True)
    rng = np.random.RandomState(1500)
    w, h = ETH_SIZE
    f = 0.9 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    planes = [(generate_texture_image(rng, (1024, 1024)), 7.0, None)]
    rects = [(-1.6, -1.0, 0.2, 0.6), (0.4, -0.9, 1.7, 0.9), (-0.7, 0.5, 0.9, 1.4)]
    for d, rect in zip((4.0, 3.3, 5.0), rects):
        planes.append((generate_texture_image(rng, (512, 512)), d, rect))
    planes.sort(key=lambda p: -p[1])
    # points on the planes: the back plane over the views' field, the front ones on their rects
    pts = []
    for _, d, rect in planes:
        x0, y0, x1, y1 = rect or (-4.5, -3.0, 4.5, 3.0)
        n = ETH_POINTS // 2 if rect is None else ETH_POINTS // 6
        pts.append(np.c_[rng.uniform(x0, x1, n), rng.uniform(y0, y1, n), np.full(n, d)])
    pts = np.concatenate(pts)
    cam_lines = ["# Camera list with one line of data per camera:",
                 "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]",
                 f"0 PINHOLE {w} {h} {f:.6f} {f:.6f} {w / 2:.6f} {h / 2:.6f}"]
    (dirs[2] / "cameras.txt").write_text("\n".join(cam_lines) + "\n")
    img_lines = ["# Image list with two lines of data per image:",
                 "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
                 "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
    vis = []
    for i in range(ETH_VIEWS):
        aa = rng.randn(3) * 0.04
        theta = np.linalg.norm(aa)
        k = aa / theta
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + math.sin(theta) * Kx + (1 - math.cos(theta)) * Kx @ Kx
        t = np.array([0.35 * (i - ETH_VIEWS // 2), 0.1 * rng.randn(), 0.1 * rng.randn()])
        img, depth, _ = render_view(K, R, t, planes, (w, h))
        write_ppm(dirs[0] / f"view_{i}.ppm", img[..., 0])
        write_png16(dirs[1] / f"view_{i}.png", np.clip(depth * 256.0, 0, 65535).round())
        Xc = pts @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:] * f + [w / 2, h / 2]
        inside = (Xc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w - 1) & (uv[:, 1] >= 0) & (
            uv[:, 1] < h - 1)
        ui, vi = uv[:, 0].astype(int).clip(0, w - 1), uv[:, 1].astype(int).clip(0, h - 1)
        seen = inside & (np.abs(depth[vi, ui] - Xc[:, 2]) < 0.05)
        vis.append(seen)
        q = rotmat2qvec(R)
        img_lines.append(f"{i} " + " ".join(f"{x:.12f}" for x in (*q, *t)) + f" 0 view_{i}.ppm")
        img_lines.append(" ".join(f"{u:.3f} {v:.3f} {p}" for p, (u, v) in
                                  zip(np.where(seen)[0], uv[seen])))
    (dirs[2] / "images.txt").write_text("\n".join(img_lines) + "\n")
    return [(a, b, int((vis[a] & vis[b]).sum())) for a in range(ETH_VIEWS)
            for b in range(a + 1, ETH_VIEWS) if (vis[a] & vis[b]).sum() >= 500]


def run_eth3d(work):
    """15c: the ETH3D benchmark on a tree written here."""
    import torch

    from gluefactory_tpu_torch.eval.eth3d import ETH3DPipeline
    from gluefactory_tpu_torch.eval.export_helper import load_model
    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.utils.tensor import batch_to_device
    from gluefactory_tpu_torch.weights import HERMETIC

    t0 = time.perf_counter()
    pairs = build_eth3d_tree(work / "data")
    log(f"[eth3d] one scene of {ETH_VIEWS} views at {ETH_SIZE[0]} x {ETH_SIZE[1]} (PPM, 16-bit "
        f"PNG depth, COLMAP text) in {time.perf_counter() - t0:.2f} s; pairs above 500 "
        f"covisible points: {pairs}")
    if len(pairs) < 3:
        fail(f"eth3d: {len(pairs)} pairs above min_covisibility, expected at least 3")
    conf = {"data": {"data_dir": str(work / "data" / "ETH3D_undistorted"),
                     "downsize_factor": ETH_DOWNSIZE},
            "model": {"extractor": {**MD_EXTRACTOR, "max_num_keypoints": 1024},
                      "matcher": MD_LIGHTGLUE, "checkpoint": str(HERMETIC)}}
    pipe = ETH3DPipeline(conf, device="cuda")
    torch.cuda.synchronize()
    for fn in hpatches_counters()[1:]:
        fn.launches = 0
    s, _, r = pipe.run(work / "eth3d")
    torch.cuda.synchronize()
    counts = [fn.launches for fn in hpatches_counters()[1:]]
    n = len(pairs)
    log(f"[eth3d] export {n / pipe.timings['export_s']:.2f} pairs/s ({pipe.timings['export_s']:.2f}"
        f" s for {n} pairs at {ETH_SIZE[0] // ETH_DOWNSIZE} x {ETH_SIZE[1] // ETH_DOWNSIZE}), eval "
        f"{pipe.timings['eval_s']:.3f} s; AP {s['AP']:.3f}, recall at the end "
        f"{float(r['curve_recall'][-1]):.3f}; launches K1 {counts[0]}, K2 {counts[1]}, "
        f"K4 {counts[2]}")
    if counts != [9 * n, 9 * n, n] or not math.isfinite(s["AP"]):
        fail(f"eth3d: launches {counts} (expected 9, 9, 1 a pair over {n}) or AP {s['AP']}")
    # the ground truth of pair 0 on the card against the CPU's on the keypoints of the
    # benchmark's model
    batch = batch_to_device(next(iter(pipe.get_dataloader())), "cuda")
    model = load_model({k: v for k, v in dict(pipe.conf.model).items() if k != "checkpoint"},
                       HERMETIC, "cuda")
    with torch.no_grad():
        feats = {f"{k}{i}": t for i, v in enumerate(("view0", "view1"))
                 for k, t in model.extractor(batch[v]).items()}
        gt = model.ground_truth({**batch, **feats})
        again = model.extractor(batch["view0"])["keypoints"]  # is the extraction repeatable?
    cpu = get_model("depth_matcher")(dict(pipe.conf.model.ground_truth), device="cpu")(
        batch_to_device({**batch, **feats}, "cpu"))
    for k in GT_KEYS:
        if not torch.equal(gt[k].cpu(), cpu[k]):
            fail(f"eth3d: {k} on the card differs from the CPU's on "
                 f"{int((gt[k].cpu() != cpu[k]).sum())} entries")
    log(f"[eth3d pair 0] ground truth on the card equal to the CPU's ({', '.join(GT_KEYS)}): "
        f"{int((gt['gt_matches0'] >= 0).sum())} positives of {gt['gt_matches0'].shape[1]}; a "
        f"second extraction of view 0 gives the same keypoints: "
        f"{bool(torch.equal(again, feats['keypoints0']))}")


def run_benchmarks_phase():
    """Phase 15: the decoders, MegaDepth-1500 and ETH3D. Returns the launches
    of the rows it adds."""
    import shutil

    work = ROOT / "outputs" / "chip_smoke_benchmarks"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        check_decoders(work)
        counts = run_megadepth1500(work)
        run_eth3d(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[bench15] phase {time.perf_counter() - t0:.1f} s")
    return counts


# ----------------------------------------------------------------- phase 16
MD16_CONF = "superpoint-open+lightglue_megadepth"  # the MegaDepth training recipe
MD16_SCENE = "0001"  # the first scene of the configuration's train_scenes_clean.txt
MD16_VIEWS = 28  # rendered views: 756 ordered pairs, ~250 in each of the 3 overlap bins
MD16_SIZE = (1600, 1200)  # (w, h) of a landscape view; MD16_PORTRAIT are rendered h x w
MD16_PORTRAIT = (3, 9, 14, 20, 25)
MD16_B, MD16_N = 32, 2048  # the configuration's pairs a step and keypoints
MD16_STEPS = 3  # timed steps after one warm-up
MD16_TRIPLETS = 8  # triplets of the views: 3 batch
MD16_GT_PAIRS = 8  # pairs whose ground truth is held card against CPU
MD16_CACHE_GROUPS = 1000  # image groups of the HDF5 cache written and read back in 16a
MD16_MP_PAIRS = 8  # optical / thermal pairs of the MP file in 16f
MD16_CACHED_B = 8  # pairs of the cached-feature step


def batch_head(batch, n):
    """The first n pairs of a collated batch (tensors, Pose / Camera, lists)."""
    from gluefactory_tpu_torch.geometry.wrappers import TensorWrapper

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, TensorWrapper)) or hasattr(x, "shape") and len(x.shape):
            return x[:n]
        return x

    return cut(batch)


def check_hdf5_io(work):
    """16a: the port's HDF5 writer and reader on this host (no h5py here:
    they check each other; the CPU tests hold both against h5py): a 1600 x
    1200 float32 depth file and a feature cache of MD16_CACHE_GROUPS image
    groups, written and read back bit for bit; ms of one depth read."""
    import statistics

    import numpy as np

    from gluefactory_tpu_torch.datasets.megadepth import read_depth
    from gluefactory_tpu_torch.utils import hdf5

    rng = np.random.RandomState(16)
    depth = (rng.rand(MD16_SIZE[1], MD16_SIZE[0]) * 80).astype(np.float32)
    depth[rng.rand(*depth.shape) < 0.2] = 0.0  # MegaDepth's holes
    t0 = time.perf_counter()
    with hdf5.File(work / "depth.h5", "w") as f:
        f.create_dataset("/depth", data=depth)
    write_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        back = read_depth(work / "depth.h5")
        times.append((time.perf_counter() - t0) * 1e3)
    if back.dtype != np.float32 or back.tobytes() != depth.tobytes():
        fail("16a: the depth file does not read back bit for bit")
    groups = {}
    t0 = time.perf_counter()
    with hdf5.File(work / "cache.h5", "w") as f:
        for i in range(MD16_CACHE_GROUPS):
            name = f"Undistorted_SfM/{MD16_SCENE}/images/{(i * 7919) % 100003}.jpg"
            n = 64 + i % 7
            groups[name] = {"keypoints": rng.rand(n, 2).astype(np.float32) * 1600,
                            "keypoint_scores": rng.rand(n).astype(np.float16),
                            "descriptors": rng.randn(n, 32).astype(np.float32),
                            "keypoint_mask": rng.rand(n) > 0.1,
                            "depth_keypoints": rng.rand(n).astype(np.float64)}
            grp = f.create_group(name)
            for k, v in groups[name].items():
                grp.create_dataset(k, data=v)
    cache_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    with hdf5.File(work / "cache.h5", "r") as f:
        images = f[f"Undistorted_SfM/{MD16_SCENE}/images"]
        if len(images) != MD16_CACHE_GROUPS or images.keys() != sorted(images.keys()):
            fail(f"16a: the cache lists {len(images)} image groups, unsorted or not "
                 f"{MD16_CACHE_GROUPS}")
        for name, want in groups.items():
            for k, v in want.items():
                got = np.asarray(f[name][k])
                if got.dtype != v.dtype or got.shape != v.shape or got.tobytes() != v.tobytes():
                    fail(f"16a: {name}/{k} does not read back bit for bit")
    cache_read = time.perf_counter() - t0
    log(f"[hdf5] 1600 x 1200 float32 depth: written in {write_ms:.2f} ms, read in "
        f"{statistics.median(times):.2f} ms (median of 7, warm, host clock), bit for bit; a cache "
        f"of {MD16_CACHE_GROUPS} image groups x 5 datasets (a 4-level tree of groups) written in "
        f"{cache_write:.2f} s, every dataset read back bit for bit in {cache_read:.2f} s")


def build_megadepth_scene(root):
    """16b: megadepth/ in the reference's layout, scene MD16_SCENE: MD16_VIEWS
    views of one multi-plane scene rendered by `render_view` at MD16_SIZE
    (landscape, or portrait for MD16_PORTRAIT) with exact depth and poses,
    written as 8-bit PNG with depth in HDF5 by the port's writer; the
    committed JPEG pair of phase 15 listed without depth, and one view
    without an image (None entries, as real scene_info files have); the
    overlaps spread over (0.1, 0.7) so that each of the configuration's
    three bins holds more than its 200 pairs. Returns the data root."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from gluefactory_tpu_torch.datasets.homographies import generate_texture_image
    from gluefactory_tpu_torch.datasets.synthetic_two_view import render_view
    from gluefactory_tpu_torch.geometry.utils import so3exp_map
    from gluefactory_tpu_torch.utils import hdf5

    data = root / "megadepth"
    img_dir = data / "Undistorted_SfM" / MD16_SCENE / "images"
    depth_dir = data / "depth_undistorted" / MD16_SCENE
    for d in (img_dir, depth_dir, data / "scene_info"):
        d.mkdir(parents=True)
    rng = np.random.RandomState(1600)
    planes = [(generate_texture_image(rng, (1024, 1024)), 9.0, None)]
    for _ in range(4):
        cx, cy = rng.uniform(-2.0, 2.0, 2)
        sx, sy = rng.uniform(1.5, 3.0, 2)
        planes.append((generate_texture_image(rng, (512, 512)), 4.0 + rng.rand() * 3.0,
                       (cx - sx / 2, cy - sy / 2, cx + sx / 2, cy + sy / 2)))
    planes.sort(key=lambda p: -p[1])
    cams = []
    for i in range(MD16_VIEWS):
        w, h = MD16_SIZE[::-1] if i in MD16_PORTRAIT else MD16_SIZE
        f = 0.9 * max(w, h)
        K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
        R = so3exp_map(torch.from_numpy((rng.randn(3) * 0.06).astype(np.float32)))
        t = rng.randn(3) * np.array([0.5, 0.3, 0.2])
        cams.append((K, R.numpy().astype(np.float64), t, (w, h)))

    def render(i):
        K, R, t, size = cams[i]
        img, depth, _ = render_view(K, R, t, planes, size)
        write_png16(img_dir / f"{i}.png", (img[..., 0] * 255 + 0.5).astype(np.uint8), bits=8)
        with hdf5.File(depth_dir / f"{i}.h5", "w") as f:
            f.create_dataset("/depth", data=depth)
        return float((depth > 0).mean())

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        covered = list(pool.map(render, range(MD16_VIEWS)))
    render_s = time.perf_counter() - t0
    rel = lambda p: str(p.relative_to(data))  # noqa: E731
    image_paths = [rel(img_dir / f"{i}.png") for i in range(MD16_VIEWS)]
    depth_paths = [rel(depth_dir / f"{i}.h5") for i in range(MD16_VIEWS)]
    poses = [np.block([[R, t[:, None]], [np.zeros((1, 3)), np.ones((1, 1))]])
             for _, R, t, _ in cams]
    intrinsics = [K for K, _, _, _ in cams]
    manifest = json.loads((CODECS / "manifest.json").read_text())["megadepth_pair0"]
    for name, K, T in zip(manifest["images"], ("K0", "K1"), (np.eye(4), manifest["T_0to1"])):
        (img_dir / name).write_bytes((CODECS / name).read_bytes())
        image_paths.append(rel(img_dir / name))
        depth_paths.append(None)  # listed without depth: never sampled
        intrinsics.append(np.array(manifest[K]))
        poses.append(np.array(T))
    image_paths.append(None)  # a view without an image
    depth_paths.append(rel(depth_dir / "0.h5"))
    intrinsics.append(intrinsics[0])
    poses.append(poses[0])
    n = len(image_paths)
    overlap = rng.uniform(0.1, 0.7, (n, n))
    overlap = ((overlap + overlap.T) / 2).astype(np.float32)
    overlap[:MD16_VIEWS, :MD16_VIEWS] = rng.uniform(0.1, 0.7, (MD16_VIEWS, MD16_VIEWS))
    overlap = np.triu(overlap, 1) + np.triu(overlap, 1).T
    np.savez(data / "scene_info" / f"{MD16_SCENE}.npz",
             image_paths=np.array(image_paths, object), depth_paths=np.array(depth_paths, object),
             poses=np.array(poses, np.float32), intrinsics=np.array(intrinsics, np.float32),
             overlap_matrix=overlap)
    log(f"[md16b] scene {MD16_SCENE}: {MD16_VIEWS} views rendered ({len(MD16_PORTRAIT)} "
        f"portrait) at {MD16_SIZE[0]} x {MD16_SIZE[1]}, depth covering "
        f"{min(covered):.3f}-{max(covered):.3f} of a view, PNG + HDF5 depth, in {render_s:.2f} s on "
        "8 threads; the committed JPEG pair listed without depth, one view without an image")
    return data


def loader_split(split, views=4):
    """Host ms a view of the MegaDepth loader's parts, medians over `views`
    views of the scene: the image decode (`read_image`), the preprocessing
    (area resize and pad), the HDF5 depth read and its nearest resize."""
    import statistics

    from gluefactory_tpu_torch.datasets.megadepth import read_depth
    from gluefactory_tpu_torch.datasets.utils import read_image, resize_image

    parts = {"decode": [], "resize + pad": [], "depth read": [], "depth resize": []}
    for idx in range(views):
        scene = split.scenes[0]
        t0 = time.perf_counter()
        img = read_image(split.root / str(split.images[scene][idx]), split.conf.grayscale)
        t1 = time.perf_counter()
        data = split.preprocessor(img)
        t2 = time.perf_counter()
        depth = read_depth(split.root / str(split.depths[scene][idx]))
        t3 = time.perf_counter()
        vw, vh = data["image_size"].astype(int)
        resize_image(depth, (vw, vh), interp="nearest")
        t4 = time.perf_counter()
        for key, a, b in zip(parts, (t0, t1, t2, t3), (t1, t2, t3, t4)):
            parts[key].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def md16_trainer(conf, flash=True):
    """A built trainer of the recipe with the committed weights grafted (the
    configuration names no load_experiment)."""
    from gluefactory_tpu_torch.train.trainer import Trainer, graft_state
    from gluefactory_tpu_torch.utils.config import merge
    from gluefactory_tpu_torch.weights import load_hermetic

    trainer = Trainer(merge(conf, {"model": {"matcher": {"flash": flash}}}), device="cuda")
    trainer.build()
    graft_state(trainer.model, load_hermetic(device="cuda"))
    return trainer


def check_md_training(conf):
    """16c: the recipe through the trainer at its shape (1024 px square-padded,
    2048 keypoints forced, 32 pairs, LightGlue 9 x 256 fp32 checkpointed): the
    loader alone; the ground truth on the card against the CPU on the same
    keypoints; the first step against the plain path; MD16_STEPS timed steps
    after a warm-up with the attention counts set to 0 just before and read
    just after; a step fed by the loader. At a batch that does not fit,
    the failing allocation is logged and the batch halved. Returns the
    launches a step and the batch run."""
    import torch

    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.utils.tensor import batch_to_device

    trainer = md16_trainer(conf)
    mconf, econf = trainer.model.matcher.conf, trainer.model.extractor.conf
    if (mconf.n_layers, mconf.descriptor_dim, mconf.mp, mconf.checkpointed) != (9, D, False, True) \
            or (int(econf.max_num_keypoints), bool(econf.force_num_keypoints)) != (MD16_N, True) \
            or int(conf["data"]["batch_size"]) != MD16_B:
        fail("16c: the configuration is not LightGlue 9 x 256 fp32 checkpointed on 2048 forced "
             "keypoints at 32 pairs")
    split = trainer.dataset.get_dataset("train")
    t0 = time.perf_counter()
    loader = trainer.dataset.get_data_loader("train", epoch=0)
    host = [next(loader)]
    loader_s = time.perf_counter() - t0
    del loader
    side = int(conf["data"]["preprocessing"]["resize"])
    shapes = {tuple(b[v]["image"].shape) for b in host for v in ("view0", "view1")}
    if shapes != {(MD16_B, side, side, 3)}:
        fail(f"16c: batches of {shapes}, expected ({MD16_B}, {side}, {side}, 3)")
    log(f"[md16c] {len(split)} pairs sampled from {len(split.scenes)} scene (3 bins); the loader "
        f"alone (the configuration's num_workers {conf['data'].get('num_workers', 0)}): "
        f"{MD16_B / loader_s:.2f} pairs/s ({MD16_B} pairs of 2 PNG reads at "
        f"{MD16_SIZE[0]} px, area resizes to {side}, 2 HDF5 depth reads and pads each, "
        f"{loader_s:.2f} s)")
    parts = loader_split(split)
    log("[md16c] the loader's parts, host ms a view (median of 4): "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))

    b = MD16_B
    while True:
        oom = None
        try:
            batches = [batch_to_device(batch_head(x, b), "cuda") for x in host]
            first = batches[0]
            with torch.no_grad():
                feats = {f"{k}{i}": t for i, v in enumerate(("view0", "view1"))
                         for k, t in trainer.model.extractor(first[v]).items()}
            if feats["keypoints0"].shape[1:] != (MD16_N, 2):
                fail(f"16c: keypoints {tuple(feats['keypoints0'].shape)}")
            n = MD16_GT_PAIRS
            gt = trainer.model.ground_truth(batch_head({**first, **feats}, n))
            cpu_gt = get_model("depth_matcher")(dict(conf["model"]["ground_truth"]),
                                                device="cpu")(
                batch_to_device(batch_head({**first, **feats}, n), "cpu"))
            for k in GT_KEYS:
                if not torch.equal(gt[k].cpu(), cpu_gt[k]):
                    fail(f"16c: {k} on the card differs from the CPU's on "
                         f"{int((gt[k].cpu() != cpu_gt[k]).sum())} entries")
            positives = float((gt["gt_matches0"] >= 0).sum(-1).float().mean())
            del feats, gt
            held = hold_first_step(trainer, lambda: md16_trainer(conf, flash=False), first,
                                   f"16c at {b} pairs")
            log(f"[md16c] {b} pairs x {MD16_N} keypoints at {side} x {side}: ground truth of "
                f"{n} pairs on the card equal to the CPU's ({', '.join(GT_KEYS)}), "
                f"{positives:.1f} positives a pair; " + held)
            ms, counts, peak, history = timed_steps(trainer, batches, MD16_STEPS)
            break
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e).splitlines()[0]
        # outside the handler, so that the failed step's tensors are released
        batches = first = None
        for param in trainer.model.parameters():
            param.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[md16c] batch {b} does not fit: {oom}")
        if b <= 4:
            fail("16c: no batch of 4 pairs or more fits")
        b //= 2
    per_step = {"K5": 18, "K6b": 18, "K7b self": 9, "K7b cross": 18}
    expect_counts(counts, MD16_STEPS, "16c", **{k.replace(" ", "_"): v
                                              for k, v in per_step.items()})
    log(f"[md16c] {MD16_STEPS} steps after a warm-up at {b} pairs: {ms:.2f} ms a step "
        f"({b * 1e3 / ms:.2f} pairs/s trained), peak {peak:.0f} MiB, launches a step "
        + ", ".join(f"{k} {v // MD16_STEPS}" for k, v in counts.items() if v)
        + "; losses total " + " ".join(f"{x['total']:.4f}" for x in history)
        + ("" if b == MD16_B else f" (batch {b}: {MD16_B} does not fit, logged above)"))
    del batches, first, host
    torch.cuda.empty_cache()
    # a step fed by the configuration's loader, from a fresh epoch
    loader = trainer.dataset.get_data_loader("train", epoch=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed = trainer.train_steps((batch_head(x, b) for x in loader), steps=1)
    torch.cuda.synchronize()
    fed_ms = (time.perf_counter() - t0) * 1e3
    del loader
    if not all(math.isfinite(x["total"]) for x in fed):
        fail(f"16c: a step fed by the loader: {fed}")
    log(f"[md16c] a step fed by the loader (its first batch included): {fed_ms:.2f} ms, against "
        f"{ms:.2f} alone")
    del trainer
    torch.cuda.empty_cache()
    return per_step, b


def check_md_triplet(conf):
    """16d: one `views: 3` batch of MD16_TRIPLETS triplets through
    `triplet_pipeline` (the recipe's extractor, LightGlue in inference): K1 /
    K2 / K4 launches of the stacked call; its matches against three
    two-view calls on the same pairs fed the triplet's own features (the
    view's `cache`), equal on at least 99%; and how far an extraction of
    each pair's 8 views alone agrees with the stacked one's 24 (the bf16
    convolutions' cuDNN algorithms follow the batch)."""
    import torch

    from gluefactory_tpu_torch.datasets.megadepth import MegaDepth
    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.utils.config import merge
    from gluefactory_tpu_torch.utils.tensor import batch_to_device
    from gluefactory_tpu_torch.weights import load_hermetic

    ds = MegaDepth(merge(conf["data"], {"views": 3, "batch_size": MD16_TRIPLETS}))
    data = batch_to_device(next(iter(ds.get_data_loader("train", epoch=0))), "cuda")
    mconf = merge(conf["model"], {"name": "triplet_pipeline",
                                  "matcher": {"is_training": False, "checkpointed": False}})
    if not mconf["allow_no_extract"]:
        fail("16d: the configuration does not allow skipping the extraction")
    state = load_hermetic(device="cuda")
    triplet = get_model("triplet_pipeline")(mconf, device="cuda").eval()
    triplet.load_state_dict(state)
    two = get_model("two_view_pipeline")(merge(mconf, {"name": "two_view_pipeline"}),
                                         device="cuda").eval()
    two.load_state_dict(state)
    feats = ("keypoints", "keypoint_scores", "descriptors", "keypoint_mask")
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        out = triplet(data)
        torch.cuda.synchronize()
        counts = read_counts()
        agree, kp_agree = [], []
        for i, (a, c) in enumerate(((0, 1), (0, 2), (1, 2))):
            suffix = ("0to1", "0to2", "1to2")[i]
            views = {f"view{j}": {**data[f"view{v}"], "cache": {
                k: out[f"{k}{j}_{suffix}"] for k in feats}} for j, v in enumerate((a, c))}
            ref = two(views)
            for k in ("matches0", "matches1"):
                agree.append(float((out[f"{k}_{suffix}"] == ref[k]).float().mean()))
            alone = two.extractor(data[f"view{a}"])["keypoints"]
            kp_agree.append(float((alone == out[f"keypoints0_{suffix}"]).all(-1).float().mean()))
    if counts != [9, 9, 1]:
        fail(f"16d: launches K1, K2, K4 {counts} for the stacked call, expected [9, 9, 1]")
    if min(agree) < 0.99:
        fail(f"16d: the stacked matches equal the two-view calls' on {min(agree):.4f} < 0.99")
    n_match = int((out["stacked"]["matches0"] >= 0).sum())
    side = data["view0"]["image"].shape[1]
    log(f"[md16d] {MD16_TRIPLETS} triplets ({3 * MD16_TRIPLETS} stacked pairs at {side} x {side}, "
        f"{MD16_N} keypoints) through triplet_pipeline: launches K1 {counts[0]}, K2 {counts[1]}, "
        f"K4 {counts[2]}; matches0 / matches1 equal to three two-view calls on the same features "
        f"on {min(agree):.4f}-{max(agree):.4f}; {n_match} matches; an extraction of {MD16_TRIPLETS}"
        f" views alone gives the stacked call's keypoints on {min(kp_agree):.4f}-"
        f"{max(kp_agree):.4f} (bf16 convolutions, algorithms by batch)")
    del triplet, two, data, out
    torch.cuda.empty_cache()
    return counts


def check_md_cached(conf, work, b):
    """16e: export_megadepth --method sp (the committed SuperPoint-open, full
    resolution) over the scene, the port's reader checking the file; then one
    step of `load_features.do: true` with `allow_no_extract` at batch b, in
    which the extractor runs no forward (the loader still reads and resizes
    every image: b is kept small)."""
    import numpy as np
    import torch

    from gluefactory_tpu_torch.scripts.export_megadepth import export_megadepth
    from gluefactory_tpu_torch.utils import hdf5
    from gluefactory_tpu_torch.utils.config import merge
    from gluefactory_tpu_torch.weights import HERMETIC

    out_dir = work / "exports"
    t0 = time.perf_counter()
    files = export_megadepth("sp", MD16_N, ["train"], out_dir, dict(conf["data"]), HERMETIC,
                             "cuda")
    export_s = time.perf_counter() - t0
    if [f.name for f in files] != [f"{MD16_SCENE}_sp_{MD16_N}.h5"]:
        fail(f"16e: the export wrote {files}")
    with hdf5.File(files[0], "r") as f:
        images = f[f"Undistorted_SfM/{MD16_SCENE}/images"]
        if len(images) != MD16_VIEWS:  # the views without depth or image are skipped
            fail(f"16e: {len(images)} image groups, expected {MD16_VIEWS}")
        grp = images["0.png"]
        kp, valid = np.asarray(grp["keypoints"]), np.asarray(grp["valid_depth_keypoints"])
        if kp.shape != (MD16_N, 2) or valid.dtype != bool or not valid.any() \
                or sorted(grp.keys()) != sorted(["keypoints", "keypoint_scores", "descriptors",
                                                 "keypoint_mask", "depth_keypoints",
                                                 "valid_depth_keypoints"]):
            fail(f"16e: group 0.png holds {sorted(grp.keys())}, keypoints {kp.shape}")
    cconf = merge(conf, {"data": {"batch_size": b, "load_features": {
        "do": True, "path": str(out_dir / f"{{scene}}_sp_{MD16_N}.h5"),
        "padding_length": MD16_N}}})
    if not cconf["model"]["allow_no_extract"]:
        fail("16e: the configuration does not allow skipping the extraction")
    trainer = md16_trainer(cconf)
    calls = []
    hook = trainer.model.extractor.register_forward_pre_hook(lambda m, a: calls.append(1))
    loader = trainer.dataset.get_data_loader("train", epoch=0)
    t0 = time.perf_counter()
    batch = next(loader)
    load_s = time.perf_counter() - t0
    del loader
    if batch["view0"]["cache"]["keypoints"].shape != (b, MD16_N, 2):
        fail(f"16e: cached keypoints {batch['view0']['cache']['keypoints'].shape}")
    torch.cuda.synchronize()
    reset_step_counts()
    t0 = time.perf_counter()
    history = trainer.train_steps([batch], steps=1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = step_counts()
    hook.remove()
    if calls or not math.isfinite(history[0]["total"]) or history[0]["skipped_nonfinite"]:
        fail(f"16e: {len(calls)} extractor forwards, losses {history[0]}")
    expect_counts(counts, 1, "16e", K5=18, K6b=18, K7b_self=9, K7b_cross=18)
    log(f"[md16e] export_megadepth --method sp: {MD16_VIEWS} views at full resolution in "
        f"{export_s:.2f} s ({MD16_VIEWS / export_s:.2f} views/s), read back by the port's reader; "
        f"a cached step at {b} pairs: no extractor forward, {step_ms:.2f} ms (its first step), "
        f"total {history[0]['total']:.4f}, {history[0]['num_matchable']:.1f} matchable a pair; "
        f"the loader's first batch in {load_s:.2f} s")
    del trainer, batch
    torch.cuda.empty_cache()


def check_mp_hdf5(work):
    """16f: one MP batch from an HDF5 file that the port's writer wrote (the
    `filename` source), through SuperPoint-open + LightGlue (the committed
    weights, fp32) on the card."""
    import numpy as np
    import torch

    from gluefactory_tpu_torch.datasets import get_dataset
    from gluefactory_tpu_torch.datasets.homographies import generate_texture_image
    from gluefactory_tpu_torch.models import get_model
    from gluefactory_tpu_torch.utils import hdf5
    from gluefactory_tpu_torch.utils.tensor import batch_to_device
    from gluefactory_tpu_torch.weights import load_hermetic

    rng = np.random.RandomState(11)
    with hdf5.File(work / "mp.h5", "w") as f:
        for i in range(MD16_MP_PAIRS):
            optical = generate_texture_image(rng, (320, 256))[..., 0]
            f.create_dataset(f"pair_{i:03d}/optical", data=optical)
            f.create_dataset(f"pair_{i:03d}/thermal", data=(1.0 - optical)[..., None])
    ds = get_dataset("mp_image_pairs")({"mp": {"filename": str(work / "mp.h5"),
                                               "train_fraction": 0.5},
                                        "test_batch_size": MD16_MP_PAIRS // 2})
    batch = batch_to_device(next(iter(ds.get_data_loader("test"))), "cuda")
    pipe = get_model("two_view_pipeline")({"extractor": {**MD_EXTRACTOR,
                                                         "max_num_keypoints": 512},
                                           "matcher": MD_LIGHTGLUE}, device="cuda").eval()
    pipe.load_state_dict(load_hermetic(device="cuda"))
    with torch.no_grad():
        out = pipe(batch)
    if batch["view0"]["image"].shape != (MD16_MP_PAIRS // 2, 256, 320, 1) or not torch_finite(
            out["matching_scores0"]):
        fail(f"16f: a batch of {tuple(batch['view0']['image'].shape)}")
    log(f"[md16f] the MP filename source: {MD16_MP_PAIRS} pairs written by the port's HDF5 "
        f"writer, a test batch of {batch['view0']['image'].shape[0]} at 256 x 320 through "
        f"SuperPoint-open + LightGlue: {int((out['matches0'] >= 0).sum())} matches, finite")


def run_megadepth_phase():
    """Phase 16: the MegaDepth training recipe. Returns the launches of the
    rows it adds."""
    import shutil

    from gluefactory_tpu_torch.utils.config import load_conf, merge

    work = ROOT / "outputs" / "chip_smoke_megadepth"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        check_hdf5_io(work)
        data = build_megadepth_scene(work / "data")
        conf = merge(load_conf(MD16_CONF), {"data": {"data_dir": str(data)}})
        per_step, b = check_md_training(conf)
        check_md_triplet(conf)
        check_md_cached(conf, work, min(b, MD16_CACHED_B))
        check_mp_hdf5(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[md16] phase {time.perf_counter() - t0:.1f} s")
    return {f"{k} recipe": v for k, v in per_step.items()}, b


# ---------------------------------------------------------------------- main
def main() -> int:
    global TRAIN_B
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--train-batch", type=int, default=TRAIN_B,
                        help="pairs a training step takes (default %(default)s)")
    # one rank of phase 13d, started by the script itself
    parser.add_argument("--ddp-rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--ddp-port", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--ddp-dir", type=str, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    TRAIN_B = args.train_batch
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
    if args.ddp_rank is not None:
        return ddp_rank_main(args.ddp_rank, args.ddp_port, args.ddp_dir)

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

    log(f"[time] phase 3 starts at {time.perf_counter() - t_start:.1f} s")
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
    lb_names = {"self": "fused_self_block", "cross": "fused_cross_block"}
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
    # the HPatches eval path (phase 8): fp32 blocks and assignment, one pair at a time
    # the adaptive eval run's compact width, 256 a side at 512 keypoints, beside the main shape
    for kind_, key, line in (("self", "K1", 326), ("cross", "K2", 393)):
        r = check_block(kind_, 2, 512, seed=30 + line, also=(256,), dt="float32")
        kernels.append(dict(name=f"{key} {lb_names[kind_]} (2, 512, 256) f32, HPatches eval",
                            key=f"{key} eval", route="cuda", source=src_blk,
                            replaces=f"{pal_blk}:{line}", **r))
    kernels.append(dict(
        name="K4 fused_log_assignment B=1 M=N=512 f32, HPatches eval", key="K4 eval",
        route="cuda", source=src_asg, replaces="gluefactory_tpu/ops/pallas_assignment.py:200,225",
        **check_assignment(1, 512, 512, seed=33)))
    # the MegaDepth-1500 benchmark (phase 15): fp32 blocks and assignment, one pair of
    # 2048 keypoints at a time (the JAX package's v2 blocks above 1024 keypoints)
    for kind_, key, lines, seed in (("self", "K1", "326,659", 40), ("cross", "K2", "393,717", 41)):
        r = check_block(kind_, 2, 2048, seed=seed, dt="float32")
        kernels.append(dict(name=f"{key} {lb_names[kind_]}(_v2) (2, 2048, 256) f32, "
                                 "MegaDepth-1500", key=f"{key} md", route="cuda", source=src_blk,
                            replaces=f"{pal_blk}:{lines}", **r))
    kernels.append(dict(
        name="K4 fused_log_assignment B=1 M=N=2048 f32, MegaDepth-1500", key="K4 md",
        route="cuda", source=src_asg, replaces="gluefactory_tpu/ops/pallas_assignment.py:200,225",
        **check_assignment(1, 2048, 2048, seed=43)))
    compact = check_assignment(1, 256, 256, seed=34)
    log(f"[kernel] K4 B=1 M=N=256 f32 (the adaptive HPatches run's compact width): max abs err "
        f"{compact['max_abs_err']:.3g}; {compact['ms']:.4f} ms")
    att = {**check_self_attention(20, bf16_rows=True),
           **check_cross_attention("stacked", 21, bf16_rows=True),
           **check_cross_attention("packed", 22, bf16_rows=True)}
    s2, n5, n6 = 2 * TRAIN_B, TRAIN_N, TRAIN_N1
    att_rows = [
        ("K5", f"K5 fused_attention_packed ({s2}, {n5}, 256) f32", "383"),
        ("K6b", f"K6b fused_cross_attention_stacked ({s2}, {n5}, 256) f32", "744"),
        ("K6a", f"K6a fused_cross_attention_packed B={TRAIN_B} M={n5} N={n6} f32", "691"),
        ("K7b self", f"K7b attention backward, self form ({s2}, {n5}, 256) f32", "222"),
        ("K7b cross", f"K7b attention backward, cross form B={TRAIN_B} {n5} x {n5} f32", "222"),
        # the `mp: True` step's (phase 13a)
        ("K5 bf16", f"K5 fused_attention_packed ({s2}, {n5}, 256) bf16, mp training", "383"),
        ("K6b bf16", f"K6b fused_cross_attention_stacked ({s2}, {n5}, 256) bf16, mp training",
         "744"),
        ("K6a bf16", f"K6a fused_cross_attention_packed B={TRAIN_B} M={n5} N={n6} bf16, mp "
                     "training", "691"),
        ("K7b self bf16", f"K7b attention backward, self form ({s2}, {n5}, 256) bf16, mp "
                          "training", "222"),
        ("K7b cross bf16", f"K7b attention backward, cross form B={TRAIN_B} {n5} x {n5} bf16, "
                           "mp training", "222"),
    ]
    for key, name, line in att_rows:
        kernels.append(dict(name=name, key=key, route="cuda", source=SRC_ATT,
                            replaces=f"{PAL_ATT}:{line}", **att[key]))
    # the MegaDepth recipe's training shape (phase 10): 2048 keypoints, 8 pairs
    att = {**check_self_attention(26, b=MD_B, n=MD_N),
           **check_cross_attention("stacked", 27, b=MD_B, n=MD_N)}
    s2 = 2 * MD_B
    for key, name, line in (
            ("K5", f"K5 fused_attention_packed ({s2}, {MD_N}, 256) f32, MegaDepth training", "383"),
            ("K6b", f"K6b fused_cross_attention_stacked ({s2}, {MD_N}, 256) f32, MegaDepth "
                    "training", "744"),
            ("K7b self", f"K7b attention backward, self form ({s2}, {MD_N}, 256) f32, MegaDepth "
                         "training", "222"),
            ("K7b cross", f"K7b attention backward, cross form B={MD_B} {MD_N} x {MD_N} f32, "
                          "MegaDepth training", "222")):
        kernels.append(dict(name=name, key=f"{key} 2048", route="cuda", source=SRC_ATT,
                            replaces=f"{PAL_ATT}:{line}", **att[key]))
    # the MegaDepth recipe at its published shape (phase 16): 2048 keypoints, 32 pairs
    att = {**check_self_attention(44, b=MD16_B, n=MD16_N),
           **check_cross_attention("stacked", 45, b=MD16_B, n=MD16_N)}
    s2 = 2 * MD16_B
    for key, name, line in (
            ("K5", f"K5 fused_attention_packed ({s2}, {MD16_N}, 256) f32, MegaDepth recipe",
             "383"),
            ("K6b", f"K6b fused_cross_attention_stacked ({s2}, {MD16_N}, 256) f32, MegaDepth "
                    "recipe", "744"),
            ("K7b self", f"K7b attention backward, self form ({s2}, {MD16_N}, 256) f32, "
                         "MegaDepth recipe", "222"),
            ("K7b cross", f"K7b attention backward, cross form B={MD16_B} {MD16_N} x {MD16_N} "
                          "f32, MegaDepth recipe", "222")):
        kernels.append(dict(name=name, key=f"{key} recipe", route="cuda", source=SRC_ATT,
                            replaces=f"{PAL_ATT}:{line}", **att[key]))
    # stage 2 of the hermetic loop (phase 12): 384 keypoints, 8 pairs. At this
    # shape a backward call's autograd and launch overhead outlasts its
    # kernels, so the kernel and the library call are timed by their kernels'
    # device time (the plain version, many small launches, by CUDA events)
    att = {**check_self_attention(28, b=S2_B, n=S2_N, timer=device_ms),
           **check_cross_attention("stacked", 29, b=S2_B, n=S2_N, timer=device_ms)}
    s2 = 2 * S2_B
    for key, name, line in (
            ("K5", f"K5 fused_attention_packed ({s2}, {S2_N}, 256) f32, stage 2", "383"),
            ("K6b", f"K6b fused_cross_attention_stacked ({s2}, {S2_N}, 256) f32, stage 2", "744"),
            ("K7b self", f"K7b attention backward, self form ({s2}, {S2_N}, 256) f32, stage 2",
             "222"),
            ("K7b cross", f"K7b attention backward, cross form B={S2_B} {S2_N} x {S2_N} f32, "
                          "stage 2", "222")):
        kernels.append(dict(name=name, key=f"{key} {S2_N}", route="cuda", source=SRC_ATT,
                            replaces=f"{PAL_ATT}:{line}", **att[key]))
    # the sift_tpu training recipe (phase 14a): 384 keypoints, 16 pairs, by device time as
    # stage 2's
    att = {**check_self_attention(37, b=SIFT_B, n=SIFT_N, timer=device_ms),
           **check_cross_attention("stacked", 38, b=SIFT_B, n=SIFT_N, timer=device_ms)}
    s2 = 2 * SIFT_B
    for key, name, line in (
            ("K5", f"K5 fused_attention_packed ({s2}, {SIFT_N}, 256) f32, sift_tpu training",
             "383"),
            ("K6b", f"K6b fused_cross_attention_stacked ({s2}, {SIFT_N}, 256) f32, sift_tpu "
                    "training", "744"),
            ("K7b self", f"K7b attention backward, self form ({s2}, {SIFT_N}, 256) f32, "
                         "sift_tpu training", "222"),
            ("K7b cross", f"K7b attention backward, cross form B={SIFT_B} {SIFT_N} x {SIFT_N} "
                          "f32, sift_tpu training", "222")):
        kernels.append(dict(name=name, key=f"{key} sift", route="cuda", source=SRC_ATT,
                            replaces=f"{PAL_ATT}:{line}", **att[key]))
    pal_conv = "gluefactory_tpu/ops/pallas_conv.py:222"
    kernels.append(dict(
        name="K8 block0_fused (8, 480, 640, 1) f32 -> (8, 240, 320, 64) bf16", key="K8",
        route="cuda", source="gluefactory_tpu_torch/csrc/block0_conv.cu", replaces=pal_conv,
        **check_block0(23)))
    k7a, _ = check_heads_attention(24)
    kernels.append(dict(
        name=f"K7a fused_attention ({HEADS_B}, {H}, {HEADS_N}, {DH}) f32", key="K7a",
        route="cuda", source=SRC_ATT, replaces=f"{PAL_ATT}:116", **k7a))
    # SuperGlue's training step (phase 13c): (32, 4, 512, 64), K7a and its backward
    sg_fwd, sg_bwd = check_heads_attention(35, b=TRAIN_B, n=TRAIN_N)
    kernels.append(dict(
        name=f"K7b attention backward, per-head form ({TRAIN_B}, {H}, {TRAIN_N}, {DH}) f32, "
             "SuperGlue training", key="K7b heads", route="cuda", source=SRC_ATT,
        replaces=f"{PAL_ATT}:222", **sg_bwd))
    kernels.append(dict(
        name=f"K7a fused_attention ({TRAIN_B}, {H}, {TRAIN_N}, {DH}) f32, SuperGlue training",
        key="K7a train", route="cuda", source=SRC_ATT, replaces=f"{PAL_ATT}:116", **sg_fwd))
    check_heads_k7b_bf16(36)
    k7c_row, k7c_launches = check_heads_cross(25)
    kernels.append(dict(
        name=f"K7c fused_cross_attention ({HEADS_B}, {H}, {HEADS_N}, {DH}) x same f32", key="K7c",
        route="cuda", source=SRC_ATT, replaces=f"{PAL_ATT}:567", **k7c_row))
    for k in kernels:
        log(f"[kernel] {k['name']}: matches its plain version within {k['tol']} "
            f"(max abs err {k['max_abs_err']:.3g})")

    log(f"[time] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
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

    log(f"[time] phase 5 starts at {time.perf_counter() - t_start:.1f} s")
    # 5. training
    per_step, fp32_ms, fp32_peak = run_training()
    step_ms = sum(k["ms"] * per_step[k["key"]] for k in kernels
                  if k.get("key") in per_step and k["key"] != "K6a")
    log(f"[train] attention kernels per step (kernel_ms x launches, m == n): {step_ms:.2f} ms")
    torch.cuda.empty_cache()

    log(f"[time] phase 6 starts at {time.perf_counter() - t_start:.1f} s")
    # 6. adaptive serving; 7. SuperGlue
    per_step["K8"] = run_adaptive_serving()
    torch.cuda.empty_cache()
    per_step["K7a"], sg_ms = run_superglue()
    per_step["K7c"] = k7c_launches
    k7a_ms = next(k["ms"] for k in kernels if k.get("key") == "K7a")
    log(f"[superglue] K7a kernels (kernel_ms x launches): {k7a_ms * per_step['K7a']:.2f} ms, "
        f"{k7a_ms * per_step['K7a'] / sg_ms:.3f} of the forward")
    torch.cuda.empty_cache()

    log(f"[time] phase 8 starts at {time.perf_counter() - t_start:.1f} s")
    # 8. the HPatches evaluation slice
    per_step.update(run_hpatches_eval())
    torch.cuda.empty_cache()

    log(f"[time] phase 9 starts at {time.perf_counter() - t_start:.1f} s")
    # 9. the training entry point
    run_training_entry()
    torch.cuda.empty_cache()

    log(f"[time] phase 10 starts at {time.perf_counter() - t_start:.1f} s")
    # 10. depth-supervised fine-tuning and the synthetic_pose benchmark
    per_step.update(run_depth_slice())
    torch.cuda.empty_cache()

    log(f"[time] phase 11 starts at {time.perf_counter() - t_start:.1f} s")
    # 11. the multispectral slice
    run_mp_slice()
    torch.cuda.empty_cache()

    log(f"[time] phase 12 starts at {time.perf_counter() - t_start:.1f} s")
    # 12. the hermetic loop: stage 1 -> stage 2 -> stage 3
    per_step.update(run_hermetic_loop())
    torch.cuda.empty_cache()

    log(f"[time] phase 13 starts at {time.perf_counter() - t_start:.1f} s")
    # 13. the training paths: mp, a trainable extractor, SuperGlue, two processes
    counts, mp_ms = run_training_paths(fp32_ms, fp32_peak)
    per_step.update(counts)
    torch.cuda.empty_cache()
    log(f"[time] phase 14 starts at {time.perf_counter() - t_start:.1f} s")
    # 14. the other extractors: sift_tpu training, cached features.do, ALIKED / DISK
    per_step.update(run_extractors_phase())
    torch.cuda.empty_cache()
    log(f"[time] phase 15 starts at {time.perf_counter() - t_start:.1f} s")
    # 15. the decoders, MegaDepth-1500 and ETH3D
    per_step.update(run_benchmarks_phase())
    torch.cuda.empty_cache()
    log(f"[time] phase 16 starts at {time.perf_counter() - t_start:.1f} s")
    # 16. the MegaDepth training recipe
    counts16, md_b = run_megadepth_phase()
    per_step.update(counts16)
    md_att = {k["key"]: k["ms"] * per_step[k["key"]] for k in kernels
              if k.get("key", "").endswith(" recipe")}
    log(f"[md16c] attention kernels a step at {md_b} pairs (kernel_ms of the 32-pair rows x "
        f"launches): {sum(md_att.values()):.2f} ms ("
        + ", ".join(f"{k} {v:.2f}" for k, v in md_att.items()) + ")")
    torch.cuda.empty_cache()
    mp_att = {k["key"]: k["ms"] * per_step[k["key"]] for k in kernels
              if k.get("key") in ("K5 bf16", "K6b bf16", "K7b self bf16", "K7b cross bf16")}
    log(f"[train13a] attention kernels a step (kernel_ms x launches): "
        f"{sum(mp_att.values()):.2f} ms of {mp_ms:.2f}, {sum(mp_att.values()) / mp_ms:.3f} of the "
        "step (" + ", ".join(f"{k} {v:.2f}" for k, v in mp_att.items()) + ")")
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
                    + f" torch_calls_ms {k['torch_ms']:.4f}")
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
