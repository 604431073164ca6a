"""The port's `synthetic_pose` eval phase against the JAX package's, on the
CPU, at the benchmark's configuration (scripts/train_depth_finetune.py::
evaluate: 20 test pairs at 640 x 480, 512 keypoints, detection threshold
0.005, LightGlue at filter threshold 0.1, RANSAC at 1 px).

For each weights file (homography-only, depth-fine-tuned):
  1. JAX's export and eval phase (its estimator's draws, PRNGKey(0));
  2. the port's eval phase on JAX's predictions, fed the same JAX draws:
     per-pair rel_pose_error beside JAX's, and both mAAs; beside them JAX's
     eval phase with view 0's keypoints scaled by float32(1 + 1e-7), one
     ulp: how far JAX's own estimate moves per pair at that change;
  3. both eval phases on JAX's predictions under the draws of PRNGKey(s),
     s = 1 ... --seeds - 1: the spread of the mAA that the draws alone make;
  4. the port's export on the CPU and its eval phase fed the JAX draws, and
     under the port's own generator (seed 0 on the CPU).

Run (a few minutes; it imports both packages, so it lives with the tests):

    JAX_PLATFORMS=cpu python tests/torch_relpose_parity.py [--pairs 20]
        [--seeds 8] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import tempfile
import time
from pathlib import Path

import h5py
import jax
import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gluefactory_tpu.estimators.relative_pose import jax_ransac  # noqa: E402
from gluefactory_tpu.eval.synthetic_pose import SyntheticPosePipeline as JPipeline  # noqa: E402
from gluefactory_tpu_torch.estimators import ransac as port_ransac  # noqa: E402
from gluefactory_tpu_torch.eval.synthetic_pose import SyntheticPosePipeline  # noqa: E402
from gluefactory_tpu_torch.utils.tools import AUCMetric  # noqa: E402

WEIGHTS = {"homography_only": "sp_open_lg.npz", "depth_finetuned": "sp_open_lg_depth.npz"}
K_HYP = 8192


def conf(weights, args):
    return {
        "data": {"image_size": [640, 480], "test_size": args.pairs},
        "eval": {"ransac_th": 1.0},
        "model": {
            "extractor": {"name": "superpoint_open", "max_num_keypoints": 512,
                          "detection_threshold": 0.005, "dtype": None},
            "matcher": {"name": "lightglue", "filter_threshold": 0.1, "collect_layers": False},
            "checkpoint": str(REPO / "weights" / "hermetic" / weights),
        },
    }


@functools.lru_cache(maxsize=8)
def jax_noise(n, seed):
    """The Gumbel draws of JAX's ransac_relative_pose for PRNGKey(seed): the
    uniform round's, then the guided round's."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(sub, (K_HYP, n)))))
    return tuple(out)


def within(a, b, tol=0.5):
    a, b = np.array(a), np.array(b)
    return int(((np.abs(a - b) <= tol) | (np.isinf(a) & np.isinf(b))).sum())


def maa(errors):
    return float(np.mean(AUCMetric([5, 10, 20], list(errors)).compute()))


def jax_eval(pipe, pred_file, seed):
    """JAX's eval phase with its estimator seeded by `seed`."""
    opts = jax_ransac.JaxRansacRelativePose.default_conf["options"]
    old, opts["seed"] = opts["seed"], seed
    try:
        _, _, r = pipe.run_eval(pipe.get_dataloader(), pred_file)
    finally:
        opts["seed"] = old
    return [float(e) for e in r["rel_pose_error_1.0"]]


def port_eval(pipe, pred_file, seed):
    """The port's eval phase fed the JAX draws of PRNGKey(seed); seed None
    keeps the port's own generator."""
    if seed is None:
        _, _, r = pipe.run_eval(pipe.get_eval_data(), pred_file)
    else:
        calls = []

        def draws(shape, generator, device):
            calls.append(shape)
            return jax_noise(shape[1], seed)[(len(calls) - 1) % 2].to(device)

        old, port_ransac.gumbel = port_ransac.gumbel, draws
        try:
            _, _, r = pipe.run_eval(pipe.get_eval_data(), pred_file)
        finally:
            port_ransac.gumbel = old
    return [float(e) for e in r["rel_pose_error_1.0"]]


def scaled_h5(h5_file, out_file, scale):
    """A copy of JAX's predictions with every keypoints0 scaled in float32."""
    with h5py.File(str(h5_file), "r") as f, h5py.File(str(out_file), "w") as g:
        def copy(name, obj):
            if isinstance(obj, h5py.Dataset):
                x = np.asarray(obj)
                if name.endswith("/keypoints0"):
                    x = x * np.float32(scale)
                g.create_dataset(name, data=x)
        f.visititems(copy)


def h5_to_npz(h5_file, npz_file):
    with h5py.File(str(h5_file), "r") as f:
        arrays = {}
        f.visititems(lambda name, obj: arrays.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    np.savez(npz_file, **arrays)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs", type=int, default=20)
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory(prefix="relpose_parity_") as tmp:
        report = run(Path(tmp), args)
    text = json.dumps(report, indent=1)
    if args.out:
        args.out.write_text(text)
    print(text)


def run(root, args):
    report = {}
    for tag, weights in WEIGHTS.items():
        t0 = time.perf_counter()
        c = conf(weights, args)
        jpipe, ppipe = JPipeline(c), SyntheticPosePipeline(c, device="cpu")
        jsum, _, jres = jpipe.run(root / tag / "jax")
        h5_to_npz(root / tag / "jax" / "predictions.h5", root / tag / "jax_predictions.npz")
        jpred = root / tag / "jax_predictions.npz"
        j0 = [float(e) for e in jres["rel_pose_error_1.0"]]
        p0 = port_eval(ppipe, jpred, 0)
        scaled_h5(root / tag / "jax" / "predictions.h5", root / tag / "jax_scaled.h5", 1 + 1e-7)
        j_ulp = jax_eval(jpipe, root / tag / "jax_scaled.h5", 0)
        spread = {"jax": [maa(j0)], "port": [maa(p0)]}
        for s in range(1, args.seeds):
            spread["jax"].append(maa(jax_eval(jpipe, root / tag / "jax" / "predictions.h5", s)))
            spread["port"].append(maa(port_eval(ppipe, jpred, s)))
        psum, _, _ = ppipe.run(root / tag / "port")
        ppred = root / tag / "port" / "predictions.npz"
        own_export = {"jax_draws": port_eval(ppipe, ppred, 0),
                      "own_generator": port_eval(ppipe, ppred, None)}
        report[tag] = {
            "jax_summaries": jsum,
            "port_cpu_summaries": psum,
            "per_pair_jax": j0,
            "per_pair_port_on_jax_predictions": p0,
            "per_pair_jax_one_ulp": j_ulp,
            "pairs_within_0.5deg": {"port": within(p0, j0), "jax_one_ulp": within(j_ulp, j0)},
            "mAA_jax": maa(j0),
            "mAA_port_on_jax_predictions": maa(p0),
            "mAA_by_seed": spread,
            "port_export": {k: {"per_pair": v, "mAA": maa(v)} for k, v in own_export.items()},
            "seconds": time.perf_counter() - t0,
        }
        print(tag, json.dumps({k: v for k, v in report[tag].items()
                               if k.startswith(("mAA", "pairs")) or k == "seconds"}),
              flush=True)
    return report


if __name__ == "__main__":
    main()
