"""Training command line (counterpart of gluefactory_tpu/train/__main__.py):

    python -m gluefactory_tpu_torch.train <experiment>
        [--conf superpoint-open+lightglue_homography] [--restore] [--overfit]
        [--profile] [--run_benchmarks] [--detect_anomaly] [--device cuda|cpu]
        [--distributed [--dist_backend nccl|gloo]] [key=value ...]

`--conf` is a JSON file or the name of one of the package's `configs/`;
the dotlist overrides it (values in JSON). The experiment lives in
GLUEFACTORY_TPU_TORCH_TRAINING/<experiment>; `--restore` resumes from its
last checkpoint. `--run_benchmarks` runs the config's `benchmarks` at the
end of every epoch. The trainer runs on the card unless `--device cpu`.

`--distributed` trains across processes started by torchrun (one a GPU):

    python -m torch.distributed.run --nproc_per_node N \
        -m gluefactory_tpu_torch.train <experiment> --conf ... --distributed

Each rank runs on `cuda:<LOCAL_RANK>` unless `--device` names a device,
with the `nccl` backend unless `--dist_backend gloo` (several ranks on one
GPU, or the CPU). Without torchrun's environment it raises
(`train/distributed.py`).
"""

from __future__ import annotations

import argparse
import logging

import torch

from ..utils.config import load_conf, merge, parse_dotlist
from ..utils.experiments import experiment_dir
from .distributed import init_distributed
from .trainer import Trainer


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("experiment")
    parser.add_argument("--conf", type=str, default=None)
    parser.add_argument("--restore", action="store_true")
    parser.add_argument("--overfit", action="store_true")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"), default="nccl")
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--run_benchmarks", action="store_true")
    parser.add_argument("--device", type=str, default=None)
    parser.add_argument("dotlist", nargs="*")
    args = parser.parse_intermixed_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(name)s %(levelname)s] %(message)s")

    device = args.device or "cuda"
    if args.distributed:
        device = init_distributed(args.dist_backend, args.device)
        if torch.distributed.get_rank() != 0:  # rank 0 logs, as it writes
            logging.getLogger().setLevel(logging.WARNING)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    conf = load_conf(args.conf) if args.conf else {}
    conf = merge(conf, parse_dotlist(args.dotlist))
    if args.run_benchmarks and conf.get("benchmarks"):
        conf = merge(conf, {"train": {"benchmarks": conf["benchmarks"]}})
    if args.overfit:
        conf = merge(conf, {"train": {"overfit": True}})
    if args.profile:
        conf = merge(conf, {"train": {"profile": True}})

    try:
        trainer = Trainer(conf, args.experiment, experiment_dir(args.experiment), device=device)
        trainer.build(restore=args.restore)
        trainer.train()
    finally:
        if args.distributed:
            torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
