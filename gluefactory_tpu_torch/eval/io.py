"""Evaluation command line (counterpart of gluefactory_tpu/eval/io.py).

Configurations are dicts: `--conf` names a JSON file (a benchmark's entry
under its `benchmarks` key is laid over its `model`), then `key=value`
overrides (values in JSON). `--checkpoint` names an `.npz` checkpoint;
`--device` is the card unless it says `cpu`.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..utils.config import merge, parse_dotlist
from .export_helper import load_model  # noqa: F401  (the JAX module's entry point)


def extract_benchmark_conf(conf: dict, benchmark: str) -> dict:
    """Lay conf["benchmarks"][benchmark] over the model conf."""
    conf = dict(conf)
    benchmarks = conf.pop("benchmarks", {})
    return merge({"model": conf.get("model", {})}, benchmarks.get(benchmark, {}))


def parse_eval_args(benchmark: str, args, default_conf: dict):
    """default < --conf file < --checkpoint < dotlist; returns (tag, conf)."""
    conf = {"data": {}, "model": {}, "eval": {}}
    if args.conf:
        path = Path(args.conf)
        conf = merge(conf, extract_benchmark_conf(json.loads(path.read_text()), benchmark))
        tag = args.tag or path.stem
    else:
        tag = args.tag or "default"
    if args.checkpoint:
        conf["model"]["checkpoint"] = args.checkpoint
        tag = args.tag or (f"{tag}_" if args.conf else "") + Path(args.checkpoint).stem
    return tag, merge(default_conf, conf, parse_dotlist(args.dotlist))


def get_eval_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tag", type=str, default=None)
    parser.add_argument("--conf", type=str, default=None, help="a JSON configuration file")
    parser.add_argument("--checkpoint", type=str, default=None, help="an .npz checkpoint")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--overwrite_eval", action="store_true")
    parser.add_argument("dotlist", nargs="*")
    return parser


__all__ = ["extract_benchmark_conf", "parse_eval_args", "get_eval_parser", "load_model"]
