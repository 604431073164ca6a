"""Experiment and checkpoint management (counterpart of
gluefactory_tpu/utils/experiments.py).

Layout: TRAINING_PATH/<experiment>/
    checkpoint_<epoch>_<iter>/             state.pt, meta.json
    checkpoint_<epoch>_<iter>_interrupted/ written on SIGINT, never listed
    checkpoint_best/                       a copy of the best checkpoint
    conf.json

`state.pt` is a `torch.save`d dict: the model's state dict (`model`), the
optimizer's (`optimizer`: count and Adam moments) and `step`. `meta.json`
holds the resolved conf, the epoch, the iteration, the validation results
(`eval`) and the best value so far (`best_eval`). Only the last
`keep_last_checkpoints` are kept. The JAX package writes orbax checkpoints,
which the port cannot read without orbax; the path from JAX parameters is
the weight bridge (`weights.params_from_jax`, and `.npz` artifacts).
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Any

import torch

from ..settings import TRAINING_PATH
from .config import merge, save_conf

STATE, META = "state.pt", "meta.json"


def experiment_dir(experiment: str) -> Path:
    return Path(TRAINING_PATH) / experiment


def list_checkpoints(dir_: Path):
    """Sorted ((epoch, iter), path) of the clean checkpoints of a directory."""
    checkpoints = []
    for p in Path(dir_).glob("checkpoint_*_*"):
        m = re.match(r"checkpoint_(\d+)_(\d+)$", p.name)
        if m and p.is_dir():
            checkpoints.append(((int(m.group(1)), int(m.group(2))), p))
    return sorted(checkpoints)


def get_last_checkpoint(experiment: str) -> Path:
    cps = list_checkpoints(experiment_dir(experiment))
    if not cps:
        raise FileNotFoundError(f"No checkpoints in {experiment}")
    return cps[-1][1]


def get_best_checkpoint(experiment: str) -> Path:
    p = experiment_dir(experiment) / "checkpoint_best"
    if not p.exists():
        raise FileNotFoundError(f"No best checkpoint in {experiment}")
    return p


def delete_old_checkpoints(dir_: Path, num_keep: int):
    cps = list_checkpoints(dir_)
    for _, p in cps[: max(len(cps) - num_keep, 0)]:
        shutil.rmtree(p)


def is_num(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def save_experiment(experiment: str, state: dict, conf, epoch: int, iter_i: int,
                    results: dict | None = None, best_eval: float | None = None,
                    is_best: bool = False, num_keep: int = 5,
                    interrupted: bool = False) -> Path:
    """Write checkpoint_<epoch>_<iter> (and its copy checkpoint_best when
    `is_best`), then prune to the last `num_keep`. An `interrupted`
    checkpoint gets the `_interrupted` suffix, which `list_checkpoints`
    skips: `--restore` resumes from the last clean one."""
    dir_ = experiment_dir(experiment)
    dir_.mkdir(parents=True, exist_ok=True)
    path = dir_ / f"checkpoint_{epoch}_{iter_i}{'_interrupted' if interrupted else ''}"
    path.mkdir(exist_ok=True)
    torch.save(state, path / STATE)
    meta = {
        "conf": merge({}, conf),
        "epoch": epoch,
        "iter": iter_i,
        "eval": {k: float(v) for k, v in (results or {}).items() if is_num(v)},
        "best_eval": None if best_eval is None else float(best_eval),
    }
    (path / META).write_text(json.dumps(meta, indent=2))
    save_conf(conf, dir_ / "conf.json")
    if is_best:
        best = dir_ / "checkpoint_best"
        shutil.rmtree(best, ignore_errors=True)
        shutil.copytree(path, best)
    delete_old_checkpoints(dir_, num_keep)
    return path


def load_checkpoint(path: Path, device: Any = "cpu"):
    """(state, meta) of a checkpoint directory, the tensors on `device`."""
    path = Path(path)
    state = torch.load(path / STATE, map_location=device, weights_only=True)
    return state, json.loads((path / META).read_text())


def load_experiment(experiment: str, conf_overrides=None, get_last: bool = False,
                    device: Any = "cuda"):
    """The model of an experiment's best (or last) checkpoint, rebuilt from
    the conf stored with it; returns (model, state, meta)."""
    from ..models import get_model

    path = get_last_checkpoint(experiment) if get_last else get_best_checkpoint(experiment)
    state, meta = load_checkpoint(path, device=device)
    conf = merge(meta["conf"], conf_overrides or {})
    model = get_model(conf["model"]["name"])(conf["model"], device=device)
    model.load_state_dict(state["model"], strict=True)
    return model, state, meta


__all__ = [
    "experiment_dir", "list_checkpoints", "get_last_checkpoint", "get_best_checkpoint",
    "delete_old_checkpoints", "save_experiment", "load_checkpoint", "load_experiment", "is_num",
]
