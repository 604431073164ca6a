"""Two-phase evaluation: export the predictions, then evaluate from the file
(counterpart of gluefactory_tpu/eval/eval_pipeline.py).

Predictions go to `predictions.npz`, per-pair results to `results.npz`,
summaries to `summaries.json` and the configuration to `conf.json`. A
configuration that differs from the cached run's needs `overwrite` (model or
data) or `overwrite_eval` (eval). Both phases run on the pipeline's device,
the card unless the caller asks for the CPU; `timings` keeps each phase's
seconds.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np

from ..models.base_model import resolve_device
from ..utils.config import Config, merge, to_dict


def load_eval(dir_: Path):
    """(summaries, results) of a finished evaluation."""
    dir_ = Path(dir_)
    with np.load(str(dir_ / "results.npz")) as f:
        results = {k: f[k] for k in f.files}
    with open(dir_ / "summaries.json") as f:
        summaries = json.load(f)
    return summaries, results


def save_eval(dir_: Path, summaries: dict, figures: dict, results: dict):
    dir_ = Path(dir_)
    dir_.mkdir(parents=True, exist_ok=True)
    np.savez(dir_ / "results.npz", **{k: np.asarray(v) for k, v in results.items()})
    s = {k: float(v) if np.isscalar(v) and not isinstance(v, str) else v
         for k, v in summaries.items()}
    with open(dir_ / "summaries.json", "w") as f:
        json.dump(s, f, indent=4, default=float)
    for fig_name, fig in figures.items():
        fig.savefig(dir_ / f"{fig_name}.png")


def exists_eval(dir_: Path):
    dir_ = Path(dir_)
    return (dir_ / "results.npz").exists() and (dir_ / "summaries.json").exists()


class EvalPipeline:
    """Subclasses define default_conf, export_keys and the two phases:
    `get_predictions(experiment_dir, model, overwrite)` and
    `run_eval(loader, pred_file)`."""

    default_conf: dict = {}
    export_keys: list = []
    optional_export_keys: list = []

    def __init__(self, conf=None, device: Any = "cuda"):
        self.conf = Config(merge({"data": {}, "model": {}, "eval": {}}, self.default_conf,
                                 conf or {}))
        self.device = resolve_device(device)
        self.timings: dict = {}
        self._init(self.conf)

    def _init(self, conf):
        pass

    def get_dataloader(self, data_conf=None):
        raise NotImplementedError

    def get_eval_data(self):
        """What the eval phase iterates: the data loader, unless a subclass
        gives the ground truth without the images."""
        return self.get_dataloader()

    def get_predictions(self, experiment_dir, model=None, overwrite=False):
        raise NotImplementedError

    def run_eval(self, loader, pred_file):
        raise NotImplementedError

    def save_conf(self, experiment_dir: Path, overwrite=False, overwrite_eval=False):
        """Refuse a changed configuration against cached outputs."""
        path = experiment_dir / "conf.json"
        conf = to_dict(self.conf)
        if path.exists():
            saved = json.loads(path.read_text())
            if (merge({}, saved.get("data", {})) != conf["data"]
                    or merge({}, saved.get("model", {})) != conf["model"]):
                assert overwrite, \
                    "Model or data conf changed against the cached predictions; pass overwrite=True"
            if merge({}, saved.get("eval", {})) != conf["eval"]:
                assert overwrite or overwrite_eval, "Eval conf changed; pass overwrite_eval=True"
        experiment_dir.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(conf, indent=2))

    def run(self, experiment_dir: Path, model=None, overwrite=False, overwrite_eval=False):
        """Export, then evaluate; returns (summaries, figures, results)."""
        experiment_dir = Path(experiment_dir)
        self.save_conf(experiment_dir, overwrite=overwrite, overwrite_eval=overwrite_eval)
        t0 = time.perf_counter()
        pred_file = self.get_predictions(experiment_dir, model=model, overwrite=overwrite)
        self.timings = {"export_s": time.perf_counter() - t0}
        figures = {}
        if not exists_eval(experiment_dir) or overwrite_eval or overwrite:
            t0 = time.perf_counter()
            summaries, figures, results = self.run_eval(self.get_eval_data(), pred_file)
            self.timings["eval_s"] = time.perf_counter() - t0
            save_eval(experiment_dir, summaries, figures, results)
        summaries, results = load_eval(experiment_dir)
        return summaries, figures, results


__all__ = ["EvalPipeline", "load_eval", "save_eval", "exists_eval"]
