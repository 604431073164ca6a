"""Two-phase evaluation: export the predictions, then evaluate from the file
(counterpart of gluefactory_tpu/eval/eval_pipeline.py).

Predictions go to `predictions.h5`, per-pair results to `results.h5` (HDF5
in the JAX package's layout, through the port's `utils/hdf5.py`: one
dataset a result, strings as fixed-length bytes), summaries to
`summaries.json` and the configuration to `conf.json`, so that an
experiment directory of either package reads in the other. A configuration
that differs from the cached run's needs `overwrite` (model or data) or
`overwrite_eval` (eval). Both phases run on the pipeline's device, the card
unless the caller asks for the CPU; `timings` keeps each phase's seconds.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np

from ..models.base_model import resolve_device
from ..utils import hdf5
from ..utils.config import Config, merge, to_dict


def load_eval(dir_: Path):
    """(summaries, results) of a finished evaluation; string results come
    back as str (the file holds ASCII bytes, which the JAX `load_eval`
    returns as they are)."""
    dir_ = Path(dir_)
    with hdf5.File(dir_ / "results.h5", "r") as f:
        results = {k: np.asarray(f[k]) for k in f.keys()}
    results = {k: np.char.decode(v, "ascii") if v.dtype.kind == "S" else v
               for k, v in results.items()}
    with open(dir_ / "summaries.json") as f:
        summaries = json.load(f)
    return summaries, results


def save_eval(dir_: Path, summaries: dict, figures: dict, results: dict):
    """Write `results.h5`, `summaries.json` and each figure as `<name>.png`
    (an RGB array, `visualization.viz2d.save_plot`)."""
    dir_ = Path(dir_)
    dir_.mkdir(parents=True, exist_ok=True)
    with hdf5.File(dir_ / "results.h5", "w") as f:
        for k, v in results.items():
            arr = np.array(v)
            if not np.issubdtype(arr.dtype, np.number):
                arr = arr.astype("S")
            f.create_dataset(k, data=arr)
    s = {k: float(v) if np.isscalar(v) and not isinstance(v, str) else v
         for k, v in summaries.items()}
    with open(dir_ / "summaries.json", "w") as f:
        json.dump(s, f, indent=4, default=float)
    if figures:
        from ..visualization.viz2d import save_plot

        for fig_name, fig in figures.items():
            save_plot(dir_ / f"{fig_name}.png", fig)


def exists_eval(dir_: Path):
    dir_ = Path(dir_)
    return (dir_ / "results.h5").exists() and (dir_ / "summaries.json").exists()


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
