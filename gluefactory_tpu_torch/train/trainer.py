"""Training runtime (counterpart of gluefactory_tpu/train/trainer.py).

`Trainer(conf, experiment, output_dir)` builds the model, the optimizer and
the step of a configuration ({"data", "model", "train"}, e.g.
`load_conf("superpoint-open+lightglue_homography")`); `build(restore)`
builds the dataset, seeds the parameters from `train.load_experiment` and
resumes from the experiment's last checkpoint; `train()` runs the epochs:

  - each epoch calls the dataset's `sample_new_items` (if it has one) and
    shuffles the train split by `seed + epoch` (`overfit`: one batch);
  - a step is `train.step.make_train_step`: forward, loss, backward, the
    non-finite veto, the clip and Adam;
  - every `log_every_iter` steps the losses go to the log and to
    `events.jsonl` (`train/...`); every `log_grad_every_iter` the gradient
    norms and the histogram of the per-module norms;
  - every `eval_every_iter` steps and at the end of an epoch, validation
    (`do_evaluation`): the model with its training configuration and its
    loss on the val split under `torch.no_grad()` (the training forward:
    the unfused layers with the attention forward kernels, no backward),
    streaming means, `median_metrics`, and with `pr_curves` the average
    precision of the predicted matches (`val/match_AP`, IGNORE labels
    masked) and the figure of its recall / precision curve (`val/match_pr`);
    with `plot: [n_pairs, "module.function"]` the function's figures of the
    first validation batch (`visualization.visualize_batch.make_match_figures`:
    `matching_i`); figures go to `<output_dir>/figures/<name>_<step>.png`, and
    a figure that fails is logged and training goes on, as in the JAX
    trainer; a new best `best_key` value writes `checkpoint_best`. A batch-mode BatchNorm normalises validation batches
    with their own statistics, and its running statistics are put back
    afterwards, as the JAX trainer discards that update;
  - every `save_every_iter` steps and at the end of an epoch a checkpoint
    (pruned to `keep_last_checkpoints`), then `train.benchmarks` (hpatches,
    synthetic, synthetic_pose) through `eval.run_benchmark` on the live
    weights;
  - SIGINT finishes the step, writes an `_interrupted` checkpoint and
    returns; `profile` traces the steps [profile_start, profile_end) with
    `torch.profiler` into `<output_dir>/profile`.

`train_steps(batches, steps)` takes optimizer steps on any iterable of
batches without the epoch loop. The model is any registered model with a
`loss`: a two-view pipeline, or a bare extractor (SuperPoint-open on
SyntheticShapes, `configs/superpoint-open_synthetic_pretrain.json`), whose
checkpoint a later experiment grafts into its `extractor` through
`load_experiment` and `load_experiment_prefix`. The step has no
randomness (no dropout, no augmentation on the device); model
initialisation draws from the model's own seeded `torch.Generator`.

Across processes (a default process group of W > 1 ranks, set up by
`train.distributed.init_distributed` before the trainer) every rank runs
this trainer on its own device: rank 0's parameters and buffers are
broadcast after the model is built and again after `build`; each rank
loads its slice of every global batch; the step all-reduces
(`train/step.py`); validation gathers every rank's per-pair values in rank
order, so its means, medians and PR curve are the one-process ones (a val
batch that the ranks do not divide is evaluated whole on every rank, as
the JAX package replicates it); only rank 0 writes the configuration, the
summaries, the checkpoints and runs the benchmarks.
"""

from __future__ import annotations

import importlib
import logging
import shutil
import signal
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from ..datasets import get_dataset
from ..geometry.gt_generation import gt_matches_from_homography
from ..models import get_model
from ..utils.config import Config, merge, save_conf, to_dict
from ..utils.experiments import (
    get_best_checkpoint,
    get_last_checkpoint,
    is_num,
    load_checkpoint,
    save_experiment,
)
from ..utils.summary import ExperimentWriter
from ..utils.tensor import batch_to_device
from ..utils.tools import AverageMetric, MedianMetric, PRMetric, set_seed
from ..weights import load_hermetic
from . import distributed
from .step import TrainState, make_optimizer, make_train_step, restore_buffers

logger = logging.getLogger(__name__)
PACKAGE = Path(__file__).resolve().parent.parent

default_train_conf = {
    "seed": 0,
    "epochs": 1,
    "optimizer": "adam",
    "lr": 1e-4,
    "lr_schedule": {"type": None, "start": 0, "exp_div_10": 1e5},
    "grad_clip": 10.0,
    "eval_every_iter": 1000,
    "save_every_iter": 5000,
    "log_every_iter": 100,
    # every N iterations: the pre-clip gradient norm, the per-module norms
    # and their histogram; None/0 leaves them out of the step
    "log_grad_every_iter": None,
    "keep_last_checkpoints": 5,
    "best_key": "loss/total",
    "overfit": False,
    "median_metrics": [],
    "pr_curves": False,
    "profile": False,
    "profile_start": 10,
    "profile_end": 15,
    # {benchmark name: benchmark conf}, run at the end of every epoch
    "benchmarks": {},
    "plot": None,
    # seed the parameters from the best checkpoint of another experiment, or
    # from an .npz artifact (a path, else one under the repository): tensors
    # of the same name and shape are copied, the rest stay fresh
    "load_experiment": None,
    # the module of this model the loaded checkpoint is (e.g. "extractor")
    "load_experiment_prefix": None,
}


def pr_curve(labels: np.ndarray, scores: np.ndarray):
    """(recall, precision, average precision) of binary labels ranked by
    descending score, as the JAX trainer computes `match_AP` and its curve."""
    order = np.argsort(-scores)
    tp = np.cumsum(labels[order])
    precision = tp / (np.arange(len(tp)) + 1)
    recall = tp / max(labels.sum(), 1)
    return recall, precision, float(np.sum(precision * labels[order]) / max(labels.sum(), 1))


def graft_state(model: torch.nn.Module, loaded: Mapping, prefix: str | None = None):
    """Copy the tensors of `loaded` whose name (under `prefix`, a module
    path like "extractor") and shape match into the model; returns
    (copied, names kept fresh)."""
    if prefix:
        dotted = ".".join(str(prefix).split("/")) + "."
        loaded = {dotted + k: v for k, v in loaded.items()}
    own = model.state_dict()
    take = {k: loaded[k] for k, v in own.items()
            if k in loaded and tuple(loaded[k].shape) == tuple(v.shape)}
    model.load_state_dict({**own, **take})
    return len(take), [k for k in own if k not in take]


class Trainer:
    def __init__(self, conf: Mapping, experiment: str | None = None,
                 output_dir: str | Path | None = None, device: Any = "cuda", mark=None):
        self.conf = Config(merge({"train": default_train_conf}, conf))
        self.experiment = experiment
        self.output_dir = Path(output_dir) if output_dir else None
        self.rank, self.world = distributed.rank(), distributed.world_size()
        self.is_main = self.rank == 0
        set_seed(self.conf.train.seed)
        model_conf = self.conf.model
        self.model = get_model(model_conf.name)(model_conf, device=device)
        self.device = self.model.device
        self.model.train()
        self._sync_state()
        params = {k: p for k, p in self.model.named_parameters() if p.requires_grad}
        self.state = TrainState(
            step=0, params=params, optimizer=make_optimizer(self.conf.train, params))
        grad_every = self.conf.train.get("log_grad_every_iter") or 0
        self.train_step = make_train_step(self.model, mark, grad_stats=grad_every > 0)
        self.dataset = self.writer = self.best_eval = None
        self.start_epoch = 0
        self.stop_requested = False

    # ------------------------------------------------------------------ state
    def _sync_state(self) -> None:
        """Rank 0's parameters and buffers on every rank (across processes)."""
        if self.world > 1:
            distributed.broadcast_state(self.model)

    def load_weights(self, state_dict: Mapping, strict: bool = True):
        """Initialise the model from a state dict (e.g. `load_hermetic()`)."""
        return self.model.load_state_dict(state_dict, strict=strict)

    def checkpoint_state(self) -> dict:
        """Parameters and buffers, optimizer state and step."""
        return {"step": self.state.step, "model": self.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict()}

    def load_state(self, state: Mapping) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.state.optimizer.load_state_dict(state["optimizer"])
        self.state.step = int(state["step"])

    def save(self, path: str | Path) -> None:
        torch.save(self.checkpoint_state(), str(path))

    def restore(self, path: str | Path) -> None:
        self.load_state(torch.load(str(path), map_location=self.device, weights_only=True))

    # ------------------------------------------------------------------ setup
    def build(self, restore: bool = False):
        """The dataset, the fine-tune initialisation, the resumed state and
        the summary writer."""
        conf = self.conf
        set_seed(conf.train.seed)
        self.dataset = get_dataset(conf.data.name)(to_dict(conf.data), device=self.device)
        if conf.train.get("load_experiment"):
            src = str(conf.train.load_experiment)
            if src.endswith(".npz"):  # a committed artifact, e.g. weights/hermetic/*.npz
                path = Path(src) if Path(src).exists() else PACKAGE.parent / src
                loaded = {"model": load_hermetic(path, device=self.device)}
            else:
                loaded, _ = load_checkpoint(get_best_checkpoint(src), device=self.device)
            n, fresh = graft_state(self.model, loaded["model"],
                                   conf.train.get("load_experiment_prefix"))
            logger.info("Fine-tune init from '%s': %d tensors copied%s", src, n,
                        f", {len(fresh)} kept fresh (e.g. {fresh[:3]})" if fresh else "")
        self.start_epoch, self.best_eval = 0, None
        if restore:
            path = get_last_checkpoint(self.experiment)
            state, meta = load_checkpoint(path, device=self.device)
            self.load_state(state)
            self.start_epoch = int(meta["epoch"]) + 1
            self.best_eval = meta.get("best_eval")
            logger.info("Restored checkpoint %s (epoch %d)", path, self.start_epoch)
        self._sync_state()
        self.writer = ExperimentWriter(self.output_dir) if (
            self.output_dir and self.is_main) else None

    # ------------------------------------------------------------- validation
    @torch.no_grad()
    def do_evaluation(self, epoch: int, it: int) -> dict:
        conf = self.conf.train
        aggs = defaultdict(AverageMetric)
        medians = {k: MedianMetric() for k in conf.median_metrics}
        pr = PRMetric() if conf.get("pr_curves") else None
        # the configuration's mode (a batch-mode BatchNorm normalises with the
        # batch's statistics), but the running statistics are put back after
        buffers = list(self.model.buffers())
        saved = [b.clone() for b in buffers]
        try:
            self._evaluate_batches(epoch, it, aggs, medians, pr)
        finally:
            restore_buffers(buffers, saved)
        results = {k: m.compute() for k, m in aggs.items()}
        results.update({f"{k}_median": m.compute() for k, m in medians.items()})
        if pr is not None:
            labels, scores = pr.compute()
            if len(labels) > 0:
                recall, precision, results["match_AP"] = pr_curve(labels, scores)
                if self.writer is not None:
                    from ..visualization.viz2d import plot_curve

                    self.writer.figure(it, "val/match_pr", plot_curve(recall, precision))
        logger.info("[Validation epoch %d iter %d] %s", epoch, it,
                    {k: round(float(v), 4) for k, v in results.items() if is_num(v)})
        if self.writer is not None:
            self.writer.scalars(it, results, prefix="val/")
        return results

    def _plot_batch(self, pred, data, it: int) -> None:
        """The `train.plot` hook on the first validation batch."""
        n_pairs, fn_path = self.conf.train.plot
        mod_path, fn_name = str(fn_path).rsplit(".", 1)
        try:
            fn = getattr(importlib.import_module(mod_path), fn_name)
            for name, fig in fn(pred, data, n_pairs=int(n_pairs)).items():
                self.writer.figure(it, name, fig)
        except Exception as e:  # noqa: BLE001 - a figure must not stop training
            logger.warning("plot hook failed: %s", e)

    def _evaluate_batches(self, epoch: int, it: int, aggs, medians, pr) -> None:
        # across processes each rank takes its slice of a val batch, and the
        # pairs are gathered; a batch that the ranks do not divide is
        # evaluated whole on every rank (the JAX package replicates it)
        sharded = self.world > 1 and self.dataset.batch_size("val") % self.world == 0
        shard = (self.rank, self.world) if sharded else (0, 1)
        for count, batch in enumerate(self.dataset.get_data_loader("val", epoch=epoch,
                                                                   shard=shard)):
            data = batch_to_device(batch, self.device)
            pred = self.model(data)
            if count == 0 and self.conf.train.plot and self.writer is not None:
                self._plot_batch(pred, data, it)
            losses, metrics = self.model.loss(pred, data)
            values = {k: v.detach().float().cpu().numpy().reshape(-1)
                      for k, v in {**losses, **metrics}.items()}
            matches = None
            if pr is not None:
                gt0 = data.get("gt_matches0")
                if gt0 is None and "H_0to1" in data and "keypoints0" in pred:
                    gt0 = gt_matches_from_homography(pred["keypoints0"], pred["keypoints1"],
                                                     data["H_0to1"], pos_th=3.0)["matches0"]
                if gt0 is not None:
                    matches = (pred["matches0"].cpu().numpy(), gt0.cpu().numpy(),
                               pred["matching_scores0"].cpu().numpy())
            if sharded:  # every rank's pairs, in the one-process order
                parts = distributed.all_gather((values, matches))
                values = {k: np.concatenate([p[0][k] for p in parts]) for k in values}
                if matches is not None:
                    matches = [np.concatenate(x) for x in zip(*(p[1] for p in parts))]
            if matches is not None:
                m0, gt0, scores = matches
                # ambiguous ground truth (IGNORE, -2) leaves the metric
                pr.update(m0 == gt0, scores, mask=(m0 >= 0) & (gt0 != -2))
            for k, arr in values.items():
                aggs[f"loss/{k}" if k in losses else k].update(arr)
                if k in medians:
                    medians[k].update(arr)

    # ------------------------------------------------------------------ train
    def train_steps(self, batches: Iterable[Mapping], steps: int | None = None) -> list:
        """Take one optimizer step per batch, at most `steps`. Returns the
        losses of every step as dicts of floats (fetched at the end: the only
        host synchronisation inside a step is the veto's)."""
        every = self.conf.train.log_every_iter
        history, t_last = [], time.perf_counter()
        for i, batch in enumerate(batches):
            if steps is not None and i >= steps:
                break
            self.state, losses = self.train_step(self.state, batch_to_device(batch, self.device))
            history.append(losses)
            if every and self.state.step % every == 0:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                logger.info("[it %d] loss %.4f (%.2f it/s) %s", self.state.step,
                            float(losses["total"]), every / max(dt, 1e-6),
                            {k: round(float(v), 3) for k, v in losses.items() if k != "total"})
        return [{k: float(v) for k, v in losses.items()} for losses in history]

    def _snapshot_source(self) -> None:
        """Pin the code: a copy of the package's source in the experiment."""
        dst = self.output_dir / "source" / PACKAGE.name
        if not dst.exists():
            shutil.copytree(PACKAGE, dst, ignore=shutil.ignore_patterns(
                "__pycache__", "*.pyc", "_build", "outputs"))

    def train(self):
        """Run the epochs from `start_epoch` to `train.epochs`; returns the
        state."""
        conf = self.conf.train
        if self.dataset is None or self.experiment is None:
            raise RuntimeError("train() needs an experiment name and build()")
        if self.output_dir and self.is_main:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            save_conf(self.conf, self.output_dir / "config.json")
            self._snapshot_source()

        def on_sigint(signum, frame):
            if self.stop_requested:
                raise KeyboardInterrupt
            logger.info("SIGINT: finishing iteration, saving, then exiting.")
            self.stop_requested = True

        old_handler = signal.signal(signal.SIGINT, on_sigint)
        it_total = self.state.step
        grad_every = conf.get("log_grad_every_iter") or 0
        profiler = None
        try:
            for epoch in range(self.start_epoch, conf.epochs):
                if hasattr(self.dataset, "sample_new_items"):
                    self.dataset.sample_new_items(conf.seed + epoch)
                shard = (self.rank, self.world)
                if conf.overfit:
                    loader = self.dataset.get_overfit_loader("train", shard=shard)
                else:
                    loader = self.dataset.get_data_loader("train", epoch=epoch, shuffle=True,
                                                          shard=shard)
                t_last = time.perf_counter()
                for batch in loader:
                    if conf.profile and it_total == conf.profile_start:
                        profiler = self._start_profile()
                    self.state, losses = self.train_step(
                        self.state, batch_to_device(batch, self.device))
                    it_total += 1
                    grad_stats = {k: v for k, v in losses.items() if k.startswith("grad/")}
                    losses = {k: v for k, v in losses.items() if not k.startswith("grad/")}
                    if grad_every and it_total % grad_every == 0 and self.writer is not None:
                        self.writer.scalars(it_total, grad_stats, prefix="train/")
                        per_mod = [float(v) for k, v in grad_stats.items()
                                   if k.startswith("grad/norm/")]
                        if per_mod:
                            self.writer.histogram(it_total, "train/grad/module_norms", per_mod)
                    if profiler is not None and it_total == conf.profile_end:
                        profiler = self._stop_profile(profiler)
                    if it_total % conf.log_every_iter == 0:
                        dt = time.perf_counter() - t_last
                        t_last = time.perf_counter()
                        logger.info("[E %d | it %d] loss %.4f (%.2f it/s) %s", epoch, it_total,
                                    float(losses["total"]), conf.log_every_iter / max(dt, 1e-6),
                                    {k: round(float(v), 3) for k, v in losses.items()
                                     if k != "total"})
                        if self.writer is not None:
                            self.writer.scalars(
                                it_total,
                                {**{f"loss/{k}": v for k, v in losses.items()},
                                 "it_per_s": conf.log_every_iter / max(dt, 1e-6),
                                 "epoch": epoch},
                                prefix="train/")
                    if conf.eval_every_iter > 0 and it_total % conf.eval_every_iter == 0:
                        self._validate_and_save(epoch, it_total)
                    if conf.save_every_iter > 0 and it_total % conf.save_every_iter == 0:
                        self._save(epoch, it_total)
                    if self.stop_requested:
                        self._save(epoch, it_total, interrupted=True)
                        return self.state
                results = self._validate_and_save(epoch, it_total)
                self._save(epoch, it_total, results=results)
                self._run_benchmarks(epoch)
        finally:
            if profiler is not None:
                self._stop_profile(profiler)
            signal.signal(signal.SIGINT, old_handler)
            if self.writer is not None:
                self.writer.close()
        return self.state

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        out = (self.output_dir or Path(".")) / "profile"
        out.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(out / "trace.json"))
        logger.info("Profile trace written to %s", out)
        return None

    def _validate_and_save(self, epoch: int, it_total: int) -> dict:
        results = self.do_evaluation(epoch, it_total)
        key = self.conf.train.best_key
        if key in results and is_num(results[key]):
            val = float(results[key])
            if self.best_eval is None or val < self.best_eval:
                self.best_eval = val
                if self.is_main:
                    save_experiment(self.experiment, self.checkpoint_state(), self.conf, epoch,
                                    it_total, results=results, best_eval=self.best_eval,
                                    is_best=True, num_keep=self.conf.train.keep_last_checkpoints)
                    logger.info("New best checkpoint (%s=%.4f)", key, val)
        return results

    def _run_benchmarks(self, epoch: int) -> None:
        if not self.is_main:
            return
        from ..eval import run_benchmark

        for name, bconf in (self.conf.train.get("benchmarks") or {}).items():
            bconf = merge({}, bconf, {"model": {"checkpoint": self.experiment}})
            out = (self.output_dir or Path(".")) / "benchmarks" / name
            try:
                # the live weights override the checkpoint's
                summaries, _ = run_benchmark(name, bconf, out, model=self.model.state_dict(),
                                             device=self.device)
                logger.info("[Benchmark %s @ epoch %d] %s", name, epoch, summaries)
                if self.writer is not None:
                    self.writer.scalars(epoch, summaries, prefix=f"bench/{name}/")
            except Exception as e:  # noqa: BLE001 - a benchmark does not stop training
                logger.warning("Benchmark %s failed: %s", name, e)

    def _save(self, epoch: int, it_total: int, results=None, interrupted: bool = False):
        if not self.is_main:
            return
        save_experiment(self.experiment, self.checkpoint_state(), self.conf, epoch, it_total,
                        results=results, best_eval=self.best_eval,
                        num_keep=self.conf.train.keep_last_checkpoints, interrupted=interrupted)


__all__ = ["Trainer", "default_train_conf", "graft_state"]
