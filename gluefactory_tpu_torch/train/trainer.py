"""Training runtime, lean (counterpart of gluefactory_tpu/train/trainer.py).

`Trainer(conf)` builds the model and the optimizer of a configuration
({"model": ..., "train": ...}, e.g. `homography_train_conf()`), and
`train(batches, steps)` takes optimizer steps on any iterable of batches
(dicts of tensors: view0/view1 images and `H_0to1`). Scalars are logged
every `log_every_iter` steps; `save` / `restore` write and read the
parameters, the optimizer state and the step with `torch.save`.

Not ported yet: datasets and the command line entry, the validation loop,
plots, benchmarks during training, multi-device training. The step has no
randomness (no dropout, no augmentation on the device), so the trainer
carries no generator; model initialisation draws from the model's own
seeded `torch.Generator`.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Iterable, Mapping

import torch

from ..models import get_model
from ..utils.config import Config, merge
from .step import TrainState, make_optimizer, make_train_step

logger = logging.getLogger(__name__)

default_train_conf = {
    "seed": 0,
    "optimizer": "adam",
    "lr": 1e-4,
    "lr_schedule": {"type": None, "start": 0, "exp_div_10": 1e5},
    "grad_clip": 10.0,
    "log_every_iter": 100,
}


def homography_train_conf() -> dict:
    """SuperPoint-open (frozen) + LightGlue on homography pairs: the model
    and train sections of the JAX package's
    configs/superpoint-open+lightglue_homography.yaml (its data, epoch and
    evaluation settings belong to parts that are not ported yet)."""
    return {
        "model": {
            "name": "two_view_pipeline",
            "extractor": {"name": "superpoint_open", "max_num_keypoints": 512,
                          "detection_threshold": 0.0, "nms_radius": 3, "trainable": False},
            "ground_truth": {"name": "homography_matcher", "th_positive": 3.0,
                             "th_negative": 3.0},
            "matcher": {"name": "lightglue", "filter_threshold": 0.1, "checkpointed": True,
                        "is_training": True},
        },
        "train": {"seed": 0, "log_every_iter": 100, "lr": 1.0e-4,
                  "lr_schedule": {"type": "exp", "start": 200000, "exp_div_10": 100000}},
    }


def batch_to_device(batch: Mapping, device) -> dict:
    """Tensors of a nested batch moved to `device`; other leaves dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, Mapping):
            out[k] = batch_to_device(v, device)
        elif torch.is_tensor(v):
            out[k] = v.to(device, non_blocking=True)
    return out


class Trainer:
    def __init__(self, conf: Mapping, device: Any = "cuda", mark=None):
        self.conf = Config(merge({"train": default_train_conf}, conf))
        model_conf = self.conf.model
        self.model = get_model(model_conf.name)(model_conf, device=device)
        self.device = self.model.device
        self.model.train()
        params = {k: p for k, p in self.model.named_parameters() if p.requires_grad}
        self.state = TrainState(
            step=0, params=params, optimizer=make_optimizer(self.conf.train, params))
        self.train_step = make_train_step(self.model, mark)

    def load_weights(self, state_dict: Mapping, strict: bool = True):
        """Initialise the model from a state dict (e.g. `load_hermetic()`)."""
        return self.model.load_state_dict(state_dict, strict=strict)

    def train(self, batches: Iterable[Mapping], steps: int | None = None) -> list:
        """Take one optimizer step per batch, at most `steps`. Returns the
        logged losses of every step as dicts of floats (fetched at the end:
        the only host synchronisation inside a step is the veto's)."""
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

    def save(self, path: str | Path) -> None:
        """Parameters, optimizer state and step."""
        torch.save({
            "step": self.state.step,
            "model": self.model.state_dict(),
            "optimizer": self.state.optimizer.state_dict(),
        }, str(path))

    def restore(self, path: str | Path) -> None:
        ckpt = torch.load(str(path), map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"], strict=True)
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        self.state.step = int(ckpt["step"])


__all__ = ["Trainer", "default_train_conf", "homography_train_conf", "batch_to_device"]
