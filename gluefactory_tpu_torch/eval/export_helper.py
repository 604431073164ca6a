"""Export-phase model application (counterpart of
gluefactory_tpu/eval/export_helper.py:25-116).

`make_export_apply_fn` builds the port's two-view pipeline on the device and
loads a checkpoint: an `.npz` file (the JAX package's flat flax artifact,
e.g. `weights/hermetic/sp_open_lg.npz`) or the name of a training
experiment of the port (its best checkpoint, else its last). Every
parameter and buffer of the configured components must be in it. The host-extractor branch of the JAX
package (sift, lsd, wireframe) waits for those extractors (ROADMAP Queue 1
items 4-5).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import torch

from ..models import get_model
from ..utils.config import to_dict
from ..utils.tensor import batch_to_device
from ..weights import load_hermetic

HOST_EXTRACTORS = {"sift", "lsd", "wireframe"}


def load_checkpoint(model: torch.nn.Module, path: str | Path) -> None:
    """Load the entries of `model.state_dict()` from an `.npz` checkpoint or
    an experiment; raises on one the checkpoint lacks."""
    device = next(iter(model.state_dict().values())).device
    if str(path).endswith(".npz"):
        state = load_hermetic(path, device=device)
    else:
        from ..utils import experiments

        try:
            ckpt = experiments.get_best_checkpoint(str(path))
        except FileNotFoundError:
            ckpt = experiments.get_last_checkpoint(str(path))
        state = experiments.load_checkpoint(ckpt, device=device)[0]["model"]
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} entries of the model, e.g. {missing[:4]}")
    model.load_state_dict({k: state[k] for k in own}, strict=True)


def load_model(model_conf: dict, checkpoint: str | Path | None = None, device: Any = "cuda"):
    """The configured pipeline in eval mode, with `checkpoint` loaded (else
    the models' seeded random initialisation)."""
    model_conf = to_dict(model_conf)
    name = (model_conf.get("extractor") or {}).get("name")
    if name in HOST_EXTRACTORS:
        raise NotImplementedError(
            f"the host extractor {name!r} is not ported yet (ROADMAP Queue 1 items 4-5)")
    model = get_model(model_conf.get("name", "two_view_pipeline"))(model_conf, device=device)
    if checkpoint:
        load_checkpoint(model, checkpoint)
    return model.eval()


def make_export_apply_fn(model_conf: dict, live_params: dict | None = None, device: Any = "cuda"):
    """(apply_fn(batch) -> predictions, state). `model_conf["checkpoint"]`
    names an `.npz` checkpoint; `live_params` (a state dict, e.g. of a model
    in training) overrides the entries it has."""
    model_conf = to_dict(model_conf)
    checkpoint = model_conf.pop("checkpoint", None)
    model = load_model(model_conf, checkpoint, device)
    if live_params is not None:
        state = model.state_dict()
        model.load_state_dict({k: live_params.get(k, v) for k, v in state.items()})
    state = {"model": model}

    @torch.no_grad()
    def apply_fn(batch):
        return model(batch_to_device(batch, model.device))

    return apply_fn, state


__all__ = ["make_export_apply_fn", "load_model", "load_checkpoint", "HOST_EXTRACTORS"]
