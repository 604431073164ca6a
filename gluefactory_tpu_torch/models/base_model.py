"""BaseModel: an `nn.Module` whose `default_conf` dicts merge over the MRO
(counterpart of gluefactory_tpu/models/base_model.py:48-60).

Every model lives on an explicit device. The entry points default to
`device="cuda"` and raise when CUDA is absent: they never carry on on the
CPU unless the caller asks for it.
"""

from __future__ import annotations

from typing import Any, ClassVar, Mapping

import torch
from torch import nn

from ..utils.config import Config, merge

__all__ = ["BaseModel", "resolve_device", "finish_init"]


def resolve_device(device: Any = "cuda") -> torch.device:
    """The device a model runs on; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return device


class BaseModel(nn.Module):
    """Subclasses set `default_conf`, `required_data_keys`, `forward` and,
    when they train, `loss`."""

    base_default_conf: ClassVar[dict] = {"name": None}
    default_conf: ClassVar[dict] = {}
    required_data_keys: ClassVar[list] = []

    @classmethod
    def merged_default_conf(cls) -> dict:
        """Accumulate default_conf over the MRO, most-derived last."""
        confs = [BaseModel.base_default_conf]
        for klass in reversed(cls.__mro__):
            d = klass.__dict__.get("default_conf")
            if d:
                confs.append(d)
        return merge({}, *confs)

    def __init__(self, conf: Mapping | None = None, device: Any = "cuda"):
        super().__init__()
        self.conf = Config(merge(self.merged_default_conf(), conf or {}))
        self.device = resolve_device(device)

    def loss(self, pred: Mapping, data: Mapping):
        """(losses, metrics) of a trainable model; others have none."""
        raise NotImplementedError

    def check_required_keys(self, data: Mapping) -> None:
        for key in self.required_data_keys:
            assert key in data, f"Missing key {key} in data"


def finish_init(model: BaseModel) -> None:
    """The last steps of an extractor's construction: the weights of
    `conf.weights` (the JAX package's `.npz` of the model's flax tree,
    through `weights.params_from_jax`), gradients only where the
    configuration trains it (`trainable`, `is_training`), and the device."""
    if model.conf.get("weights"):
        from ..weights import load_npz

        model.load_state_dict(load_npz(model.conf.weights))
    model.requires_grad_(bool(model.conf.get("trainable") or model.conf.get("is_training")))
    model.to(model.device)
