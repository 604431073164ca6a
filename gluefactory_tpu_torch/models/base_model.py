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

__all__ = ["BaseModel", "resolve_device"]


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
    """Subclasses set `default_conf`, `required_data_keys` and `forward`."""

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

    def check_required_keys(self, data: Mapping) -> None:
        for key in self.required_data_keys:
            assert key in data, f"Missing key {key} in data"
