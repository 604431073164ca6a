"""Recursive config merge (counterpart of gluefactory_tpu/utils/config.py).

Only what the models need: `merge` and `to_dict`. Configs are plain dicts
wrapped in `Config` for attribute access; nothing here imports yaml.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

__all__ = ["Config", "merge", "to_dict"]


def to_dict(conf: Any) -> Any:
    """Recursively convert Config/Mapping trees to plain dicts."""
    if isinstance(conf, Mapping):
        return {k: to_dict(v) for k, v in conf.items()}
    if isinstance(conf, (list, tuple)):
        return [to_dict(v) for v in conf]
    return conf


def merge(base: Mapping | None, *overrides: Mapping | None) -> dict:
    """Recursive merge; later arguments win. Returns a new plain dict."""
    out = copy.deepcopy(to_dict(base)) if base else {}
    for override in overrides:
        if override:
            _merge_into(out, to_dict(override))
    return out


def _merge_into(dst: dict, src: Mapping) -> None:
    for key, val in src.items():
        if key in dst and isinstance(dst[key], dict) and isinstance(val, Mapping):
            _merge_into(dst[key], val)
        else:
            dst[key] = copy.deepcopy(val)


class Config(dict):
    """A dict with attribute access; nested mappings become Configs."""

    def __init__(self, data: Mapping | None = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = Config(v) if isinstance(v, Mapping) else v

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e
