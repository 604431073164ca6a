"""Recursive config merge (counterpart of gluefactory_tpu/utils/config.py).

`merge`, `to_dict`, `parse_dotlist`, and `load_conf` / `save_conf`. Configs
are plain dicts wrapped in `Config` for attribute access. Files are JSON:
nothing here imports yaml (the JAX package's YAML configs have JSON copies
under `gluefactory_tpu_torch/configs/`, and values of a dotlist are JSON).
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Mapping

__all__ = ["Config", "merge", "to_dict", "parse_dotlist", "load_conf", "save_conf",
           "CONFIG_DIR"]

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def load_conf(path: str | Path) -> dict:
    """A JSON configuration as a plain dict: a file, or the name of one of
    the package's `configs/` (with or without `.json`)."""
    with open(_resolve(path)) as f:
        return json.load(f) or {}


def save_conf(conf: Mapping, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_dict(conf), f, indent=2)


def _resolve(name: str | Path) -> Path:
    path = Path(name)
    if path.exists():
        return path
    for cand in (CONFIG_DIR / str(name), CONFIG_DIR / f"{name}.json"):
        if cand.exists():
            return cand
    raise FileNotFoundError(f"no configuration {name!r} (a path, or a name under {CONFIG_DIR})")


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


def _parse_value(raw: str) -> Any:
    """A dotlist value: JSON (numbers, lists, true/false/null), the Python
    spellings True/False/None, or else the string itself."""
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return {"True": True, "False": False, "None": None}.get(raw, raw)


def parse_dotlist(items: list[str]) -> dict:
    """CLI overrides like ``model.matcher.n_layers=9`` as a nested dict."""
    out: dict = {}
    for item in items:
        if "=" not in item:
            raise ValueError(f"Expected key=value, got {item!r}")
        key, _, raw = item.partition("=")
        node = out
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _parse_value(raw.strip())
    return out
