"""Model registry (counterpart of gluefactory_tpu/models/__init__.py).

`get_model(name)` resolves "lightglue", "matchers.lightglue" or a full
import path; modules export `__main_model__` to name their class.
"""

import importlib
import importlib.util

from .base_model import BaseModel


def get_class(mod_path: str, base: type):
    mod = importlib.import_module(mod_path)
    main = getattr(mod, "__main_model__", None)
    if main is not None:
        return main
    classes = [
        v
        for v in mod.__dict__.values()
        if isinstance(v, type) and issubclass(v, base) and v.__module__ == mod_path
    ]
    if len(classes) != 1:
        raise ValueError(f"Expected one model class in {mod_path}, got {classes}")
    return classes[0]


def get_model(name: str):
    import_paths = [
        name,
        f"{__name__}.{name}",
        f"{__name__}.extractors.{name}",
        f"{__name__}.matchers.{name}",
    ]
    for path in import_paths:
        try:
            found = importlib.util.find_spec(path) is not None
        except ModuleNotFoundError:
            found = False
        if found:
            return get_class(path, BaseModel)
    raise RuntimeError(f"Model {name} not found in any of [{' '.join(import_paths)}]")


__all__ = ["BaseModel", "get_model", "get_class"]
