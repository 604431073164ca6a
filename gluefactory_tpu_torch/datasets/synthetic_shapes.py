"""Registry bridge: `get_dataset("synthetic_shapes")` is the multipoint
SyntheticShapes generator (multipoint/datasets/synthetic_shapes.py), so that
a training configuration names it like any other dataset (counterpart of
gluefactory_tpu/datasets/synthetic_shapes.py)."""

from ..multipoint.datasets.synthetic_shapes import SyntheticShapes

__main_dataset__ = SyntheticShapes

__all__ = ["SyntheticShapes"]
