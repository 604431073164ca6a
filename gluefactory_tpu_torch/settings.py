"""Filesystem roots (counterpart of gluefactory_tpu/settings.py).

Each can be moved with an environment variable of its own:
GLUEFACTORY_TPU_TORCH_ROOT, GLUEFACTORY_TPU_TORCH_DATA (datasets, e.g.
`hpatches-sequences-release/`), GLUEFACTORY_TPU_TORCH_TRAINING (training
experiments) and GLUEFACTORY_TPU_TORCH_EVAL (benchmark outputs).
"""

import os
from pathlib import Path

root = Path(os.environ.get("GLUEFACTORY_TPU_TORCH_ROOT", Path(__file__).parent.parent))

DATA_PATH = Path(os.environ.get("GLUEFACTORY_TPU_TORCH_DATA", root / "data"))
TRAINING_PATH = Path(os.environ.get("GLUEFACTORY_TPU_TORCH_TRAINING",
                                   root / "outputs" / "training"))
EVAL_PATH = Path(os.environ.get("GLUEFACTORY_TPU_TORCH_EVAL", root / "outputs" / "results"))
