"""LightGlue with converted official weights (counterpart of
gluefactory_tpu/models/matchers/lightglue_pretrained.py:70-85).

An official `.pth` is converted once with `scripts/convert_weights.py` (the
port's or the JAX package's: the `.npz` is the same) into the stacked flax
layout; this model is LightGlue with that tree loaded, strictly, when it is
built (`conf.weights`, required), as an extractor loads its `conf.weights`.
The tree decides the configuration it fits: an official checkpoint has no
`posenc_cond_*` (set `posenc: fourier`), and the ALIKED and DISK checkpoints
carry an `input_proj` from 128-d descriptors (set `input_dim: 128`); the
`*-official` configurations set both.
"""

from __future__ import annotations

from ..base_model import finish_init
from .lightglue import LightGlue


class LightGluePretrained(LightGlue):
    default_conf = {
        "name": "lightglue_pretrained",
        "weights": None,  # path to a converted .npz (required)
        "filter_threshold": 0.1,
        "depth_confidence": 0.95,
        "width_confidence": 0.99,
    }

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        if not self.conf.weights:
            raise ValueError("lightglue_pretrained needs conf.weights (a converted .npz)")
        finish_init(self)


__main_model__ = LightGluePretrained
