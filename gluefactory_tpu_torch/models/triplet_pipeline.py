"""Triplet (three-view) pipeline (counterpart of
gluefactory_tpu/models/triplet_pipeline.py).

The three pairs of a triplet (0to1, 0to2, 1to2) are stacked along the batch
axis and run through the two-view pipeline in one call; the predictions come
back whole (`stacked`) and split per pair (`<key>_0to1`, `<key>_0to2`,
`<key>_1to2`). The loss is the two-view loss on the stacked data.

Two faults of the JAX version are repaired here (ROADMAP Queue 3a): it hands
the stacked two-view data to a forward that checks the triplet's keys, so it
fails with "Missing key view2"; and it concatenates every view entry with a
`shape`, which a `Camera` has but cannot be concatenated as an array. Here the
triplet's keys are checked on the triplet only, and `Camera` / `Pose` entries
(and nested dicts, such as a view's `cache`) are stacked leaf by leaf, as
`collate` stacks them. The relative poses stack in both directions
(`T_0to1` and `T_1to0`), which pose and depth ground truth reads.
"""

from __future__ import annotations

import torch

from ..geometry.wrappers import TensorWrapper
from .two_view_pipeline import TwoViewPipeline

__all__ = ["stack_twoviews", "unstack_twoviews", "TripletPipeline"]


def _cat(*xs):
    """Concatenate tensors, `Camera` / `Pose` leaf by leaf, or dicts key by
    key along the batch axis; None where the entries do not stack."""
    if all(torch.is_tensor(x) for x in xs):
        return torch.cat(xs, 0)
    if all(isinstance(x, TensorWrapper) for x in xs) and len({type(x) for x in xs}) == 1:
        return type(xs[0])(*(torch.cat(leaves, 0) for leaves in zip(*(x.leaves() for x in xs))))
    if all(isinstance(x, dict) for x in xs):
        out = {k: _cat(*(x[k] for x in xs)) for k in xs[0] if all(k in x for x in xs)}
        return {k: v for k, v in out.items() if v is not None}
    return None


def stack_twoviews(data: dict) -> dict:
    """{view0, view1, view2, H_* or T_*} -> two-view data whose batch axis is
    ordered [0to1, 0to2, 1to2]."""
    v0, v1, v2 = data["view0"], data["view1"], data["view2"]
    stacked = {"view0": _cat(v0, v0, v1), "view1": _cat(v1, v2, v2)}
    if "H_0to1" in data:
        stacked["H_0to1"] = _cat(data["H_0to1"], data["H_0to2"], data["H_1to2"])
    if "T_0to1" in data:
        stacked["T_0to1"] = _cat(data["T_0to1"], data["T_0to2"], data["T_1to2"])
        stacked["T_1to0"] = _cat(data["T_1to0"], data["T_2to0"], data["T_2to1"])
    return stacked


def unstack_twoviews(pred: dict, b: int) -> dict:
    """Stacked predictions split back into their 0to1 / 0to2 / 1to2 groups
    (the tensors with the stacked batch axis; others, such as the adaptive
    matcher's exit layer, stay in the stacked predictions only)."""
    batched = {k: v for k, v in pred.items()
               if torch.is_tensor(v) and v.ndim > 0 and v.shape[0] == 3 * b}
    return {suffix: {k: v[i * b:(i + 1) * b] for k, v in batched.items()}
            for i, suffix in enumerate(("0to1", "0to2", "1to2"))}


class TripletPipeline(TwoViewPipeline):
    default_conf = {
        "name": "triplet_pipeline",
        "batch_triplets": True,
    }
    required_data_keys = ["view0", "view1", "view2"]

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        view0 = data["view0"]
        b = view0["image" if "image" in view0 else "image_size"].shape[0]
        pred = self.two_view_forward(stack_twoviews(data))
        out = {"stacked": pred}
        for suffix, p in unstack_twoviews(pred, b).items():
            out.update({f"{k}_{suffix}": v for k, v in p.items()})
        return out

    def loss(self, pred: dict, data: dict):
        return super().loss(pred["stacked"], stack_twoviews(data))


__main_model__ = TripletPipeline
