"""Training-time match figures (counterpart of
gluefactory_tpu/visualization/visualize_batch.py): the predicted matches of
the first pairs of a batch, green where they equal the ground truth and red
where not (lime without one), over both images with their keypoints, drawn
by `viz2d` on numpy canvases."""

from __future__ import annotations

import numpy as np

from ..utils.tensor import batch_to_numpy
from .viz2d import cm_RdGn, plot_images, plot_keypoints, plot_matches


def make_match_figures(pred, data, n_pairs: int = 2):
    """{"matching_i": Figure} for the first `n_pairs` pairs of the batch."""
    pred = batch_to_numpy(pred)
    data = batch_to_numpy(data)
    figs = {}
    for i in range(min(n_pairs, len(pred["keypoints0"]))):
        kp0, kp1 = pred["keypoints0"][i], pred["keypoints1"][i]
        m0 = pred["matches0"][i]
        valid = m0 > -1
        kpm0, kpm1 = kp0[valid], kp1[np.clip(m0[valid], 0, None)]
        if "gt_matches0" in pred or "gt_matches0" in data:
            gt = (pred if "gt_matches0" in pred else data)["gt_matches0"][i]
            color = cm_RdGn((m0 == gt)[valid].astype(float)).tolist()
        else:
            color = "lime"
        fig, axes = plot_images([data["view0"]["image"][i], data["view1"]["image"][i]])
        plot_keypoints([kp0, kp1], axes=axes, colors="royalblue")
        if len(kpm0):
            plot_matches(kpm0, kpm1, color=color, axes=axes, ps=0, a=0.6)
        figs[f"matching_{i}"] = fig
    return figs


__all__ = ["make_match_figures"]
