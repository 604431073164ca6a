"""Match quality against ground-truth labels (counterpart of
gluefactory_tpu/models/utils/metrics.py). Label conventions: > -1 matched,
== -1 unmatched, == -2 ignored.
"""

from __future__ import annotations

import torch


def matcher_metrics(pred, data, prefix: str = "", prefix_gt: str | None = None) -> dict:
    """Recall, precision, accuracy and ranking AP of the predicted matches,
    each (B,)."""
    if prefix_gt is None:
        prefix_gt = prefix
    m = pred[f"{prefix}matches0"]
    gt_m = data[f"gt_{prefix_gt}matches0"]
    scores = pred[f"{prefix}matching_scores0"]
    hit = (m == gt_m).float()

    def ratio(mask):
        mask = mask.float()
        return (hit * mask).sum(1) / (1e-8 + mask.sum(1))

    p_mask = ((m > -1) & (gt_m >= -1)).float()
    r_mask = (gt_m > -1).float()
    order = torch.argsort(-scores, dim=-1, stable=True)
    sorted_p, sorted_r, sorted_tp = (torch.gather(t, 1, order) for t in (p_mask, r_mask, hit))
    p_pts = torch.cumsum(sorted_tp * sorted_p, -1) / (1e-8 + torch.cumsum(sorted_p, -1))
    r_pts = torch.cumsum(sorted_tp * sorted_r, -1) / (1e-8 + sorted_r.sum(-1)[:, None])
    ap = ((r_pts[..., 1:] - r_pts[..., :-1]) * p_pts[..., 1:]).sum(-1)
    return {
        f"{prefix}match_recall": ratio(gt_m > -1),
        f"{prefix}match_precision": ratio((m > -1) & (gt_m >= -1)),
        f"{prefix}accuracy": ratio(gt_m >= -1),
        f"{prefix}average_precision": ap,
    }


__all__ = ["matcher_metrics"]
