"""Assignment NLL loss for matchers (counterpart of
gluefactory_tpu/models/utils/losses.py): balanced negative log-likelihood
over the (M+1) x (N+1) log assignment, with weights built from the
ground-truth assignment and matches (-1 rows and columns feed the dustbin
terms; -2 entries contribute nothing).
"""

from __future__ import annotations

import torch


def nll_weights(log_assignment: torch.Tensor, data) -> torch.Tensor:
    """The (B, M+1, N+1) weight matrix of the ground-truth labels."""
    gt_assignment = data["gt_assignment"].float()
    m, n = gt_assignment.shape[1:]
    weights = torch.zeros_like(log_assignment)
    weights[:, :m, :n] = gt_assignment
    weights[:, :m, -1] = (data["gt_matches0"] == -1).float()
    weights[:, -1, :n] = (data["gt_matches1"] == -1).float()
    return weights


def weight_loss(log_assignment: torch.Tensor, weights: torch.Tensor):
    """Weighted NLL split into its positive and negative parts. Returns
    (nll_pos, nll_neg, num_pos, num_neg), each (B,)."""
    loss_sc = log_assignment * weights
    num_neg0 = weights[:, :-1, -1].sum(-1).clamp(min=1.0)
    num_neg1 = weights[:, -1, :-1].sum(-1).clamp(min=1.0)
    num_pos = weights[:, :-1, :-1].sum((-1, -2)).clamp(min=1.0)
    nll_pos = -loss_sc[:, :-1, :-1].sum((-1, -2)) / num_pos
    nll_neg0 = -loss_sc[:, :-1, -1].sum(-1)
    nll_neg1 = -loss_sc[:, -1, :-1].sum(-1)
    nll_neg = (nll_neg0 + nll_neg1) / (num_neg0 + num_neg1)
    return nll_pos, nll_neg, num_pos, (num_neg0 + num_neg1) / 2.0


def nll_loss(pred, data, weights=None, nll_balancing: float = 0.5):
    """Balanced assignment NLL. Returns (nll (B,), weights, metrics dict)."""
    log_assignment = pred["log_assignment"]
    if weights is None:
        weights = nll_weights(log_assignment, data)
    nll_pos, nll_neg, num_pos, num_neg = weight_loss(log_assignment, weights)
    nll = nll_balancing * nll_pos + (1 - nll_balancing) * nll_neg
    metrics = {
        "assignment_nll": nll,
        "nll_pos": nll_pos,
        "nll_neg": nll_neg,
        "num_matchable": num_pos,
        "num_unmatchable": num_neg,
    }
    return nll, weights, metrics


__all__ = ["nll_loss", "nll_weights", "weight_loss"]
