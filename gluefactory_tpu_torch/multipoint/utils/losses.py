"""SuperPoint-style self-supervised losses of the detector's pretraining
(counterpart of gluefactory_tpu/multipoint/utils/losses.py):

  - `detector_loss`: the cell-wise cross-entropy of the 65-way softmax
    against the space-to-depth keypoint map. The label of a cell is the
    argmax of [2 * labels, 0.5] (the dustbin wins an empty cell, the first
    keypoint of the cell otherwise); with a validity mask a cell counts when
    all its pixels are valid (the min over the cell);
  - `descriptor_loss`: the dense hinge loss between the two views' cell
    descriptors. Positives are the cell pairs whose view-0 centre, warped by
    H_0to1 in fp32 (`geometry.homography.warp_points`), lies within
    `threshold` px of the view-1 centre (dist <= threshold); the loss is
    lambda_d s max(0, pos_margin - d) + (1 - s) max(0, d - neg_margin),
    summed and divided by a (B,) norm;
  - `superpoint_loss`: det + det2 + 1e-4 desc, with whichever terms the
    predictions carry.

The hinges are `torch.maximum` against 0, whose gradient splits a tie as
`jnp.maximum`'s does.
"""

from __future__ import annotations

import torch

from ...geometry.homography import warp_points


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W) -> (B, H/r, W/r, r*r) cell unfolding."""
    b, h, w = x.shape
    x = x.reshape(b, h // r, r, w // r, r)
    return x.permute(0, 1, 3, 2, 4).reshape(b, h // r, w // r, r * r)


def _cell_valid(valid_mask: torch.Tensor, cell: int) -> torch.Tensor:
    return space_to_depth(valid_mask.float(), cell).amin(-1)


def detector_loss(logits: torch.Tensor, keypoint_map: torch.Tensor, valid_mask=None,
                  cell: int = 8) -> torch.Tensor:
    """Cell-wise cross-entropy over cell^2 + 1 classes, (B,).

    logits: (B, Hc, Wc, cell^2 + 1); keypoint_map: (B, H, W) binary."""
    labels_cells = space_to_depth(keypoint_map.float(), cell)
    dustbin = torch.full_like(labels_cells[..., :1], 0.5)
    labels = torch.cat([labels_cells * 2.0, dustbin], -1).argmax(-1)  # first max on ties
    ce = -torch.log_softmax(logits, -1).gather(-1, labels[..., None])[..., 0]
    if valid_mask is not None:
        cell_valid = _cell_valid(valid_mask, cell)
        ce = ce * cell_valid
        return ce.sum((-1, -2)) / torch.clamp(cell_valid.sum((-1, -2)), min=1.0)
    return ce.mean((-1, -2))


def descriptor_loss(desc0: torch.Tensor, desc1: torch.Tensor, H_0to1: torch.Tensor,
                    valid_mask1=None, cell: int = 8, pos_margin: float = 1.0,
                    neg_margin: float = 0.2, lambda_d: float = 250.0, threshold: float = 8.0):
    """Dense hinge descriptor loss of (B, Hc, Wc, D) cell descriptors.
    Returns (loss (B,), positive_dist (B,), negative_dist (B,))."""
    b, hc, wc, d = desc0.shape
    ys, xs = torch.meshgrid(torch.arange(hc, dtype=torch.float32, device=desc0.device),
                            torch.arange(wc, dtype=torch.float32, device=desc0.device),
                            indexing="ij")
    centers = torch.stack([xs, ys], -1).reshape(1, -1, 2) * cell + cell / 2
    centers = centers.expand(b, hc * wc, 2)
    warped0 = warp_points(centers, H_0to1.float())  # view-0 centres in view 1
    dist = torch.linalg.vector_norm(warped0[:, :, None, :] - centers[:, None, :, :], dim=-1)
    s = (dist <= threshold).float()

    dot = torch.einsum("bnd,bmd->bnm", desc0.reshape(b, -1, d), desc1.reshape(b, -1, d))
    zero = torch.zeros((), dtype=dot.dtype, device=dot.device)
    pos = torch.maximum(pos_margin - dot, zero)
    neg = torch.maximum(dot - neg_margin, zero)
    per_pair = lambda_d * s * pos + (1.0 - s) * neg

    if valid_mask1 is not None:
        cell_valid = _cell_valid(valid_mask1, cell)
        per_pair = per_pair * cell_valid.reshape(b, 1, -1)
        # (B,): a (B, 1) norm would broadcast the (B,) sums into (B, B)
        norm = torch.clamp(cell_valid.reshape(b, -1).sum(-1), min=1.0) * (hc * wc)
    else:
        norm = torch.tensor(float(hc * wc) ** 2, device=dot.device)
    loss = per_pair.sum((-1, -2)) / norm
    pos_dist = (s * dot).sum((-1, -2)) / torch.clamp(s.sum((-1, -2)), min=1.0)
    neg_dist = ((1 - s) * dot).sum((-1, -2)) / torch.clamp((1 - s).sum((-1, -2)), min=1.0)
    return loss, pos_dist, neg_dist


def superpoint_loss(pred: dict, data: dict, conf) -> tuple:
    """The detector loss of each view and, with both dense descriptor maps,
    the descriptor loss: (losses of (B,), {}). data: keypoint_map (B, H, W),
    valid_mask; keypoint_map2, valid_mask2 and H_0to1 for a pair."""
    cell = conf.get("cell", 8)
    det = detector_loss(pred["logits"], data["keypoint_map"], data.get("valid_mask"), cell=cell)
    losses = {"detector_loss": det}
    total = det
    if "logits2" in pred:
        det2 = detector_loss(pred["logits2"], data["keypoint_map2"], data.get("valid_mask2"),
                             cell=cell)
        losses["detector_loss2"] = det2
        total = total + det2
    if "dense_descriptors" in pred and "dense_descriptors2" in pred:
        dl, pd, nd = descriptor_loss(pred["dense_descriptors"], pred["dense_descriptors2"],
                                     data["H_0to1"], data.get("valid_mask2"), cell=cell)
        losses.update({"descriptor_loss": dl, "positive_dist": pd, "negative_dist": nd})
        total = total + 1e-4 * dl
    losses["total"] = total
    return losses, {}


__all__ = ["space_to_depth", "detector_loss", "descriptor_loss", "superpoint_loss"]
