"""Box NMS and keypoint maps (counterpart of
gluefactory_tpu/multipoint/utils/utils.py; `space_to_depth` is in
losses.py)."""

from __future__ import annotations

import torch

from ...models.extractors.superpoint_open import simple_nms


def box_nms(prob: torch.Tensor, size: int = 4, iou: float = 0.1, min_prob: float = 0.015,
            keep_top_k: int = 0) -> torch.Tensor:
    """NMS of fixed-size boxes on a (B, H, W) or (H, W) probability map, as
    the JAX package computes it: the max-pool suppression of `simple_nms`
    at radius max(size // 2, 1) (equal boxes: the IoU test is a distance
    test, so `iou` is unused), scores below `min_prob` zeroed, and with
    `keep_top_k` only the scores at or above the k-th largest."""
    out = simple_nms(prob[None] if prob.dim() == 2 else prob, max(size // 2, 1))
    out = torch.where(out >= min_prob, out, torch.zeros_like(out))
    if keep_top_k:
        b, h, w = out.shape
        flat = out.reshape(b, -1)
        kth = torch.topk(flat, keep_top_k, dim=1).values[:, -1:]
        out = torch.where(flat >= torch.clamp(kth, min=min_prob), flat,
                          torch.zeros_like(flat)).reshape(b, h, w)
    return out[0] if prob.dim() == 2 else out


def keypoint_map_from_points(kpts: torch.Tensor, mask: torch.Tensor, shape) -> torch.Tensor:
    """Scatter (B, K, 2) xy keypoints (truncated to int, clipped to the
    image) where `mask` holds into a binary (B, H, W) map."""
    h, w = shape
    b = kpts.shape[0]
    xs = kpts[..., 0].to(torch.int32).clamp(0, w - 1).long()
    ys = kpts[..., 1].to(torch.int32).clamp(0, h - 1).long()
    flat = torch.zeros((b, h * w), dtype=torch.float32, device=kpts.device)
    flat.scatter_reduce_(1, ys * w + xs, mask.float(), reduce="amax")
    return flat.reshape(b, h, w)


__all__ = ["box_nms", "keypoint_map_from_points"]
