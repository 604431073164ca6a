"""Keypoints on a fixed grid (counterpart of
gluefactory_tpu/models/extractors/grid_extractor.py): one keypoint at the
centre of each `cell_size` cell (+0.5), every one valid, score 1."""

from __future__ import annotations

import torch

from ..base_model import BaseModel


class GridExtractor(BaseModel):
    default_conf = {"name": "grid_extractor", "cell_size": 14}
    required_data_keys = ["image"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        b, h, w, _ = data["image"].shape
        cs = self.conf.cell_size
        dev = data["image"].device
        ys, xs = torch.meshgrid(torch.arange(h // cs, dtype=torch.float32, device=dev),
                                torch.arange(w // cs, dtype=torch.float32, device=dev),
                                indexing="ij")
        grid = torch.stack([xs, ys], -1) * cs + cs / 2 + 0.5
        kpts = grid.reshape(1, -1, 2).expand(b, -1, 2)
        return {
            "grid": grid[None].expand(b, *grid.shape),
            "keypoints": kpts,
            "keypoint_scores": torch.ones(kpts.shape[:-1], device=dev),
            "keypoint_mask": torch.ones(kpts.shape[:-1], dtype=torch.bool, device=dev),
        }


__main_model__ = GridExtractor
