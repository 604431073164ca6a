"""XPoint: MultiPoint with an attention backbone per modality (counterpart
of gluefactory_tpu/multipoint/models/xpoint.py).

`backbone` picks the encoder as the JAX `_make_encoder` does:
  swin       SwinV2Encoder(d0 = max(dim // 2, 16), depths (p, p) with
             p = max(depth // 2, 1), heads (max(d0 // 32, 1), max(d0 // 16, 1)))
  swinir     SwinIREncoder(dim, groups max(depth // 2, 1), 2 blocks a group,
             heads max(dim // 16, 1))
  scunet     SCUNetEncoder(max(2 dim // 3, 32), out_dim dim, blocks a stage
             max(depth // 2, 1))
with `window` where it applies, feeding MultiPoint's shared detector and
descriptor heads. The JAX module's other encoders (`swin_lite`, `cbam`,
`vit`), which no configuration of the repo names, and the homography
regression head (`homography_head`, with multipoint/models/homography_net.py)
are not ported yet and raise (ROADMAP Queue 1 item 7b).
"""

from __future__ import annotations

from torch import nn

from .backbones import SCUNetEncoder, SwinIREncoder, SwinV2Encoder
from .multipoint import MultiPoint


class XPoint(MultiPoint):
    default_conf = {
        "name": "xpoint",
        "backbone": "swin",
        "backbone_dim": 96,
        "backbone_depth": 4,
        "window": 8,
        "homography_head": False,
    }

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        if self.conf.homography_head:
            raise NotImplementedError(
                "XPoint's homography head (multipoint/models/homography_net.py) is not ported "
                "yet (ROADMAP Queue 1 item 7b)")

    def _make_encoder(self) -> nn.Module:
        conf = self.conf
        name = conf.backbone
        dim, depth, window = conf.backbone_dim, conf.backbone_depth, conf.window
        if name == "swin":
            # stage 1 runs at twice stage 0's width: halve it so the output is dim
            d0 = max(dim // 2, 16)
            per_stage = max(depth // 2, 1)
            return SwinV2Encoder(d0, depths=(per_stage, per_stage),
                                 heads=(max(d0 // 32, 1), max(d0 // 16, 1)), window=window)
        if name == "swinir":
            return SwinIREncoder(dim, groups=max(depth // 2, 1), depth=2,
                                 heads=max(dim // 16, 1), window=window)
        if name == "scunet":
            return SCUNetEncoder(max(dim * 2 // 3, 32), out_dim=dim,
                                 blocks_per_stage=max(depth // 2, 1), window=window)
        if name in ("swin_lite", "cbam", "vit"):
            raise NotImplementedError(
                f"XPoint's '{name}' backbone is not ported yet (ROADMAP Queue 1 item 7b)")
        raise ValueError(f"unknown XPoint backbone '{name}'")


__main_model__ = XPoint
