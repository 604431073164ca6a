"""HomographyNet and the homography heads (counterpart of
gluefactory_tpu/multipoint/models/homography_net.py).

  - `h_to_4pt`: a (B, 3, 3) homography as the (B, 4, 2) displacements of
    the image corners (the 4-point parameterisation).
  - `HomographyNet`: both views to grey ([0.299, 0.587, 0.114]) stacked as
    two channels, 3 x 3 convs without bias -> BatchNorm (eps 1e-3, flax's
    running averages: `models.utils.layers.BatchNorm`) -> ReLU, a 2 x 2 max
    pool after every stage but the last, global average pool, `fc_dim`,
    then the 8 offsets; its loss is the L2 of the corner offsets against
    `H_0to1`.
  - `CorrelationHomographyHead` (SRHEN): the cosine correlation of the two
    1/8 feature maps as an (h, w) map of h * w channels (channel m is view
    1's position y * w + x), two stride-2 "SAME" convs, pool, two dense
    layers; `width` scales the channels (0.5: the "Lighter" variant). Its
    first conv takes its input width from the first map it sees, as the
    flax module does at initialisation.
  - `CrossAttentionHomographyHead` (MS2CAHE): each view's tokens attend to
    the other's, pooled, two dense layers. Its dense layers keep flax's
    creation-order names `Dense_0` ... `Dense_9`: t0, t1, q / k / v of view
    0 attending to view 1, q / k / v of the reverse, the two output layers.

Heads take NHWC features as the JAX heads do. Module names follow the flax
tree (`weights.params_from_jax` maps it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...models.base_model import BaseModel
from ...models.utils.layers import BatchNorm, Conv

GRAY = (0.299, 0.587, 0.114)


def h_to_4pt(H: torch.Tensor, size) -> torch.Tensor:
    """(B, 3, 3) homography -> (B, 4, 2) corner displacements for an image of
    (w, h) `size`."""
    w, h = size
    corners = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]],
                           dtype=H.dtype, device=H.device)
    pts = torch.cat([corners, torch.ones_like(corners[:, :1])], -1)
    warped = torch.einsum("bij,nj->bni", H, pts)
    return warped[..., :2] / warped[..., 2:] - corners[None]


class LazyConv(nn.LazyConv2d):
    """`Conv` whose input width is taken from its first input (or from the
    state dict loaded into it), as a flax `nn.Conv` infers it at init."""

    cls_to_become = Conv

    def __init__(self, cout: int, kernel: int, stride: int = 1, padding: str = "SAME"):
        super().__init__(cout, kernel, stride=stride)
        self.same = padding == "SAME"

    def forward(self, x):
        return Conv.forward(self, x)


class CorrelationHomographyHead(nn.Module):
    def __init__(self, width: float = 1.0):
        super().__init__()
        ch, mid = int(128 * width), int(256 * width)
        self.Conv_0 = LazyConv(ch, 3, stride=2)
        self.Conv_1 = Conv(ch, ch, 3, stride=2)
        self.Dense_0 = nn.Linear(ch, mid)
        self.Dense_1 = nn.Linear(mid, 8)

    def forward(self, f0, f1):
        b, h, w, c = f0.shape
        t0, t1 = f0.reshape(b, h * w, c), f1.reshape(b, h * w, c)
        t0 = t0 / (t0.norm(dim=-1, keepdim=True) + 1e-8)
        t1 = t1 / (t1.norm(dim=-1, keepdim=True) + 1e-8)
        # (B, n, m) with n view 0's position: NCHW takes m as the channel
        corr = torch.einsum("bnc,bmc->bmn", t0.float(), t1.float()).reshape(b, h * w, h, w)
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(corr))))
        y = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(y).reshape(-1, 4, 2)


class CrossAttentionHomographyHead(nn.Module):
    def __init__(self, cin: int, dim: int = 128, heads: int = 4):
        super().__init__()
        self.dim, self.heads = dim, heads
        for i, fan_in in enumerate([cin, cin] + [dim] * 6 + [2 * dim, dim]):
            self.add_module(f"Dense_{i}", nn.Linear(fan_in, 8 if i == 9 else dim))

    def _attend(self, q, kv, first: int):
        b, dh = q.shape[0], self.dim // self.heads
        dq, dk, dv = (getattr(self, f"Dense_{first + j}") for j in range(3))
        qh = dq(q).reshape(b, -1, self.heads, dh)
        kh = dk(kv).reshape(b, -1, self.heads, dh)
        vh = dv(kv).reshape(b, -1, self.heads, dh)
        attn = torch.softmax(
            torch.einsum("bnhd,bmhd->bhnm", qh.float(), kh.float()) / dh**0.5, -1)
        return torch.einsum("bhnm,bmhd->bnhd", attn, vh).reshape(b, -1, self.dim)

    def forward(self, f0, f1):
        b, h, w, c = f0.shape
        t0 = self.Dense_0(f0.reshape(b, h * w, c))
        t1 = self.Dense_1(f1.reshape(b, h * w, c))
        a0 = self._attend(t0, t1, 2).mean(dim=1)
        a1 = self._attend(t1, t0, 5).mean(dim=1)
        y = F.relu(self.Dense_8(torch.cat([a0, a1], -1)))
        return self.Dense_9(y).reshape(-1, 4, 2)


class HomographyNet(BaseModel):
    default_conf = {
        "name": "homography_net",
        "channels": [64, 64, 128, 128],
        "fc_dim": 128,
        "is_training": False,
        "loss": {"weight": 1.0},
    }
    required_data_keys = ["view0", "view1"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        channels = list(self.conf.channels)
        cin = 2
        for i, c in enumerate(channels):
            self.add_module(f"Conv_{i}", Conv(cin, c, 3, bias=False))
            self.add_module(f"BatchNorm_{i}", BatchNorm(c))
            cin = c
        self.Dense_0 = nn.Linear(cin, self.conf.fc_dim)
        self.Dense_1 = nn.Linear(self.conf.fc_dim, 8)
        self.to(self.device)

    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        im0, im1 = data["view0"]["image"], data["view1"]["image"]
        if im0.shape[-1] == 3:
            gray = torch.tensor(GRAY, dtype=im0.dtype, device=im0.device)
            im0, im1 = (im0 @ gray)[..., None], (im1 @ gray)[..., None]
        x = torch.cat([im0, im1], -1).permute(0, 3, 1, 2)
        n = len(self.conf.channels)
        for i in range(n):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x),
                                                       self.conf.is_training))
            if i < n - 1:
                x = F.max_pool2d(x, 2, 2)
        y = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return {"h_4pt": self.Dense_1(y).reshape(-1, 4, 2)}

    def loss(self, pred, data):
        image = data["view0"]["image"]
        gt = h_to_4pt(data["H_0to1"], (image.shape[2], image.shape[1]))
        diff = pred["h_4pt"] - gt
        err = (diff**2).sum(-1).mean(-1)
        return ({"h4pt": err, "total": self.conf.loss["weight"] * err},
                {"corner_error": diff.norm(dim=-1).mean(-1)})


__main_model__ = HomographyNet
