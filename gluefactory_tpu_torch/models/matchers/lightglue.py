"""LightGlue matcher, full-depth inference (counterpart of
gluefactory_tpu/models/matchers/lightglue.py).

Parameters keep the JAX package's names and stacked (L, in, out) layout,
so a flax tree maps onto them leaf for leaf (weights.params_from_jax).
Every layer runs through the block ops of ops/lightglue_block.py and the
exit assignment through ops/log_assignment.py: their CUDA kernels on the
card, their plain versions on the CPU.

Both keypoint sets run stacked on the batch axis, (2B, N, D), as the JAX
stacked path does for m == n. When m != n the shorter set is padded with
masked tokens to the common length: masked tokens are excluded as keys and
their rows are dropped afterwards, so the valid outputs are those of the
unstacked path (lightglue.py:495-509).

Adaptive depth/width and training are not ported yet (ROADMAP Queue 1
items 6 and 8) and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.lightglue_block import fused_cross_block, fused_self_block
from ...ops.log_assignment import filter_matches_from_stats, fused_log_assignment
from ..base_model import BaseModel


def normalize_keypoints(
    kpts: torch.Tensor,
    size: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Center/scale keypoints into ~[-1, 1]; without an image size the span
    of the valid keypoints defines the frame."""
    if size is None:
        big = kpts if mask is None else kpts.masked_fill(~mask[..., None], float("-inf"))
        small = kpts if mask is None else kpts.masked_fill(~mask[..., None], float("inf"))
        size = 1.0 + big.amax(dim=-2) - small.amin(dim=-2)
    size = size.to(kpts.dtype)
    shift = size / 2
    scale = size.amax(dim=-1) / 2
    return (kpts - shift[..., None, :]) / scale[..., None, None]


class LightGlue(BaseModel):
    default_conf = {
        "name": "lightglue",
        "input_dim": 256,
        "add_scale_ori": False,
        "descriptor_dim": 256,
        "n_layers": 9,
        "num_heads": 4,
        "mp": False,  # bf16 through the transformer stack
        "depth_confidence": -1.0,
        "width_confidence": -1.0,
        "filter_threshold": 0.0,
        "collect_layers": True,
        "posenc": "conditional_fourier",
        "is_training": False,
    }
    required_data_keys = ["keypoints0", "keypoints1", "descriptors0", "descriptors1"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        conf = self.conf
        if conf.depth_confidence > 0 or conf.width_confidence > 0:
            raise NotImplementedError(
                "adaptive depth/width inference is not ported yet (ROADMAP Queue 1 item 6)"
            )
        if conf.is_training:
            raise NotImplementedError("LightGlue training is not ported yet (ROADMAP Queue 1 item 8)")
        if conf.add_scale_ori:
            raise NotImplementedError("add_scale_ori is not ported yet")
        d, n = conf.descriptor_dim, conf.n_layers
        dh = d // conf.num_heads
        gen = torch.Generator().manual_seed(0)  # random init before weights load

        def lecun(*shape):
            fan_in = shape[-2]
            return torch.randn(*shape, generator=gen) * fan_in**-0.5

        shapes = {}
        if conf.input_dim != d:
            shapes["input_proj_w"] = lambda: lecun(conf.input_dim, d)
            shapes["input_proj_b"] = lambda: torch.zeros(d)
        shapes["posenc_Wr"] = lambda: torch.randn(2, dh // 2, generator=gen)
        if conf.posenc == "conditional_fourier":
            shapes["posenc_cond_w"] = lambda: lecun(1, dh // 2)
            shapes["posenc_cond_b"] = lambda: torch.zeros(dh // 2)
        stacks = {
            "self_Wqkv": (d, 3 * d), "self_out": (d, d), "self_ffn1": (2 * d, 2 * d),
            "self_ffn2": (2 * d, d), "cross_qk": (d, d), "cross_v": (d, d),
            "cross_out": (d, d), "cross_ffn1": (2 * d, 2 * d), "cross_ffn2": (2 * d, d),
            "assign_proj": (d, d), "assign_match": (d, 1),
        }
        for name, (din, dout) in stacks.items():
            shapes[name + "_w"] = lambda din=din, dout=dout: lecun(n, din, dout)
            shapes[name + "_b"] = lambda dout=dout: torch.zeros(n, dout)
        for blk in ("self", "cross"):
            shapes[blk + "_ln_scale"] = lambda: torch.ones(n, 2 * d)
            shapes[blk + "_ln_bias"] = lambda: torch.zeros(n, 2 * d)
        shapes["conf_head_w"] = lambda: lecun(max(n - 1, 1), d, 1)
        shapes["conf_head_b"] = lambda: torch.zeros(max(n - 1, 1), 1)
        for name, make in shapes.items():
            self.register_parameter(name, nn.Parameter(make(), requires_grad=False))
        self.to(self.device)
        self._cast_cache: dict = {}

    def _load_from_state_dict(self, *args, **kwargs):
        self._cast_cache = {}
        return super()._load_from_state_dict(*args, **kwargs)

    # ------------------------------------------------------------------ utils
    def _layer(self, i: int, dtype: torch.dtype):
        """Per-layer block weights in the activation dtype, contiguous
        (cached: the parameters are fixed at inference)."""
        key = (i, dtype)
        if key not in self._cast_cache:
            p = lambda name: getattr(self, name)[i].to(dtype).contiguous()
            self_args = [p(f"self_{k}") for k in (
                "Wqkv_w", "Wqkv_b", "out_w", "out_b", "ffn1_w", "ffn1_b",
                "ln_scale", "ln_bias", "ffn2_w", "ffn2_b")]
            cross_args = [p(f"cross_{k}") for k in (
                "qk_w", "qk_b", "v_w", "v_b", "out_w", "out_b", "ffn1_w", "ffn1_b",
                "ln_scale", "ln_bias", "ffn2_w", "ffn2_b")]
            self._cast_cache[key] = (self_args, cross_args)
        return self._cast_cache[key]

    def _posenc(self, kpts: torch.Tensor, num_valid: float):
        """Rotary (cos, sin), each (B, N, Dh): the encoding is the same for
        every head, so one head's slice carries it."""
        projected = kpts @ self.posenc_Wr
        if self.conf.posenc == "conditional_fourier":
            cond = torch.full(kpts.shape[:1] + (1,), max(float(num_valid), 0.0),
                              device=kpts.device, dtype=projected.dtype)
            projected = projected + (cond @ self.posenc_cond_w + self.posenc_cond_b)[:, None, :]
        cos = torch.cos(projected).repeat_interleave(2, dim=-1)
        sin = torch.sin(projected).repeat_interleave(2, dim=-1)
        return cos, sin

    # ----------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        conf = self.conf
        kpts0, kpts1 = data["keypoints0"], data["keypoints1"]
        b, m, _ = kpts0.shape
        n = kpts1.shape[1]
        mask0 = data.get("keypoint_mask0")
        mask1 = data.get("keypoint_mask1")
        size0 = data.get("view0", {}).get("image_size")
        size1 = data.get("view1", {}).get("image_size")
        kn0 = normalize_keypoints(kpts0, size0, mask0)
        kn1 = normalize_keypoints(kpts1, size1, mask1)

        desc0, desc1 = data["descriptors0"], data["descriptors1"]
        if conf.input_dim != conf.descriptor_dim:
            desc0 = desc0 @ self.input_proj_w + self.input_proj_b
            desc1 = desc1 @ self.input_proj_w + self.input_proj_b
        dtype = torch.bfloat16 if conf.mp else torch.float32
        desc0, desc1 = desc0.to(dtype), desc1.to(dtype)

        # the conditional encoding uses the padded keypoint count, like the fork
        cos0, sin0 = self._posenc(kn0, m)
        cos1, sin1 = self._posenc(kn1, n)

        desc0, desc1, all0, all1 = self._run_layers(
            desc0, desc1, (cos0, sin0), (cos1, sin1), mask0, mask1
        )

        # final assignment (fp32), fused with the match statistics
        i_exit = conf.n_layers - 1
        d = conf.descriptor_dim
        w, bproj = self.assign_proj_w[i_exit], self.assign_proj_b[i_exit]
        mdesc0 = ((desc0.float() @ w + bproj) / d**0.25).contiguous()
        mdesc1 = ((desc1.float() @ w + bproj) / d**0.25).contiguous()
        wm, bm = self.assign_match_w[i_exit], self.assign_match_b[i_exit]
        z0 = (desc0.float() @ wm + bm)[..., 0].contiguous()
        z1 = (desc1.float() @ wm + bm)[..., 0].contiguous()
        scores, rowmax, rowarg, colmax, colarg = fused_log_assignment(
            mdesc0, mdesc1, z0, z1, mask0, mask1
        )
        m0, m1, mscores0, mscores1 = filter_matches_from_stats(
            rowmax, rowarg, colmax, colarg, conf.filter_threshold
        )
        full = lambda k: torch.full((b, k), float(conf.n_layers), device=kpts0.device)
        return {
            "matches0": m0,
            "matches1": m1,
            "matching_scores0": mscores0,
            "matching_scores1": mscores1,
            "ref_descriptors0": all0.transpose(0, 1),  # (B, L, M, D)
            "ref_descriptors1": all1.transpose(0, 1),
            "log_assignment": scores,
            "prune0": full(m),
            "prune1": full(n),
            "stop_layer": torch.tensor(i_exit, dtype=torch.int32),
        }

    def _run_layers(self, desc0, desc1, enc0, enc1, mask0, mask1):
        """Full depth over both sets stacked as (2B, N, D), N = max(m, n)."""
        b, m = desc0.shape[:2]
        n = desc1.shape[1]
        length = max(m, n)
        masked = mask0 is not None or mask1 is not None or m != n

        def pad(t, k, value=0.0):
            return F.pad(t, (0, 0, 0, length - k), value=value) if t.ndim == 3 else \
                F.pad(t, (0, length - k), value=value)

        def valid(mk, k):
            mk = torch.ones((b, k), dtype=torch.bool, device=desc0.device) if mk is None else mk
            return pad(mk, k, value=False)

        desc = torch.cat([pad(desc0, m), pad(desc1, n)], dim=0).contiguous()
        dt = desc.dtype
        cos = torch.cat([pad(enc0[0], m), pad(enc1[0], n)], dim=0).to(dt).contiguous()
        sin = torch.cat([pad(enc0[1], m), pad(enc1[1], n)], dim=0).to(dt).contiguous()
        mask = torch.cat([valid(mask0, m), valid(mask1, n)], dim=0).contiguous() if masked else None

        nh = self.conf.num_heads
        collect = self.conf.collect_layers
        layers = []
        for i in range(self.conf.n_layers):
            self_args, cross_args = self._layer(i, dt)
            desc = fused_self_block(desc, cos, sin, mask, *self_args, num_heads=nh, masked=masked)
            desc = fused_cross_block(desc, mask, *cross_args, num_heads=nh, masked=masked)
            if collect:
                layers.append(desc)
        alls = torch.stack(layers) if collect else desc[None]
        return desc[:b, :m], desc[b:, :n], alls[:, :b, :m], alls[:, b:, :n]


__main_model__ = LightGlue
