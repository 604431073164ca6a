"""LightGlue matcher: full-depth and adaptive inference, and training
(counterpart of gluefactory_tpu/models/matchers/lightglue.py).

Parameters keep the JAX package's names and stacked (L, in, out) layout,
so a flax tree maps onto them leaf for leaf (weights.params_from_jax).

Inference (`is_training: False`) runs under `torch.no_grad()`: every layer
goes through the block ops of ops/lightglue_block.py and the exit
assignment through ops/log_assignment.py, their CUDA kernels on the card
and their plain versions on the CPU. Both keypoint sets run stacked on the
batch axis, (2B, N, D), as the JAX stacked path does for m == n. When
m != n the shorter set is padded with masked tokens to the common length:
masked tokens are excluded as keys and their rows are dropped afterwards,
so the valid outputs are those of the unstacked path (lightglue.py:495-509).

Training (`is_training: True`) is differentiable and runs the unfused
layers, as the JAX package does: dense projections, LayerNorm and GELU are
torch calls, the attention goes through ops/fused_attention.py (packed self
attention, bidirectional cross attention and their backward: CUDA kernels
on the card, plain versions on the CPU; `flash: False` takes the plain
versions on any device, as the JAX package's XLA path). m == n runs stacked
(`_layer_stacked`), m != n as two sets (`_layer`). Per-layer descriptors
are always collected for the deep-supervision `loss`; `checkpointed`
recomputes each layer in the backward. The exit assignment is the plain
differentiable one, as in the JAX package (the fused one is forward-only).

Adaptive inference (`depth_confidence` and/or `width_confidence` > 0): a
Python loop over the layers in place of the JAX package's `lax.while_loop`.
After each layer the token confidences decide whether the whole batch stops
(every element's confident share over `depth_confidence`), and tokens that
are confident and unmatchable leave the active sets. The active masks are
the kernels' masks, so pruning bites inside them. Once every element's
active set fits the static capacity (`width_capacity`), the survivors are
gathered into compact buffers and the remaining layers run there. The loop
reads one flag pair (stop, fits) on the host a layer. A layer goes through
the block kernels when both sides have one width that is a multiple of 128
and at most 1024, else through the unfused layer (the attention kernels of
ops/fused_attention.py). The exit assignment runs over the active tokens.
Where the loop ends (an exit, or the last layer) before every active set
fits the capacity, the port does what the JAX model's code does
(gluefactory_tpu/models/matchers/lightglue.py:735-762): only the first C
active tokens of each set, in their original order, stay active for the
exit assignment, and the rest are dropped. `width_capacity: -1` keeps every
active token.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ...ops.assignment import filter_matches, sigmoid_log_double_softmax
from ...ops.attention import (
    apply_rotary,
    cross_attention_bidirectional_packed,
    cross_attention_bidirectional_stacked,
    self_attention_packed,
)
from ...ops.fused_attention import (
    fused_attention_packed,
    fused_cross_attention_packed,
    fused_cross_attention_stacked,
)
from ...ops.lightglue_block import fused_cross_block, fused_self_block
from ...ops.log_assignment import filter_matches_from_stats, fused_log_assignment
from ..base_model import BaseModel
from ..utils.losses import nll_loss
from ..utils.metrics import matcher_metrics


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
        "flash": True,  # training attention through the kernels (False: plain versions)
        "depth_confidence": -1.0,
        "width_confidence": -1.0,
        # compact width of the pruned sets, a fraction of the keypoint count
        # (or an absolute count); <= 0 keeps pruning mask-only. Where the loop
        # ends before the active sets fit, only the first C active tokens of
        # each set reach the exit assignment, as in the JAX model: -1 keeps
        # every token
        "width_capacity": 0.5,
        "filter_threshold": 0.0,
        "checkpointed": False,  # training: recompute each layer in the backward
        "collect_layers": True,
        "posenc": "conditional_fourier",
        "is_training": False,
        "loss": {"gamma": 1.0, "fn": "nll", "nll_balancing": 0.5},
    }
    required_data_keys = ["keypoints0", "keypoints1", "descriptors0", "descriptors1"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        conf = self.conf
        if conf.add_scale_ori:
            raise NotImplementedError(
                "add_scale_ori is not ported yet (ROADMAP Queue 1 item 9, with the "
                "extractors that give scales and orientations)")
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
            self.register_parameter(name, nn.Parameter(make()))
        self.to(self.device)
        # the fixed confidence schedule, fp32 values as Python floats
        self.confidence_thresholds = np.clip(
            0.8 + 0.1 * np.exp(-4.0 * np.arange(n) / n), 0.0, 1.0).astype(np.float32).tolist()
        self._cast_cache: dict = {}
        self._cast_stamp = None

    # ------------------------------------------------------------------ utils
    def _drop_stale_casts(self):
        """Empty the cache of cast weights if a parameter changed since it was
        filled (an optimizer step or a load bumps its version counter)."""
        stamp = tuple((p._version, p.data_ptr()) for p in self.parameters())
        if stamp != self._cast_stamp:
            self._cast_cache, self._cast_stamp = {}, stamp

    def _block_weights(self, i: int, dtype: torch.dtype):
        """Per-layer weights of the inference block kernels in the activation
        dtype, contiguous (cached, see `_drop_stale_casts`)."""
        key = (i, dtype)
        if key not in self._cast_cache:
            p = lambda name: getattr(self, name)[i].detach().to(dtype).contiguous()
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
    def forward(self, data: dict) -> dict:
        if self.conf.is_training:
            return self._forward(data)
        with torch.no_grad():
            return self._forward(data)

    def _forward(self, data: dict) -> dict:
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

        do_early_stop = conf.depth_confidence > 0 and not conf.is_training
        do_point_pruning = conf.width_confidence > 0 and not conf.is_training
        full = lambda k: torch.full((b, k), float(conf.n_layers), device=kpts0.device)
        if do_early_stop or do_point_pruning:
            ones = lambda k: torch.ones((b, k), dtype=torch.bool, device=kpts0.device)
            (desc0, desc1, i_exit, act0, act1, prune0, prune1,
             compact) = self._run_layers_adaptive(
                desc0, desc1, (cos0, sin0), (cos1, sin1),
                ones(m) if mask0 is None else mask0, ones(n) if mask1 is None else mask1)
            all0, all1 = desc0[None], desc1[None]
            # the exit assignment runs over the active tokens
            if mask0 is not None or do_point_pruning:
                mask0 = act0
            if mask1 is not None or do_point_pruning:
                mask1 = act1
        else:
            run = self._run_layers_train if conf.is_training else self._run_layers
            desc0, desc1, all0, all1 = run(desc0, desc1, (cos0, sin0), (cos1, sin1), mask0, mask1)
            i_exit = conf.n_layers - 1
            prune0, prune1 = full(m), full(n)
            compact = -1

        if conf.is_training:
            scores = self._assignment(i_exit, desc0, desc1, mask0, mask1)
            m0, m1, mscores0, mscores1 = filter_matches(scores, conf.filter_threshold)
        else:
            scores, m0, m1, mscores0, mscores1 = self._fused_assignment(
                i_exit, desc0, desc1, mask0, mask1)
        return {
            "matches0": m0,
            "matches1": m1,
            "matching_scores0": mscores0,
            "matching_scores1": mscores1,
            "ref_descriptors0": all0.transpose(0, 1),  # (B, L, M, D)
            "ref_descriptors1": all1.transpose(0, 1),
            "log_assignment": scores,
            "prune0": prune0,
            "prune1": prune1,
            "stop_layer": torch.tensor(i_exit, dtype=torch.int32),
            # first layer that ran on the compact buffers, -1 if none did
            "compact_layer": torch.tensor(compact, dtype=torch.int32),
        }

    def _fused_assignment(self, i_exit, desc0, desc1, mask0, mask1):
        """Exit assignment (fp32) fused with the match statistics: inference."""
        conf = self.conf
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
        return (scores, *filter_matches_from_stats(
            rowmax, rowarg, colmax, colarg, conf.filter_threshold))

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
        self._drop_stale_casts()
        layers = []
        for i in range(self.conf.n_layers):
            self_args, cross_args = self._block_weights(i, dt)
            desc = fused_self_block(desc, cos, sin, mask, *self_args, num_heads=nh, masked=masked)
            desc = fused_cross_block(desc, mask, *cross_args, num_heads=nh, masked=masked)
            if collect:
                layers.append(desc)
        alls = torch.stack(layers) if collect else desc[None]
        return desc[:b, :m], desc[b:, :n], alls[:, :b, :m], alls[:, b:, :n]

    # ------------------------------------------------------ adaptive inference
    def _resolve_capacity(self, n_pts: int) -> int:
        """Static compact width for a side with n_pts slots (a multiple of 128
        from 256 keypoints up, else of 8); 0 disables."""
        cap = self.conf.width_capacity
        if cap is None or cap <= 0 or self.conf.width_confidence <= 0:
            return 0
        c = int(cap) if cap > 1 else int(np.ceil(cap * n_pts))
        mult = 128 if n_pts >= 256 else 8
        c = int(min(n_pts, -(-c // mult) * mult))
        return 0 if c >= n_pts else c

    def _token_heads(self, i: int):
        """(D, 2) weight and (2,) bias, fp32, of the two per-token heads read
        after layer i: the confidence head (layer min(i, L - 2)) and the
        matchability head (cached like the block weights)."""
        key = ("heads", i)
        if key not in self._cast_cache:
            j = min(i, max(self.conf.n_layers - 2, 0))
            w = torch.cat([self.conf_head_w[j], self.assign_match_w[i]], dim=1)
            b = torch.cat([self.conf_head_b[j], self.assign_match_b[i]])
            self._cast_cache[key] = (w.detach().float().contiguous(), b.detach().float())
        return self._cast_cache[key]

    def _make_adaptive_layer(self, enc0, enc1, dt):
        """`layer(i, d0, d1, a0, a1) -> (d0, d1)` for sets of the widths of
        enc0 / enc1, with the active masks a0 / a1 as the attention masks:
        the block kernels when both widths are one kernel-friendly width,
        else the unfused layer."""
        nh = self.conf.num_heads
        mloc, nloc = enc0[0].shape[1], enc1[0].shape[1]
        if mloc == nloc and mloc % 128 == 0 and mloc <= 1024:
            cos, sin = (torch.cat([e0, e1], dim=0).to(dt).contiguous()
                        for e0, e1 in zip(enc0, enc1))

            def layer(i, d0, d1, a0, a1):
                b = d0.shape[0]
                self_args, cross_args = self._block_weights(i, dt)
                desc = torch.cat([d0, d1], dim=0)
                mask = torch.cat([a0, a1], dim=0)
                desc = fused_self_block(desc, cos, sin, mask, *self_args, num_heads=nh)
                desc = fused_cross_block(desc, mask, *cross_args, num_heads=nh)
                return desc[:b], desc[b:]

            return layer
        enc0, enc1 = (tuple(t.repeat(1, 1, nh).to(dt) for t in enc) for enc in (enc0, enc1))
        return lambda i, d0, d1, a0, a1: self._layer(i, d0, d1, enc0, enc1, a0, a1)

    def _run_layers_adaptive(self, desc0, desc1, enc0, enc1, act0, act1):
        """Early exit on token confidence and point pruning, in two phases:
        full-width buffers until every element's active set fits the static
        capacity, then compact (B, C) buffers of the survivors (descriptors,
        rotary encodings, masks) for the remaining layers. Returns (desc0,
        desc1, exit layer, act0, act1, prune0, prune1, first compact layer or
        -1); tokens pruned before
        the compaction keep their stale descriptors, which the masked exit
        assignment never reads. If the loop ends before compacting, the
        active masks keep only the first C active tokens of each set."""
        conf = self.conf
        n_layers = conf.n_layers
        b, m = act0.shape
        n = act1.shape[1]
        c0_cap, c1_cap = self._resolve_capacity(m), self._resolve_capacity(n)
        use_compact = c0_cap > 0 and c1_cap > 0
        self._drop_stale_casts()

        # both sets' token state side by side, (B, M + N): one pass of small ops a layer
        act = torch.cat([act0, act1], dim=1)
        prune = torch.ones((b, m + n), device=act.device)

        def fits_flag(a, split):
            return (a[:, :split].sum(-1).max() <= c0_cap) & (a[:, split:].sum(-1).max() <= c1_cap)

        d0, d1, a, split = desc0, desc1, act, m
        layer = self._make_adaptive_layer(enc0, enc1, desc0.dtype)
        idx, compact = None, -1
        fits = use_compact and bool(fits_flag(a, m))  # masked inputs may fit at once
        take = lambda t, ix: torch.gather(t, 1, ix[..., None].expand(-1, -1, t.shape[-1]))
        # the first c active slots, original order kept (stable sort)
        first = lambda t, c: torch.argsort((~t).to(torch.uint8), dim=-1, stable=True)[:, :c]
        i, stop = 0, False
        while i < n_layers and not stop:
            if use_compact and idx is None and fits:
                idx0, idx1 = first(a[:, :m], c0_cap), first(a[:, m:], c1_cap)
                idx = torch.cat([idx0, idx1 + m], dim=1)
                desc0, desc1 = d0, d1  # the first phase's buffers; survivors return here
                d0, d1, a, split = take(d0, idx0), take(d1, idx1), torch.gather(a, 1, idx), c0_cap
                layer = self._make_adaptive_layer(
                    tuple(take(t, idx0) for t in enc0), tuple(take(t, idx1) for t in enc1),
                    desc0.dtype)
                compact = i
            d0, d1 = layer(i, d0, d1, a[:, :split], a[:, split:])
            is_last = i == n_layers - 1
            stop_flag = fit_flag = None
            if not is_last:
                w, bias = self._token_heads(i)
                heads = torch.sigmoid(torch.cat([d0, d1], dim=1).float() @ w + bias)
                conf_, match_ = heads[..., 0], heads[..., 1]
                th = self.confidence_thresholds[i]
                if conf.depth_confidence > 0:
                    # inactive slots count as confident and are subtracted again, so
                    # that the ratio is the same on the full and the compact view
                    num = a.sum(-1).float()
                    ratio = ((conf_ > th) | ~a).sum(-1).float() - (a.shape[1] - num)
                    stop_flag = (ratio / num.clamp(min=1.0) > conf.depth_confidence).all()
                if conf.width_confidence > 0:
                    # keep likely-matchable or low-confidence tokens (without early exit
                    # every token counts as confident); dropped again if the batch stops here
                    keep = match_ > (1 - conf.width_confidence)
                    if conf.depth_confidence > 0:
                        keep = keep | (conf_ <= th)
                    pruned = a & keep
                    if use_compact and idx is None:
                        fit_flag = fits_flag(pruned, split)
            stop = is_last
            flags = [f for f in (stop_flag, fit_flag) if f is not None]
            if flags:
                flags = torch.stack(flags).tolist()  # the one host read of the layer
                stop = flags[0] if stop_flag is not None else stop
                fits = flags[-1] if fit_flag is not None else fits
            if conf.width_confidence > 0:
                if not stop:
                    a = pruned
                # compact survivors' counts go back to their original slots
                prune = prune + a.float() if idx is None else prune.scatter_add(1, idx, a.float())
            i += 1

        if idx is not None:
            # survivors go back; never-gathered tokens keep their descriptors of
            # the first phase and stay inactive
            put = lambda full, ix, t: full.scatter(1, ix[..., None].expand(-1, -1, t.shape[-1]), t)
            d0, d1 = put(desc0, idx0, d0), put(desc1, idx1, d1)
            a = torch.zeros_like(act).scatter(1, idx, a)
        elif use_compact:
            # the loop ended before compacting: the JAX model still gathers the
            # first C active tokens of each set (lightglue.py:735-762) and only
            # those reach the exit assignment; no layer ran on compact buffers
            idx = torch.cat([first(a[:, :m], c0_cap), first(a[:, m:], c1_cap) + m], dim=1)
            a = torch.zeros_like(act).scatter(1, idx, torch.gather(a, 1, idx))
        return d0, d1, i - 1, a[:, :m], a[:, m:], prune[:, :m], prune[:, m:], compact

    # ------------------------------------------------- training: unfused layers
    def _dense(self, x, name: str, i: int):
        """x @ W[i] + b[i] with layer i of a stacked dense, in x's dtype."""
        return x @ getattr(self, name + "_w")[i].to(x.dtype) + getattr(
            self, name + "_b")[i].to(x.dtype)

    def _ffn(self, x, message, i: int, blk: str):
        """FFN([x, message]) with the first product split into two half-K
        ones, fp32 LayerNorm (eps 1e-5) and exact GELU."""
        d = x.shape[-1]
        w1 = getattr(self, f"{blk}_ffn1_w")[i].to(x.dtype)
        y = x @ w1[:d] + message @ w1[d:] + getattr(self, f"{blk}_ffn1_b")[i].to(x.dtype)
        y = F.layer_norm(y.float(), (2 * d,), getattr(self, f"{blk}_ln_scale")[i],
                         getattr(self, f"{blk}_ln_bias")[i], eps=1e-5).to(x.dtype)
        return self._dense(F.gelu(y), f"{blk}_ffn2", i)

    def _self_block(self, i: int, x, cos, sin, mask):
        """cos/sin are the packed (S, N, D) tables in x's dtype."""
        q, k, v = self._dense(x, "self_Wqkv", i).chunk(3, dim=-1)
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        if self.conf.flash:
            context = fused_attention_packed(q, k, v, mask, mask, self.conf.num_heads)
        else:
            context = self_attention_packed(q, k, v, mask, self.conf.num_heads)
        message = self._dense(context, "self_out", i)
        return x + self._ffn(x, message, i, "self")

    def _cross_block(self, i: int, x0, x1, mask0, mask1):
        attend = (fused_cross_attention_packed if self.conf.flash
                  else cross_attention_bidirectional_packed)
        m0, m1 = attend(
            self._dense(x0, "cross_qk", i), self._dense(x1, "cross_qk", i),
            self._dense(x0, "cross_v", i), self._dense(x1, "cross_v", i),
            mask0, mask1, self.conf.num_heads)
        x0 = x0 + self._ffn(x0, self._dense(m0, "cross_out", i), i, "cross")
        x1 = x1 + self._ffn(x1, self._dense(m1, "cross_out", i), i, "cross")
        return x0, x1

    def _layer(self, i: int, desc0, desc1, enc0, enc1, mask0, mask1):
        desc0 = self._self_block(i, desc0, *enc0, mask0)
        desc1 = self._self_block(i, desc1, *enc1, mask1)
        return self._cross_block(i, desc0, desc1, mask0, mask1)

    def _layer_stacked(self, i: int, desc, cos, sin, mask):
        """One layer over both sets stacked on the batch axis (2B, N, D): one
        self and one cross attention call."""
        desc = self._self_block(i, desc, cos, sin, mask)
        attend = (fused_cross_attention_stacked if self.conf.flash
                  else cross_attention_bidirectional_stacked)
        m0, m1 = attend(
            self._dense(desc, "cross_qk", i), self._dense(desc, "cross_v", i), mask,
            self.conf.num_heads)
        message = self._dense(torch.cat([m0, m1], dim=0), "cross_out", i)
        return desc + self._ffn(desc, message, i, "cross")

    def _run_layers_train(self, desc0, desc1, enc0, enc1, mask0, mask1):
        """Full depth through the unfused layers, per-layer descriptors
        collected; with `checkpointed` each layer is recomputed in the
        backward instead of keeping its activations."""
        b, m = desc0.shape[:2]
        n = desc1.shape[1]
        nh, dt = self.conf.num_heads, desc0.dtype
        packed = lambda enc: tuple(t.repeat(1, 1, nh).to(dt) for t in enc)
        enc0, enc1 = packed(enc0), packed(enc1)

        def run(layer, *args):
            if self.conf.checkpointed:
                return checkpoint(layer, *args, use_reentrant=False)
            return layer(*args)

        if m == n:
            desc = torch.cat([desc0, desc1], dim=0)
            cos, sin = (torch.cat([e0, e1], dim=0) for e0, e1 in zip(enc0, enc1))
            mask = None
            if mask0 is not None or mask1 is not None:
                ones = torch.ones((b, m), dtype=torch.bool, device=desc.device)
                mask = torch.cat([ones if mask0 is None else mask0,
                                  ones if mask1 is None else mask1], dim=0)
            layers = []
            for i in range(self.conf.n_layers):
                desc = run(self._layer_stacked, i, desc, cos, sin, mask)
                layers.append(desc)
            alls = torch.stack(layers)
            return desc[:b], desc[b:], alls[:, :b], alls[:, b:]

        all0, all1 = [], []
        for i in range(self.conf.n_layers):
            desc0, desc1 = run(self._layer, i, desc0, desc1, enc0, enc1, mask0, mask1)
            all0.append(desc0)
            all1.append(desc1)
        return desc0, desc1, torch.stack(all0), torch.stack(all1)

    # ------------------------------------------------------- assignment, loss
    def _assignment(self, i: int, desc0, desc1, mask0, mask1):
        """Differentiable log assignment (B, M+1, N+1) at layer i, fp32."""
        d = self.conf.descriptor_dim
        desc0, desc1 = desc0.float(), desc1.float()
        mdesc0 = self._dense(desc0, "assign_proj", i) / d**0.25
        mdesc1 = self._dense(desc1, "assign_proj", i) / d**0.25
        sim = torch.einsum("bmd,bnd->bmn", mdesc0, mdesc1)
        z0 = self._dense(desc0, "assign_match", i)
        z1 = self._dense(desc1, "assign_match", i)
        return sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1)

    def _confidence_logits(self, i: int, desc):
        """Token-confidence logits at layer i < n - 1; no gradient reaches the
        descriptors."""
        return self._dense(desc.detach().float(), "conf_head", i)[..., 0]

    def loss(self, pred: dict, data: dict):
        """Deep-supervised NLL + confidence BCE over all layers: per-layer
        assignments are recomputed from the stored per-layer descriptors; the
        ground-truth weights of the final layer serve every layer. Returns
        (losses, metrics), each a dict of (B,) tensors."""
        conf = self.conf
        n_layers = conf.n_layers
        all0 = pred["ref_descriptors0"].transpose(0, 1)  # (L, B, M, D)
        all1 = pred["ref_descriptors1"].transpose(0, 1)
        mask0, mask1 = data.get("keypoint_mask0"), data.get("keypoint_mask1")
        balancing = conf.loss.nll_balancing

        la_final = self._assignment(n_layers - 1, all0[-1], all1[-1], mask0, mask1)
        nll, gt_weights, loss_metrics = nll_loss(
            {"log_assignment": la_final}, data, nll_balancing=balancing)
        losses = {
            "total": nll,
            "last": nll.detach(),
            **loss_metrics,
            "row_norm": la_final.exp()[:, :-1].sum(2).mean(1),
        }
        final_m0 = la_final.detach()[:, :-1, :].argmax(-1)
        final_m1 = la_final.detach()[:, :, :-1].argmax(-2)

        total, sum_weights = nll, 1.0
        confidence = torch.zeros_like(nll)
        for i in range(n_layers - 1):
            la_i = self._assignment(i, all0[i], all1[i], mask0, mask1)
            nll_i, _, _ = nll_loss({"log_assignment": la_i}, data, weights=gt_weights,
                                   nll_balancing=balancing)
            w = conf.loss.gamma ** (n_layers - i - 1) if conf.loss.gamma > 0.0 else i + 1.0
            total = total + nll_i * w
            sum_weights += w
            correct0 = (la_i.detach()[:, :-1, :].argmax(-1) == final_m0).float()
            correct1 = (la_i.detach()[:, :, :-1].argmax(-2) == final_m1).float()
            bce0 = _masked_bce(self._confidence_logits(i, all0[i]), correct0, mask0)
            bce1 = _masked_bce(self._confidence_logits(i, all1[i]), correct1, mask1)
            confidence = confidence + (bce0 + bce1) / 2.0 / (n_layers - 1)
        total = total / sum_weights
        losses["confidence"] = confidence
        if conf.is_training:
            total = total + confidence
        losses["total"] = total
        metrics = {} if conf.is_training else matcher_metrics(pred, data)
        return losses, metrics


def _masked_bce(logits, labels, mask):
    """Binary cross entropy with logits, averaged over the valid tokens."""
    per_tok = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    if mask is None:
        return per_tok.mean(-1)
    m = mask.to(per_tok.dtype)
    return (per_tok * m).sum(-1) / m.sum(-1).clamp(min=1.0)


__main_model__ = LightGlue
