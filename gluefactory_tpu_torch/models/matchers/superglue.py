"""SuperGlue matcher, inference and training (counterpart of
gluefactory_tpu/models/matchers/superglue.py).

Keypoint encoder MLP (position + score -> descriptor space), attentional
GNN with alternating self and cross message passing, and a log-space
Sinkhorn optimal-transport assignment with a learned dustbin score. Padding
masks (True = valid) exclude invalid keypoints from the attention and from
the transport marginals.

The attention runs on the per-head (B, H, N, Dh) layout through
`ops.attention.masked_attention`: the CUDA kernel on the card (four launches
a layer pair: two self, two cross), the plain version on the CPU. Everything
else is torch calls in fp32. `weights.superglue_from_flax` maps the JAX
model's parameter tree (or a tree of its gradients) onto this module's
state dict, and `conf.weights` loads an `.npz` of such a tree, strictly:
`scripts/convert_weights.py` writes one from the official weights, whose
BatchNorms it folds into the dense layers, so it needs `ln: False`.

With `is_training` the forward is differentiable and the parameters train:
the attention's backward is the backward kernel on the per-head layout (one
launch an attention call), and the 50 Sinkhorn iterations are torch calls
that autograd differentiates (the JAX package has no kernel for them).
`loss` is the NLL of the log assignment against the ground-truth assignment
(`models/utils/losses.nll_loss`, `loss.nll_balancing`), with the matcher
metrics when not training. (The JAX model calls its XLA attention here,
with a comment that the Pallas kernel lacks a VJP; its kernel has had one
since `fused_attention`'s `custom_vjp`, and the port keeps its kernel.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.assignment import filter_matches
from ...ops.attention import masked_attention
from ..base_model import BaseModel
from ..utils.losses import nll_loss
from ..utils.metrics import matcher_metrics

_NEG_INF = -1e9


def normalize_keypoints_superglue(kpts, size=None, mask=None):
    """SuperGlue's own normalisation: shift by size / 2, scale by
    0.7 * max(size); without an image size the span of the valid keypoints
    defines the frame."""
    if size is None:
        big = kpts if mask is None else kpts.masked_fill(~mask[..., None], float("-inf"))
        small = kpts if mask is None else kpts.masked_fill(~mask[..., None], float("inf"))
        size = 1.0 + big.amax(dim=-2) - small.amin(dim=-2)
    size = size.to(kpts.dtype)
    shift = size / 2
    scale = size.amax(dim=-1) * 0.7
    return (kpts - shift[..., None, :]) / scale[..., None, None]


def log_sinkhorn_iterations(Z, log_mu, log_nu, iters: int):
    """Log-space Sinkhorn: `iters` alternating row and column updates."""
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores, alpha, iters: int, mask0=None, mask1=None):
    """Differentiable optimal transport with dustbins, masked: padded
    keypoints get zero marginal mass. scores (B, M, N) -> (B, M+1, N+1)."""
    b, m, n = scores.shape
    ones = lambda k: torch.ones((b, k), device=scores.device)
    one0 = ones(m) if mask0 is None else mask0.float()
    one1 = ones(n) if mask1 is None else mask1.float()
    ms, ns = one0.sum(-1), one1.sum(-1)  # valid counts

    alpha = alpha.to(scores.dtype)
    bins0 = alpha.expand(b, m, 1)
    bins1 = alpha.expand(b, 1, n)
    if mask0 is not None:
        pair = mask0[:, :, None] & mask1[:, None, :]
        scores = scores.masked_fill(~pair, _NEG_INF)
        bins0 = bins0.masked_fill(~mask0[:, :, None], _NEG_INF)
        bins1 = bins1.masked_fill(~mask1[:, None, :], _NEG_INF)
    couplings = torch.cat([torch.cat([scores, bins0], -1),
                           torch.cat([bins1, alpha.expand(b, 1, 1)], -1)], 1)

    norm = -torch.log(ms + ns)  # (B,)
    neg = torch.full_like(one0[:, :1], _NEG_INF)
    log_mu = torch.cat([torch.where(one0 > 0, norm[:, None], neg),
                        (torch.log(ns) + norm)[:, None]], 1)
    log_nu = torch.cat([torch.where(one1 > 0, norm[:, None], neg),
                        (torch.log(ms) + norm)[:, None]], 1)
    Z = log_sinkhorn_iterations(couplings, log_mu, log_nu, iters)
    return Z - norm[:, None, None]


class _MLP(nn.Module):
    """Dense layers with LayerNorm (eps 1e-6) + ReLU between them."""

    def __init__(self, cin: int, layers, use_ln: bool = True):
        super().__init__()
        widths = [cin, *layers]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.norm = nn.ModuleList(
            nn.LayerNorm(c, eps=1e-6) for c in (layers[:-1] if use_ln else ()))
        self.use_ln = use_ln

    def forward(self, x):
        for i, dense in enumerate(self.dense):
            x = dense(x)
            if i < len(self.dense) - 1:
                if self.use_ln:
                    x = self.norm[i](x)
                x = F.relu(x)
        return x


class _GNNLayer(nn.Module):
    """One attentional message-passing step."""

    def __init__(self, dim: int, num_heads: int, use_ln: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.q, self.k, self.v, self.out = (nn.Linear(dim, dim) for _ in range(4))
        self.mlp = _MLP(2 * dim, (2 * dim, dim), use_ln)

    def forward(self, x, source, mask_x, mask_s):
        h = self.num_heads

        def heads(t):
            b, n, d = t.shape
            return t.reshape(b, n, h, d // h).transpose(1, 2)

        msg = masked_attention(heads(self.q(x)), heads(self.k(source)), heads(self.v(source)),
                               mask_x, mask_s)
        b, _, n, _ = msg.shape
        msg = self.out(msg.transpose(1, 2).reshape(b, n, -1))
        return x + self.mlp(torch.cat([x, msg], -1))


class SuperGlue(BaseModel):
    default_conf = {
        "name": "superglue",
        "input_dim": 256,
        "descriptor_dim": 256,
        "weights": None,  # a convert_weights .npz of the official weights (needs ln: False)
        "keypoint_encoder": [32, 64, 128, 256],
        "GNN_layers": 9,  # pairs of (self, cross)
        "num_heads": 4,
        "sinkhorn_iterations": 50,
        "filter_threshold": 0.2,
        "ln": True,  # LayerNorm in the MLPs
        "is_training": False,
        "loss": {"nll_balancing": 0.5},
    }
    required_data_keys = ["keypoints0", "keypoints1", "descriptors0", "descriptors1"]

    def __init__(self, conf=None, device="cuda"):
        super().__init__(conf, device)
        conf = self.conf
        d = conf.descriptor_dim
        self.kenc = _MLP(3, (*conf.keypoint_encoder, d), conf.ln)
        # layer 2i is the self step of pair i, layer 2i + 1 its cross step
        self.gnn = nn.ModuleList(
            _GNNLayer(d, conf.num_heads, conf.ln) for _ in range(2 * conf.GNN_layers))
        self.final_proj = nn.Linear(d, d)
        self.bin_score = nn.Parameter(torch.ones(()))
        # the JAX model's initialisation (LeCun-normal kernels, zero biases), seeded
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                     * mod.in_features**-0.5)
                    mod.bias.zero_()
        if conf.weights:
            from ...weights import load_superglue_npz

            self.load_state_dict(load_superglue_npz(conf.weights))
        self.requires_grad_(bool(conf.is_training))
        self.to(self.device)

    def forward(self, data: dict) -> dict:
        if self.conf.is_training:
            return self._forward(data)
        with torch.no_grad():
            return self._forward(data)

    def _forward(self, data: dict) -> dict:
        self.check_required_keys(data)
        conf = self.conf
        kpts0, kpts1 = data["keypoints0"], data["keypoints1"]
        mask0, mask1 = data.get("keypoint_mask0"), data.get("keypoint_mask1")
        size0 = data.get("view0", {}).get("image_size")
        size1 = data.get("view1", {}).get("image_size")
        kn0 = normalize_keypoints_superglue(kpts0, size0, mask0)
        kn1 = normalize_keypoints_superglue(kpts1, size1, mask1)
        sc0 = data.get("keypoint_scores0")
        sc1 = data.get("keypoint_scores1")
        sc0 = torch.ones_like(kpts0[..., 0]) if sc0 is None else sc0
        sc1 = torch.ones_like(kpts1[..., 0]) if sc1 is None else sc1

        desc0 = data["descriptors0"] + self.kenc(torch.cat([kn0, sc0[..., None]], -1))
        desc1 = data["descriptors1"] + self.kenc(torch.cat([kn1, sc1[..., None]], -1))
        for i, layer in enumerate(self.gnn):
            if i % 2 == 0:  # self
                desc0 = layer(desc0, desc0, mask0, mask0)
                desc1 = layer(desc1, desc1, mask1, mask1)
            else:  # cross, both from the descriptors before the step
                desc0, desc1 = (layer(desc0, desc1, mask0, mask1),
                                layer(desc1, desc0, mask1, mask0))

        mdesc0, mdesc1 = self.final_proj(desc0), self.final_proj(desc1)
        scores = torch.einsum("bmd,bnd->bmn", mdesc0, mdesc1).float() / conf.descriptor_dim**0.5
        log_assignment = log_optimal_transport(
            scores, self.bin_score, conf.sinkhorn_iterations, mask0, mask1)
        m0, m1, ms0, ms1 = filter_matches(log_assignment, conf.filter_threshold)
        return {
            "matches0": m0,
            "matches1": m1,
            "matching_scores0": ms0,
            "matching_scores1": ms1,
            "log_assignment": log_assignment,
        }

    def loss(self, pred: dict, data: dict):
        """(losses, metrics), dicts of (B,) tensors: the NLL of the log
        assignment (`total`) and its components; the matcher metrics when
        not training."""
        nll, _, metrics_nll = nll_loss(pred, data, nll_balancing=self.conf.loss.nll_balancing)
        metrics = {} if self.conf.is_training else matcher_metrics(pred, data)
        return {"total": nll, **metrics_nll}, metrics


__main_model__ = SuperGlue
