"""Weight bridge from the JAX package's flax trees to the port's modules.

`params_from_jax(tree)` maps a flax variables tree ({"params": ...,
"batch_stats": ...} of numpy arrays, nested dicts or flat "a/b/c" keys) to
a flat state dict of the port:

  - SuperPoint `VGGBlock_i/Conv_0/kernel` (HWIO) -> `blocks.i.conv.weight`
    (OIHW), its bias -> `blocks.i.conv.bias`;
  - `VGGBlock_i/BatchNorm_0/{scale,bias}` and the `batch_stats`
    `{mean,var}` -> `blocks.i.bn_{scale,bias,mean,var}`;
  - LightGlue leaves keep their names and their stacked layout: dense
    weights stay (L, in, out), which is the row-major (K, N) operand the
    CUDA kernels read, so one layer is a contiguous slice;
  - the nested trees of the models whose torch modules carry the flax
    names (SuperPoint-MagicLeap `conv1a/kernel`, MultiPoint
    `encoder_optical/Conv_0/kernel`, XPoint's backbones down to
    `stage0_block0/attn/cpb_fc1/kernel`; ALIKED `block3/conv1/offset_conv/kernel`,
    DISK `_Down_0/GroupNorm_0/scale`, KeyNet-HardNet
    `_KeyNetScoreHead_0/bn0/scale` and its `batch_stats`, DINOv2
    `block_0/q/kernel`): the path joined by dots, a conv
    `kernel` (HWIO) -> `weight` (OIHW), a Dense `kernel` (in, out) ->
    `nn.Linear`'s `weight` (out, in), a BatchNorm's or LayerNorm's `scale`
    -> `weight`, `batch_stats` `mean` / `var` -> `running_mean` /
    `running_var`; other parameters keep name and layout (SwinV2's raw
    `qkv` (in, 3 dim), `q_bias`, `v_bias`, `logit_scale`, SwinIR's
    `relative_position_bias_table`; ALIKED's `sddh_*` and DISK-official's
    `down_0_conv_w` (HWIO) top-level leaves, DINOv2's `cls_token`,
    `pos_embed` and LayerScale `ls1` / `ls2`, LightGlue's `posenc_Wr`, (2,
    F/2) or with `add_scale_ori` (4, F/2));
  - a component prefix (`extractor/`, `matcher/`) becomes `extractor.` /
    `matcher.`, the key layout of the two-view pipeline's state dict;
  - f16 leaves are upcast to f32.

`params_to_jax(state_dict)` is the inverse: the nested flax variables tree
(numpy arrays) of a port state dict, so that a trained checkpoint of the
port can be handed to the JAX package.

`superglue_from_flax(params)` maps the JAX SuperGlue's parameter tree to
the port's SuperGlue state dict: `Dense_*` kernels (in, out) transposed to
`nn.Linear` weights (out, in), LayerNorm scale / bias, `bin_score`.

`load_npz(path)` maps a flat `.npz` of a flax tree (the layout that
`scripts/convert_weights.py` writes, in either package: an extractor's or
`lightglue_pretrained`'s `conf.weights`); `load_superglue_npz(path)` one of
the SuperGlue tree (SuperGlue's `conf.weights`);
`load_hermetic(path)` reads the committed flat npz artifact
(counterpart of gluefactory_tpu/models/matchers/lightglue_pretrained.py:20-67).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .models.base_model import resolve_device

HERMETIC = Path(__file__).resolve().parent.parent / "weights" / "hermetic" / "sp_open_lg.npz"

_VGG = re.compile(r"VGGBlock_(\d+)/(Conv_0|BatchNorm_0)/(\w+)$")
_FLAX_LEAVES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
                "var": "running_var"}
_VGG_NAMES = {
    ("Conv_0", "kernel"): "conv.weight",
    ("Conv_0", "bias"): "conv.bias",
    ("BatchNorm_0", "scale"): "bn_scale",
    ("BatchNorm_0", "bias"): "bn_bias",
    ("BatchNorm_0", "mean"): "bn_mean",
    ("BatchNorm_0", "var"): "bn_var",
}


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def port_key(path: str) -> str:
    """Port state-dict key of one flax leaf path ("params/matcher/x", ...)."""
    parts = path.split("/")
    if parts[0] in ("params", "batch_stats"):
        parts = parts[1:]
    prefix = ""
    if parts[0] in ("extractor", "matcher"):
        prefix, parts = parts[0] + ".", parts[1:]
    rest = "/".join(parts)
    m = _VGG.match(rest)
    if m:
        return f"{prefix}blocks.{m.group(1)}.{_VGG_NAMES[(m.group(2), m.group(3))]}"
    if len(parts) > 1:  # a nested module tree
        return prefix + ".".join(parts[:-1] + [_FLAX_LEAVES.get(parts[-1], parts[-1])])
    return prefix + rest


def params_from_jax(tree: Mapping[str, Any]) -> dict:
    """Flat port state dict (fp32 CPU tensors) of a flax variables tree."""
    out = {}
    for path, leaf in _flatten(tree).items():
        arr = np.asarray(leaf)
        if arr.dtype == np.float16:
            arr = arr.astype(np.float32)
        if path.endswith("/kernel"):
            # a conv's HWIO -> OIHW, a Dense's (in, out) -> (out, in)
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[port_key(path)] = torch.from_numpy(np.array(arr, order="C"))
    return out


_VGG_PORT = re.compile(r"blocks\.(\d+)\.(.+)$")
_VGG_LEAVES = {v: k for k, v in _VGG_NAMES.items()}


def params_to_jax(state_dict: Mapping[str, Any]) -> dict:
    """Nested flax variables tree ({"params": ..., "batch_stats": ...}, fp32
    numpy arrays) of a port state dict: the inverse of `params_from_jax`."""
    tree: dict = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().float().numpy()
        parts = []
        if key.split(".")[0] in ("extractor", "matcher"):
            comp, key = key.split(".", 1)
            parts.append(comp)
        collection = "params"
        m = _VGG_PORT.match(key)
        if m:
            module, leaf = _VGG_LEAVES[m.group(2)]
            if leaf in ("mean", "var"):
                collection = "batch_stats"
            if leaf == "kernel":
                arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            parts += [f"VGGBlock_{m.group(1)}", module, leaf]
        elif "." in key:  # a nested module tree
            *modules, leaf = key.split(".")
            if leaf in ("running_mean", "running_var"):
                collection, leaf = "batch_stats", leaf[len("running_"):]
            elif leaf == "weight":
                leaf = "kernel" if arr.ndim > 1 else "scale"
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            parts += modules + [leaf]
        else:
            parts.append(key)
        node = tree.setdefault(collection, {})
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr.copy()
    return tree


_SG_GNN = re.compile(r"(self|cross)_(\d+)/(.+)$")
_SG_DENSE = {"Dense_0": "q", "Dense_1": "k", "Dense_2": "v", "Dense_3": "out"}
_SG_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _superglue_key(path: str) -> str:
    """Port state-dict key of one leaf path of the JAX SuperGlue's tree."""
    m = _SG_GNN.match(path)
    prefix = ""
    if m:  # layer 2i is the self step of pair i, 2i + 1 its cross step
        prefix = f"gnn.{2 * int(m.group(2)) + (m.group(1) == 'cross')}."
        path = m.group(3)
    parts = path.split("/")
    if parts[0] in ("kenc", "_MLP_0"):
        prefix += "kenc." if parts[0] == "kenc" else "mlp."
        kind, index = parts[1].rsplit("_", 1)
        return f"{prefix}{'dense' if kind == 'Dense' else 'norm'}.{index}.{_SG_LEAF[parts[2]]}"
    if len(parts) == 1:
        return prefix + parts[0]  # bin_score
    return f"{prefix}{_SG_DENSE.get(parts[0], parts[0])}.{_SG_LEAF[parts[1]]}"


def superglue_from_flax(params: Mapping[str, Any]) -> dict:
    """Port SuperGlue state dict (fp32 CPU tensors) of the JAX SuperGlue's
    parameter tree (nested or flat, with or without the "params" level)."""
    out = {}
    for path, leaf in _flatten(params).items():
        path = path[len("params/"):] if path.startswith("params/") else path
        arr = np.asarray(leaf, dtype=np.float32)
        if path.endswith("/kernel"):
            arr = arr.T  # (in, out) -> nn.Linear's (out, in)
        out[_superglue_key(path)] = torch.from_numpy(np.array(arr, order="C"))
    return out


def load_npz(path: str | Path) -> dict:
    """Port state dict (fp32 CPU tensors) of a flat `.npz` of a flax tree, as
    the JAX package's `scripts/convert_weights.py` writes one ("params/a/b"
    keys)."""
    with np.load(str(path)) as flat:
        return params_from_jax({k: flat[k] for k in flat.files})


def load_superglue_npz(path: str | Path) -> dict:
    """Port SuperGlue state dict of a flat `.npz` of the SuperGlue tree, as
    `convert_superglue` writes one."""
    with np.load(str(path)) as flat:
        return superglue_from_flax({k: flat[k] for k in flat.files})


def load_hermetic(path: str | Path = HERMETIC, device: Any = "cuda") -> dict:
    """The committed SuperPoint-open + LightGlue weights as a two-view
    pipeline state dict on `device`."""
    device = resolve_device(device)
    return {k: v.to(device) for k, v in load_npz(path).items()}


__all__ = ["HERMETIC", "params_from_jax", "params_to_jax", "port_key", "superglue_from_flax",
           "load_npz", "load_superglue_npz", "load_hermetic"]
