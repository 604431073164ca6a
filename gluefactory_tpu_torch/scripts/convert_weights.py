"""Convert public PyTorch checkpoints into flax-layout parameter trees
(counterpart of gluefactory_tpu/scripts/convert_weights.py).

The converters emit the same tree as the JAX package's, leaf for leaf, as
float32 numpy arrays, so a converted `.npz` serves either package. The port
loads one through `weights.load_npz` (`params_from_jax`): an extractor's or
`lightglue_pretrained`'s `conf.weights`, or SuperGlue's `conf.weights`
through `weights.superglue_from_flax` (with `ln: False`).

    python -m gluefactory_tpu_torch.scripts.convert_weights \\
        --kind superpoint --input superpoint_v1.pth --output sp_ml.npz
    python -m gluefactory_tpu_torch.scripts.convert_weights \\
        --kind lightglue --input superpoint_lightglue_v0-1_arxiv.pth --output lg.npz
    python -m gluefactory_tpu_torch.scripts.convert_weights \\
        --kind superglue --input superglue_outdoor.pth --output sg.npz

`.pth` files are read with `torch.load(..., weights_only=True)` (zip and
legacy formats); a `{"model": ...}` or `{"state_dict": ...}` wrapper is
unwrapped, entries that are not tensors are dropped, and floating tensors
(bf16 and fp16 included) become float32.

Mappings:
  - superpoint (MagicLeap .pth): convXy.weight (OIHW) -> convXy.kernel
    (HWIO), biases 1:1;
  - lightglue (cvg/LightGlue .pth, v0.1 names renamed first): per-layer
    tensors stacked on a leading layer axis, dense weights transposed to
    (in, out); the fused Wqkv's output channels permuted from upstream's
    (heads, head_dim, component) packing to (component, heads, head_dim);
  - superglue (MagicLeap superglue_{indoor,outdoor}.pth): Conv1d kernels ->
    Dense kernels, BatchNorm1d running statistics folded into the conv before
    it (exact at inference; the model needs `ln: False`), attention channels
    permuted from upstream's (head_dim, heads) packing to (heads, head_dim);
  - aliked, dinov2 (the HuggingFace Dinov2Model state dict), disk (the
    official thin U-Net, mapped by shape and order).

`--kind gluestick` and `--kind loftr` raise: their matchers are not ported
yet (ROADMAP Queue 1 items 5 and 3), and their converters come with them.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


# --------------------------------------------------------------------------- #
# SuperPoint (MagicLeap)
# --------------------------------------------------------------------------- #
def convert_superpoint(state: dict) -> dict:
    params = {}
    for name in (
        "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
        "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb",
    ):
        w = np.asarray(state[f"{name}.weight"])  # OIHW
        b = np.asarray(state[f"{name}.bias"])
        params[name] = {"kernel": w.transpose(2, 3, 1, 0), "bias": b}
    return {"params": params}


# --------------------------------------------------------------------------- #
# LightGlue
# --------------------------------------------------------------------------- #
def _qkv_permutation(d: int, num_heads: int) -> np.ndarray:
    """Output-channel permutation upstream -> ours for the fused Wqkv.

    Upstream channel c = h * (3 dh) + i * 3 + comp (unflatten (H, dh, 3));
    ours c = comp * d + h * dh + i (q, k, v as contiguous thirds). Returns
    perm with ours[:, c] = upstream[:, perm[c]]."""
    dh = d // num_heads
    return np.arange(3 * d).reshape(num_heads, dh, 3).transpose(2, 0, 1).reshape(-1)


def _stack(state, fmt, n, transpose=True):
    ws = [np.asarray(state[fmt.format(i)]) for i in range(n)]
    ws = [w.T if (transpose and w.ndim == 2) else w for w in ws]
    return np.stack(ws)


def convert_lightglue(state: dict, n_layers: int = 9, num_heads: int = 4) -> dict:
    """Official LightGlue state dict -> the stacked layout. Expects the
    upstream key names (transformers.{i}.self_attn..., log_assignment.{i},
    token_confidence.{i}.token.0): rename v0.1 checkpoints first."""
    p = {}

    def S(fmt):
        return _stack(state, fmt, n_layers)

    def B(fmt, n=n_layers):
        return np.stack([np.asarray(state[fmt.format(i)]) for i in range(n)])

    d = np.asarray(state["transformers.0.self_attn.out_proj.weight"]).shape[0]
    perm = _qkv_permutation(d, num_heads)
    p["self_Wqkv_w"] = S("transformers.{}.self_attn.Wqkv.weight")[:, :, perm]
    p["self_Wqkv_b"] = B("transformers.{}.self_attn.Wqkv.bias")[:, perm]
    p["self_out_w"] = S("transformers.{}.self_attn.out_proj.weight")
    p["self_out_b"] = B("transformers.{}.self_attn.out_proj.bias")
    for our, theirs in [("self_ffn1", "self_attn.ffn.0"), ("self_ffn2", "self_attn.ffn.3")]:
        p[f"{our}_w"] = S("transformers.{}." + theirs + ".weight")
        p[f"{our}_b"] = B("transformers.{}." + theirs + ".bias")
    p["self_ln_scale"] = B("transformers.{}.self_attn.ffn.1.weight")
    p["self_ln_bias"] = B("transformers.{}.self_attn.ffn.1.bias")

    p["cross_qk_w"] = S("transformers.{}.cross_attn.to_qk.weight")
    p["cross_qk_b"] = B("transformers.{}.cross_attn.to_qk.bias")
    p["cross_v_w"] = S("transformers.{}.cross_attn.to_v.weight")
    p["cross_v_b"] = B("transformers.{}.cross_attn.to_v.bias")
    p["cross_out_w"] = S("transformers.{}.cross_attn.to_out.weight")
    p["cross_out_b"] = B("transformers.{}.cross_attn.to_out.bias")
    for our, theirs in [("cross_ffn1", "cross_attn.ffn.0"), ("cross_ffn2", "cross_attn.ffn.3")]:
        p[f"{our}_w"] = S("transformers.{}." + theirs + ".weight")
        p[f"{our}_b"] = B("transformers.{}." + theirs + ".bias")
    p["cross_ln_scale"] = B("transformers.{}.cross_attn.ffn.1.weight")
    p["cross_ln_bias"] = B("transformers.{}.cross_attn.ffn.1.bias")

    p["assign_proj_w"] = S("log_assignment.{}.final_proj.weight")
    p["assign_proj_b"] = B("log_assignment.{}.final_proj.bias")
    p["assign_match_w"] = S("log_assignment.{}.matchability.weight")
    p["assign_match_b"] = B("log_assignment.{}.matchability.bias")
    p["conf_head_w"] = _stack(state, "token_confidence.{}.token.0.weight", n_layers - 1)
    p["conf_head_b"] = B("token_confidence.{}.token.0.bias", n_layers - 1)
    p["posenc_Wr"] = np.asarray(state["posenc.Wr.weight"]).T
    if "input_proj.weight" in state:
        p["input_proj_w"] = np.asarray(state["input_proj.weight"]).T
        p["input_proj_b"] = np.asarray(state["input_proj.bias"])
    if "posenc.condition_modulation.weight" in state:
        p["posenc_cond_w"] = np.asarray(state["posenc.condition_modulation.weight"]).T
        p["posenc_cond_b"] = np.asarray(state["posenc.condition_modulation.bias"])
    return {"params": p}


def rename_lightglue_v01(state: dict, n_layers: int = 9) -> dict:
    """Upstream's renaming for v0.1 checkpoints: self_attn.{i} ->
    transformers.{i}.self_attn, cross_attn.{i} -> transformers.{i}.cross_attn."""
    for i in range(n_layers):
        state = {
            k.replace(f"self_attn.{i}", f"transformers.{i}.self_attn"): v
            for k, v in state.items()
        }
        state = {
            k.replace(f"cross_attn.{i}", f"transformers.{i}.cross_attn"): v
            for k, v in state.items()
        }
    return state


# --------------------------------------------------------------------------- #
# SuperGlue (MagicLeap)
# --------------------------------------------------------------------------- #
def _fold_bn(kernel: np.ndarray, bias: np.ndarray, state: dict, bn_prefix: str):
    """Fold BatchNorm1d (eval mode) into the linear before it: exact at
    inference. kernel is (in, out); BN is over the out channels."""
    gamma = np.asarray(state[f"{bn_prefix}.weight"])
    beta = np.asarray(state[f"{bn_prefix}.bias"])
    mean = np.asarray(state[f"{bn_prefix}.running_mean"])
    var = np.asarray(state[f"{bn_prefix}.running_var"])
    eps = 1e-5
    scale = gamma / np.sqrt(var + eps)
    return kernel * scale[None, :], (bias - mean) * scale + beta


def _conv1d_to_dense(state: dict, key: str):
    """torch Conv1d(k=1) weight (out, in, 1) -> Dense kernel (in, out)."""
    w = np.asarray(state[f"{key}.weight"])[:, :, 0].T
    b = np.asarray(state[f"{key}.bias"])
    return w, b


def _sg_head_permutation(d: int, num_heads: int) -> np.ndarray:
    """Channel permutation upstream -> ours for SuperGlue's attention.

    Upstream views the d channels as (head_dim, heads): c = i * H + h; ours
    as (heads, head_dim): c = h * dh + i. Returns perm with
    ours[c] = upstream[perm[c]]."""
    dh = d // num_heads
    return np.arange(d).reshape(dh, num_heads).T.reshape(-1)


def convert_superglue(state: dict, n_gnn_layers: int = 9, num_heads: int = 4) -> dict:
    """MagicLeap SuperGlue state dict -> the flax tree (model conf ln=False)."""
    p: dict = {}

    # keypoint encoder: convs at indices 0, 3, 6, ... with BN at +1 (but the last)
    enc_keys = sorted(
        {int(k.split(".")[2]) for k in state
         if k.startswith("kenc.encoder.") and k.endswith(".weight") and "running" not in k}
    )
    conv_idxs = [i for i in enc_keys if f"kenc.encoder.{i}.bias" in state
                 and state[f"kenc.encoder.{i}.weight"].ndim == 3]
    kenc = {}
    for j, ci in enumerate(conv_idxs):
        w, b = _conv1d_to_dense(state, f"kenc.encoder.{ci}")
        if j < len(conv_idxs) - 1:  # BN follows every conv but the last
            w, b = _fold_bn(w, b, state, f"kenc.encoder.{ci + 1}")
        kenc[f"Dense_{j}"] = {"kernel": w, "bias": b}
    p["kenc"] = kenc

    d = np.asarray(state["final_proj.weight"]).shape[0]
    perm = _sg_head_permutation(d, num_heads)
    for i in range(2 * n_gnn_layers):
        ours = f"self_{i // 2}" if i % 2 == 0 else f"cross_{i // 2}"
        pre = f"gnn.layers.{i}"
        layer: dict = {}
        for j in range(3):  # q, k, v: output channels permuted to head-major
            w, b = _conv1d_to_dense(state, f"{pre}.attn.proj.{j}")
            layer[f"Dense_{j}"] = {"kernel": w[:, perm], "bias": b[perm]}
        # merge: its input channels arrive in upstream packing -> permute rows
        w, b = _conv1d_to_dense(state, f"{pre}.attn.merge")
        layer["Dense_3"] = {"kernel": w[perm, :], "bias": b}
        # mlp: Conv1d(2d, 2d) + BN + ReLU + Conv1d(2d, d)
        w0, b0 = _conv1d_to_dense(state, f"{pre}.mlp.0")
        w0, b0 = _fold_bn(w0, b0, state, f"{pre}.mlp.1")
        w1, b1 = _conv1d_to_dense(state, f"{pre}.mlp.3")
        layer["_MLP_0"] = {
            "Dense_0": {"kernel": w0, "bias": b0},
            "Dense_1": {"kernel": w1, "bias": b1},
        }
        p[ours] = layer

    w = np.asarray(state["final_proj.weight"])
    w = w[:, :, 0].T if w.ndim == 3 else w.T
    p["final_proj"] = {"kernel": w, "bias": np.asarray(state["final_proj.bias"])}
    p["bin_score"] = np.asarray(state["bin_score"]).reshape(())
    return {"params": p}


# --------------------------------------------------------------------------- #
# ALIKED (Shiaoming/ALIKED {model}.pth)
# --------------------------------------------------------------------------- #
def _conv2d_hwio(state: dict, key: str, fold_bn: str | None = None):
    """torch Conv2d OIHW -> HWIO kernel (+ bias, optionally BN-folded)."""
    w = np.asarray(state[f"{key}.weight"]).transpose(2, 3, 1, 0)
    b = np.asarray(state.get(f"{key}.bias", np.zeros(w.shape[-1], np.float32)))
    if fold_bn is not None:
        gamma = np.asarray(state[f"{fold_bn}.weight"])
        beta = np.asarray(state[f"{fold_bn}.bias"])
        mean = np.asarray(state[f"{fold_bn}.running_mean"])
        var = np.asarray(state[f"{fold_bn}.running_var"])
        scale = gamma / np.sqrt(var + 1e-5)
        w = w * scale
        b = (b - mean) * scale + beta
    return w, b


def convert_aliked(state: dict) -> dict:
    """ALIKED .pth -> the flax tree of models/extractors/aliked.py. BatchNorm
    (eval) folds into the conv before it; dcn blocks keep their offset convs;
    the SDDH convs become dense kernels."""
    p: dict = {}

    def conv_entry(key, fold_bn=None):
        w, b = _conv2d_hwio(state, key, fold_bn)
        return {"kernel": w, "bias": b}

    def block(name, has_down=False):
        out = {}
        for j in (1, 2):
            conv_key = f"{name}.conv{j}"
            if f"{conv_key}.regular_conv.weight" in state:  # dcn
                d = conv_entry(f"{conv_key}.regular_conv", f"{name}.bn{j}")
                d["offset_conv"] = conv_entry(f"{conv_key}.offset_conv")
                out[f"conv{j}"] = d
            else:
                out[f"conv{j}"] = {"conv": conv_entry(conv_key, f"{name}.bn{j}")}
        if has_down:
            out["downsample"] = conv_entry(f"{name}.downsample")
        return out

    p["block1"] = block("block1")
    p["block2"] = block("block2", has_down=True)
    p["block3"] = block("block3", has_down=True)
    p["block4"] = block("block4", has_down=True)
    for j in (1, 2, 3, 4):  # the aggregation's 1x1 convs, bias=False
        w = np.asarray(state[f"conv{j}.weight"]).transpose(2, 3, 1, 0)
        p[f"conv{j}"] = {"conv": {"kernel": w}}
    for ours, idx in (("score1", 0), ("score2", 2), ("score3", 4), ("score4", 6)):
        w = np.asarray(state[f"score_head.{idx}.weight"]).transpose(2, 3, 1, 0)
        p[ours] = {"conv": {"kernel": w}}

    # SDDH: offset_conv.0 is a VALID KxK conv -> (K, K, D, 2M) kernel
    w0 = np.asarray(state["desc_head.offset_conv.0.weight"]).transpose(2, 3, 1, 0)
    p["sddh_offset0_kernel"] = w0
    p["sddh_offset0_bias"] = np.asarray(state["desc_head.offset_conv.0.bias"])
    p["sddh_offset1_kernel"] = np.asarray(state["desc_head.offset_conv.2.weight"])[:, :, 0, 0].T
    p["sddh_offset1_bias"] = np.asarray(state["desc_head.offset_conv.2.bias"])
    p["sddh_sf_kernel"] = np.asarray(state["desc_head.sf_conv.weight"])[:, :, 0, 0].T
    p["sddh_agg_weights"] = np.asarray(state["desc_head.agg_weights"])
    return {"params": p}


# --------------------------------------------------------------------------- #
# DINOv2 (HuggingFace Dinov2Model state dict; facebook/dinov2-{small,...})
# --------------------------------------------------------------------------- #
def convert_dinov2(state: dict) -> dict:
    """HF Dinov2Model state dict -> the flax tree of models/backbones/dinov2.py.
    The mask token (pretraining only) is dropped; LayerScale lambda1 maps to
    ls1 / ls2."""
    p: dict = {}

    def lin(key):
        return {
            "kernel": np.asarray(state[f"{key}.weight"]).T,
            "bias": np.asarray(state[f"{key}.bias"]),
        }

    w = np.asarray(state["embeddings.patch_embeddings.projection.weight"])
    p["patch_embed"] = {
        "kernel": w.transpose(2, 3, 1, 0),
        "bias": np.asarray(state["embeddings.patch_embeddings.projection.bias"]),
    }
    p["cls_token"] = np.asarray(state["embeddings.cls_token"])
    p["pos_embed"] = np.asarray(state["embeddings.position_embeddings"])

    n_layers = 1 + max(int(k.split(".")[2]) for k in state if k.startswith("encoder.layer."))
    for i in range(n_layers):
        pre = f"encoder.layer.{i}"
        p[f"block_{i}"] = {
            "norm1": {"scale": np.asarray(state[f"{pre}.norm1.weight"]),
                      "bias": np.asarray(state[f"{pre}.norm1.bias"])},
            "q": lin(f"{pre}.attention.attention.query"),
            "k": lin(f"{pre}.attention.attention.key"),
            "v": lin(f"{pre}.attention.attention.value"),
            "proj": lin(f"{pre}.attention.output.dense"),
            "ls1": np.asarray(state[f"{pre}.layer_scale1.lambda1"]),
            "norm2": {"scale": np.asarray(state[f"{pre}.norm2.weight"]),
                      "bias": np.asarray(state[f"{pre}.norm2.bias"])},
            "fc1": lin(f"{pre}.mlp.fc1"),
            "fc2": lin(f"{pre}.mlp.fc2"),
            "ls2": np.asarray(state[f"{pre}.layer_scale2.lambda1"]),
        }
    p["norm"] = {"scale": np.asarray(state["layernorm.weight"]),
                 "bias": np.asarray(state["layernorm.bias"])}
    return {"params": p}


# --------------------------------------------------------------------------- #
# DISK (official depth-save.pth / kornia DISK.from_pretrained)
# --------------------------------------------------------------------------- #
def convert_disk(state: dict, down=(16, 32, 64, 64, 64), up=(64, 64, 64, 129),
                 in_ch: int = 3, kernel_size: int = 5) -> dict:
    """The official DISK thin U-Net (jatentaki/disk `depth-save.pth`, also
    vendored by kornia) -> models/extractors/disk_official.py.

    Mapped by shape and order, not by key name: a torch state dict keeps
    module-definition order, and the U-Net's parameter sequence is

        [down0: conv w, b]  [down_i (i >= 1): prelu, conv w, b] x 4
        [up_i: prelu, conv w, b] x 4

    with a distinct shape at every position (InstanceNorm has no parameters,
    the resampling none either). This survives the Sequential renames of
    disk / kornia versions; a shape that does not fit raises with its
    position."""
    seq = [np.asarray(v) for v in state.values()
           if np.asarray(v).ndim in (1, 4) and np.asarray(v).dtype.kind == "f"]
    d_in = [in_ch] + list(down[:-1])
    bot = [down[-1]] + list(up[:-1])
    skips = list(down[-2::-1])
    expect = []  # (name, kind, shape)
    ks = kernel_size
    for i, (cin, cout) in enumerate(zip(d_in, down)):
        if i > 0:
            expect.append((f"down_{i}_prelu", "prelu", (cin,)))
        expect.append((f"down_{i}_conv", "conv", (cout, cin, ks, ks)))
    for i, (b, s, cout) in enumerate(zip(bot, skips, up)):
        expect.append((f"up_{i}_prelu", "prelu", (b + s,)))
        expect.append((f"up_{i}_conv", "conv", (cout, b + s, ks, ks)))

    params = {}
    pos = 0
    for name, kind, shape in expect:
        if pos >= len(seq):
            raise ValueError(f"DISK state dict ended early at {name}")
        t = seq[pos]
        if kind == "prelu":
            # nn.PReLU holds one scalar (num_parameters=1) or one weight a
            # channel; a scalar is broadcast
            if t.shape == (1,):
                t = np.full(shape, float(t[0]), np.float32)
            if t.shape != shape:
                raise ValueError(f"{name}: expected PReLU {shape}, got {t.shape}")
            params[name] = t
            pos += 1
        else:
            if t.shape != shape:
                raise ValueError(f"{name}: expected conv {shape}, got {t.shape}")
            w = t.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            bvec = seq[pos + 1]
            if bvec.shape != (shape[0],):
                raise ValueError(f"{name}: expected bias ({shape[0]},), got {bvec.shape}")
            params[name + "_w"] = w
            params[name + "_b"] = bvec
            pos += 2
    if pos != len(seq):
        raise ValueError(
            f"DISK state dict has {len(seq) - pos} unconsumed tensors "
            "(unexpected architecture variant)")
    return {"params": params}


# --------------------------------------------------------------------------- #
# I/O
# --------------------------------------------------------------------------- #
def load_state_dict(path) -> dict:
    """A `.pth` file's flat str -> numpy state dict: `torch.load` with
    `weights_only=True`, a `{"model": ...}` / `{"state_dict": ...}` wrapper
    unwrapped, entries that are not tensors dropped, floating tensors (bf16
    and fp16 included) as float32."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("model", "state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    if not isinstance(obj, dict):
        raise ValueError(f"checkpoint did not contain a state dict (got {type(obj)})")
    return {k: (v.float() if v.is_floating_point() else v).numpy()
            for k, v in obj.items() if isinstance(v, torch.Tensor)}


def flatten_tree(tree: dict) -> dict:
    flat = {}

    def rec(prefix, d):
        for k, v in d.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                rec(key, v)
            else:
                flat[key] = np.asarray(v)

    rec("", tree)
    return flat


def save_tree_npz(tree: dict, path) -> int:
    flat = flatten_tree(tree)
    np.savez(path, **flat)
    return len(flat)


def _strip_prefix(state: dict, prefix: str) -> dict:
    if any(k.startswith(prefix) for k in state):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    return state


def convert(kind: str, state: dict, n_layers: int = 9, num_heads: int = 4) -> dict:
    """The flax tree of one checkpoint `kind` from its state dict."""
    if kind == "superpoint":
        return convert_superpoint(state)
    if kind == "lightglue":
        return convert_lightglue(rename_lightglue_v01(state, n_layers), n_layers, num_heads)
    if kind == "superglue":
        return convert_superglue(state, n_layers, num_heads)
    if kind == "aliked":
        return convert_aliked(state)
    if kind == "dinov2":
        return convert_dinov2(state)
    if kind == "disk":
        return convert_disk(_strip_prefix(state, "extractor."))  # a disk repo checkpoint
    if kind == "gluestick":
        raise NotImplementedError(
            "GlueStick is not ported yet: convert_gluestick comes with its matcher after the "
            "line extractors (ROADMAP Queue 1 item 5)")
    if kind == "loftr":
        raise NotImplementedError(
            "LoFTR is not ported yet: convert_loftr comes with its matcher "
            "(ROADMAP Queue 1 item 3)")
    raise ValueError(f"unknown checkpoint kind {kind!r}")


KINDS = ["superpoint", "lightglue", "superglue", "gluestick", "aliked", "dinov2", "disk",
         "loftr"]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kind", choices=KINDS, required=True)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--n_layers", type=int, default=9)
    parser.add_argument("--num_heads", type=int, default=4)
    args = parser.parse_args(argv)

    tree = convert(args.kind, load_state_dict(args.input), args.n_layers, args.num_heads)
    n = save_tree_npz(tree, args.output)
    print(f"Wrote {n} arrays to {args.output}")


if __name__ == "__main__":
    main()
