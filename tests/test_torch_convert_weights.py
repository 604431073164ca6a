"""The port's weight converters (`gluefactory_tpu_torch/scripts/convert_weights.py`),
`lightglue_pretrained`, SuperGlue's `weights` and `match_pair_with_weights`
against the JAX package on the CPU.

Seeded upstream-layout state dicts stand in for the official checkpoints
(the fabricators of tests/test_convert_weights.py and
tests/test_convert_disk_loftr.py, and a full-width copy of the LightGlue one
for the pair check). Bars:
  - the converters: the port's tree has the JAX converter's keys, and every
    array equals its JAX one bit for bit, dtype included;
  - the command line: zip and legacy `.pth`, a `{"model": ...}` /
    `{"state_dict": ...}` wrapper and bf16 tensors; the JAX package's
    `load_npz_params` reads the port's `.npz` array for array, and the port's
    model loads it strictly;
  - the forwards (fp32, the repo's bars of
    tests/test_pallas_lightglue_block.py:79-82): `matches0` equal on at
    least 99% and `log_assignment` within 5e-3, for `lightglue_pretrained`
    (small L / D) and SuperGlue with `ln: False`, each fed the port's tree
    against the JAX model fed the JAX converter's tree;
  - `match_pair_with_weights` on one small explicit pair at the published
    widths: the same keypoints within 1e-4 px, `matches0` on at least 99%,
    the match count within 1% and the precision within 0.01 of the JAX
    function's.
The official-weight floors of the reference's integration test run when the
checkpoints are under $GLUEFACTORY_TPU_WEIGHTS (num_matches > 1300,
prec@3px > 0.8 on the synthetic pair), and skip otherwise.
"""

import contextlib
import functools
import os
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_convert_disk_loftr import TorchDisk
from test_convert_weights import (
    D, H, L, make_aliked_state, make_lightglue_state, make_superglue_state)
from torch_jax_init import jit_o0, jitted_pipeline_init
from gluefactory_tpu.eval import export_helper as jeh
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.matchers.lightglue_pretrained import load_npz_params
from gluefactory_tpu.models.two_view_pipeline import TwoViewPipeline
from gluefactory_tpu.scripts import convert_weights as jcw
from gluefactory_tpu.utils import torch_io
from gluefactory_tpu_torch.eval.export_helper import match_pair_with_weights
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.scripts import convert_weights as tcw
from gluefactory_tpu_torch.weights import load_npz

ROOT = Path(__file__).resolve().parent.parent
SP_LAYERS = [("conv1a", 64, 1), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
             ("conv3a", 128, 64), ("conv3b", 128, 128), ("conv4a", 128, 128),
             ("conv4b", 128, 128), ("convPa", 256, 128), ("convPb", 65, 256),
             ("convDa", 256, 128), ("convDb", 256, 256)]


def _scaled(rng, *shape, gain=1.0):
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
    return torch.tensor((rng.randn(*shape) * gain / np.sqrt(fan_in)).astype(np.float32))


def superpoint_state(rng):
    """MagicLeap SuperPoint's keys and shapes, fan-in-scaled weights."""
    sd = {}
    for name, cout, cin in SP_LAYERS:
        k = 1 if name in ("convPb", "convDb") else 3
        sd[f"{name}.weight"] = _scaled(rng, cout, cin, k, k, gain=1.5)
        sd[f"{name}.bias"] = _scaled(rng, cout, gain=0.1)
    return sd


def lightglue_state(rng, d=256, n_layers=9, input_dim=None, conditional=False, match=False):
    """cvg/LightGlue's keys and shapes at any width, 4 heads
    (tests/test_convert_weights.py's fabricator with fan-in-scaled weights,
    which keep the log assignment at the magnitudes of trained weights).
    `match`: small residual branches, every point matchable and a scaled
    identity before the similarity, so that the layers keep the
    descriptors and the assignment matches similar ones, as trained weights
    do."""
    res = 0.05 if match else 1.0
    sd = {}
    for i in range(n_layers):
        for blk in ("self_attn", "cross_attn"):
            pre = f"transformers.{i}.{blk}"
            if blk == "self_attn":
                sd[f"{pre}.Wqkv.weight"] = _scaled(rng, 3 * d, d)
                sd[f"{pre}.Wqkv.bias"] = _scaled(rng, 3 * d, gain=0.1)
                sd[f"{pre}.out_proj.weight"] = _scaled(rng, d, d, gain=res)
                sd[f"{pre}.out_proj.bias"] = _scaled(rng, d, gain=0.1)
            else:
                for nm in ("to_qk", "to_v", "to_out"):
                    sd[f"{pre}.{nm}.weight"] = _scaled(rng, d, d, gain=res if nm == "to_out" else 1)
                    sd[f"{pre}.{nm}.bias"] = _scaled(rng, d, gain=0.1)
            sd[f"{pre}.ffn.0.weight"] = _scaled(rng, 2 * d, 2 * d)
            sd[f"{pre}.ffn.0.bias"] = _scaled(rng, 2 * d, gain=0.1)
            sd[f"{pre}.ffn.1.weight"] = 1 + _scaled(rng, 2 * d, gain=0.1)
            sd[f"{pre}.ffn.1.bias"] = _scaled(rng, 2 * d, gain=0.1)
            sd[f"{pre}.ffn.3.weight"] = _scaled(rng, d, 2 * d, gain=res)
            sd[f"{pre}.ffn.3.bias"] = _scaled(rng, d, gain=0.1)
        sd[f"log_assignment.{i}.final_proj.weight"] = _scaled(rng, d, d)
        sd[f"log_assignment.{i}.final_proj.bias"] = _scaled(rng, d, gain=0.1)
        sd[f"log_assignment.{i}.matchability.weight"] = _scaled(rng, 1, d)
        sd[f"log_assignment.{i}.matchability.bias"] = _scaled(rng, 1, gain=0.1) + 5 * match
        if match:  # sim = 48^2 cos / sqrt(d): about 144 for equal unit descriptors
            sd[f"log_assignment.{i}.final_proj.weight"] = 48 * torch.eye(d)
        if i < n_layers - 1:
            sd[f"token_confidence.{i}.token.0.weight"] = _scaled(rng, 1, d)
            sd[f"token_confidence.{i}.token.0.bias"] = _scaled(rng, 1, gain=0.1)
    sd["posenc.Wr.weight"] = torch.tensor(rng.randn(d // 8, 2).astype(np.float32))
    if conditional:
        sd["posenc.condition_modulation.weight"] = _scaled(rng, d // 8, 1, gain=0.01)
        sd["posenc.condition_modulation.bias"] = _scaled(rng, d // 8, gain=0.1)
    if input_dim:
        sd["input_proj.weight"] = _scaled(rng, d, input_dim)
        sd["input_proj.bias"] = _scaled(rng, d, gain=0.1)
    return sd


def dinov2_state(rng, d=32, depth=2, grid=2, patch=14):
    """HuggingFace Dinov2Model's keys and shapes."""
    t = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32) * 0.1)
    sd = {"embeddings.cls_token": t(1, 1, d), "embeddings.mask_token": t(1, d),
          "embeddings.position_embeddings": t(1, grid * grid + 1, d),
          "embeddings.patch_embeddings.projection.weight": t(d, 3, patch, patch),
          "embeddings.patch_embeddings.projection.bias": t(d)}
    for i in range(depth):
        pre = f"encoder.layer.{i}"
        for name, (o, c) in {"attention.attention.query": (d, d),
                             "attention.attention.key": (d, d),
                             "attention.attention.value": (d, d),
                             "attention.output.dense": (d, d), "mlp.fc1": (4 * d, d),
                             "mlp.fc2": (d, 4 * d)}.items():
            sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"] = t(o, c), t(o)
        for name in ("norm1", "norm2"):
            sd[f"{pre}.{name}.weight"], sd[f"{pre}.{name}.bias"] = 1 + t(d), t(d)
        sd[f"{pre}.layer_scale1.lambda1"] = t(d)
        sd[f"{pre}.layer_scale2.lambda1"] = t(d)
    sd["layernorm.weight"], sd["layernorm.bias"] = 1 + t(d), t(d)
    return sd


def disk_state():
    torch.manual_seed(3)
    return TorchDisk().state_dict()


def _np(sd):
    return {k: v.detach().float().numpy() for k, v in sd.items()}


# kind -> (the port's `convert` kind, the state dict, the JAX converter as its CLI calls it)
CASES = {
    "superpoint": ("superpoint", lambda: superpoint_state(np.random.RandomState(5)),
                   jcw.convert_superpoint),
    "lightglue_fourier": ("lightglue",
                          lambda: make_lightglue_state(np.random.RandomState(7), False),
                          lambda s: jcw.convert_lightglue(s, L, H)),
    "lightglue_conditional": ("lightglue",
                              lambda: make_lightglue_state(np.random.RandomState(8), True),
                              lambda s: jcw.convert_lightglue(s, L, H)),
    "lightglue_v01": ("lightglue",
                      lambda: make_lightglue_state(np.random.RandomState(3), False, v01_names=True),
                      lambda s: jcw.convert_lightglue(jcw.rename_lightglue_v01(s, L), L, H)),
    "lightglue_input_proj": ("lightglue",
                             lambda: lightglue_state(np.random.RandomState(9), D, L, input_dim=32),
                             lambda s: jcw.convert_lightglue(s, L, H)),
    "superglue": ("superglue", lambda: make_superglue_state(np.random.RandomState(11)),
                  lambda s: jcw.convert_superglue(s, 2, H)),
    "aliked": ("aliked", lambda: make_aliked_state(np.random.RandomState(17)),
               jcw.convert_aliked),
    "dinov2": ("dinov2", lambda: dinov2_state(np.random.RandomState(4)), jcw.convert_dinov2),
    "disk": ("disk", disk_state, jcw.convert_disk),
}
# the layer count the CLI passes (--n_layers): LightGlue's layers, SuperGlue's pairs
N_LAYERS = {"lightglue": L, "superglue": 2}


def _assert_trees_equal(ours, ref):
    ours, ref = jcw.flatten_tree(ours), jcw.flatten_tree(ref)
    assert sorted(ours) == sorted(ref)
    for key, arr in ref.items():
        assert ours[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(ours[key], arr, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_converter_tree_equals_jax(case, tmp_path):
    """The same `.pth` through the JAX package's reader and converter, and
    through the port's."""
    kind, make, jax_convert = CASES[case]
    pth = tmp_path / f"{case}.pth"
    torch.save(make(), str(pth))
    ref = jax_convert(torch_io.load_state_dict(str(pth)))
    ours = tcw.convert(kind, tcw.load_state_dict(pth), N_LAYERS.get(kind, 9), H)
    _assert_trees_equal(ours, ref)


@pytest.mark.parametrize("kind,item", [("gluestick", "item 5"), ("loftr", "item 3")])
def test_unported_kinds_raise_naming_their_item(kind, item, tmp_path):
    pth = tmp_path / "x.pth"
    torch.save({"w": torch.ones(1)}, str(pth))
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        tcw.main(["--kind", kind, "--input", str(pth), "--output", str(tmp_path / "x.npz")])


def _superglue_conf():
    return {"GNN_layers": 2, "descriptor_dim": D, "input_dim": D, "num_heads": H,
            "keypoint_encoder": [8, 16], "ln": False}


def _lightglue_conf(**over):
    return {"n_layers": L, "descriptor_dim": D, "input_dim": D, "num_heads": H,
            "posenc": "fourier", "depth_confidence": -1, "width_confidence": -1, **over}


# the port's model that loads each case's tree through its `weights` key
PORT_MODELS = {
    "superpoint": None,  # superpoint_magicleap has no `weights` (nor has the JAX model)
    "lightglue_fourier": ("lightglue_pretrained", _lightglue_conf()),
    "superglue": ("superglue", _superglue_conf()),
    "aliked": ("aliked", {"model_name": "aliked-t16"}),
    "dinov2": ("backbones.dinov2", {"embed_dim": 32, "depth": 2, "num_heads": 2, "pos_grid": 2}),
    "disk": ("disk_official", {}),
}


@pytest.mark.parametrize("case,legacy,wrap,bf16", [
    ("superpoint", True, None, False),
    ("lightglue_fourier", False, "model", False),
    ("superglue", False, None, True),
    ("aliked", False, "state_dict", False),
    ("dinov2", True, None, False),
    ("disk", False, "extractor", True),
])
def test_cli_round_trip(case, legacy, wrap, bf16, tmp_path):
    kind, make, jax_convert = CASES[case]
    sd = make()
    if bf16:
        sd = {k: v.bfloat16() if v.is_floating_point() else v for k, v in sd.items()}
    if wrap == "extractor":  # a disk repository checkpoint: flat "extractor." keys
        obj = {f"extractor.{k}": v for k, v in sd.items()}
    elif wrap:
        obj = {wrap: sd, "epoch": 3, "note": "not a tensor"}
    else:
        obj = sd
    pth, npz = tmp_path / "in.pth", tmp_path / "out.npz"
    torch.save(obj, str(pth), _use_new_zipfile_serialization=not legacy)
    argv = ["--kind", kind, "--input", str(pth), "--output", str(npz)]
    if kind in N_LAYERS:
        argv += ["--n_layers", str(N_LAYERS[kind]), "--num_heads", str(H)]
    tcw.main(argv)

    # bf16 values are exact in float32: the tree of the float32 state
    ref = jax_convert({k: v.float().numpy() for k, v in sd.items()})
    loaded = load_npz_params(npz)  # the JAX package's reader
    flat_ref, flat_loaded = jcw.flatten_tree(ref), jcw.flatten_tree(loaded)
    assert sorted(flat_loaded) == sorted(flat_ref)
    for key, arr in flat_ref.items():
        assert flat_loaded[key].dtype == np.float32, key
        np.testing.assert_array_equal(np.asarray(flat_loaded[key]), arr, err_msg=key)

    if PORT_MODELS[case] is None:
        model = get_model("superpoint_magicleap")({}, device="cpu")
        model.load_state_dict(load_npz(npz), strict=True)
        state = model.state_dict()
    else:
        name, conf = PORT_MODELS[case]
        state = get_model(name)({**conf, "weights": str(npz)}, device="cpu").state_dict()
    # every entry of the port's model came from the file
    assert len(state) == len(flat_ref)


def test_jax_cli_leaves_bf16_unreadable_pinned(tmp_path, monkeypatch):
    """The JAX command line casts floating tensors to float32 by
    `dtype.kind == "f"`, which a bfloat16 array (kind "V") fails: it writes
    the bytes as void and no reader gets numbers back. The port casts bf16
    (ROADMAP Queue 3a)."""
    sd = {k: v.bfloat16() for k, v in superpoint_state(np.random.RandomState(2)).items()}
    pth = tmp_path / "sp.pth"
    torch.save(sd, str(pth))
    monkeypatch.setattr("sys.argv", ["convert_weights", "--kind", "superpoint", "--input",
                                     str(pth), "--output", str(tmp_path / "jax.npz")])
    jcw.main()
    with np.load(tmp_path / "jax.npz") as f:
        assert f["params/conv1a/kernel"].dtype.kind == "V"
    tcw.main(["--kind", "superpoint", "--input", str(pth), "--output", str(tmp_path / "t.npz")])
    with np.load(tmp_path / "t.npz") as f:
        kernel = f["params/conv1a/kernel"]
    assert kernel.dtype == np.float32
    np.testing.assert_array_equal(kernel, sd["conv1a.weight"].float().numpy().transpose(2, 3, 1, 0))


# ------------------------------------------------------------------ forwards
def _lg_data(seed, m, n, in_dim):
    rng = np.random.RandomState(seed)
    size = np.array([[320.0, 240.0]] * 2, np.float32)
    return {"keypoints0": rng.uniform(0, 320, (2, m, 2)).astype(np.float32),
            "keypoints1": rng.uniform(0, 320, (2, n, 2)).astype(np.float32),
            "descriptors0": rng.randn(2, m, in_dim).astype(np.float32),
            "descriptors1": rng.randn(2, n, in_dim).astype(np.float32),
            "view0": {"image_size": size}, "view1": {"image_size": size}}


def _tree_map(data, fn):
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v) for k, v in data.items()}


@pytest.mark.parametrize("seed,m,n,over", [
    (40, 48, 48, {}),
    (41, 40, 32, {"posenc": "conditional_fourier"}),
    (42, 48, 40, {"input_dim": 32}),
    # the model's own defaults: adaptive depth 0.95, width 0.99
    (43, 64, 64, {"depth_confidence": 0.95, "width_confidence": 0.99}),
])
def test_lightglue_pretrained_matches_jax(seed, m, n, over, tmp_path):
    conf = _lightglue_conf(**over)
    sd = lightglue_state(np.random.RandomState(seed), D, L,
                         input_dim=over.get("input_dim"),
                         conditional=conf["posenc"] == "conditional_fourier")
    pth, npz = tmp_path / "lg.pth", tmp_path / "lg.npz"
    torch.save(sd, str(pth))
    tcw.main(["--kind", "lightglue", "--input", str(pth), "--output", str(npz),
              "--n_layers", str(L), "--num_heads", str(H)])
    data = _lg_data(seed, m, n, conf["input_dim"])

    jm = jax_model("lightglue_pretrained").from_conf(conf)
    tree = jax.tree.map(jnp.asarray, jcw.convert_lightglue(_np(sd), L, H))
    ref = jax.tree.map(np.asarray, jit_o0(jm.apply)(tree, _tree_map(data, jnp.asarray)))

    tm = get_model("lightglue_pretrained")({**conf, "weights": str(npz)}, device="cpu")
    out = tm(_tree_map(data, torch.from_numpy))
    np.testing.assert_allclose(out["log_assignment"].numpy(), ref["log_assignment"], atol=5e-3)
    assert (out["matches0"].numpy() == ref["matches0"]).mean() >= 0.99
    assert (out["matches1"].numpy() == ref["matches1"]).mean() >= 0.99
    assert (ref["matches0"] >= 0).any()


def test_superglue_official_weights_match_jax(tmp_path):
    state = make_superglue_state(np.random.RandomState(11))
    pth, npz = tmp_path / "sg.pth", tmp_path / "sg.npz"
    torch.save(state, str(pth))
    tcw.main(["--kind", "superglue", "--input", str(pth), "--output", str(npz),
              "--n_layers", "2", "--num_heads", str(H)])
    rng = np.random.RandomState(12)
    m, n = 40, 32
    data = {"keypoints0": (rng.rand(2, m, 2) * 300).astype(np.float32),
            "keypoints1": (rng.rand(2, n, 2) * 300).astype(np.float32),
            "keypoint_scores0": rng.rand(2, m).astype(np.float32),
            "keypoint_scores1": rng.rand(2, n).astype(np.float32),
            "descriptors0": rng.randn(2, m, D).astype(np.float32),
            "descriptors1": rng.randn(2, n, D).astype(np.float32),
            "view0": {"image_size": np.full((2, 2), 300.0, np.float32)},
            "view1": {"image_size": np.full((2, 2), 300.0, np.float32)}}
    jm = jax_model("superglue").from_conf(_superglue_conf())
    tree = jax.tree.map(jnp.asarray, jcw.convert_superglue(_np(state), 2, H))
    ref = jax.tree.map(np.asarray, jit_o0(jm.apply)(tree, _tree_map(data, jnp.asarray)))

    tm = get_model("superglue")({**_superglue_conf(), "weights": str(npz)}, device="cpu")
    out = tm(_tree_map(data, torch.from_numpy))
    np.testing.assert_allclose(out["log_assignment"].numpy(), ref["log_assignment"], atol=5e-3)
    assert (out["matches0"].numpy() == ref["matches0"]).mean() >= 0.99
    assert (out["matches1"].numpy() == ref["matches1"]).mean() >= 0.99
    assert (ref["matches0"] >= 0).any()


# ------------------------------------------------------- match_pair_with_weights
def _jit_apply(self, *args, **kwargs):
    return jit_o0(functools.partial(flax.linen.Module.apply, self))(*args, **kwargs)


@contextlib.contextmanager
def jitted_pipeline():
    """The JAX pipeline's init and apply, each one compile (the JAX
    `match_pair_with_weights` calls both outside jit)."""
    with jitted_pipeline_init(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TwoViewPipeline, "apply", _jit_apply)
        yield


def _small_pair():
    """A smooth 96 x 128 texture and the same scene moved by one cell (8 px)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(21)
    big = gaussian_filter(rng.rand(104, 136), 1.5)
    big = ((big - big.min()) / (big.max() - big.min())).astype(np.float32)
    H_0to1 = np.array([[1, 0, -8], [0, 1, -8], [0, 0, 1]], np.float32)
    return big[:96, :128], big[8:, 8:], H_0to1


@pytest.mark.parametrize("pair,k", [("explicit", 128), ("synthetic", 64)])
def test_match_pair_with_weights_matches_jax(pair, k, tmp_path):
    """On the small explicit pair, and on the functions' own 480 x 640
    synthetic pair at 64 keypoints."""
    rng = np.random.RandomState(31)
    sp, lg = tmp_path / "superpoint_v1.pth", tmp_path / "superpoint_lightglue.pth"
    torch.save(superpoint_state(rng), str(sp), _use_new_zipfile_serialization=False)
    torch.save(lightglue_state(rng, match=True), str(lg))
    kw = dict(max_num_keypoints=k)
    if pair == "explicit":
        img0, img1, H_0to1 = _small_pair()
        kw.update(image0=img0, image1=img1, H_0to1=H_0to1)
    with jitted_pipeline():
        ref = jeh.match_pair_with_weights(str(sp), str(lg), tmp_path / "jax", **kw)
    out = match_pair_with_weights(sp, lg, tmp_path / "port", device="cpu", **kw)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "lightglue.npz", "superpoint.npz"]
    assert ref["num_matches"] > (10 if pair == "explicit" else 0)
    np.testing.assert_allclose(out["keypoints0"], ref["keypoints0"], atol=1e-4)
    np.testing.assert_allclose(out["keypoints1"], ref["keypoints1"], atol=1e-4)
    assert (out["matches0"] == ref["matches0"]).mean() >= 0.99
    assert abs(out["num_matches"] - ref["num_matches"]) <= 0.01 * ref["num_matches"]
    assert abs(out["prec@3px"] - ref["prec@3px"]) <= 0.01


WEIGHTS_DIR = Path(os.environ.get("GLUEFACTORY_TPU_WEIGHTS", ROOT / "weights"))
LG_FILES = ("superpoint_lightglue.pth", "superpoint_lightglue_v0-1_arxiv.pth")


def _official_weights():
    return (WEIGHTS_DIR / "superpoint_v1.pth").exists() and any(
        (WEIGHTS_DIR / f).exists() for f in LG_FILES)


@pytest.mark.skipif(
    not _official_weights(),
    reason="official checkpoints not on disk; place superpoint_v1.pth and "
    "superpoint_lightglue.pth under $GLUEFACTORY_TPU_WEIGHTS to run the reference's "
    "integration floors")
def test_official_weight_floors(tmp_path):
    """The reference's floors (test_integration.py:106-108): more than 1300
    matches at precision@3px above 0.8 on the textured synthetic pair."""
    lg = next(WEIGHTS_DIR / f for f in LG_FILES if (WEIGHTS_DIR / f).exists())
    result = match_pair_with_weights(WEIGHTS_DIR / "superpoint_v1.pth", lg, tmp_path,
                                     device="cpu")
    assert result["num_matches"] > 1300
    assert result["prec@3px"] > 0.8
