"""The port's JSON copies of the JAX package's YAML configurations: the four
`*-official` ones and `superpoint+lightglue_homography`, each equal to its
YAML but for the overrides listed in OVERRIDES, every YAML with a JSON copy
or a name on one of the two lists below; and the faults of the reference
that the overrides answer, each shown on the JAX package (at the published
width of 256, two layers):
  - `posenc`: the JAX LightGlue defaults to `conditional_fourier`, and an
    official checkpoint has no `posenc.condition_modulation`, so the JAX
    model cannot apply the converted tree (ScopeParamNotFoundError);
  - `input_dim`: the ALIKED and DISK LightGlue checkpoints take 128-d
    descriptors through `input_proj`; at the default 256 the JAX model has
    no input projection, ignores the tree's, and fails on 128-d descriptors;
  - `ln`: the converted SuperGlue tree has no LayerNorm (its BatchNorms are
    folded), and the YAML leaves `ln: True`;
and with every override the JAX model applies the tree. Two gaps of the
JAX eval path that no override can answer are pinned beside them: it never
reads `matcher.weights` (`make_export_apply_fn` overlays only `checkpoint`),
which the port loads at construction, and a converted SuperPoint `.npz` is
no pipeline checkpoint (its keys lack `extractor/`): the JAX overlay keeps
the random extractor, the port's loader raises.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_convert_weights import lightglue_state, superpoint_state
from torch_jax_init import jit_o0, jitted_pipeline_init
from gluefactory_tpu.eval.export_helper import make_export_apply_fn as jax_export_fn
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.scripts import convert_weights as jcw
from gluefactory_tpu_torch.eval.export_helper import load_model, make_export_apply_fn
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.scripts import convert_weights as tcw
from gluefactory_tpu_torch.utils.config import load_conf

ROOT = Path(__file__).resolve().parent.parent
YAML_DIR = ROOT / "gluefactory_tpu" / "configs"
JSON_DIR = ROOT / "gluefactory_tpu_torch" / "configs"

# configuration -> {model.matcher key: (value, the reference fault it answers)}
OVERRIDES = {
    "superpoint+lightglue-official": {
        "posenc": ("fourier", "official LightGlue checkpoints have no posenc_cond_*")},
    "aliked+lightglue-official": {
        "posenc": ("fourier", "official LightGlue checkpoints have no posenc_cond_*"),
        "input_dim": (128, "the ALIKED checkpoint projects 128-d descriptors (input_proj)")},
    "disk+lightglue-official": {
        "posenc": ("fourier", "official LightGlue checkpoints have no posenc_cond_*"),
        "input_dim": (128, "the DISK checkpoint projects 128-d descriptors (input_proj)")},
    "superpoint+superglue-official": {
        "ln": (False, "the converted SuperGlue tree folds BatchNorm and has no LayerNorm")},
    "superpoint+lightglue_homography": {},
}
# YAMLs with no JSON copy: the host OpenCV SIFT is not portable
NOT_PORTABLE = {"sift+NN", "sift+lightglue-official", "sift+lightglue_homography",
                "sift+lightglue_homography_pv", "sift+lightglue_megadepth"}
# ... or their models are not ported yet
NOT_YET = {"loftr-official": "ROADMAP Queue 1 item 3",
           "superpoint+lsd+gluestick": "ROADMAP Queue 1 item 5",
           "superpoint+lsd+gluestick-homography": "ROADMAP Queue 1 item 5",
           "superpoint+lsd+gluestick-megadepth": "ROADMAP Queue 1 item 5"}
SMALL = {"n_layers": 2}  # two layers at the published width


def _yaml(name):
    return yaml.safe_load((YAML_DIR / f"{name}.yaml").read_text())


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_json_equals_yaml_but_its_overrides(name):
    ref, conf = _yaml(name), load_conf(name)
    matcher = ref["model"]["matcher"]
    for key, (value, _) in OVERRIDES[name].items():
        assert matcher.get(key) != value  # an override changes the YAML
        matcher[key] = value
    assert conf == ref


def test_every_yaml_has_a_json_copy_or_a_reason():
    yamls = {p.stem for p in YAML_DIR.glob("*.yaml")}
    jsons = {p.stem for p in JSON_DIR.glob("*.json")}
    assert NOT_PORTABLE | set(NOT_YET) <= yamls  # no stale name on the lists
    assert not (NOT_PORTABLE | set(NOT_YET)) & jsons
    assert sorted(yamls - NOT_PORTABLE - set(NOT_YET) - jsons) == []


def _lightglue_tree(name, seed):
    in_dim = 128 if "input_dim" in OVERRIDES[name] else None
    sd = lightglue_state(np.random.RandomState(seed), 256, 2, input_dim=in_dim)
    return sd, jcw.convert_lightglue({k: v.numpy() for k, v in sd.items()}, 2, 4)


def _lg_data(in_dim, n=16):
    rng = np.random.RandomState(0)
    return {"keypoints0": jnp.asarray(rng.uniform(0, 300, (1, n, 2)), jnp.float32),
            "keypoints1": jnp.asarray(rng.uniform(0, 300, (1, n, 2)), jnp.float32),
            "descriptors0": jnp.asarray(rng.randn(1, n, in_dim), jnp.float32),
            "descriptors1": jnp.asarray(rng.randn(1, n, in_dim), jnp.float32)}


def _matcher_conf(name, drop=None):
    """The YAML's matcher with the overrides but `drop`, at two layers."""
    conf = {**_yaml(name)["model"]["matcher"], **SMALL}
    conf.update({k: v for k, (v, _) in OVERRIDES[name].items() if k != drop})
    return conf


LG_OFFICIAL = ["superpoint+lightglue-official", "aliked+lightglue-official",
               "disk+lightglue-official"]


@pytest.mark.parametrize("name", LG_OFFICIAL)
def test_posenc_fault_and_the_override(name, tmp_path):
    sd, tree = _lightglue_tree(name, 1)
    in_dim = OVERRIDES[name].get("input_dim", (256,))[0]
    data = _lg_data(in_dim)
    broken = jax_model("lightglue_pretrained").from_conf(_matcher_conf(name, drop="posenc"))
    with pytest.raises(Exception, match="posenc_cond_w"):
        broken.apply(tree, data)
    fixed = jax_model("lightglue_pretrained").from_conf(_matcher_conf(name))
    ref = jit_o0(fixed.apply)(tree, data)
    # the port's JSON configuration loads the port's tree and agrees
    pth, npz = tmp_path / "lg.pth", tmp_path / "lg.npz"
    torch.save(sd, str(pth))
    tcw.main(["--kind", "lightglue", "--input", str(pth), "--output", str(npz),
              "--n_layers", "2"])
    conf = {**load_conf(name)["model"]["matcher"], **SMALL, "weights": str(npz)}
    out = get_model(conf["name"])(conf, device="cpu")(
        {k: torch.from_numpy(np.array(v)) for k, v in data.items()})
    np.testing.assert_allclose(out["log_assignment"].numpy(), np.asarray(ref["log_assignment"]),
                               atol=5e-3)


@pytest.mark.parametrize("name", ["aliked+lightglue-official", "disk+lightglue-official"])
def test_input_dim_fault(name):
    _, tree = _lightglue_tree(name, 2)
    broken = jax_model("lightglue_pretrained").from_conf(_matcher_conf(name, drop="input_dim"))
    # 128-d descriptors into the 256-d layers
    with pytest.raises(ValueError, match=r"\(128\) does not match .* \(256\)"):
        broken.apply(tree, _lg_data(128))


def test_superglue_ln_fault_and_the_override(tmp_path):
    from test_convert_weights import make_superglue_state

    name = "superpoint+superglue-official"
    small = {"GNN_layers": 2, "descriptor_dim": 64, "input_dim": 64, "num_heads": 4,
             "keypoint_encoder": [8, 16]}
    state = make_superglue_state(np.random.RandomState(5))
    tree = jcw.convert_superglue({k: v.numpy() for k, v in state.items()}, 2, 4)
    rng = np.random.RandomState(6)
    data = {"keypoints0": jnp.asarray(rng.rand(1, 12, 2) * 100, jnp.float32),
            "keypoints1": jnp.asarray(rng.rand(1, 12, 2) * 100, jnp.float32),
            "descriptors0": jnp.asarray(rng.randn(1, 12, 64), jnp.float32),
            "descriptors1": jnp.asarray(rng.randn(1, 12, 64), jnp.float32)}
    broken = jax_model("superglue").from_conf({**_yaml(name)["model"]["matcher"], **small})
    with pytest.raises(Exception, match="LayerNorm"):
        broken.apply(tree, data)
    conf = {**load_conf(name)["model"]["matcher"], **small}
    jax_model("superglue").from_conf(conf).apply(tree, data)
    pth, npz = tmp_path / "sg.pth", tmp_path / "sg.npz"
    torch.save(state, str(pth))
    tcw.main(["--kind", "superglue", "--input", str(pth), "--output", str(npz),
              "--n_layers", "2"])
    get_model("superglue")({**conf, "weights": str(npz)}, device="cpu")


def test_jax_eval_path_ignores_the_weights_pinned(tmp_path):
    """`matcher.weights` and a converted SuperPoint `.npz` as `checkpoint`
    change nothing in the JAX eval path; the port loads the first and
    refuses the second."""
    name = "superpoint+lightglue-official"
    sd, _ = _lightglue_tree(name, 3)
    torch.save(sd, str(tmp_path / "lg.pth"))
    torch.save(superpoint_state(np.random.RandomState(4)), str(tmp_path / "sp.pth"))
    for kind, stem, more in (("lightglue", "lg", ["--n_layers", "2"]), ("superpoint", "sp", [])):
        tcw.main(["--kind", kind, "--input", str(tmp_path / f"{stem}.pth"), "--output",
                  str(tmp_path / f"{stem}.npz"), *more])
    with np.load(tmp_path / "lg.npz") as f:
        lg_qkv = f["params/self_Wqkv_w"]
    with np.load(tmp_path / "sp.npz") as f:
        sp_conv = f["params/conv1a/kernel"]

    model = _yaml(name)["model"]
    model["matcher"].update(posenc="fourier", weights=str(tmp_path / "lg.npz"), **SMALL)
    model["extractor"]["max_num_keypoints"] = 32
    model["checkpoint"] = str(tmp_path / "sp.npz")
    img = np.random.RandomState(7).rand(1, 64, 64, 1).astype(np.float32)
    size = np.asarray([[64.0, 64.0]], np.float32)
    batch = {v: {"image": img, "image_size": size} for v in ("view0", "view1")}
    apply_fn, state = jax_export_fn(dict(model))
    with jitted_pipeline_init():
        apply_fn(batch)
    params = state["variables"]["params"]
    assert not np.allclose(np.asarray(params["matcher"]["self_Wqkv_w"]), lg_qkv)
    assert not np.allclose(np.asarray(params["extractor"]["conv1a"]["kernel"]), sp_conv)

    port_conf = load_conf(name)["model"]
    port_conf["matcher"].update(weights=str(tmp_path / "lg.npz"), **SMALL)
    _, port = make_export_apply_fn(port_conf, device="cpu")
    np.testing.assert_array_equal(port["model"].matcher.self_Wqkv_w.detach().numpy(), lg_qkv)
    with pytest.raises(KeyError, match="lacks"):
        load_model(port_conf, checkpoint=tmp_path / "sp.npz", device="cpu")
