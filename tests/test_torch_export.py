"""The port's HDF5 exports against the JAX package on the CPU (h5py is the
reference reader; the port never imports it).

- `export_predictions`: the port's file read by h5py and a JAX-written file
  read by the port's `load_predictions`, on the same loader: the same group
  tree (names with "/" nest), dtypes and arrays bit for bit, `as_half`
  included; `callback_fn`'s entries under the model's; a repeated name
  skipped. The one difference, pinned: a 0-d value (`stop_layer`) is
  written for every sample by the port, while the JAX function's `v[b]`
  raises on it.
- `save_eval` / `load_eval`: `results.h5` with string results (fixed-length
  bytes) read back by h5py and by the JAX `load_eval`, and a JAX-written
  experiment directory read by the port (which decodes the strings).
- `scripts/export_local_features.py --method sp` against the JAX script on
  a tiny homographies tree, the JAX `PRNGKey(0)` variables carried to the
  port by `--checkpoint`: at least 99% of the keypoints shared, descriptors
  within 1e-4 (plus one float16 step, the file's rounding) and scores within
  1e-5 on the shared ones; the port's
  `CacheLoader` reads the file. Both run SuperPoint-open in float32 (its
  `dtype` patched in each package's method table): in bfloat16 the two
  packages round the convolutions at other points (ROADMAP Queue 3a), which
  moves a descriptor by a bfloat16 step, above these bars.
"""

import functools
import json
import sys

import flax
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_jax_init import jit_o0
import gluefactory_tpu.datasets.homographies as jhom
import gluefactory_tpu.scripts.export_local_features as jelf
from gluefactory_tpu.eval.eval_pipeline import load_eval as jax_load_eval
from gluefactory_tpu.eval.eval_pipeline import save_eval as jax_save_eval
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.utils.export_predictions import export_predictions as jax_export
import gluefactory_tpu_torch.datasets.homographies as thom
import gluefactory_tpu_torch.scripts.export_megadepth as tem
from gluefactory_tpu_torch.eval.eval_pipeline import exists_eval, load_eval, save_eval
from gluefactory_tpu_torch.models.cache_loader import CacheLoader
from gluefactory_tpu_torch.scripts import export_local_features as elf
from gluefactory_tpu_torch.utils.export_predictions import export_predictions, load_predictions


def _loader(seed=0, batches=3, b=2):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(batches):
        out.append({"name": [f"scene{i % 2}/pair{b * i + j}" for j in range(b)],
                    "view0": {"scales": np.ones((b, 2), np.float32)}})
    preds = [{"keypoints0": rng.rand(b, 7, 2).astype(np.float32) * 100,
              "matches0": rng.randint(-1, 7, (b, 7)).astype(np.int64),
              "matching_scores0": rng.rand(b, 7).astype(np.float32),
              "mask": rng.rand(b, 7) > 0.5,
              "depth": rng.rand(b, 3).astype(np.float64)} for _ in range(batches)]
    return out, preds


def _h5py_tree(path):
    with h5py.File(str(path), "r") as f:
        out = {}
        f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _port_tree(path):
    return {f"{n}/{k}": v for n, p in load_predictions(path).items() for k, v in p.items()}


@pytest.mark.parametrize("as_half", [False, True])
def test_exports_read_in_either_package(tmp_path, as_half):
    loader, preds = _loader()
    apply_fn = (lambda it: lambda batch: next(it))
    callback = (lambda pred, data: {"mask": np.zeros_like(pred["mask"]),  # the model's wins
                                    "extra": np.full(len(data["name"]), 3, np.int32)})
    port = export_predictions(loader, apply_fn(iter(preds)), tmp_path / "port.h5",
                              as_half=as_half, callback_fn=callback)
    ref = jax_export(loader, apply_fn(iter(preds)), tmp_path / "jax.h5", as_half=as_half,
                     callback_fn=callback)
    by_h5py, jax_by_h5py, jax_by_port = _h5py_tree(port), _h5py_tree(ref), _port_tree(ref)
    assert set(by_h5py) == set(jax_by_h5py) == set(jax_by_port) == set(_port_tree(port))
    assert len(by_h5py) == 6 * 6 and "scene1/pair3/extra" in by_h5py
    for k, v in jax_by_h5py.items():
        for other in (by_h5py[k], jax_by_port[k], _port_tree(port)[k]):
            assert other.dtype == v.dtype, k
            np.testing.assert_array_equal(other, v, err_msg=k)
    assert by_h5py["scene0/pair0/keypoints0"].dtype == (np.float16 if as_half else np.float32)
    assert by_h5py["scene0/pair0/depth"].dtype == np.float64  # only float32 is halved
    np.testing.assert_array_equal(by_h5py["scene0/pair0/mask"], preds[0]["mask"][0])
    with h5py.File(str(port), "r") as f:  # the group tree h5py sees
        assert sorted(f.keys()) == ["scene0", "scene1"]
        assert sorted(f["scene0"].keys()) == ["pair0", "pair1", "pair4", "pair5"]


def test_duplicate_names_are_skipped(tmp_path, caplog):
    loader, preds = _loader(batches=2)
    loader[1]["name"] = loader[0]["name"]
    it = iter(preds)
    export_predictions(loader, lambda b: next(it), tmp_path / "p.h5")
    assert "Duplicate sample name" in caplog.text
    got = load_predictions(tmp_path / "p.h5")
    assert sorted(got) == ["scene0/pair0", "scene0/pair1"]
    np.testing.assert_array_equal(got["scene0/pair1"]["matches0"], preds[0]["matches0"][1])


def test_zero_dim_values_differ_from_jax_pinned(tmp_path):
    """LightGlue's `stop_layer` is one 0-d value a batch: the port writes it
    to every sample, the JAX function's `v[b]` raises (ROADMAP Queue 3a)."""
    loader, preds = _loader(batches=1)
    pred = {**preds[0], "stop_layer": np.asarray(5)}
    export_predictions(loader, lambda b: pred, tmp_path / "p.h5")
    assert [int(p["stop_layer"]) for p in load_predictions(tmp_path / "p.h5").values()] == [5, 5]
    with pytest.raises(IndexError):
        jax_export(loader, lambda b: pred, tmp_path / "jax.h5")


def test_results_h5_with_strings(tmp_path):
    results = {"name": ["v_wide/2", "i_synth/10"], "H_error": np.array([0.5, 1.25]),
               "inl": np.array([3, 4])}
    summaries = {"AP": np.float64(0.5), "n": 2}
    save_eval(tmp_path / "port", summaries, {}, results)
    assert exists_eval(tmp_path / "port")
    with h5py.File(str(tmp_path / "port" / "results.h5"), "r") as f:
        names = f["name"]
        assert names.dtype.kind == "S" and list(names[()]) == [b"v_wide/2", b"i_synth/10"]
        assert h5py.check_string_dtype(names.dtype).encoding == "ascii"
        np.testing.assert_array_equal(f["H_error"][()], results["H_error"])
    s, r = load_eval(tmp_path / "port")
    js, jr = jax_load_eval(tmp_path / "port")
    assert s == js == {"AP": 0.5, "n": 2}
    assert set(r) == set(jr) == set(results)
    assert list(r["name"]) == results["name"]  # the port decodes JAX's bytes
    for k in results:
        ref = np.char.decode(jr[k], "ascii") if jr[k].dtype.kind == "S" else jr[k]
        np.testing.assert_array_equal(r[k], ref, err_msg=k)
    # a JAX-written experiment directory, read by the port
    jax_save_eval(tmp_path / "jax", summaries, {}, results)
    s2, r2 = load_eval(tmp_path / "jax")
    assert s2 == s
    for k in results:
        assert r2[k].dtype == r[k].dtype, k
        np.testing.assert_array_equal(r2[k], r[k], err_msg=k)
    assert json.loads((tmp_path / "port" / "summaries.json").read_text()) == s


# ------------------------------------------------------------ export_local_features
@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """The JAX script and the port's on the same tiny homographies tree."""
    root = tmp_path_factory.mktemp("elf")
    image_dir = root / "images" / "ppm"
    image_dir.mkdir(parents=True)
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    for i in range(4):  # textured, so that the detector has structure to find
        img = np.zeros((96, 128), np.float32)
        for _ in range(12):
            fx, fy = rng.uniform(0.02, 0.2, 2)
            img += rng.uniform(0.2, 1) * np.sin(2 * np.pi * (fx * xx + fy * yy) + rng.rand() * 6)
        img = (img - img.min()) / np.ptp(img) * 255
        rgb = np.repeat(img[..., None], 3, -1).astype(np.uint8)
        (image_dir / f"{i}.ppm").write_bytes(b"P6\n128 96\n255\n" + rgb.tobytes())
    dotlist = ['data.data_dir=images', 'data.image_dir=ppm', 'data.glob=["*.ppm"]',
               'data.train_size=2', 'data.val_size=2', 'data.val_batch_size=2',
               'data.homography={"patch_shape": [96, 64], "difficulty": 0.5}']
    n_kpts = 128
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jhom, thom):
            mp.setattr(mod, "DATA_PATH", root)
        for table in (jelf.METHOD_CONFS, tem.METHOD_CONFS):
            mp.setitem(table, "sp", {**table["sp"], "dtype": "float32"})
        # the script's init and apply run op by op; under jit they compile once
        sp_cls = type(jax_model("superpoint_open").from_conf({}))
        jitted = {}
        mp.setattr(sp_cls, "init", lambda self, *a: jit_o0(
            functools.partial(flax.linen.Module.init, self))(*a))
        mp.setattr(sp_cls, "apply", lambda self, *a: jitted.setdefault(id(self), jit_o0(
            functools.partial(flax.linen.Module.apply, self)))(*a))
        mp.setattr(sys, "argv", ["export_local_features", "--dataset", "homographies",
                                 "--method", "sp", "--split", "val", "--n_kpts", str(n_kpts),
                                 "--output", str(root / "jax.h5"), *dotlist])
        jelf.main()
        # the JAX script's weights: SuperPoint-open initialised from PRNGKey(0)
        # (its `init` is the jitted one patched in above)
        jm = jax_model("superpoint_open").from_conf({**jelf.METHOD_CONFS["sp"],
                                                     "max_num_keypoints": n_kpts})
        variables = jm.init(jax.random.PRNGKey(0), {"image": jnp.zeros((1, 64, 96, 1))})
        flat = {f"{c}/extractor/{k}": np.asarray(v)
                for c in variables for k, v in _flatten(variables[c]).items()}
        np.savez(root / "jax_sp.npz", **flat)
        out = elf.main(["--dataset", "homographies", "--method", "sp", "--split", "val",
                        "--n_kpts", str(n_kpts), "--output", str(root / "port.h5"),
                        "--checkpoint", str(root / "jax_sp.npz"), "--device", "cpu",
                        *dotlist])
    assert out == root / "port.h5"
    return root


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_export_local_features_matches_the_jax_script(features):
    ref, out = _h5py_tree(features / "jax.h5"), _h5py_tree(features / "port.h5")
    assert set(out) == set(ref)
    names = sorted({k.rsplit("/", 1)[0] for k in ref})
    assert len(names) == 2
    for name in names:
        for v in "01":
            assert out[f"{name}/descriptors{v}"].dtype == np.float16  # as_half
            kp, kpj = out[f"{name}/keypoints{v}"], ref[f"{name}/keypoints{v}"]
            pos = {tuple(p): i for i, p in enumerate(kpj.tolist())}
            shared = [(i, pos[tuple(p)]) for i, p in enumerate(kp.tolist()) if tuple(p) in pos]
            assert len(shared) >= 0.99 * len(kpj), (name, v, len(shared))
            a, b = np.array(shared).T
            # float16 in the file: a value the packages compute ~1e-7 apart on
            # either side of a float16 rounding boundary is stored one float16
            # step (|v| 2^-10 at most) apart, above 1e-4 where |v| > 0.1
            np.testing.assert_allclose(out[f"{name}/descriptors{v}"][a].astype(np.float32),
                                       ref[f"{name}/descriptors{v}"][b].astype(np.float32),
                                       rtol=2**-10, atol=1e-4)
            np.testing.assert_allclose(out[f"{name}/keypoint_scores{v}"][a].astype(np.float32),
                                       ref[f"{name}/keypoint_scores{v}"][b].astype(np.float32),
                                       rtol=0, atol=1e-5)


def test_cache_loader_reads_the_export(features):
    loader = CacheLoader({"path": str(features / "port.h5"), "add_data_path": False})
    name = sorted(load_predictions(features / "port.h5"))[0]
    cached = loader({"name": name})
    ref = load_predictions(features / "port.h5")[name]
    assert {"keypoints0", "descriptors1", "keypoint_scores0"} <= set(cached)
    for k, v in ref.items():
        got = np.asarray(cached[k])
        assert got.shape == v.shape, k
        np.testing.assert_array_equal(got, v.astype(got.dtype), err_msg=k)
        if v.dtype == np.float16:  # `numeric_type` float32
            assert got.dtype == np.float32, k


def test_sift_method_is_not_portable(tmp_path):
    with pytest.raises(NotImplementedError, match="not portable"):
        elf.main(["--dataset", "homographies", "--method", "sift", "--device", "cpu",
                  "--output", str(tmp_path / "x.h5")])
