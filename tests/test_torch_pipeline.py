"""The port's whole slice (SuperPoint-open -> full-depth LightGlue -> match
filtering) with the committed hermetic weights, against the JAX
two_view_pipeline on the CPU in float32; plus the port's package rules.

Under pytest-xdist every worker collects every test file, so the thread cap
below holds for all of the port's tests: torch takes this worker's share of
the cores for its intra-op pool (one thread with 6 workers on 8 cores)
instead of a pool as large as the machine in every worker. Run alone, the
cap leaves torch's default.
"""

import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from torch_jax_init import jit_o0
from gluefactory_tpu.models import get_model as jax_model
from gluefactory_tpu.models.matchers.lightglue_pretrained import load_npz_params
from gluefactory_tpu_torch.estimators.homography.torch_ransac import TorchRansacHomography
from gluefactory_tpu_torch.eval.MP import MPPipeline
from gluefactory_tpu_torch.eval.export_helper import match_pair_with_weights
from gluefactory_tpu_torch.eval.hpatches import HPatchesPipeline
from gluefactory_tpu_torch.eval.synthetic import SyntheticHomographyPipeline
from gluefactory_tpu_torch.geometry.wrappers import Camera
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.scripts.export_local_features import export_local_features
from gluefactory_tpu_torch.scripts.slam_scale_run import LoopClosingSlam
from gluefactory_tpu_torch.sfm.slam import IncrementalSlam
from gluefactory_tpu_torch.train.trainer import Trainer
from gluefactory_tpu_torch.utils.config import load_conf
from gluefactory_tpu_torch.weights import HERMETIC, load_hermetic

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = Path(__file__).resolve().parent.parent
CONF = {
    "extractor": {"name": "superpoint_open", "max_num_keypoints": 256, "dtype": "float32"},
    "matcher": {"name": "lightglue", "filter_threshold": 0.1},
}


def _pair(seed, h=240, w=320, dy=13, dx=21):
    """A smooth random image and the same scene shifted by (dx, dy) pixels."""
    rng = np.random.RandomState(seed)
    big = gaussian_filter(rng.rand(h + dy, w + dx), 2.0)
    big = ((big - big.min()) / (big.max() - big.min())).astype(np.float32)
    return big[None, :h, :w, None], big[None, dy:, dx:, None]


def test_pipeline_matches_jax_with_hermetic_weights():
    i0, i1 = _pair(0)
    size = np.asarray([[320.0, 240.0]], np.float32)
    jdata = {v: {"image": jnp.asarray(i), "image_size": jnp.asarray(size)}
             for v, i in (("view0", i0), ("view1", i1))}
    jp = jax_model("two_view_pipeline").from_conf(CONF)
    # the npz holds the whole variables tree: no init needed
    variables = jax.tree.map(lambda a: a.astype(jnp.float32), load_npz_params(HERMETIC))
    ref = jax.tree.map(np.asarray, jit_o0(jp.apply)(variables, jdata))

    pipe = get_model("two_view_pipeline")(CONF, device="cpu")
    pipe.load_state_dict(load_hermetic(device="cpu"))
    tdata = {v: {"image": torch.from_numpy(i), "image_size": torch.from_numpy(size)}
             for v, i in (("view0", i0), ("view1", i1))}
    out = {k: v.numpy() for k, v in pipe(tdata).items()}

    assert (out["matches0"] == ref["matches0"]).mean() >= 0.99
    assert (out["matches1"] == ref["matches1"]).mean() >= 0.99
    for i in "01":
        assert (out[f"matches{i}"][~out[f"keypoint_mask{i}"]] == -1).all()
    assert (out["matches0"] >= 0).sum() > 20


@pytest.mark.parametrize("make", [
    lambda: get_model("two_view_pipeline")(CONF),
    lambda: get_model("lightglue")(),
    lambda: get_model("superpoint_open")(),
    lambda: get_model("superpoint_open")({"fused_block0": True}),
    lambda: get_model("superglue")(),
    lambda: load_hermetic(),
    lambda: get_model("nearest_neighbor_matcher")(),
    lambda: HPatchesPipeline(),
    lambda: TorchRansacHomography(),
    lambda: SyntheticHomographyPipeline(),
    lambda: Trainer(load_conf("superpoint-open+lightglue_homography"), "e"),
    lambda: MPPipeline(),
    lambda: get_model("superpoint_magicleap")(),
    lambda: get_model("gluefactory_tpu_torch.multipoint.models.multipoint")(),
    lambda: get_model("triplet_pipeline")(CONF),
    lambda: IncrementalSlam(Camera.from_params(480, 360, 420.0, 420.0, 240.0, 180.0), None),
    lambda: LoopClosingSlam(Camera.from_params(480, 360, 420.0, 420.0, 240.0, 180.0)),
    lambda: get_model("gluefactory_tpu_torch.multipoint.models.homography_net")(),
    lambda: export_local_features("homographies", "sp"),
    lambda: get_model("lightglue_pretrained")({"weights": "lightglue.npz"}),
    lambda: match_pair_with_weights("superpoint_v1.pth", "superpoint_lightglue.pth", "work"),
])
def test_entry_points_default_to_cuda_and_raise_without_it(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "gluefactory_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {p.name for p in files}
    assert {"superglue.py", "block0_conv.py", "fused_attention.py", "lightglue.py", "hpatches.py",
            "ransac.py", "torch_ransac.py", "eval_pipeline.py", "nearest_neighbor_matcher.py",
            "trainer.py", "__main__.py", "homographies.py", "augmentations.py", "image_ops.py",
            "experiments.py", "summary.py", "synthetic.py", "base_dataset.py", "MP.py",
            "mp_image_pairs.py", "superpoint_magicleap.py", "layers.py", "distributed.py",
            "stdout_capturing.py", "sift_tpu.py", "keynet_hardnet.py", "aliked.py", "disk.py",
            "disk_official.py", "grid_extractor.py", "mixed.py", "dinov2.py", "image_codecs.py",
            "image_pairs.py", "megadepth1500.py", "eth3d.py", "image_folder.py", "hdf5.py",
            "megadepth.py", "cache_loader.py", "triplet_pipeline.py",
            "export_megadepth.py", "ba.py", "pose_graph.py", "slam.py", "triangulation.py",
            "metrics.py", "pair_matching.py", "slam_scale_run.py", "export_predictions.py",
            "export_local_features.py", "viz2d.py", "visualize_batch.py", "convert_weights.py",
            "lightglue_pretrained.py"} <= names
    multipoint = {p.relative_to(ROOT / "gluefactory_tpu_torch" / "multipoint").as_posix()
                  for p in files if "multipoint" in p.parts}
    assert {"datasets/image_pair_dataset.py", "models/multipoint.py", "models/xpoint.py",
            "models/backbones.py", "utils/evaluation.py", "models/homography_net.py",
            "utils/homographies.py"} <= multipoint
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "gluefactory_tpu", "cv2",
                               "h5py", "yaml", "tqdm", "matplotlib", "PIL"), (path, mod)
