"""Export-phase model application and the official-checkpoint pair check
(counterpart of gluefactory_tpu/eval/export_helper.py).

`make_export_apply_fn` builds the port's two-view pipeline on the device and
loads a checkpoint: an `.npz` file (the JAX package's flat flax artifact,
e.g. `weights/hermetic/sp_open_lg.npz`) or the name of a training
experiment of the port (its best checkpoint, else its last). Every
parameter and buffer of the configured components must be in it. The host-extractor branch of the JAX
package raises: `sift` (the host OpenCV SIFT) is not portable, `sift_tpu`
takes its place; the line extractors `lsd` and `wireframe` wait (ROADMAP
Queue 1 item 5).

`match_pair_with_weights` converts official SuperPoint and LightGlue `.pth`
files with the port's converters and matches one pair, a textured
synthetic one by default, with its precision against the known homography.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models import get_model
from ..models.base_model import resolve_device
from ..utils.config import to_dict
from ..utils.tensor import batch_to_device
from ..weights import load_hermetic

HOST_EXTRACTORS = {"sift", "lsd", "wireframe"}


def load_checkpoint(model: torch.nn.Module, path: str | Path) -> None:
    """Load the entries of `model.state_dict()` from an `.npz` checkpoint or
    an experiment; raises on one the checkpoint lacks."""
    device = next(iter(model.state_dict().values())).device
    if str(path).endswith(".npz"):
        state = load_hermetic(path, device=device)
    else:
        from ..utils import experiments

        try:
            ckpt = experiments.get_best_checkpoint(str(path))
        except FileNotFoundError:
            ckpt = experiments.get_last_checkpoint(str(path))
        state = experiments.load_checkpoint(ckpt, device=device)[0]["model"]
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} entries of the model, e.g. {missing[:4]}")
    model.load_state_dict({k: state[k] for k in own}, strict=True)


def load_model(model_conf: dict, checkpoint: str | Path | None = None, device: Any = "cuda"):
    """The configured pipeline in eval mode, with `checkpoint` loaded (else
    the models' seeded random initialisation)."""
    model_conf = to_dict(model_conf)
    name = (model_conf.get("extractor") or {}).get("name")
    if name in HOST_EXTRACTORS:
        if name == "sift":
            raise NotImplementedError(
                "the host extractor 'sift' (OpenCV) is not portable; use 'sift_tpu'")
        raise NotImplementedError(
            f"the host extractor {name!r} is not ported yet (ROADMAP Queue 1 item 5)")
    model = get_model(model_conf.get("name", "two_view_pipeline"))(model_conf, device=device)
    if checkpoint:
        load_checkpoint(model, checkpoint)
    return model.eval()


def make_export_apply_fn(model_conf: dict, live_params: dict | None = None, device: Any = "cuda"):
    """(apply_fn(batch) -> predictions, state). `model_conf["checkpoint"]`
    names an `.npz` checkpoint; `live_params` (a state dict, e.g. of a model
    in training) overrides the entries it has."""
    model_conf = to_dict(model_conf)
    checkpoint = model_conf.pop("checkpoint", None)
    model = load_model(model_conf, checkpoint, device)
    if live_params is not None:
        state = model.state_dict()
        model.load_state_dict({k: live_params.get(k, v) for k, v in state.items()})
    state = {"model": model}

    @torch.no_grad()
    def apply_fn(batch):
        return model(batch_to_device(batch, model.device))

    return apply_fn, state


def match_pair_with_weights(
    superpoint_pth: str | Path,
    lightglue_pth: str | Path,
    work_dir: str | Path,
    image0: np.ndarray | None = None,
    image1: np.ndarray | None = None,
    H_0to1: np.ndarray | None = None,
    max_num_keypoints: int = 2048,
    filter_threshold: float = 0.1,
    device: Any = "cuda",
) -> dict:
    """Official SuperPoint (MagicLeap) + LightGlue checkpoints on one pair of
    (H, W) grey images in [0, 1]: the `.pth` files converted with the port's
    converters into `work_dir/superpoint.npz` and `work_dir/lightglue.npz`,
    `superpoint_magicleap` (detection threshold 0.0005) feeding
    `lightglue_pretrained` at full depth (`posenc` from the tree), and the
    precision at 3 px against `H_0to1`. Without images, the JAX function's
    textured synthetic pair: a 480 x 640 sum of 24 random low-frequency
    gratings and its inverse warp by a fixed homography (on `device`).

    Returns {"num_matches", "prec@3px", "matches0", "keypoints0/1"}."""
    from ..multipoint.utils.homographies import warp_image_bilinear
    from ..scripts.convert_weights import convert, load_state_dict, save_tree_npz
    from ..weights import load_npz

    device = resolve_device(device)
    work_dir = Path(work_dir)
    work_dir.mkdir(parents=True, exist_ok=True)
    sp_npz, lg_npz = work_dir / "superpoint.npz", work_dir / "lightglue.npz"
    save_tree_npz(convert("superpoint", load_state_dict(superpoint_pth)), sp_npz)
    lg_tree = convert("lightglue", load_state_dict(lightglue_pth))
    save_tree_npz(lg_tree, lg_npz)
    posenc = "conditional_fourier" if "posenc_cond_w" in lg_tree["params"] else "fourier"

    if image0 is None:
        rng = np.random.RandomState(0)
        h, w = 480, 640
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        image0 = np.zeros((h, w), np.float32)
        for _ in range(24):
            fx, fy = rng.uniform(0.01, 0.2, 2)
            image0 += rng.uniform(0.2, 1.0) * np.sin(
                2 * np.pi * (fx * xx + fy * yy) + rng.uniform(0, 6.28))
        image0 = (image0 - image0.min()) / (np.ptp(image0) + 1e-8)
        H_0to1 = np.array([[0.95, 0.05, 12.0], [-0.04, 0.98, -7.0], [1e-5, -2e-5, 1.0]],
                          np.float32)
        image1 = warp_image_bilinear(torch.from_numpy(image0)[None, ..., None].to(device),
                                     torch.from_numpy(H_0to1)[None].to(device))
        image1 = image1[0, ..., 0].cpu().numpy()
    if H_0to1 is None:
        raise ValueError("custom images need their H_0to1")

    pipe = get_model("two_view_pipeline")({
        "extractor": {"name": "superpoint_magicleap", "max_num_keypoints": max_num_keypoints,
                      "detection_threshold": 0.0005},
        "matcher": {"name": "lightglue_pretrained", "weights": str(lg_npz),
                    "filter_threshold": filter_threshold, "posenc": posenc,
                    "depth_confidence": -1, "width_confidence": -1},
    }, device=device).eval()
    pipe.extractor.load_state_dict(load_npz(sp_npz))

    def view(img):
        hh, ww = img.shape[:2]
        return {"image": torch.as_tensor(np.asarray(img, np.float32))[None, ..., None].to(device),
                "image_size": torch.tensor([[float(ww), float(hh)]], device=device)}

    with torch.no_grad():
        pred = pipe({"view0": view(image0), "view1": view(image1)})
    kpts0 = pred["keypoints0"][0].cpu().numpy()
    kpts1 = pred["keypoints1"][0].cpu().numpy()
    m0 = pred["matches0"][0].cpu().numpy()
    valid = m0 >= 0
    pts0, pts1 = kpts0[valid], kpts1[m0[valid]]
    hom = np.concatenate([pts0, np.ones_like(pts0[:, :1])], -1) @ np.asarray(H_0to1).T
    err = np.linalg.norm(hom[:, :2] / hom[:, 2:] - pts1, axis=-1)
    return {
        "num_matches": int(valid.sum()),
        "prec@3px": float((err < 3.0).mean()) if valid.any() else 0.0,
        "matches0": m0,
        "keypoints0": kpts0,
        "keypoints1": kpts1,
    }


__all__ = ["make_export_apply_fn", "load_model", "load_checkpoint", "match_pair_with_weights",
           "HOST_EXTRACTORS"]
