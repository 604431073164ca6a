"""Minimal incremental SfM/SLAM driver (counterpart of
gluefactory_tpu/sfm/slam.py).

Per keyframe: match against the previous keyframe (any matcher), estimate
the relative pose with the batched E-RANSAC, resolve the monocular scale
against the existing map, triangulate new landmarks, and refine the active
window with the Schur-complement bundle adjustment every `ba_every`
keyframes. Evaluation: ATE against ground truth.

The bookkeeping (tracks, keyframes) stays on the host in numpy, as in the
JAX package; relative pose, triangulation and BA run on the SLAM's device
(CUDA unless a CPU device is passed). The window's tracks are not padded:
the JAX package pads them to multiples of 256 for compile reuse, and its
padded rows change nothing.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..estimators.ransac import ransac_relative_pose
from ..geometry.wrappers import Camera
from ..models.base_model import resolve_device
from .ba import BAProblem, bundle_adjust
from .metrics import absolute_trajectory_error, camera_centers
from .triangulation import triangulate_dlt

logger = logging.getLogger(__name__)


def ransac_relpose(p0n, p1n, valid, seed: int, th: float):
    """The default relative-pose estimator: the port's E-RANSAC on the
    points' device, its draws from a generator seeded by `seed`."""
    gen = torch.Generator(device=p0n.device).manual_seed(seed)
    return ransac_relative_pose(p0n, p1n, valid, generator=gen, th=th)


@dataclass
class Keyframe:
    idx: int
    R: np.ndarray  # world->cam
    t: np.ndarray
    kpts: np.ndarray  # (N, 2)
    desc: np.ndarray  # (N, D)
    mask: np.ndarray  # (N,)


@dataclass
class SlamState:
    keyframes: list = field(default_factory=list)
    # landmark tracks: world point + per-keyframe observations
    X: list = field(default_factory=list)  # (3,) each
    obs: list = field(default_factory=list)  # list of {kf_idx: uv}


class IncrementalSlam:
    def __init__(self, camera: Camera, matcher_fn, conf=None, device: Any = "cuda",
                 relpose_fn: Callable | None = None):
        """matcher_fn(prev_keyframe, kpts, desc, mask) -> matches0 (N,);
        relpose_fn(p0n, p1n, valid, seed, th) -> (R, t, inliers, ...) on the
        device's tensors, the port's E-RANSAC (`ransac_relpose`) by default."""
        self.device = resolve_device(device)
        self.camera = camera.to(self.device)
        self.matcher_fn = matcher_fn
        self.relpose_fn = relpose_fn or ransac_relpose
        conf = conf or {}
        self.ransac_th_px = conf.get("ransac_th", 1.0)
        self.ba_window = conf.get("ba_window", 8)
        self.ba_every = conf.get("ba_every", 4)
        self.max_track_obs = conf.get("max_track_obs", 8)
        self.state = SlamState()
        self._kp_to_track: list = []  # per keyframe: dict kp_idx -> track_idx

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype, device=self.device)

    def normalize(self, p: np.ndarray) -> torch.Tensor:
        """Pixels (N, 2) -> normalised coordinates (N, 2), float32 on the
        device."""
        return self.camera.normalize(self._tensor(p[None]))[0]

    def triangulate(self, rays, Rs, ts) -> np.ndarray:
        """Two-view DLT of (S, 2, 2) rays under (S, 2, 3, 3) / (S, 2, 3)
        poses, float32 on the device; (S, 3) on the host."""
        valid = torch.ones(len(rays), 2, dtype=torch.bool, device=self.device)
        return triangulate_dlt(self._tensor(rays), self._tensor(Rs), self._tensor(ts),
                               valid).cpu().numpy()

    @property
    def f_mean(self) -> float:
        return float(self.camera.f.mean())

    # ------------------------------------------------------------------ steps
    def add_keyframe(self, kpts, desc, mask, gt_pose=None):
        state = self.state
        if not state.keyframes:
            kf = Keyframe(0, np.eye(3), np.zeros(3), kpts, desc, mask)
            state.keyframes.append(kf)
            self._kp_to_track.append({})
            return kf

        prev = state.keyframes[-1]
        matches0 = np.asarray(self.matcher_fn(prev, kpts, desc, mask))
        valid = matches0 >= 0
        if valid.sum() < 16:
            logger.warning("Keyframe %d: too few matches", len(state.keyframes))
            valid = matches0 >= -1  # degrade gracefully

        m_prev = np.where(valid)[0]
        m_cur = matches0[m_prev]
        p0n, p1n = self.normalize(prev.kpts[m_prev]), self.normalize(kpts[m_cur])
        res = self.relpose_fn(p0n, p1n, torch.ones(len(m_prev), dtype=torch.bool,
                                                   device=self.device),
                              len(state.keyframes), self.ransac_th_px / self.f_mean)
        R_rel = np.asarray(res.R.cpu())
        t_rel = np.asarray(res.t.cpu())
        inliers = np.asarray(res.inliers.cpu())

        # resolve monocular scale against existing landmarks seen in prev
        scale = self._resolve_scale(prev, m_prev, m_cur, kpts, R_rel, t_rel, inliers)
        t_rel = t_rel * scale

        R_new = R_rel @ prev.R
        t_new = R_rel @ prev.t + t_rel
        kf = Keyframe(len(state.keyframes), R_new, t_new, kpts, desc, mask)
        state.keyframes.append(kf)
        self._kp_to_track.append({})

        # extend/create tracks for inlier matches
        self._update_tracks(prev, kf, m_prev[inliers], m_cur[inliers])

        if kf.idx % self.ba_every == 0 and len(state.X) > 32:
            self._run_ba()
        return kf

    def _resolve_scale(self, prev, m_prev, m_cur, kpts, R_rel, t_rel, inliers):
        """Ratio of map depth to fresh two-view depth over shared tracks."""
        tracks = self._kp_to_track[prev.idx]
        shared = [
            (i, j) for i, j in zip(m_prev[inliers], m_cur[inliers]) if i in tracks
        ]
        if len(shared) < 8 or not self.state.X:
            return 1.0
        # depth of the mapped points in prev's frame
        idxs = [tracks[i] for i, _ in shared]
        Xw = np.stack([self.state.X[t] for t in idxs])
        z_map = (Xw @ prev.R.T + prev.t)[:, 2]
        # two-view triangulated depth with |t_rel| = 1
        p0n = self.normalize(prev.kpts[[i for i, _ in shared]]).cpu().numpy()
        p1n = self.normalize(kpts[[j for _, j in shared]]).cpu().numpy()
        n = len(shared)
        rays = np.stack([p0n, p1n], axis=1)  # (S, 2, 2)
        Rs = np.stack([np.broadcast_to(np.eye(3), (n, 3, 3)),
                       np.broadcast_to(R_rel, (n, 3, 3))], 1)
        ts = np.stack([np.zeros((n, 3)), np.broadcast_to(t_rel, (n, 3))], 1)
        z_rel = self.triangulate(rays, Rs, ts)[:, 2]
        good = (z_rel > 0.1) & (z_map > 0.1)
        if good.sum() < 5:
            return 1.0
        ratio = np.median(z_map[good] / z_rel[good])
        return float(np.clip(ratio, 0.1, 10.0))

    def _update_tracks(self, prev, kf, idx_prev, idx_cur):
        state = self.state
        tracks_prev = self._kp_to_track[prev.idx]
        tracks_cur = self._kp_to_track[kf.idx]
        new_p0, new_p1, new_pairs = [], [], []
        for i, j in zip(idx_prev, idx_cur):
            if i in tracks_prev:
                tid = tracks_prev[i]
                if len(state.obs[tid]) < self.max_track_obs:
                    state.obs[tid][kf.idx] = kf.kpts[j]
                tracks_cur[j] = tid
            else:
                new_p0.append(prev.kpts[i])
                new_p1.append(kf.kpts[j])
                new_pairs.append((i, j))
        if new_p0:
            # triangulate new landmarks in world frame
            p0n = self.normalize(np.asarray(new_p0)).cpu().numpy()
            p1n = self.normalize(np.asarray(new_p1)).cpu().numpy()
            S = len(new_p0)
            rays = np.stack([p0n, p1n], 1)
            Rs = np.stack([np.broadcast_to(prev.R, (S, 3, 3)),
                           np.broadcast_to(kf.R, (S, 3, 3))], 1)
            ts = np.stack([np.broadcast_to(prev.t, (S, 3)),
                           np.broadcast_to(kf.t, (S, 3))], 1)
            Xw = self.triangulate(rays, Rs, ts)
            z0 = (Xw @ prev.R.T + prev.t)[:, 2]
            z1 = (Xw @ kf.R.T + kf.t)[:, 2]
            for s, (i, j) in enumerate(new_pairs):
                if z0[s] < 0.2 or z1[s] < 0.2 or not np.isfinite(Xw[s]).all():
                    continue
                tid = len(state.X)
                state.X.append(Xw[s])
                state.obs.append({prev.idx: prev.kpts[i], kf.idx: kf.kpts[j]})
                tracks_prev[i] = tid
                tracks_cur[j] = tid

    def _run_ba(self):
        """Windowed BA over the last ba_window keyframes."""
        state = self.state
        kfs = state.keyframes[-self.ba_window:]
        kf_ids = {kf.idx: local for local, kf in enumerate(kfs)}
        K_obs = self.max_track_obs
        track_ids, cam_idx, uv, valid = [], [], [], []
        for tid, obs in enumerate(state.obs):
            in_window = {k: v for k, v in obs.items() if k in kf_ids}
            if len(in_window) < 2:
                continue
            track_ids.append(tid)
            ci = np.zeros(K_obs, np.int32)
            pix = np.zeros((K_obs, 2), np.float32)
            vm = np.zeros(K_obs, bool)
            for n, (k, p) in enumerate(list(in_window.items())[:K_obs]):
                ci[n] = kf_ids[k]
                pix[n] = p
                vm[n] = True
            cam_idx.append(ci)
            uv.append(pix)
            valid.append(vm)
        if len(track_ids) < 16:
            return
        problem = BAProblem(
            self._tensor(np.stack([kf.R for kf in kfs])),
            self._tensor(np.stack([kf.t for kf in kfs])),
            self._tensor(np.stack([state.X[t] for t in track_ids])),
            self._tensor(np.stack(cam_idx), torch.int32),
            self._tensor(np.stack(uv)),
            self._tensor(np.stack(valid), torch.bool),
            self.camera.calibration_matrix().float(),
        )
        refined, _, _ = bundle_adjust(problem, iterations=6)
        R_new = refined.R.cpu().numpy()
        t_new = refined.t.cpu().numpy()
        X_new = refined.X.cpu().numpy()
        for local, kf in enumerate(kfs):
            kf.R = R_new[local]
            kf.t = t_new[local]
        for s, tid in enumerate(track_ids):
            state.X[tid] = X_new[s]

    # ------------------------------------------------------------------- eval
    def trajectory(self) -> np.ndarray:
        R = np.stack([kf.R for kf in self.state.keyframes])
        t = np.stack([kf.t for kf in self.state.keyframes])
        return camera_centers(R, t)

    def evaluate_ate(self, gt_positions: np.ndarray) -> dict:
        return absolute_trajectory_error(self.trajectory(), gt_positions)


__all__ = ["IncrementalSlam", "Keyframe", "SlamState", "ransac_relpose"]
