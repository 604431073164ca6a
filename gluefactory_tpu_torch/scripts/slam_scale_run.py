"""SLAM at scale: a loop-closing run over a closed 120-keyframe trajectory
(counterpart of scripts/slam_scale_run.py of the JAX package).

A long synthetic loop through `sfm/slam.py` (incremental odometry: NN
matching -> batched E-RANSAC -> monocular scale -> triangulation -> windowed
Schur BA), with loop-closure detection batched over the pair axis by
`parallel/pair_matching.py` (every `closure_every`-th keyframe against
`closure_candidates` old keyframes in one call) and drift correction by the
pose-graph optimiser (`sfm/pose_graph.py`). Reports keyframes/s, closures
found, and ATE before and after the pose graph.

    python -m gluefactory_tpu_torch.scripts.slam_scale_run [--frames 120] [--seed 0]
        [--device cuda|cpu]

Called from a process group of `torch.distributed`, each rank runs the
odometry and matches its slice of the candidate pairs (one `match_pairs`
call a detection on every rank).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any

import numpy as np
import torch

from ..geometry.wrappers import Camera
from ..models import get_model
from ..parallel.pair_matching import make_pair_matcher
from ..sfm.metrics import camera_centers
from ..sfm.pose_graph import PoseGraph, optimize_pose_graph
from ..sfm.slam import IncrementalSlam, Keyframe


def make_loop_sequence(rng, n_frames=120, n_pts=2500, radius=8.0, obs_noise=0.35):
    """Camera travelling a closed circle inside a ring-shaped landmark cloud,
    yaw following the path; the final frames revisit the start pose. Oracle
    features: exact projections plus per-landmark unit descriptors (the run
    exercises the geometry stack, not a detector)."""
    f, cx, cy = 420.0, 240.0, 180.0
    cam = Camera.from_params(480, 360, f, f, cx, cy)
    # landmarks on a ring of radius ~2x the path, various heights
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    rad = rng.uniform(radius * 1.6, radius * 2.6, n_pts)
    X = np.stack(
        [rad * np.cos(ang), rng.uniform(-2.5, 2.5, n_pts), rad * np.sin(ang)], -1
    )
    desc = rng.randn(n_pts, 64).astype("float32")
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)

    frames, poses = [], []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        center = np.array([radius * np.cos(th), 0.0, radius * np.sin(th)])
        # look outward (toward the ring) along the radial direction
        fwd = np.array([np.cos(th), 0.0, np.sin(th)])
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        R = np.stack([right, up, fwd], 0)  # world->cam rows
        t = -R @ center
        p_cam = X @ R.T + t
        z = p_cam[:, 2]
        uv = p_cam[:, :2] / np.maximum(z[:, None], 1e-6) * f + np.array([cx, cy])
        vis = (z > 1.0) & (uv[:, 0] >= 0) & (uv[:, 0] < 480) & (uv[:, 1] >= 0) & (
            uv[:, 1] < 360
        )
        uv_noisy = (uv + rng.randn(n_pts, 2) * obs_noise).astype("float32")
        frames.append((uv_noisy, vis))
        poses.append((R, t))
    return cam, desc, frames, poses


def odometry_matcher(prev: Keyframe, kpts, desc, mask):
    """Mutual nearest neighbours of the descriptors above 0.9 similarity."""
    sim = prev.desc @ desc.T
    m0 = sim.argmax(1)
    m1 = sim.argmax(0)
    mutual = m1[m0] == np.arange(len(m0))
    good = mutual & (sim.max(1) > 0.9) & prev.mask & mask[m0]
    return np.where(good, m0, -1)


class LoopClosingSlam:
    """IncrementalSlam plus batched loop-closure detection and pose-graph
    correction. The closure matcher runs `nearest_neighbor_matcher` over a
    batch of (old keyframe, current keyframe) pairs in one `match_pairs`
    call (split over the ranks under `torch.distributed`)."""

    def __init__(self, cam, conf=None, device: Any = "cuda", relpose_fn=None):
        conf = conf or {}
        self.slam = IncrementalSlam(
            cam, odometry_matcher,
            {"ba_window": conf.get("ba_window", 6), "ba_every": conf.get("ba_every", 4)},
            device=device, relpose_fn=relpose_fn,
        )
        self.device = self.slam.device
        nn = get_model("nearest_neighbor_matcher")({"mutual_check": True}, device=self.device)
        self.match_pairs = make_pair_matcher(nn)
        self.n_candidates = conf.get("closure_candidates", 8)
        self.min_gap = conf.get("closure_min_gap", 25)
        self.closure_every = conf.get("closure_every", 4)
        self.min_matches = conf.get("closure_min_matches", 64)
        self.closures = []  # (i, j, R_ij, t_ij)
        self.pair_matches_checked = 0
        self.match_calls = 0

    def _closure_candidates(self, cur_idx):
        n = self.n_candidates
        old = [k for k in range(cur_idx - self.min_gap)]
        if len(old) < n:
            return None
        # uniform sample of n old keyframes (one batch)
        return list(np.linspace(0, len(old) - 1, n).astype(int))

    def _detect_closures(self, kf):
        cands = self._closure_candidates(kf.idx)
        if cands is None:
            return
        kfs = self.slam.state.keyframes

        batch = {}
        for key, attr in (("descriptors", "desc"), ("keypoints", "kpts"),
                          ("keypoint_mask", "mask")):
            cur = getattr(kf, attr)
            batch[key + "0"] = torch.as_tensor(np.stack([getattr(kfs[c], attr) for c in cands]),
                                               device=self.device)
            batch[key + "1"] = torch.as_tensor(cur, device=self.device).expand(
                (len(cands),) + cur.shape)
        pred = self.match_pairs(batch)
        self.match_calls += 1
        # the whole candidate batch came back from the one call
        assert pred["matches0"].shape[0] == len(cands), pred["matches0"].shape
        m0 = pred["matches0"].cpu().numpy()
        self.pair_matches_checked += len(cands)
        for row, c in enumerate(cands):
            good = m0[row] >= 0
            if good.sum() < self.min_matches:
                continue
            edge = self._closure_edge(kfs[c], kf, np.where(good)[0], m0[row][good])
            if edge is not None:
                self.closures.append((c, kf.idx) + edge)

    def _closure_edge(self, kf_i, kf_j, idx_i, idx_j):
        """Relative pose i->j: E-RANSAC rotation + translation direction,
        scale resolved against the map depths of kf_i's tracked landmarks."""
        slam = self.slam
        p0n = slam.normalize(kf_i.kpts[idx_i])
        p1n = slam.normalize(kf_j.kpts[idx_j])
        res = slam.relpose_fn(p0n, p1n, torch.ones(len(idx_i), dtype=torch.bool,
                                                   device=self.device),
                              kf_j.idx * 1000 + kf_i.idx, 1.0 / slam.f_mean)
        inl = res.inliers.cpu().numpy()
        if inl.sum() < 24:
            return None
        R_rel, t_unit = res.R.cpu().numpy(), res.t.cpu().numpy()

        # scale from map landmarks tracked in kf_i: depth(map in kf_i) against
        # the depth triangulated under (R_rel, t_unit), over E-RANSAC inliers
        # only (an outlier triangulates to an arbitrary depth)
        tracks_i = slam._kp_to_track[kf_i.idx]
        sel = [k for k, kp in enumerate(idx_i) if inl[k] and int(kp) in tracks_i]
        if len(sel) < 8:
            return None
        sel = np.asarray(sel)
        Xi = np.stack([slam.state.X[tracks_i[int(idx_i[k])]] for k in sel])
        depth_map = (Xi @ kf_i.R.T + kf_i.t)[:, 2]
        # triangulate each point from the 2 views (frame i = identity), so the
        # points live in frame i and X[:, 2] is their depth there
        P = len(sel)
        p0n, p1n = p0n.cpu().numpy(), p1n.cpu().numpy()
        rays = np.stack([p0n[sel], p1n[sel]], axis=1)  # (P, 2, 2)
        R2 = np.broadcast_to(np.stack([np.eye(3), R_rel], 0), (P, 2, 3, 3))
        t2 = np.broadcast_to(np.stack([np.zeros(3), t_unit], 0), (P, 2, 3))
        depth_tri = slam.triangulate(rays, R2, t2)[:, 2]
        ok = (depth_tri > 1e-3) & (depth_map > 1e-3)
        if ok.sum() < 8:
            return None
        scale = float(np.median(depth_map[ok] / depth_tri[ok]))
        if not (1e-2 < scale < 1e2):
            return None
        return (R_rel, t_unit * scale)

    def add_keyframe(self, uv, desc_bank, vis):
        kf = self.slam.add_keyframe(uv, desc_bank, vis)
        if kf.idx > 0 and kf.idx % self.closure_every == 0:
            self._detect_closures(kf)
        return kf

    def pose_graph(self) -> PoseGraph:
        """Odometry edges between consecutive keyframes (from the current
        estimates, weight 1) and the detected closure edges (measured,
        weight 2), float32 on the device."""
        kfs = self.slam.state.keyframes
        R = np.stack([k.R for k in kfs])
        t = np.stack([k.t for k in kfs])
        edges, R_ij, t_ij, w = [], [], [], []
        for i in range(len(kfs) - 1):
            Rr = R[i + 1] @ R[i].T
            edges.append((i, i + 1))
            R_ij.append(Rr)
            t_ij.append(t[i + 1] - Rr @ t[i])
            w.append(1.0)
        for (i, j, Rr, tr) in self.closures:
            edges.append((i, j))
            R_ij.append(Rr)
            t_ij.append(tr)
            w.append(2.0)

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        return PoseGraph(dev(R), dev(t), dev(edges, torch.int32), dev(np.stack(R_ij)),
                         dev(np.stack(t_ij)), dev(w))

    def optimize(self, iterations=25):
        """Pose-graph correction of every keyframe; returns the final cost."""
        graph, cost = optimize_pose_graph(self.pose_graph(), iterations=iterations)
        R_opt, t_opt = graph.R.cpu().numpy(), graph.t.cpu().numpy()
        for k, kf in enumerate(self.slam.state.keyframes):
            kf.R, kf.t = R_opt[k], t_opt[k]
        return float(cost)


def run(n_frames=120, seed=0, verbose=True, device: Any = "cuda", conf=None):
    """The loop-closing run; returns its stats."""
    rng = np.random.RandomState(seed)
    cam, desc_bank, frames, poses = make_loop_sequence(rng, n_frames=n_frames)
    slam = LoopClosingSlam(cam, conf, device=device)

    t0 = time.perf_counter()
    for uv, vis in frames:
        slam.add_keyframe(uv, desc_bank, vis)
    dt = time.perf_counter() - t0

    gt_centers = camera_centers(
        np.stack([R for R, _ in poses]), np.stack([t for _, t in poses])
    )
    ate_before = slam.slam.evaluate_ate(gt_centers)["ate_rmse"]
    n_closures = len(slam.closures)
    t1 = time.perf_counter()
    slam.optimize()
    pg_s = time.perf_counter() - t1
    ate_after = slam.slam.evaluate_ate(gt_centers)["ate_rmse"]
    stats = {
        "n_keyframes": n_frames,
        "keyframes_per_s": n_frames / dt,
        "n_landmarks": len(slam.slam.state.X),
        "closures_found": n_closures,
        "pairs_checked": slam.pair_matches_checked,
        "pairs_per_call": slam.pair_matches_checked / max(slam.match_calls, 1),
        "pose_graph_s": pg_s,
        "ate_before_pg": ate_before,
        "ate_after_pg": ate_after,
    }
    if verbose:
        print(json.dumps(stats))
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=120)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return run(n_frames=args.frames, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
