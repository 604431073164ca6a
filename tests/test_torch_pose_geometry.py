"""The port's pose geometry against the JAX package on the CPU: the SO(3)
exponential, `Pose` / `Camera` and world -> image projection, batches of
wrappers, depth sampling and reprojection, epipolar geometry, the 3 x 3
SVD's essential projection, the pose + depth ground truth and the
`depth_matcher` model.

Inputs come from numpy seeds. Bars, as stated at each test: the SO(3) map
and the Pose ops 1e-6 (relative to the value, floor 1e-6); pixel
coordinates (projection, reprojection) 3e-5 px plus 1e-6 of the coordinate,
on the points valid on both sides, with the validity masks equal: both
sides are fp32 through a 3D path in another order, and a pixel carries f x
a few ulps of a normalised coordinate, 1.5e-5 px at f = 144 (measured);
sampled depths 1e-5; epipolar distances 1e-5 relative with a floor of
2e-5 / f in normalised units (under E) and 1e-4 px in pixels (under F,
whose residual p1^T F p0 cancels terms of ~1: 5e-5 px measured); the
projected E 1e-6 (unit-norm inputs); ground-truth labels exact, projections
within 1e-4 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluefactory_tpu.geometry import depth as jdepth
from gluefactory_tpu.geometry import epipolar as jepi
from gluefactory_tpu.geometry import gt_generation as jgt
from gluefactory_tpu.geometry.utils import angle_error_mat as j_angle_mat
from gluefactory_tpu.geometry.utils import angle_error_vec as j_angle_vec
from gluefactory_tpu.geometry.utils import so3exp_map as j_so3
from gluefactory_tpu.geometry.wrappers import Camera as JCamera
from gluefactory_tpu.geometry.wrappers import Pose as JPose
from gluefactory_tpu.geometry.wrappers import world_points_to_image as j_w2i
from gluefactory_tpu.models.matchers.depth_matcher import DepthMatcher as JDepthMatcher
from gluefactory_tpu.ops.linalg import svd3x3 as j_svd3x3
from gluefactory_tpu_torch.datasets.base_dataset import collate
from gluefactory_tpu_torch.geometry import depth, epipolar, gt_generation
from gluefactory_tpu_torch.geometry.utils import angle_error_mat, angle_error_vec, so3exp_map
from gluefactory_tpu_torch.geometry.wrappers import Camera, Pose, world_points_to_image
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.ops.linalg import svd3x3
from gluefactory_tpu_torch.utils.tensor import batch_to_device, batch_to_numpy, index_batch

W, H, F = 160, 120, 144.0


def close(out, ref, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(out, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


def _poses(seed, b=3):
    """(R, t) float32 arrays of b random relative poses."""
    rng = np.random.RandomState(seed)
    R = np.asarray(j_so3(jnp.asarray(rng.randn(b, 3).astype(np.float32) * 0.1)))
    t = (rng.randn(b, 3) * [0.4, 0.25, 0.15]).astype(np.float32)
    return R, t


PX = 3e-5  # the pixel floor, see above


def close_px(out, ref, valid, atol=PX):
    """Pixel coordinates (..., N, 2) on the valid points."""
    valid = np.asarray(valid)
    close(np.asarray(out)[valid], np.asarray(ref)[valid], rtol=1e-6, atol=atol)


def _both(R, t):
    return JPose.from_Rt(jnp.asarray(R), jnp.asarray(t)), Pose.from_Rt(torch.tensor(R),
                                                                       torch.tensor(t))


def _cams(dist=()):
    data = np.array([W, H, F, F * 1.02, W / 2 + 0.3, H / 2 - 0.2, *dist], np.float32)
    return JCamera(jnp.asarray(data)), Camera(torch.from_numpy(data))


def _scene(seed, b=2, n=64):
    """Depth maps of two slanted planes a view, keypoints (some off the
    image or on holes), cameras and the poses between the views."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    depths = []
    for _ in range(2):
        d = 4.0 + rng.rand(b, 1, 1) + 0.004 * xs - 0.003 * ys
        d = np.where(xs[None] > W * rng.uniform(0.4, 0.7), d * 0.8, d)
        d[:, 10:20, 30:45] = 0.0  # no depth here
        depths.append(d.astype(np.float32))
    kps = [np.concatenate([rng.uniform(0, [W, H], (b, n - 4, 2)),
                           rng.uniform(-3, 3, (b, 4, 2)) + [W, 0]], 1).astype(np.float32)
           for _ in range(2)]
    R, t = _poses(seed, b)
    return depths, kps, R, t


def test_so3exp_and_angles_match_jax():
    rng = np.random.RandomState(0)
    w = (rng.randn(32, 3) * 0.3).astype(np.float32)
    w[:4] *= 1e-8  # below eps: the first-order branch
    close(so3exp_map(torch.from_numpy(w)), j_so3(jnp.asarray(w)))
    R1, R2 = so3exp_map(torch.from_numpy(w)), so3exp_map(torch.from_numpy(w[::-1].copy()))
    close(angle_error_mat(R1, R2), j_angle_mat(jnp.asarray(R1.numpy()), jnp.asarray(R2.numpy())),
          rtol=1e-5, atol=1e-3)  # arccos near 1 in fp32
    v1, v2 = rng.randn(8, 3).astype(np.float32), rng.randn(8, 3).astype(np.float32)
    close(angle_error_vec(torch.from_numpy(v1), torch.from_numpy(v2)),
          j_angle_vec(jnp.asarray(v1), jnp.asarray(v2)), rtol=1e-5, atol=1e-4)


def test_pose_and_camera_ops_match_jax():
    (jT, T), (jU, U) = _both(*_poses(1)), _both(*_poses(2))
    M = np.asarray(jT.matrix())
    for a, b in ((T.inv(), jT.inv()), (T @ U, jT @ jU), (Pose.from_4x4mat(M), jT)):
        close(a.R, b.R)
        close(a.t, b.t)
    p = np.random.RandomState(3).randn(3, 10, 3).astype(np.float32)
    close(T @ torch.from_numpy(p), jT @ jnp.asarray(p))
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    close(Camera.from_calibration_matrix(torch.from_numpy(K))._data,
          JCamera.from_calibration_matrix(jnp.asarray(K))._data)
    for dist in ((), (0.05, -0.01)):
        jc, c = _cams(dist)
        close(c.calibration_matrix(), jc.calibration_matrix())
        p3d = (np.random.RandomState(4).randn(3, 50, 3) + [0, 0, 4]).astype(np.float32)
        p3d[:, :3, 2] = -1.0  # behind the camera
        (a, va), (b, vb) = c.cam2image(torch.from_numpy(p3d)), jc.cam2image(jnp.asarray(p3d))
        assert np.array_equal(va.numpy(), np.asarray(vb)) and va.any() and not va.all()
        close_px(a, b, va)
        pix = np.random.RandomState(5).uniform(0, [W, H], (3, 20, 2)).astype(np.float32)
        close(c.image2cam(torch.from_numpy(pix)), jc.image2cam(jnp.asarray(pix)))
        (a, va), (b, vb) = (world_points_to_image(torch.from_numpy(p3d), T, c),
                            j_w2i(jnp.asarray(p3d), jT, jc))
        assert np.array_equal(va.numpy(), np.asarray(vb)) and va.any()
        close_px(a, b, va)


def test_wrappers_collate_move_and_index():
    R, t = _poses(6, 4)
    samples = [{"T": Pose.from_Rt(torch.from_numpy(R[i].copy()), torch.from_numpy(t[i].copy())),
                "view": {"camera": _cams()[1], "image": np.zeros((2, 3), np.float32)},
                "name": f"p{i}"} for i in range(4)]
    batch = collate(samples)
    assert isinstance(batch["T"], Pose) and batch["T"].shape == (4,)
    assert batch["view"]["camera"].shape == (4,) and batch["name"] == ["p0", "p1", "p2", "p3"]
    assert torch.equal(batch["T"].R, torch.from_numpy(R)) and batch["T"][2].R.shape == (3, 3)
    moved = batch_to_device(batch, "cpu")
    assert isinstance(moved["T"], Pose) and torch.is_tensor(moved["view"]["image"])
    items = list(index_batch(moved))
    assert len(items) == 4 and torch.equal(items[1]["T"].t, torch.from_numpy(t[1]))
    assert items[3]["view"]["camera"].shape == ()
    as_np = batch_to_numpy(batch)
    assert isinstance(as_np["T"], Pose) and isinstance(as_np["T"].R, np.ndarray)
    f64 = batch["T"].to(torch.float64)
    assert f64.R.dtype == f64.t.dtype == torch.float64


def test_sample_depth_project_and_dense_warp_match_jax():
    depths, kps, R, t = _scene(7)
    (jT, T), (jc, c) = _both(R, t), _cams()
    for kp, d in zip(kps, depths):
        (a, va), (b, vb) = (depth.sample_depth(torch.from_numpy(kp), torch.from_numpy(d)),
                            jdepth.sample_depth(jnp.asarray(kp), jnp.asarray(d)))
        assert np.array_equal(va.numpy(), np.asarray(vb)) and va.any() and not va.all()
        close(a, b, rtol=1e-6, atol=1e-5)
    kp0, d0 = torch.from_numpy(kps[0]), torch.from_numpy(depths[0])
    z0, v0 = depth.sample_depth(kp0, d0)
    for ccth in (None, 4.0):
        out = depth.project(kp0, z0, torch.from_numpy(depths[1]), c, c, T, v0, ccth=ccth)
        ref = jdepth.project(jnp.asarray(kps[0]), jnp.asarray(z0.numpy()), jnp.asarray(depths[1]),
                             jc, jc, jT, jnp.asarray(v0.numpy()), ccth=ccth)
        assert np.array_equal(out[1].numpy(), np.asarray(ref[1])) and out[1].any()
        close_px(out[0], ref[0], out[1])
    out = depth.dense_warp_consistency(d0, torch.from_numpy(depths[1]), T, c, c, ccth=4.0)
    ref = jdepth.dense_warp_consistency(jnp.asarray(depths[0]), jnp.asarray(depths[1]), jT, jc,
                                        jc, ccth=4.0)
    assert (out[1].numpy() == np.asarray(ref[1])).mean() >= 0.9999
    # a longer chain (two reprojections a pixel): the ground truth's 1e-4 px
    close_px(out[0], ref[0], out[1].numpy() & np.asarray(ref[1]), atol=1e-4)


def test_epipolar_geometry_matches_jax():
    R, t = _poses(8)
    (jT, T), (jc, c) = _both(R, t), _cams()
    close(epipolar.T_to_E(T), jepi.T_to_E(jT), rtol=1e-5)
    Fm = epipolar.T_to_F(c, c, T)
    close(Fm, jepi.T_to_F(jc, jc, jT), rtol=1e-5, atol=1e-9)
    close(epipolar.F_to_E(c, c, Fm), jepi.F_to_E(jc, jc, jnp.asarray(Fm.numpy())), rtol=1e-5,
          atol=1e-6)
    rng = np.random.RandomState(9)
    p0, p1 = (rng.uniform(0, [W, H], (3, 40, 2)).astype(np.float32) for _ in range(2))
    # normalised points under E, pixels under F; squared distances as distances
    n0, n1 = (((p - [W / 2, H / 2]) / F).astype(np.float32) for p in (p0, p1))
    for (a, b, M, floor) in ((n0, n1, epipolar.T_to_E(T), 2e-5 / F), (p0, p1, Fm, 1e-4)):
        ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
        jM = jnp.asarray(M.numpy())
        close(epipolar.sym_epipolar_distance(ta, tb, M, False),
              jepi.sym_epipolar_distance(ja, jb, jM, False), rtol=1e-5, atol=floor)
        close(epipolar.sym_epipolar_distance(ta, tb, M).sqrt(),
              jnp.sqrt(jepi.sym_epipolar_distance(ja, jb, jM)), rtol=1e-5, atol=floor)
        close(epipolar.sym_epipolar_distance_all(ta, tb, M),
              jepi.sym_epipolar_distance_all(ja, jb, jM), rtol=1e-5, atol=floor)
    tp0, tp1 = torch.from_numpy(p0), torch.from_numpy(p1)
    jp0, jp1 = jnp.asarray(p0), jnp.asarray(p1)
    for all_pairs in (True, False):
        for essential in (True, False):
            close(epipolar.generalized_epi_dist(tp0, tp1, c, c, T, all_pairs, essential),
                  jepi.generalized_epi_dist(jp0, jp1, jc, jc, jT, all_pairs, essential),
                  rtol=1e-5, atol=2e-5 / F if essential else 1e-4)
    E = epipolar.T_to_E(T)
    # the decomposition: the true pose is among the four candidates (E in fp32)
    R1, R2, td = epipolar.decompose_essential_matrix(E.double())
    cands = [(Rx, s * td) for Rx in (R1, R2) for s in (1, -1)]
    rerr = torch.stack([angle_error_mat(Rx, T.R.double()) for Rx, _ in cands])
    terr = torch.stack([angle_error_vec(tx, T.t.double()) for _, tx in cands])
    assert bool(((rerr < 0.02) & (terr < 0.02)).any(0).all())
    t_err, r_err = epipolar.relative_pose_error(T, T.R, -T.t * 3)
    jt_err, jr_err = jepi.relative_pose_error(jT, jT.R, -jT.t * 3)
    close(t_err, jt_err, rtol=0, atol=2e-2)  # fp32 arccos of cosines near 1
    close(r_err, jr_err, rtol=0, atol=2e-2)


def test_svd3x3_essential_projection_matches_jax():
    """U diag(s, s, 0) V^T, s the mean of the two largest singular values, of
    unit-norm full-rank and rank-2 matrices: within 1e-6 of the JAX
    projection, though the eigensolvers (float64 LAPACK, fp32 Jacobi) may
    choose other signs and bases."""
    rng = np.random.RandomState(10)
    A = rng.randn(64, 3, 3)
    u, s, vt = np.linalg.svd(A)
    s[32:, 2] = 0.0  # rank 2
    A = (u * s[:, None, :]) @ vt
    A = (A / np.linalg.norm(A, axis=(1, 2), keepdims=True)).astype(np.float32)

    def project(U, S, Vt):
        sig = (S[..., 0] + S[..., 1]) / 2
        return (U * np.stack([sig, sig, 0 * sig], -1)[..., None, :]) @ Vt

    U, S, Vt = (x.numpy() for x in svd3x3(torch.from_numpy(A)))
    jU, jS, jVt = (np.asarray(x) for x in j_svd3x3(jnp.asarray(A)))
    close(project(U, S, Vt), project(jU, jS, jVt), rtol=0, atol=1e-6)
    close((U * S[..., None, :]) @ Vt, A, rtol=0, atol=1e-6)
    close(U @ U.transpose(0, 2, 1), np.broadcast_to(np.eye(3), U.shape), rtol=0, atol=1e-6)


def _gt_data(depths, R, t, cam, lib):
    """The data dict of the ground-truth functions, in JAX or torch."""
    if lib == "jax":
        T = JPose.from_Rt(jnp.asarray(R), jnp.asarray(t))
        return {"view0": {"camera": cam, "depth": jnp.asarray(depths[0])},
                "view1": {"camera": cam, "depth": jnp.asarray(depths[1])},
                "T_0to1": T, "T_1to0": T.inv()}
    T = Pose.from_Rt(torch.from_numpy(R), torch.from_numpy(t))
    return {"view0": {"camera": cam, "depth": torch.from_numpy(depths[0])},
            "view1": {"camera": cam, "depth": torch.from_numpy(depths[1])},
            "T_0to1": T, "T_1to0": T.inv()}


@pytest.mark.parametrize("epi_th,cc_th", [(None, None), (5.0, None), (None, 4.0), (5.0, 4.0)])
def test_gt_matches_from_pose_depth_matches_jax(epi_th, cc_th):
    """Keypoints of view 1 are view 0's reprojected with 0.7 px noise (and
    the rest random), so there are positives, negatives and ignored ones."""
    depths, kps, R, t = _scene(11, n=96)
    jc, c = _cams()
    tdata, jdata = _gt_data(depths, R, t, c, "torch"), _gt_data(depths, R, t, jc, "jax")
    kp0 = torch.from_numpy(kps[0])
    z0, v0 = depth.sample_depth(kp0, tdata["view0"]["depth"])
    proj, vis = depth.project(kp0, z0, None, c, c, tdata["T_0to1"], v0)
    noise = torch.from_numpy(np.random.RandomState(12).randn(*kps[1].shape).astype(np.float32))
    kp1 = torch.where(vis[..., None] & (torch.arange(96) < 60)[None, :, None],
                      proj + 0.7 * noise, torch.from_numpy(kps[1]))
    valid0 = torch.arange(96)[None].expand(2, -1) < torch.tensor([[90], [96]])
    valid1 = torch.ones(2, 96, dtype=torch.bool)
    valid1[0, -5:] = False
    out = gt_generation.gt_matches_from_pose_depth(kp0, kp1, tdata, epi_th=epi_th, cc_th=cc_th,
                                                   valid0=valid0, valid1=valid1)
    ref = jgt.gt_matches_from_pose_depth(jnp.asarray(kps[0]), jnp.asarray(kp1.numpy()), jdata,
                                         epi_th=epi_th, cc_th=cc_th,
                                         valid0=jnp.asarray(valid0.numpy()),
                                         valid1=jnp.asarray(valid1.numpy()))
    for k in ("matches0", "matches1", "assignment", "visible0", "visible1", "reward",
              "matching_scores0"):
        assert np.array_equal(out[k].numpy(), np.asarray(ref[k])), k
    m0 = out["matches0"].numpy()
    assert (m0 >= 0).sum() > 20 and (m0 == -1).sum() > 5 and (m0 == -2).sum() > 5
    for k, v in (("proj_0to1", "visible0"), ("proj_1to0", "visible1")):
        close_px(out[k], ref[k], out[v], atol=1e-4)
    close(out["depth_keypoints0"], ref["depth_keypoints0"], rtol=1e-6, atol=1e-5)
    # precomputed keypoint depths (the feature-cache path) give the same labels
    kw = {"depth_keypoints0": out["depth_keypoints0"], "depth_keypoints1": out["depth_keypoints1"],
          "valid_depth_keypoints0": depth.sample_depth(kp0, tdata["view0"]["depth"])[1],
          "valid_depth_keypoints1": depth.sample_depth(kp1, tdata["view1"]["depth"])[1]}
    again = gt_generation.gt_matches_from_pose_depth(kp0, kp1, tdata, epi_th=epi_th, cc_th=cc_th,
                                                     valid0=valid0, valid1=valid1, **kw)
    assert torch.equal(again["matches0"], out["matches0"])
    with pytest.raises(NotImplementedError, match="Queue 1 items 3 and 5"):
        gt_generation.gt_line_matches_from_pose_depth(None, None, tdata)


def test_depth_matcher_matches_jax():
    depths, kps, R, t = _scene(13)
    jc, c = _cams()
    conf = {"th_positive": 3.0, "th_negative": 5.0, "th_epi": 5.0}
    tdata = {**_gt_data(depths, R, t, c, "torch"), "keypoints0": torch.from_numpy(kps[0]),
             "keypoints1": torch.from_numpy(kps[1])}
    jdata = {**_gt_data(depths, R, t, jc, "jax"), "keypoints0": jnp.asarray(kps[0]),
             "keypoints1": jnp.asarray(kps[1])}
    out = get_model("depth_matcher")(conf, device="cpu")(tdata)
    ref = JDepthMatcher.from_conf(conf)(jdata)
    assert set(out) == set(ref)
    for k in out:
        if out[k].dtype in (torch.bool, torch.int32):
            assert np.array_equal(out[k].numpy(), np.asarray(ref[k])), k
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        get_model("depth_matcher")({"use_lines": True}, device="cpu")
