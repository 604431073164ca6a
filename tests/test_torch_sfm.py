"""The port's SfM layer (gluefactory_tpu_torch/sfm, parallel/pair_matching)
on the CPU against the JAX package's gluefactory_tpu/sfm on the same inputs:
triangulation, the BA normal equations and Schur reduction, the LM step and
loop, the pose graph (its autodiff Jacobian too), the ATE metrics,
`Camera.from_params`, and the landmark-sharded BA step and pair matching on
two gloo ranks against one process.

Monocular BA leaves the scale about camera 0 free (the gauge prior clamps
camera 0's pose only), and the LM step solves along that direction with the
damping alone: in float32 a relative change of ~1e-7 in S (another
summation order) moves t by up to ~1e-2 and X by ~0.2 after a step, in
either package (JAX's float32 camera solve is ~1e-3 from the float64 solve
of its own system). So t and X are held at 1e-4 where they are determined:
in float64, raw, and in float32 after ten LM iterations, up to the
similarity the gauge leaves free. R and the cost are held in float32; the
accept/reject sequence until the cost converges (after that both loops
compare costs equal up to rounding), in float32 and, on a problem started
far off where steps are rejected, in float64.

The file is also the ranks' program (`python tests/test_torch_sfm.py RANK
WORLD PORT DIR`), which imports no JAX.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # run as the ranks' program
    sys.path.insert(0, str(ROOT))

from gluefactory_tpu_torch.geometry.wrappers import Camera  # noqa: E402
from gluefactory_tpu_torch.models import get_model  # noqa: E402
from gluefactory_tpu_torch.parallel.pair_matching import make_pair_matcher  # noqa: E402
from gluefactory_tpu_torch.sfm import ba, metrics, pose_graph, triangulation  # noqa: E402

NN_CONF = {"mutual_check": True}
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def to_torch(problem, dtype=torch.float32):
    """A JAX BAProblem (or numpy fields) as the port's, floats in `dtype`."""
    return ba.BAProblem(*(torch.tensor(np.asarray(x)).to(dtype) if np.asarray(x).dtype.kind == "f"
                          else torch.tensor(np.asarray(x)) for x in problem))


def to_jax(problem, jnp, dtype):
    return type(problem)(*(jnp.asarray(np.asarray(x), dtype) if np.asarray(x).dtype.kind == "f"
                           else jnp.asarray(np.asarray(x)) for x in problem))


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    import gluefactory_tpu.sfm.ba as jba
    import gluefactory_tpu.sfm.pose_graph as jpg
    from test_sfm import make_ba_problem

    class J:
        pass

    J.jax, J.jnp, J.ba, J.pg, J.make_ba_problem = jax, jnp, jba, jpg, make_ba_problem
    return J


@pytest.fixture(scope="module")
def problem(jx):
    return jx.make_ba_problem(np.random.RandomState(0), n_cams=6, n_pts=64, k_obs=4)[0]


# --------------------------------------------------------------- geometry
def test_camera_from_params_matches_jax():
    from gluefactory_tpu.geometry.wrappers import Camera as JaxCamera

    for args in ((400, 300, 400.0, 400.0, 200.0, 150.0, ()),
                 (480, 360, 420.0, 415.5, 240.25, 180.75, (0.1, -0.02))):
        ours, theirs = Camera.from_params(*args), JaxCamera.from_params(*args)
        assert ours._data.dtype == torch.float32
        np.testing.assert_array_equal(ours._data.numpy(), np.asarray(theirs._data))
        np.testing.assert_array_equal(ours.calibration_matrix().numpy(),
                                      np.asarray(theirs.calibration_matrix()))


def test_triangulation_against_jax(jx):
    from gluefactory_tpu.geometry.utils import so3exp_map
    from gluefactory_tpu.geometry.wrappers import Camera as JaxCamera
    from gluefactory_tpu.sfm.triangulation import reprojection_errors, triangulate_dlt

    rng = np.random.RandomState(0)
    S, K = 48, 4
    aa = rng.randn(S, K, 3).astype(np.float32) * 0.1
    R = np.array(so3exp_map(jx.jnp.asarray(aa)))
    t = (rng.randn(S, K, 3) * 0.5).astype(np.float32)
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (S, 3)).astype(np.float32)
    p_cam = np.einsum("skij,sj->ski", R, X) + t
    rays = (p_cam[..., :2] / p_cam[..., 2:] + rng.randn(S, K, 2) * 1e-3).astype(np.float32)
    valid = rng.rand(S, K) > 0.2
    valid[:, :2] = True
    ref = np.asarray(jx.jax.jit(triangulate_dlt)(*(jx.jnp.asarray(a) for a in (rays, R, t, valid))))
    out = triangulation.triangulate_dlt(*(torch.from_numpy(a) for a in (rays, R, t, valid)))
    assert rel(out, ref) < 1e-5

    cam_args = (640, 480, 500.0, 510.0, 320.0, 240.0)
    uv = (p_cam[:, 0, :2] / p_cam[:, 0, 2:] * 500 + 320 + rng.randn(S, 2)).astype(np.float32)
    jcam = JaxCamera.from_params(*cam_args)
    ref = np.asarray(jx.jax.jit(lambda *a: reprojection_errors(a[0], a[1], jcam, *a[2:]))(
        *(jx.jnp.asarray(a) for a in (X, uv, R[:, 0], t[:, 0]))))
    out = triangulation.reprojection_errors(torch.from_numpy(X), torch.from_numpy(uv),
                                            Camera.from_params(*cam_args),
                                            torch.from_numpy(R[:, 0]), torch.from_numpy(t[:, 0]))
    assert rel(out, ref) < 1e-5


# ---------------------------------------------------------------------- BA
@pytest.fixture(scope="module")
def reduced(jx, problem):
    lam = 1e-3
    r, J_cam, J_pt = jx.jax.jit(jx.ba.residuals_and_jacobians)(problem)
    S, rhs, *_ = jx.jax.jit(jx.ba._schur_reduce, static_argnums=4)(r, J_cam, J_pt,
                                                                   problem.cam_idx, 6, lam)
    tp = to_torch(problem)
    r2, J_cam2, J_pt2 = ba.residuals_and_jacobians(tp)
    S2, rhs2, *_ = ba._schur_reduce(r2, J_cam2, J_pt2, tp.cam_idx, 6, lam)
    return {"r": (r2, r), "J_cam": (J_cam2, J_cam), "J_pt": (J_pt2, J_pt), "S": (S2, S),
            "rhs": (rhs2, rhs)}


@pytest.mark.parametrize("name", ["r", "J_cam", "J_pt", "S", "rhs"])
def test_normal_equations_against_jax(reduced, name):
    ours, ref = reduced[name]
    assert ours.shape == ref.shape
    assert rel(ours.numpy(), ref) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gn_step_against_jax(jx, problem, dtype):
    with jx.jax.enable_x64(dtype == "float64"):
        jdt = getattr(jx.jnp, dtype)
        jp = to_jax(problem, jx.jnp, jdt)
        ref = jx.jax.jit(jx.ba.ba_gn_step)(jp, jx.jnp.asarray(1e-3, jdt))
        ref_cost = float(jx.jax.jit(jx.ba.ba_cost)(ref))
        ref = [np.asarray(a) for a in ref[:3]]
    out = ba.ba_gn_step(to_torch(problem, DTYPES[dtype]), torch.tensor(1e-3, dtype=DTYPES[dtype]))
    assert out.R.dtype == DTYPES[dtype]
    assert rel(out.R, ref[0]) < 1e-4
    if dtype == "float64":  # float32's t and X move along the free scale (module docstring)
        assert rel(out.t, ref[1]) < 1e-4 and rel(out.X, ref[2]) < 1e-4
        assert abs(float(ba.ba_cost(out)) - ref_cost) < 1e-4 * ref_cost


@pytest.fixture(scope="module")
def adjusted(jx, problem):
    """bundle_adjust over 10 iterations in both packages and dtypes."""
    runs = {}
    for dtype in DTYPES:
        with jx.jax.enable_x64(dtype == "float64"):
            jdt = getattr(jx.jnp, dtype)
            refined, cost, lam = jx.ba.bundle_adjust(to_jax(problem, jx.jnp, jdt), iterations=10)
            ref = ([np.asarray(a) for a in refined[:3]], float(cost))
        out, cost, lam = ba.bundle_adjust(to_torch(problem, DTYPES[dtype]), iterations=10)
        runs[dtype] = ([a.numpy() for a in out[:3]], float(cost)), ref
    return runs


def test_bundle_adjust_float32_against_jax(adjusted):
    (ours, cost), (ref, ref_cost) = adjusted["float32"]
    assert abs(cost - ref_cost) < 1e-4 * ref_cost, (cost, ref_cost)
    assert rel(ours[0], ref[0]) < 1e-4
    # t and X up to the similarity the monocular gauge leaves free
    c_ours, c_ref = metrics.camera_centers(ours[0], ours[1]), metrics.camera_centers(ref[0], ref[1])
    pts, pts_ref = np.concatenate([ours[2], c_ours]), np.concatenate([ref[2], c_ref])
    s, R, t = metrics.umeyama_alignment(pts.astype(np.float64), pts_ref.astype(np.float64))
    aligned = (s * (R @ pts.T)).T + t
    assert rel(aligned, pts_ref) < 1e-4, s


def test_bundle_adjust_float64_against_jax(adjusted):
    (ours, cost), (ref, ref_cost) = adjusted["float64"]
    assert abs(cost - ref_cost) < 1e-4 * ref_cost
    for a, b in zip(ours, ref):
        assert rel(a, b) < 1e-4


@pytest.mark.parametrize("dtype,perturb,converged", [
    ("float32", {}, 1e-5), ("float64", {"perturb_cam": 0.2, "perturb_pt": 1.0}, 1e-9)])
def test_bundle_adjust_accepts_as_jax(jx, dtype, perturb, converged):
    """bundle_adjust's accept/reject decisions (read from its lambda after
    1..10 iterations) against JAX's (bundle_adjust's body in a Python loop
    of its jitted step and cost), at every iteration before the cost
    converges: once a step changes the cost by less than `converged`
    relative (10x the rounding of the cost's sum in float32), both loops
    compare costs equal up to rounding, and either decision is right. In
    float64 on a problem started far off (perturbed 0.2 rad / 1 unit), where
    steps overshoot and are rejected."""
    problem = jx.make_ba_problem(np.random.RandomState(0), n_cams=6, n_pts=64, k_obs=4,
                                 **perturb)[0]
    with jx.jax.enable_x64(dtype == "float64"):
        jnp = jx.jnp
        step, cost_fn = jx.jax.jit(jx.ba.ba_gn_step), jx.jax.jit(jx.ba.ba_cost)
        prob, lam = to_jax(problem, jnp, getattr(jnp, dtype)), jnp.asarray(1e-3)
        cost, theirs, changes = cost_fn(prob), [], []
        for _ in range(10):
            new = step(prob, lam)
            new_cost = cost_fn(new)
            accept = bool(new_cost < cost)
            theirs.append(accept)
            changes.append(abs(float(new_cost) - float(cost)) / float(cost))
            if accept:
                prob, cost = new, new_cost
            lam = jnp.clip(lam * (0.5 if accept else 4.0), 1e-8, 1e4)
    tp = to_torch(problem, DTYPES[dtype])
    lams = [1e-3] + [float(ba.bundle_adjust(tp, iterations=k)[2]) for k in range(1, 11)]
    ours = [b < a for a, b in zip(lams, lams[1:])]
    n = next((i for i, c in enumerate(changes) if not c > converged), 10)
    assert n >= 3, changes
    assert ours[:n] == theirs[:n], (ours, theirs, changes)
    if dtype == "float64":
        assert not all(theirs[:n]), (theirs, changes)


HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__", "__index__")


def forbid_host_reads(monkeypatch):
    """Every Tensor method that copies a value to the host raises."""
    def forbid(name):
        def read(*args, **kwargs):
            raise AssertionError(f"host read: Tensor.{name}")
        return read

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, forbid(name))


def test_lm_loops_make_no_host_read(problem, monkeypatch):
    tp, graph = to_torch(problem), loop_graph(np.random.RandomState(0))[0]
    forbid_host_reads(monkeypatch)
    out, cost, lam = ba.bundle_adjust(tp, iterations=10)
    graph, pg = pose_graph.optimize_pose_graph(graph, iterations=10)
    with pytest.raises(AssertionError, match="host read"):
        bool(cost < 1)
    assert isinstance(cost, torch.Tensor) and isinstance(pg, torch.Tensor)


# --------------------------------------------------------------- pose graph
def loop_graph(rng, jnp=None):
    """The graph of tests/test_sfm.py::TestPoseGraph::test_optimization_closes_loop
    (8 cameras on a circle, odometry plus the closure, drifted init), as the
    port's PoseGraph (and the JAX one when `jnp` is given); the ground
    truth."""
    from gluefactory_tpu_torch.geometry.utils import so3exp_map

    def exp(aa):
        return so3exp_map(torch.tensor(np.asarray(aa, np.float32))).numpy()

    n = 8
    R_gt = np.stack([exp([0, 2 * np.pi * i / n, 0]) for i in range(n)])
    t_gt = np.stack([np.array([np.cos(2 * np.pi * i / n), 0, np.sin(2 * np.pi * i / n)],
                              np.float32) for i in range(n)])
    edges, R_ij, t_ij = [], [], []
    for i in range(n):
        j = (i + 1) % n
        R_ij.append(R_gt[j] @ R_gt[i].T)
        t_ij.append(t_gt[j] - R_ij[-1] @ t_gt[i])
        edges.append((i, j))
    R0, t0 = [R_gt[0]], [t_gt[0]]
    for i in range(1, n):
        R0.append(exp(rng.randn(3) * 0.03) @ R_gt[i])
        t0.append(t_gt[i] + rng.randn(3) * 0.05)
    fields = (np.stack(R0).astype(np.float32), np.stack(t0).astype(np.float32),
              np.asarray(edges, np.int32), np.stack(R_ij).astype(np.float32),
              np.stack(t_ij).astype(np.float32), np.ones(len(edges), np.float32))
    graph = pose_graph.PoseGraph(*(torch.from_numpy(f) for f in fields))
    if jnp is None:
        return graph, (R_gt, t_gt)
    from gluefactory_tpu.sfm.pose_graph import PoseGraph as JaxPoseGraph

    return graph, JaxPoseGraph(*(jnp.asarray(f) for f in fields)), (R_gt, t_gt)


@pytest.fixture(scope="module")
def graphs(jx):
    return loop_graph(np.random.RandomState(0), jx.jnp)


def test_so3_log_against_jax(jx):
    from gluefactory_tpu.geometry.utils import so3exp_map

    rng = np.random.RandomState(0)
    aa = np.concatenate([rng.randn(16, 3) * 0.5, rng.randn(4, 3) * 1e-4,
                         rng.randn(4, 3) / np.sqrt(3) * 3.0, np.zeros((1, 3))]).astype(np.float32)
    R = np.array(so3exp_map(jx.jnp.asarray(aa)))
    R[-1] = np.eye(3, dtype=np.float32)  # trace 3: the clip and the small-angle branch
    ref = np.asarray(jx.jax.jit(jx.pg.so3_log)(jx.jnp.asarray(R)))
    out = pose_graph.so3_log(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_edge_residuals_and_cost_against_jax(jx, graphs):
    graph, jgraph, _ = graphs
    res, cost = jx.jax.jit(lambda g: (jx.pg.edge_residuals(g), jx.pg.pg_cost(g)))(jgraph)
    assert rel(pose_graph.edge_residuals(graph), res) < 1e-5
    assert abs(float(pose_graph.pg_cost(graph)) - float(cost)) < 1e-5 * float(cost)


def test_pg_jacobian_and_step_against_jax(jx, graphs):
    """The Jacobian of the residual with respect to the 6N deltas (the one
    `_pg_step` takes) against jax.jacfwd of the JAX expression, at zero and
    at a delta off it; then one step."""
    from gluefactory_tpu.geometry.utils import so3exp_map

    graph, jgraph, _ = graphs
    jnp = jx.jnp
    N = graph.R.shape[0]

    def jax_residual(deltas):
        R = jnp.einsum("nij,njk->nik", so3exp_map(deltas[:, :3]), jgraph.R, precision="highest")
        return jx.pg.edge_residuals(jgraph._replace(R=R, t=jgraph.t + deltas[:, 3:])).reshape(-1)

    jac = jx.jax.jit(lambda d: (jax_residual(d), jx.jax.jacfwd(jax_residual)(d)))
    for d in (np.zeros((N, 6), np.float32),
              (np.random.RandomState(1).randn(N, 6) * 0.01).astype(np.float32)):
        ref_r, ref = (np.asarray(a) for a in jac(jnp.asarray(d)))
        ref = ref.reshape(-1, N * 6)
        r0, J = pose_graph._pg_jacobian(graph, torch.from_numpy(d))
        assert J.shape == ref.shape
        assert float((J - torch.from_numpy(ref)).abs().max()) < 1e-5 * np.abs(ref).max()
        assert rel(r0, ref_r) < 1e-5
    ref = jx.jax.jit(jx.pg._pg_step)(jgraph, jnp.asarray(1e-4))
    out = pose_graph._pg_step(graph, torch.tensor(1e-4))
    assert rel(out.R, ref.R) < 1e-4 and rel(out.t, ref.t) < 1e-4


def test_optimize_pose_graph_against_jax(jx, graphs):
    graph, jgraph, (R_gt, t_gt) = graphs
    cost0 = float(pose_graph.pg_cost(graph))
    ref, ref_cost = jx.pg.optimize_pose_graph(jgraph, iterations=10)
    out, cost = pose_graph.optimize_pose_graph(graph, iterations=10)
    assert abs(float(cost) - float(ref_cost)) <= 1e-4 * float(ref_cost) + 1e-9
    assert rel(out.R, ref.R) < 1e-4 and rel(out.t, ref.t) < 1e-4
    # the JAX test's bars
    assert float(cost) < cost0 * 0.05
    ate = metrics.absolute_trajectory_error(
        metrics.camera_centers(out.R.numpy(), out.t.numpy()), metrics.camera_centers(R_gt, t_gt))
    assert ate["ate_rmse"] < 0.05, ate


# ------------------------------------------------------------------ metrics
def test_metrics_against_jax():
    from gluefactory_tpu.sfm import metrics as jm

    rng = np.random.RandomState(0)
    src = rng.randn(30, 3)
    R = np.linalg.qr(rng.randn(3, 3))[0]
    R *= np.sign(np.linalg.det(R))
    dst = 1.7 * src @ R.T + np.array([1.0, -2.0, 0.5]) + rng.randn(30, 3) * 0.01
    for a, b in zip(metrics.umeyama_alignment(src, dst), jm.umeyama_alignment(src, dst)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    for align in (True, False):
        ours = metrics.absolute_trajectory_error(src, dst, align=align)
        theirs = jm.absolute_trajectory_error(src, dst, align=align)
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert abs(ours[k] - theirs[k]) < 1e-10
    Rs, ts = np.stack([R, R.T]), rng.randn(2, 3)
    np.testing.assert_allclose(metrics.camera_centers(Rs, ts), jm.camera_centers(Rs, ts),
                               rtol=0, atol=1e-10)


# ------------------------------------------------------- two gloo ranks
def pair_batch(rng, pairs=8, n=96, d=32):
    """Descriptor pairs sharing most points (so that the NN matches), with
    padded keypoints."""
    desc = rng.randn(pairs, n, d).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    perm = np.stack([rng.permutation(n) for _ in range(pairs)])
    desc1 = np.take_along_axis(desc, perm[..., None], 1) + rng.randn(pairs, n, d) * 0.05
    desc1 = (desc1 / np.linalg.norm(desc1, axis=-1, keepdims=True)).astype(np.float32)
    return {"descriptors0": desc, "descriptors1": desc1,
            "keypoints0": rng.rand(pairs, n, 2).astype(np.float32) * 100,
            "keypoints1": rng.rand(pairs, n, 2).astype(np.float32) * 100,
            "keypoint_mask0": rng.rand(pairs, n) > 0.1, "keypoint_mask1": rng.rand(pairs, n) > 0.1}


def rank_program(rank: int, world: int, out: Path) -> None:
    """One rank: its landmark shard's distributed BA step in both dtypes and
    its share of the pair batch through match_pairs."""
    inputs = dict(np.load(out / "inputs.npz"))
    P = inputs["X"].shape[0]
    sl = slice(rank * P // world, (rank + 1) * P // world)
    res = {}
    for name, dt in DTYPES.items():
        f = {k: torch.from_numpy(inputs[k]).to(dt) if inputs[k].dtype.kind == "f"
             else torch.from_numpy(inputs[k]) for k in ba.BAProblem._fields}
        R, t, X = ba.distributed_ba_step(f["R"], f["t"], f["X"][sl], f["cam_idx"][sl],
                                         f["uv"][sl], f["valid"][sl], f["K_mat"],
                                         torch.tensor(1e-3, dtype=dt))
        res.update({f"{name}_R": R.numpy(), f"{name}_t": t.numpy(), f"{name}_X": X.numpy()})
    match_pairs = make_pair_matcher(get_model("nearest_neighbor_matcher")(NN_CONF, device="cpu"))
    pred = match_pairs({k[5:]: torch.from_numpy(v) for k, v in inputs.items()
                        if k.startswith("pair_")})
    res.update(matches0=pred["matches0"].numpy(), scores0=pred["matching_scores0"].numpy())
    np.savez(out / f"rank{rank}.npz", **res)


@pytest.fixture(scope="module")
def two_ranks(problem, tmp_path_factory):
    out = tmp_path_factory.mktemp("sfm_ranks")
    batch = pair_batch(np.random.RandomState(0))
    np.savez(out / "inputs.npz", **{k: np.asarray(v) for k, v in problem._asdict().items()},
             **{f"pair_{k}": v for k, v in batch.items()})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(port), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)], batch


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_distributed_ba_step_matches_one_process(problem, two_ranks, dtype):
    ranks, _ = two_ranks
    ref = ba.ba_gn_step(to_torch(problem, DTYPES[dtype]), torch.tensor(1e-3, dtype=DTYPES[dtype]))
    for r in ranks:  # the cameras are replicated
        np.testing.assert_array_equal(r[f"{dtype}_R"], ranks[0][f"{dtype}_R"])
        np.testing.assert_array_equal(r[f"{dtype}_t"], ranks[0][f"{dtype}_t"])
    X = np.concatenate([r[f"{dtype}_X"] for r in ranks])
    assert rel(ranks[0][f"{dtype}_R"], ref.R) < 1e-5
    if dtype == "float64":
        assert rel(ranks[0][f"{dtype}_t"], ref.t) < 1e-5 and rel(X, ref.X) < 1e-5
    else:  # the halves' sum moves float32's t and X along the free scale; the JAX test's bars
        np.testing.assert_allclose(ranks[0][f"{dtype}_t"], ref.t.numpy(), atol=1e-3)
        np.testing.assert_allclose(X, ref.X.numpy(), rtol=2e-3, atol=2e-3)


def test_pair_matching_across_ranks_and_batched(two_ranks):
    ranks, batch = two_ranks
    model = get_model("nearest_neighbor_matcher")(NN_CONF, device="cpu")
    full = make_pair_matcher(model)({k: torch.from_numpy(v) for k, v in batch.items()})
    single = [model({k: torch.from_numpy(v[i:i + 1]) for k, v in batch.items()})
              for i in range(8)]
    m_single = torch.cat([s["matches0"] for s in single]).numpy()
    np.testing.assert_array_equal(full["matches0"].numpy(), m_single)
    assert (m_single >= 0).mean() > 0.5
    for r in ranks:
        np.testing.assert_array_equal(r["matches0"], m_single)
        np.testing.assert_array_equal(r["scores0"], full["matching_scores0"].numpy())


if __name__ == "__main__":
    from gluefactory_tpu_torch.train import distributed

    rank_, world_, port_, out_ = sys.argv[1:5]
    torch.set_num_threads(1)
    os.environ.update(RANK=rank_, WORLD_SIZE=world_, LOCAL_RANK=rank_,
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port_)
    distributed.init_distributed("gloo", "cpu")
    try:
        rank_program(int(rank_), int(world_), Path(out_))
    finally:
        torch.distributed.destroy_process_group()
