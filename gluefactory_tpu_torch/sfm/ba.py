"""Batched bundle adjustment with a landmark Schur complement (counterpart of
gluefactory_tpu/sfm/ba.py).

  - Fixed-shape tracks: every landmark carries up to K observations (camera
    index, pixel, validity), so the normal equations are dense batched
    products over (P, K) with scatter-adds into camera blocks.
  - The landmarks are marginalised landmark by landmark (their 3x3 blocks
    inverted in a batch); the reduced camera system S (6C x 6C, C cameras
    in the window, typically <= 64) is accumulated by scatter-adds in a
    fixed order (a run repeats itself bit for bit) and solved densely by
    Cholesky. The cross terms of a landmark's camera pairs are one
    (P, K, K, 6, 6) tensor, written once and scattered once.
  - Across processes, each rank reduces its landmark shard and the ranks
    all-reduce S and its right-hand side (`distributed_ba_step`); the
    camera solve is replicated, the back-substitution stays local.
  - Levenberg-Marquardt with multiplicative damping and accept/reject by
    `torch.where` on device tensors, a fixed number of iterations:
    `bundle_adjust` reads nothing back to the host before it returns.

Everything runs in float32 (or the problem's dtype) with fp32 products:
TF32 would move the cameras by ~1e-3 relative. Gauge: camera 0 is clamped
by a large diagonal prior (a soft gauge fix).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.utils import skew_symmetric, so3exp_map
from ..models.utils.layers import no_tf32


class BAProblem(NamedTuple):
    R: torch.Tensor  # (C, 3, 3) world->cam
    t: torch.Tensor  # (C, 3)
    X: torch.Tensor  # (P, 3) world points
    cam_idx: torch.Tensor  # (P, K) integer
    uv: torch.Tensor  # (P, K, 2) pixel observations
    valid: torch.Tensor  # (P, K) bool
    K_mat: torch.Tensor  # (3, 3) shared intrinsics


def _project(K_mat, p_cam):
    """Pinhole projection of (..., 3) camera points -> (..., 2) pixels and
    the clamped depth."""
    z = p_cam[..., 2].clamp(min=1e-6)
    x = p_cam[..., 0] / z
    y = p_cam[..., 1] / z
    fx, fy, cx, cy = K_mat[0, 0], K_mat[1, 1], K_mat[0, 2], K_mat[1, 2]
    return torch.stack([fx * x + cx, fy * y + cy], -1), z


def residuals_and_jacobians(problem: BAProblem):
    """Per-observation residuals (P, K, 2) and Jacobians with respect to the
    camera deltas (P, K, 2, 6: [omega, tau], left-multiplicative) and the
    landmarks (P, K, 2, 3); invalid observations are zero."""
    with no_tf32():
        idx = problem.cam_idx.long()
        R = problem.R[idx]  # (P, K, 3, 3)
        RX = torch.einsum("pkij,pj->pki", R, problem.X)
        p_cam = RX + problem.t[idx]
        proj, z = _project(problem.K_mat, p_cam)
        r = proj - problem.uv

        fx, fy = problem.K_mat[0, 0], problem.K_mat[1, 1]
        x, y = p_cam[..., 0], p_cam[..., 1]
        inv_z = 1.0 / z
        zero = torch.zeros_like(z)
        J_proj = torch.stack([
            torch.stack([fx * inv_z, zero, -fx * x * inv_z**2], -1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z**2], -1),
        ], -2)  # (P, K, 2, 3) d proj / d p_cam
        # p_cam' = exp(w) R X + t + tau => d/dw = -[RX]x, d/dtau = I
        J_w = -torch.einsum("pkab,pkbc->pkac", J_proj, skew_symmetric(RX))
        J_cam = torch.cat([J_w, J_proj], -1)  # (P, K, 2, 6)
        J_pt = torch.einsum("pkab,pkbc->pkac", J_proj, R)  # (P, K, 2, 3)

    w = problem.valid.to(r.dtype)[..., None]
    return r * w, J_cam * w[..., None], J_pt * w[..., None]


def _schur_reduce(r, J_cam, J_pt, cam_idx, n_cams: int, lm_lambda):
    """The landmark-marginalised camera system of a (shard of the) problem.

    Returns S (C, C, 6, 6), rhs (C, 6), V_inv (P, 3, 3), b_p (P, 3) and
    W (P, K, 6, 3). Everything but the scatter targets is landmark-local:
    the ranks of `distributed_ba_step` sum S and rhs afterwards."""
    dt, dev = r.dtype, r.device
    P, K = cam_idx.shape
    C = n_cams
    idx = cam_idx.reshape(-1).long()
    with no_tf32():
        # landmark blocks
        V = torch.einsum("pkai,pkaj->pij", J_pt, J_pt)
        V = V + lm_lambda * torch.eye(3, dtype=dt, device=dev)
        V_inv = torch.linalg.inv_ex(V)[0]
        b_p = -torch.einsum("pkai,pka->pi", J_pt, r)

        # camera blocks
        U_obs = torch.einsum("pkai,pkaj->pkij", J_cam, J_cam)
        b_obs = -torch.einsum("pkai,pka->pki", J_cam, r)
        W = torch.einsum("pkai,pkaj->pkij", J_cam, J_pt)  # (P, K, 6, 3)
        U = _scatter_sum(C, idx, U_obs.reshape(-1, 6, 6))
        b_c = _scatter_sum(C, idx, b_obs.reshape(-1, 6))

        # Schur cross terms of every (k, k') camera pair of a landmark, built
        # in place over the three landmark coordinates (no broadcast copies)
        WVi = torch.einsum("pkij,pjl->pkil", W, V_inv)  # (P, K, 6, 3)
        cross = torch.mul(WVi[:, :, None, :, None, 0], W[:, None, :, None, :, 0])
        for l in (1, 2):
            cross.addcmul_(WVi[:, :, None, :, None, l], W[:, None, :, None, :, l])
        pair = (cam_idx[:, :, None].long() * C + cam_idx[:, None, :].long()).reshape(-1)
        S = -_scatter_sum(C * C, pair, cross.view(-1, 6, 6)).view(C, C, 6, 6)
        del cross
        diag = torch.arange(C, device=dev)
        S[diag, diag] += U

        rhs = b_c + _scatter_sum(C, idx, -torch.einsum("pkil,pl->pki", WVi, b_p).reshape(-1, 6))
    return S, rhs, V_inv, b_p, W


def _scatter_sum(n: int, idx, values):
    """The rows of `values` summed by `idx` into n rows, in an order that does
    not change from run to run: `index_put_` accumulates by sorted index on
    CUDA, where `index_add_` adds by atomics."""
    return values.new_zeros((n,) + values.shape[1:]).index_put_((idx,), values, accumulate=True)


def _solve_cameras(S, rhs, cam_lambda, gauge_weight: float = 1e9):
    """The camera deltas (C, 6) of the damped system, camera 0 clamped;
    Cholesky without a host read of its status."""
    C = S.shape[0]
    dt, dev = S.dtype, S.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = torch.arange(C, device=dev)
    S = S.clone()
    S[diag, diag] += cam_lambda * eye6
    S[0, 0] += gauge_weight * eye6  # clamp camera 0
    S_dense = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    S_dense = S_dense + 1e-9 * torch.eye(C * 6, dtype=dt, device=dev)
    return cholesky_solve(S_dense, rhs.reshape(-1, 1)).reshape(C, 6)


def cholesky_solve(A, b):
    """A^-1 b for a symmetric positive-definite A by its Cholesky factor and
    two triangular solves, with no host read (`torch.linalg.cholesky`
    would read the factorisation's status to raise)."""
    with no_tf32():
        L = torch.linalg.cholesky_ex(A)[0]
        y = torch.linalg.solve_triangular(L, b, upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _back_substitute(W, V_inv, b_p, d_cam, cam_idx):
    """The landmark deltas dX = V^-1 (b_p - sum_k W^T d_cam[c_k])."""
    with no_tf32():
        Wt_dc = torch.einsum("pkij,pki->pkj", W, d_cam[cam_idx.long()]).sum(1)
        return torch.einsum("pij,pj->pi", V_inv, b_p - Wt_dc)


def _apply_deltas(problem: BAProblem, d_cam, d_pts):
    with no_tf32():
        R_new = torch.einsum("cij,cjk->cik", so3exp_map(d_cam[:, :3]), problem.R)
    return problem._replace(R=R_new, t=problem.t + d_cam[:, 3:], X=problem.X + d_pts)


def ba_cost(problem: BAProblem) -> torch.Tensor:
    r, _, _ = residuals_and_jacobians(problem)
    return 0.5 * torch.sum(r**2)


def ba_gn_step(problem: BAProblem, lm_lambda) -> BAProblem:
    """One damped Gauss-Newton (LM) step; returns the updated problem."""
    r, J_cam, J_pt = residuals_and_jacobians(problem)
    S, rhs, V_inv, b_p, W = _schur_reduce(r, J_cam, J_pt, problem.cam_idx, problem.R.shape[0],
                                          lm_lambda)
    del r, J_cam, J_pt
    d_cam = _solve_cameras(S, rhs, lm_lambda)
    return _apply_deltas(problem, d_cam, _back_substitute(W, V_inv, b_p, d_cam, problem.cam_idx))


@torch.no_grad()
def bundle_adjust(problem: BAProblem, iterations: int = 10, init_lambda: float = 1e-3):
    """`iterations` LM steps with accept/reject on the device: a step is
    kept when it lowers the cost, and lambda halves (kept) or quadruples
    (rejected) within [1e-8, 1e4]. No host read before it returns.

    Returns (problem, final cost, lambda) as 0-d tensors."""
    lam = torch.full((), init_lambda, dtype=problem.R.dtype, device=problem.R.device)
    cost = ba_cost(problem)
    for _ in range(iterations):
        new = ba_gn_step(problem, lam)
        new_cost = ba_cost(new)
        accept = new_cost < cost
        problem = problem._replace(R=torch.where(accept, new.R, problem.R),
                                   t=torch.where(accept, new.t, problem.t),
                                   X=torch.where(accept, new.X, problem.X))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-8, 1e4)
    return problem, cost, lam


@torch.no_grad()
def distributed_ba_step(R, t, X, cam_idx, uv, valid, K_mat, lm_lambda):
    """One LM step with the landmarks sharded over the ranks of
    `torch.distributed` (counterpart of `make_distributed_ba_step`): each rank
    passes its landmark shard (X, cam_idx, uv, valid) and the replicated
    cameras, reduces its shard's Schur system, all-reduces S and rhs (the
    camera Hessian reduction), solves the replicated camera system and
    back-substitutes its own landmarks. Returns (R, t, its X shard)."""
    import torch.distributed as dist

    problem = BAProblem(R, t, X, cam_idx, uv, valid, K_mat)
    r, J_cam, J_pt = residuals_and_jacobians(problem)
    S, rhs, V_inv, b_p, W = _schur_reduce(r, J_cam, J_pt, cam_idx, R.shape[0], lm_lambda)
    dist.all_reduce(S)
    dist.all_reduce(rhs)
    d_cam = _solve_cameras(S, rhs, lm_lambda)
    new = _apply_deltas(problem, d_cam, _back_substitute(W, V_inv, b_p, d_cam, cam_idx))
    return new.R, new.t, new.X


__all__ = [
    "BAProblem", "bundle_adjust", "ba_gn_step", "ba_cost", "residuals_and_jacobians",
    "distributed_ba_step",
]
