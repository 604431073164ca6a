"""Batched RANSAC for homographies and relative poses, on tensors on the
device (counterpart of gluefactory_tpu/estimators/ransac.py:33-389).

Homographies:
A fixed budget of K minimal samples is drawn with the Gumbel-top-k trick,
all K 4-point DLTs are solved in one batch and scored by their MSAC score
over all N correspondences; the top 4 at each of three selection scales are
refined together by annealed IRLS (threshold multipliers 4, 2, 1, 1, 1),
then one guided round re-draws K samples weighted by the soft inliers of the
best model so far. The best refined candidate wins; success needs 4 inliers.
A threshold sweep runs as one batch: the JAX package's evaluation calls its
estimator once a threshold with the same key, so every threshold sees the
same draws, and here they share one call (one sixth of the launches of six).

`ransac_homography_core` takes the Gumbel noise of each round as inputs, (K,
N) each, so the same noise can be fed to the JAX package and to the port on
either device. `ransac_homography` draws it from a `torch.Generator`. No
function here reads the device on the host (the eigensolver's status check
aside, ops/linalg.py).

Relative poses (`ransac_relative_pose_core`, on normalised image
coordinates, thresholds on the Sampson distance in those units): the same
scheme with Hartley-conditioned 8-point minimal solves projected onto the
essential manifold (`svd3x3`), linear soft inliers max(0, 1 - d / th^2),
selection scales 1, 4 and 16, annealing multipliers 16, 8, 4, 2, 1, ...,
and the guided round weighted at 4 th^2; the best model is decomposed into
the (R, t) with the most points in front of both cameras, and success needs
8 inliers. The sweep shares the uniform round's solves and scores; a call
makes two float64 `eigh` calls (9 x 9 and 3 x 3) a solve step.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..geometry.epipolar import decompose_essential_matrix
from ..geometry.homography import solve_homography_dlt, sym_homography_error
from ..geometry.utils import hartley_matrix, hartley_normalize, to_homogeneous
from ..ops.linalg import smallest_eigenvector, svd3x3


class RansacResult(NamedTuple):
    model: torch.Tensor  # (3, 3) H
    inliers: torch.Tensor  # (N,) bool
    score: torch.Tensor  # inlier count
    success: torch.Tensor  # bool


def gumbel(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of the last axis, ties to the lower
    index (the order of `jax.lax.top_k`)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def sample_minimal_indices(noise: torch.Tensor, valid: torch.Tensor, sample_size: int):
    """(K, S) index sets of S distinct valid correspondences: the top S of the
    (K, N) Gumbel noise over the valid entries."""
    scores = noise + torch.where(valid, 0.0, -1e9)[None, :]
    return torch.topk(scores, sample_size, dim=-1)[1]


def sample_weighted_indices(noise: torch.Tensor, logw: torch.Tensor, m: int):
    """(..., K, m) index sets drawn with probability proportional to
    exp(logw), logw (..., N) and noise (K, N)."""
    return torch.topk(logw.unsqueeze(-2) + noise, m, dim=-1)[1]


def homography_residuals(kpts0, kpts1, H) -> torch.Tensor:
    """`sym_homography_error` with non-finite errors (a singular model) as 1e9."""
    err = sym_homography_error(kpts0, kpts1, H)
    return torch.where(torch.isfinite(err), err, 1e9)


def _soft_inliers(err, th, valid_f):
    """MSAC weights max(0, 1 - (e / th)^2) over the valid entries."""
    return (1.0 - (err / th) ** 2).clamp(min=0.0) * valid_f


def _msac_score(err, th, valid_f):
    """Truncated-quadratic (MSAC) score: the sum of the soft inlier weights."""
    return _soft_inliers(err, th, valid_f).sum(-1)


def ransac_homography_core(
    kpts0: torch.Tensor,
    kpts1: torch.Tensor,
    valid: torch.Tensor,
    noise: Sequence[torch.Tensor],
    th: float | Sequence[float] = 3.0,
    refine_iters: int = 3,
) -> RansacResult:
    """One pair: kpts (N, 2), valid (N,) bool, and the (K, N) Gumbel noise of
    the uniform round followed by one (K, N) array a guided round.

    `th` is a threshold, or a sequence of T thresholds: the sweep then runs
    as one batch over T on the same draws, each threshold's result that of a
    call with it alone, and every output gains a leading T axis."""
    sweep = not isinstance(th, (int, float))
    dev = kpts0.device
    ths = torch.as_tensor(list(th) if sweep else [th], dtype=kpts0.dtype, device=dev)
    nt, n = ths.shape[0], kpts0.shape[0]
    tk, tkn = ths[:, None], ths[:, None, None]  # against (T, K) and (T, K, N)
    rows = torch.arange(nt, device=dev)
    valid_f = valid.to(kpts0.dtype)
    multipliers = [4.0, 2.0] + [1.0] * max(refine_iters, 2)
    k0, k1 = kpts0[None, None], kpts1[None, None]

    def candidates_from(idx):
        """The refined top candidates (T, 12, 3, 3) of the minimal samples
        idx, (K, 4) shared by the thresholds or (T, K, 4)."""
        Hs = solve_homography_dlt(kpts0[idx], kpts1[idx])
        Hs = Hs if Hs.ndim == 4 else Hs[None]  # (1 or T, K, 3, 3)
        errs = homography_residuals(k0, k1, Hs)
        cand = torch.cat([top_k(_msac_score(errs, tkn * mult, valid_f), 4)
                          for mult in (1.0, 2.0, 4.0)], -1)  # (T, 12)
        H = Hs.expand(nt, -1, -1, -1)[rows[:, None], cand]
        err = errs.expand(nt, -1, -1)[rows[:, None], cand]
        c = H.shape[1]
        for mult in multipliers:
            t = tkn * mult
            w = _soft_inliers(err, t, valid_f)
            H_new = solve_homography_dlt(k0.expand(nt, c, n, 2), k1.expand(nt, c, n, 2), w)
            err_new = homography_residuals(k0, k1, H_new)
            ok = (_msac_score(err_new, t, valid_f) >= w.sum(-1)) & \
                torch.isfinite(H_new).flatten(-2).all(-1)
            # the residuals of the kept model are carried, not recomputed
            H = torch.where(ok[..., None, None], H_new, H)
            err = torch.where(ok[..., None], err_new, err)
        return H

    H_all = candidates_from(sample_minimal_indices(noise[0], valid, 4))
    for g in noise[1:]:
        errs_all = homography_residuals(k0, k1, H_all)
        err_best = errs_all[rows, torch.argmax(_msac_score(errs_all, tkn, valid_f), -1)]
        # soft inlier log-weights at a relaxed threshold; the floor keeps the
        # distribution proper when the first round found nothing
        logw = torch.log(_soft_inliers(err_best, 2.0 * tk, valid_f) + 1e-4) + \
            torch.where(valid, 0.0, -1e9)
        H_all = torch.cat([H_all, candidates_from(sample_weighted_indices(g, logw, 4))], 1)

    final_errs = homography_residuals(k0, k1, H_all)
    best = torch.argmax(_msac_score(final_errs, tkn, valid_f), -1)
    inliers = (final_errs[rows, best] < tk) & valid
    count = inliers.sum(-1)
    out = RansacResult(H_all[rows, best], inliers, count.to(kpts0.dtype), count >= 4)
    return out if sweep else RansacResult(*(x[0] for x in out))


def ransac_homography(
    kpts0: torch.Tensor,
    kpts1: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator | None = None,
    th: float | Sequence[float] = 3.0,
    num_hypotheses: int = 1024,
    refine_iters: int = 3,
    guided_rounds: int = 1,
) -> RansacResult:
    """One pair on the device of `kpts0`, at a threshold or a sweep of them
    (see `ransac_homography_core`); the noise comes from `generator` (on that
    device), one (K, N) draw a round."""
    shape = (num_hypotheses, kpts0.shape[0])
    noise = [gumbel(shape, generator, kpts0.device) for _ in range(1 + guided_rounds)]
    return ransac_homography_core(kpts0, kpts1, valid, noise, th, refine_iters)


# --------------------------------------------------------------------------
# essential matrix / relative pose
# --------------------------------------------------------------------------


class RelPoseResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    E: torch.Tensor  # (3, 3)
    inliers: torch.Tensor  # (N,) bool
    score: torch.Tensor  # inlier count
    success: torch.Tensor  # bool


def _eight_point(p0n, p1n, weights=None):
    """(Weighted) 8-point essential matrices of (..., N, 2) normalised
    points: the Hartley-conditioned null vector of the epipolar system,
    denormalised and projected onto the essential manifold U diag(s, s, 0)
    V^T, s the mean of the two largest singular values. (..., 3, 3)."""
    p0c, s0, m0 = hartley_normalize(p0n, weights)
    p1c, s1, m1 = hartley_normalize(p1n, weights)
    T0, T1 = hartley_matrix(s0, m0), hartley_matrix(s1, m1)
    x0, y0, x1, y1 = p0c[..., 0], p0c[..., 1], p1c[..., 0], p1c[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)],
                    -1)
    if weights is not None:
        A = A * weights[..., None]
    F = smallest_eigenvector(A.transpose(-1, -2) @ A).unflatten(-1, (3, 3))
    E = T1.transpose(-1, -2) @ F @ T0
    U, s, Vt = svd3x3(E)
    sigma = (s[..., 0] + s[..., 1]) / 2.0
    return (U * torch.stack([sigma, sigma, torch.zeros_like(sigma)], -1)[..., None, :]) @ Vt


def sampson_distance(p0n, p1n, E):
    """Sampson distance (..., N) of (N, 2) normalised correspondences under
    (..., 3, 3) essential matrices; a non-finite one is 1e9. Elementwise
    terms, so that (T, K, N) sweeps stay lean and fp32."""
    e = [[E[..., i, j, None] for j in range(3)] for i in range(3)]
    x0, y0, x1, y1 = p0n[:, 0], p0n[:, 1], p1n[:, 0], p1n[:, 1]
    ep0 = [e[i][0] * x0 + e[i][1] * y0 + e[i][2] for i in range(3)]
    etp1 = [e[0][j] * x1 + e[1][j] * y1 + e[2][j] for j in range(2)]
    num = (x1 * ep0[0] + y1 * ep0[1] + ep0[2]) ** 2
    den = ep0[0] ** 2 + ep0[1] ** 2 + etp1[0] ** 2 + etp1[1] ** 2
    d = num / den.clamp(min=1e-12)
    return torch.where(torch.isfinite(d), d, 1e9)


def _triangulate_depths(p0n, p1n, R, t):
    """Depths (z0, z1) of the points for the pose (R, t): x1 ~ z0 R x0 + t,
    z0 minimising |[x1]_x (z0 R x0 + t)|. p (N, 2); R (..., 3, 3); t (..., 3)."""
    x0, x1 = to_homogeneous(p0n), to_homogeneous(p1n)
    Rx0 = (R[..., None, :, :] * x0[:, None, :]).sum(-1)  # (..., N, 3)
    c = torch.linalg.cross(x1.expand_as(Rx0), Rx0)
    d = torch.linalg.cross(x1.expand_as(Rx0), t[..., None, :].expand_as(Rx0))
    z0 = -(c * d).sum(-1) / (c * c).sum(-1).clamp(min=1e-12)
    return z0, (Rx0 * z0[..., None] + t[..., None, :])[..., 2]


def decompose_and_choose(E, p0n, p1n, valid):
    """The (R, t) of the four decompositions of E (..., 3, 3), in the order
    (R1, t), (R1, -t), (R2, t), (R2, -t), with the most valid points in
    front of both cameras (the first on a tie). Returns (R, t, in front)."""
    R1, R2, t = decompose_essential_matrix(E)
    Rs = torch.stack([R1, R1, R2, R2], -3)  # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], -2)  # (..., 4, 3)
    z0, z1 = _triangulate_depths(p0n, p1n, Rs, ts)
    good = (z0 > 0) & (z1 > 0) & valid[..., None, :]  # (..., 4, N)
    best = torch.argmax(good.sum(-1), -1)[..., None, None]  # (..., 1, 1)
    return (torch.take_along_dim(Rs, best[..., None], dim=-3)[..., 0, :, :],
            torch.take_along_dim(ts, best, dim=-2)[..., 0, :],
            torch.take_along_dim(good, best, dim=-2)[..., 0, :])


def _linear_inliers(err, th2, valid_f):
    """Soft inlier weights max(0, 1 - d / th^2) over the valid entries."""
    return (1.0 - err / th2).clamp(min=0.0) * valid_f


def ransac_relative_pose_core(
    p0n: torch.Tensor,
    p1n: torch.Tensor,
    valid: torch.Tensor,
    noise: Sequence[torch.Tensor],
    th: float | Sequence[float] | torch.Tensor = 1e-3,
    refine_iters: int = 3,
) -> RelPoseResult:
    """One pair: normalised points (N, 2), valid (N,) bool, and the (K, N)
    Gumbel noise of the uniform round followed by one (K, N) array a guided
    round. `th` (normalised units) is a threshold, or T of them (a sequence
    or a 1-D tensor): the sweep runs as one batch over T on the same draws
    and every output gains a leading T axis."""
    dev, dt = p0n.device, p0n.dtype
    sweep = not isinstance(th, (int, float)) and not (torch.is_tensor(th) and th.dim() == 0)
    ths = torch.as_tensor(th, dtype=dt, device=dev).reshape(-1)
    nt, n = ths.shape[0], p0n.shape[0]
    th2 = ths * ths
    t2k, t2kn = th2[:, None], th2[:, None, None]  # against (T, K) and (T, K, N)
    rows = torch.arange(nt, device=dev)
    valid_f = valid.to(dt)
    multipliers = [16.0, 8.0, 4.0, 2.0] + [1.0] * max(refine_iters, 2)

    def candidates_from(idx):
        """The refined top candidates (T, 12, 3, 3) of the minimal samples
        idx, (K, 8) shared by the thresholds or (T, K, 8)."""
        Es = _eight_point(p0n[idx], p1n[idx])
        Es = Es if Es.dim() == 4 else Es[None]  # (1 or T, K, 3, 3)
        errs = sampson_distance(p0n, p1n, Es)
        cand = torch.cat([top_k(_linear_inliers(errs, t2kn * mult, valid_f).sum(-1), 4)
                          for mult in (1.0, 4.0, 16.0)], -1)  # (T, 12)
        E = Es.expand(nt, -1, -1, -1)[rows[:, None], cand]
        err = errs.expand(nt, -1, -1)[rows[:, None], cand]
        c = E.shape[1]
        for mult in multipliers:
            t2 = t2kn * mult
            w = _linear_inliers(err, t2, valid_f)
            E_new = _eight_point(p0n.expand(nt, c, n, 2), p1n.expand(nt, c, n, 2), w)
            err_new = sampson_distance(p0n, p1n, E_new)
            ok = (_linear_inliers(err_new, t2, valid_f).sum(-1) >= w.sum(-1)) & \
                torch.isfinite(E_new).flatten(-2).all(-1)
            # the residuals of the kept model are carried, not recomputed
            E = torch.where(ok[..., None, None], E_new, E)
            err = torch.where(ok[..., None], err_new, err)
        return E

    E_all = candidates_from(sample_minimal_indices(noise[0], valid, 8))
    for g in noise[1:]:
        errs_all = sampson_distance(p0n, p1n, E_all)
        err_best = errs_all[rows, torch.argmax(_linear_inliers(errs_all, t2kn, valid_f).sum(-1),
                                               -1)]
        # soft inlier log-weights at a relaxed threshold; the floor keeps the
        # distribution proper when the first round found nothing
        logw = torch.log(_linear_inliers(err_best, 4.0 * t2k, valid_f) + 1e-4) + \
            torch.where(valid, 0.0, -1e9)
        E_all = torch.cat([E_all, candidates_from(sample_weighted_indices(g, logw, 8))], 1)

    final_errs = sampson_distance(p0n, p1n, E_all)
    best = torch.argmax(_linear_inliers(final_errs, t2kn, valid_f).sum(-1), -1)
    E = E_all[rows, best]
    inliers = (final_errs[rows, best] < t2k) & valid
    R, t, in_front = decompose_and_choose(E, p0n, p1n, inliers)
    inliers = inliers & in_front
    count = inliers.sum(-1)
    out = RelPoseResult(R, t, E, inliers, count.to(dt), count >= 8)
    return out if sweep else RelPoseResult(*(x[0] for x in out))


def ransac_relative_pose(
    p0n: torch.Tensor,
    p1n: torch.Tensor,
    valid: torch.Tensor,
    generator: torch.Generator | None = None,
    th: float | Sequence[float] | torch.Tensor = 1e-3,
    num_hypotheses: int = 1024,
    refine_iters: int = 3,
    guided_rounds: int = 1,
) -> RelPoseResult:
    """One pair on the device of `p0n`, at a threshold or a sweep of them
    (see `ransac_relative_pose_core`); the noise comes from `generator` (on
    that device), one (K, N) draw a round."""
    shape = (num_hypotheses, p0n.shape[0])
    noise = [gumbel(shape, generator, p0n.device) for _ in range(1 + guided_rounds)]
    return ransac_relative_pose_core(p0n, p1n, valid, noise, th, refine_iters)


__all__ = [
    "RelPoseResult", "sampson_distance", "decompose_and_choose", "ransac_relative_pose_core",
    "ransac_relative_pose",
    "RansacResult", "gumbel", "top_k", "sample_minimal_indices", "sample_weighted_indices",
    "homography_residuals", "ransac_homography_core", "ransac_homography",
]
