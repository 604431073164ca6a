"""Batched RANSAC for homographies, on tensors on the device (counterpart of
gluefactory_tpu/estimators/ransac.py:33-142; the relative-pose half waits for
the relative-pose benchmarks, ROADMAP Queue 1 item 6).

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
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..geometry.homography import solve_homography_dlt, sym_homography_error


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


__all__ = [
    "RansacResult", "gumbel", "top_k", "sample_minimal_indices", "sample_weighted_indices",
    "homography_residuals", "ransac_homography_core", "ransac_homography",
]
