"""Pose-graph optimisation over SE(3) (counterpart of
gluefactory_tpu/sfm/pose_graph.py).

Given relative-pose constraints between keyframes, refine the absolute
poses by damped Gauss-Newton on the residual log(T_ij_meas^-1 T_j T_i^-1):
batched over the edges, the Jacobian by forward-mode autodiff of the whole
residual (`torch.func.jacfwd`, as the JAX package takes `jax.jacfwd`), a
dense Cholesky solve over the (small) keyframe set, and an LM loop whose
accept/reject stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.utils import so3exp_map
from ..models.utils.layers import no_tf32
from .ba import cholesky_solve


def so3_log(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3). The trace is
    clipped to +-(1 - 1e-7) by maximum / minimum, whose derivative at a tie
    is one half, as jnp.clip's."""
    # filled on the device: a tensor made from a Python number is copied
    # there, and the copy waits for the host
    lo = torch.full((), -1 + 1e-7, dtype=R.dtype, device=R.device)
    hi = torch.full((), 1 - 1e-7, dtype=R.dtype, device=R.device)
    trace = (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1) / 2
    theta = torch.arccos(torch.minimum(torch.maximum(trace, lo), hi))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    scale = torch.where(theta < eps, 0.5, theta / (2 * torch.sin(theta) + eps))
    return w * scale[..., None]


class PoseGraph(NamedTuple):
    R: torch.Tensor  # (N, 3, 3) world->cam
    t: torch.Tensor  # (N, 3)
    edges: torch.Tensor  # (E, 2) integer (i, j)
    R_ij: torch.Tensor  # (E, 3, 3) measured i->j
    t_ij: torch.Tensor  # (E, 3)
    weight: torch.Tensor  # (E,)


def edge_residuals(graph: PoseGraph) -> torch.Tensor:
    """6-D residual per edge, [log(R_err), t_err], with
    T_err = T_meas_ij^-1 (T_j T_i^-1), times the edge's weight."""
    i, j = graph.edges[:, 0].long(), graph.edges[:, 1].long()
    Ri, ti, Rj, tj = graph.R[i], graph.t[i], graph.R[j], graph.t[j]
    with no_tf32():
        R_rel = torch.einsum("eij,ekj->eik", Rj, Ri)  # Rj Ri^T
        t_rel = tj - torch.einsum("eij,ej->ei", R_rel, ti)
        R_err = torch.einsum("eji,ejk->eik", graph.R_ij, R_rel)
    t_err = t_rel - graph.t_ij
    return torch.cat([so3_log(R_err), t_err], -1) * graph.weight[:, None]


def pg_cost(graph: PoseGraph) -> torch.Tensor:
    return 0.5 * torch.sum(edge_residuals(graph) ** 2)


def _retract(graph: PoseGraph, deltas: torch.Tensor) -> PoseGraph:
    """The graph with each node moved by its left-multiplicative
    [omega, tau] delta."""
    with no_tf32():
        R = torch.einsum("nij,njk->nik", so3exp_map(deltas[:, :3]), graph.R)
    return graph._replace(R=R, t=graph.t + deltas[:, 3:])


def _pg_jacobian(graph: PoseGraph, deltas: torch.Tensor):
    """The residual vector (6E,) at `deltas` (N, 6) and its Jacobian
    (6E, 6N) with respect to them, by forward-mode autodiff."""

    def residual_of_deltas(d):
        return edge_residuals(_retract(graph, d)).reshape(-1)

    with no_tf32():
        r = residual_of_deltas(deltas)
        J = torch.func.jacfwd(residual_of_deltas)(deltas)
    return r, J.reshape(r.shape[0], deltas.numel())


def _pg_step(graph: PoseGraph, lam) -> PoseGraph:
    """Damped GN step with the Jacobian of the whole residual vector with
    respect to the 6N pose deltas (left-multiplicative [omega, tau] per
    node) by autodiff: N is small (a keyframe graph)."""
    N = graph.R.shape[0]
    dt, dev = graph.R.dtype, graph.R.device
    r0, J = _pg_jacobian(graph, torch.zeros(N, 6, dtype=dt, device=dev))
    with no_tf32():
        H = J.T @ J + lam * torch.eye(N * 6, dtype=dt, device=dev)
        H[:6, :6] += 1e9 * torch.eye(6, dtype=dt, device=dev)  # gauge: clamp node 0
        g = -(J.T @ r0)
    return _retract(graph, cholesky_solve(H, g[:, None]).reshape(N, 6))


@torch.no_grad()
def optimize_pose_graph(graph: PoseGraph, iterations: int = 10, init_lambda: float = 1e-4):
    """LM loop with accept/reject on the device (no host read before it
    returns); returns (graph, cost)."""
    lam = torch.full((), init_lambda, dtype=graph.R.dtype, device=graph.R.device)
    cost = pg_cost(graph)
    for _ in range(iterations):
        new = _pg_step(graph, lam)
        new_cost = pg_cost(new)
        accept = new_cost < cost
        graph = graph._replace(R=torch.where(accept, new.R, graph.R),
                               t=torch.where(accept, new.t, graph.t))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-8, 1e4)
    return graph, cost


__all__ = ["PoseGraph", "optimize_pose_graph", "pg_cost", "edge_residuals", "so3_log"]
