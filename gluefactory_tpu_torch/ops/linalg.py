"""Batched small symmetric eigenproblems and 3 x 3 SVDs (counterpart of
gluefactory_tpu/ops/linalg.py:73 `smallest_eigenvector` and :82 `svd3x3`).

The JAX package runs a 10-sweep cyclic Jacobi because XLA's `eigh` is slow on
the TPU for thousands of 9x9 problems. Here `torch.linalg.eigh` does the work
(cuSOLVER's batched Jacobi on the card, LAPACK on the CPU), in float64:
fp32 `eigh` of the DLT's A^T A misses the JAX solver's fp32 Jacobi by up to
1.2e-4 of H on weighted minimal samples (fp32 LAPACK is the least accurate
of the three against an exact solve), the float64 solve of the same fp32
matrix by 8e-5 and the exact solution by 2e-5. `eigh` checks its status on
the host, so each call reads the device once.

Where the null space has two or more dimensions (a degenerate minimal sample,
e.g. three collinear points), this solver and the Jacobi sweeps may return
different vectors of it; such hypotheses score low either way.
"""

from __future__ import annotations

import torch

# matrices an `eigh` call solves at most: cuSOLVER's batched solver refused
# 6 x 8192 9 x 9 matrices (CUSOLVER_STATUS_INVALID_VALUE on an H100), 8192 pass
EIGH_BATCH = 8192


def eigh(A: torch.Tensor):
    """`torch.linalg.eigh` of (..., n, n) matrices in chunks of EIGH_BATCH
    (one status read a chunk on the card)."""
    flat = A.reshape((-1,) + A.shape[-2:])
    if flat.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(A)
    parts = [torch.linalg.eigh(c) for c in flat.split(EIGH_BATCH)]
    return (torch.cat([w for w, _ in parts]).reshape(A.shape[:-1]),
            torch.cat([v for _, v in parts]).reshape(A.shape))


def smallest_eigenvector(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n)
    matrices (the lower triangle is read), up to sign: (..., n), in A's dtype."""
    _, V = eigh(A.double())
    return V[..., :, 0].to(A.dtype)


def svd3x3(A: torch.Tensor):
    """SVD of (..., 3, 3) matrices through the eigenvectors of A^T A (float64
    `eigh`, one status read on the card), in the JAX package's construction
    for (near) rank-2 inputs such as essential matrices: u0 = A v0 / s0,
    u1 = A v1 / s1 made orthogonal to u0, u2 = u0 x u1 with its sign taken
    from A v2. Returns (U, s descending, V^T) in A's dtype; U and V are
    orthonormal, their determinants' signs are not fixed. Sign choices of the
    eigensolver change U and V but not U diag(s) V^T."""
    A64 = A.double()
    evals, V = eigh(A64.transpose(-1, -2) @ A64)
    evals, V = evals.flip(-1), V.flip(-1)  # descending
    s = evals.clamp(min=0.0).sqrt()
    AV = A64 @ V
    u0 = AV[..., :, 0] / s[..., 0:1].clamp(min=1e-12)
    u1 = AV[..., :, 1] / s[..., 1:2].clamp(min=1e-12)
    u1 = u1 - (u0 * u1).sum(-1, keepdim=True) * u0
    u1 = u1 / torch.linalg.vector_norm(u1, dim=-1, keepdim=True).clamp(min=1e-12)
    u2 = torch.linalg.cross(u0, u1)
    u2 = torch.where((AV[..., :, 2] * u2).sum(-1, keepdim=True) < 0, -u2, u2)
    U = torch.stack([u0, u1, u2], -1)
    return U.to(A.dtype), s.to(A.dtype), V.transpose(-1, -2).to(A.dtype)


__all__ = ["eigh", "smallest_eigenvector", "svd3x3", "EIGH_BATCH"]
