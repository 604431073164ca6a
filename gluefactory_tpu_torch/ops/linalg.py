"""Batched small symmetric eigenproblems (counterpart of
gluefactory_tpu/ops/linalg.py:73, `smallest_eigenvector`).

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


def smallest_eigenvector(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n)
    matrices (the lower triangle is read), up to sign: (..., n), in A's dtype."""
    _, V = torch.linalg.eigh(A.double())
    return V[..., :, 0].to(A.dtype)


__all__ = ["smallest_eigenvector"]
