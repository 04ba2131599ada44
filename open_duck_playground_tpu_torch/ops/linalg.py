"""Batched small dense symmetric solves for the physics pipeline.

Counterpart of the JAX package's ``ops/linalg.py``. The joint-space inertia
M and the Newton Hessian H are ``(B, nv, nv)`` with nv in {20, 30}. Two
backends:

- ``ldl`` (the default, as in the JAX package): LDL^T without square
  roots, Jacobi-prescaled, factored left-looking one column at a time; each
  column is a few batched vector operations over ``(B, nv)``, so a solve is
  O(nv) steps, not the O(nv^3) scalar operations of the JAX package's
  unrolled form;
- ``cholesky``: ``torch.linalg.cholesky`` and ``cholesky_solve``.
"""

from __future__ import annotations

import torch

_BACKEND = "ldl"


def set_backend(name: str) -> None:
    global _BACKEND
    assert name in ("cholesky", "ldl")
    _BACKEND = name


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A (..., n, n)."""
    if _BACKEND == "cholesky":
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return _ldl_solve(A, b)


def _ldl_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LDL^T solve of the Jacobi-prescaled system.

    S A S with S = diag(1/sqrt(diag A)) has a unit diagonal, which keeps the
    unpivoted factorization accurate in float32 even for the Newton Hessian
    H = M + J^T D J (contact D ~ 1e5 against inertia entries ~ 1e-5).
    """
    n = A.shape[-1]
    A, b = torch.broadcast_tensors(A, b[..., None])
    b = b[..., 0]
    sc = torch.rsqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-30))
    a = A * sc[..., :, None] * sc[..., None, :]
    L = torch.zeros_like(a)
    d = torch.zeros_like(b)
    for j in range(n):
        # column j below (and at) the diagonal, less the earlier columns'
        # contributions L[i, k] L[j, k] d[k], k < j
        col = a[..., :, j]
        if j:
            col = col - ((L[..., :, :j] * L[..., j:j + 1, :j]) * d[..., None, :j]).sum(-1)
        d[..., j] = col[..., j]
        L[..., j + 1:, j] = col[..., j + 1:] * (1.0 / col[..., j:j + 1])
    dinv = 1.0 / d

    # solve in the scaled system: (S A S) y = S b, x = S y
    z = b * sc
    for i in range(1, n):
        z[..., i] = z[..., i] - (L[..., i, :i] * z[..., :i]).sum(-1)
    z = z * dinv
    for i in range(n - 2, -1, -1):
        z[..., i] = z[..., i] - (L[..., i + 1:, i] * z[..., i + 1:]).sum(-1)
    return z * sc
