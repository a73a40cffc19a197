"""Numerics core, forward only: jitter, jittered Cholesky with rung
escalation, triangular inverse and the diagonal reparameterization.

Counterpart of ``doubly_stochastic_dgp_tpu/ops/linalg.py``
(``add_jitter``, ``safe_cholesky``, ``inv_lower``, ``reparameterize``).
The JAX escalation tests the factor for NaN; ``torch.linalg.cholesky``
raises on a non-positive-definite matrix instead, so the port uses
``cholesky_ex`` and escalates when ``info != 0`` or the factor is not
finite.  Reading ``info`` costs one host sync per call (ROADMAP queue).
"""

from __future__ import annotations

import torch

__all__ = ["add_jitter", "safe_cholesky", "inv_lower", "reparameterize"]


def _eye_like(K):
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def add_jitter(K, jitter):
    """K + jitter * I on the last two dims."""
    return K + jitter * _eye_like(K)


def safe_cholesky(K, jitter):
    """Cholesky of K + jitter*I, escalating to 1e2*jitter and 1e4*jitter
    on failure.

    One factorization on the healthy path.  When any batch element fails,
    every rung is factorized and each element takes its first rung that
    succeeded, else the last rung — the JAX selection rule."""
    j0 = float(jitter)
    I = _eye_like(K)
    L0, info0 = torch.linalg.cholesky_ex(K + j0 * I)
    ok0 = (info0 == 0) & torch.isfinite(L0).all(dim=-1).all(dim=-1)
    if bool(ok0.all()):
        return L0
    Ls, oks = [L0], [ok0]
    for j in (1e2 * j0, 1e4 * j0):
        L, info = torch.linalg.cholesky_ex(K + j * I)
        Ls.append(L)
        oks.append((info == 0) & torch.isfinite(L).all(dim=-1).all(dim=-1))
    sel = Ls[-1]
    for L, ok in zip(reversed(Ls[:-1]), reversed(oks[:-1])):
        sel = torch.where(ok[..., None, None], L, sel)
    return sel


def inv_lower(L):
    """Inverse of a lower-triangular matrix (batched over leading dims)."""
    eye = _eye_like(L).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def reparameterize(mean, var, z, jitter):
    """Diagonal reparameterization mean + z * sqrt(max(var, 0) + jitter)
    (the clamp absorbs float32 cancellation in Kff - Qff)."""
    if var is None:
        return mean
    return mean + z * torch.sqrt(torch.clamp(var, min=0.0) + jitter)
