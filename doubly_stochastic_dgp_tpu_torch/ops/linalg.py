"""Numerics core: jitter, jittered Cholesky with rung escalation (absolute
and the relative ladder) and its grad-safe backward, triangular inverse
and solves, the diagonal and full-covariance reparameterization and the
Gaussian KL terms.

Counterpart of ``doubly_stochastic_dgp_tpu/ops/linalg.py``
(``add_jitter``, ``safe_cholesky``, ``safe_cholesky_ladder``,
``inv_lower``, ``tri_solve``, ``mvn_logpdf``, ``reparameterize``,
``gauss_kl_white``, ``gauss_kl_nonwhite``); the JAX fused
factor-and-inverse forms (``safe_cholesky_inv``, ``tri_solve(Li=)``) are
left out, since no JAX model calls them.  The JAX escalation tests the
factor for NaN and gates the later rungs behind a ``lax.cond``; ``torch.linalg.cholesky``
raises on a non-positive-definite matrix instead, so the port uses
``cholesky_ex`` and factorizes every rung in one batched call, then
selects per batch element with ``torch.where`` on ``info`` and
finiteness.  Nothing is read on the host, so the factorization runs
inside a captured CUDA graph; the price is the later rungs' work on a
healthy matrix (PERF.md).
"""

from __future__ import annotations

import math

import torch

__all__ = ["DeviceCount", "add_jitter", "safe_cholesky", "safe_cholesky_ladder",
           "cholesky_nan", "inv_lower", "tri_solve", "mvn_logpdf",
           "reparameterize", "gauss_kl_white", "gauss_kl_nonwhite"]


def _eye_like(K):
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def add_jitter(K, jitter):
    """K + jitter * I on the last two dims."""
    return K + jitter * _eye_like(K)


def _phi(X):
    """Lower triangle with the diagonal halved (Murray 2016, eq. 8)."""
    return torch.tril(X, -1) + 0.5 * torch.diag_embed(
        torch.diagonal(X, dim1=-2, dim2=-1))


def _chol_pullback(L, gL):
    """Reverse-mode rule for L = cholesky(A), A symmetric (Murray 2016):
    gA = 0.5 (Li^T phi(L^T gL) Li + transpose), the JAX ``_chol_pullback``
    (symmetrized, so it agrees with any symmetric downstream use)."""
    gL = torch.tril(gL)
    mid = _phi(L.transpose(-1, -2) @ gL)
    Li = inv_lower(L)
    gA = Li.transpose(-1, -2) @ mid @ Li
    return 0.5 * (gA + gA.transpose(-1, -2))


class DeviceCount:
    """A count kept on the device: :meth:`add` adds a 0-dim tensor to the
    count on that tensor's device without a host read; ``int()`` (and
    ``==``) read it.  The count of a device is created by its first
    :meth:`add`, which must come before any CUDA graph capture that adds
    to it (a capture would bake in the creation)."""

    def __init__(self):
        self._counts = {}

    def add(self, n):
        count = self._counts.get(n.device)
        if count is None:
            if n.device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "DeviceCount: first add on a device while a CUDA graph "
                    "is being captured; run the captured code once eagerly "
                    "first")
            count = self._counts[n.device] = torch.zeros(
                (), dtype=torch.int64, device=n.device)
        count.add_(n)

    def reset(self):
        for count in self._counts.values():
            count.zero_()

    def __int__(self):
        return sum(int(c) for c in self._counts.values())

    def __eq__(self, other):
        return int(self) == other

    def __repr__(self):
        return f"DeviceCount({int(self)})"


def _select_rung(K, jitters, relative):
    """Every rung factorized in one batched ``cholesky_ex`` over the
    stacked rungs; each batch element takes its first rung that succeeded
    (``info == 0`` and a finite factor), else NaN — the JAX selection
    rule, with no host read.  Rung j adds j I, or (j * mean(diag
    K)) I when ``relative``; a rung of exactly 0.0 adds nothing.  Returns
    the factor and a 0-dim bool tensor: whether the first rung failed
    anywhere."""
    I = _eye_like(K)

    def rung(j):
        if j == 0.0:
            return K
        if relative:
            j = j * torch.diagonal(K, dim1=-2, dim2=-1).mean(-1)[..., None,
                                                                 None]
        return K + j * I

    Ls, info = torch.linalg.cholesky_ex(torch.stack([rung(j)
                                                     for j in jitters]))
    oks = (info == 0) & torch.isfinite(Ls).all(dim=-1).all(dim=-1)
    # where every rung fails, NaN in the lower triangle, as the JAX
    # Cholesky returns (cholesky_ex leaves a partial, finite factor)
    sel = torch.where(oks[-1][..., None, None], Ls[-1],
                      torch.full_like(Ls[-1], float("nan")).tril())
    for r in range(len(jitters) - 2, -1, -1):
        sel = torch.where(oks[r][..., None, None], Ls[r], sel)
    return sel, ~oks[0].all()


class _SafeCholesky(torch.autograd.Function):
    """Rung selection forward; the Cholesky pullback on the *selected*
    factor backward, so a rejected rung's non-finite factor never sits on
    the autograd path (a ``torch.where`` over the rungs would push
    0 * NaN through the rejected rung's ``cholesky_ex`` backward).
    ``relative`` scales the rungs by the mean diagonal of each batch
    element."""

    @staticmethod
    def forward(ctx, K, jitters, relative):
        L, escalated = _select_rung(K, jitters, relative)
        if relative:
            safe_cholesky_ladder.escalations.add(escalated)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, gL):
        (L,) = ctx.saved_tensors
        return _chol_pullback(L, gL), None, None


def safe_cholesky(K, jitter):
    """Cholesky of K + jitter*I, escalating to 1e2*jitter and 1e4*jitter
    on failure; batched over leading dims, per-element rung choice."""
    j0 = float(jitter)
    return _SafeCholesky.apply(K, (j0, 1e2 * j0, 1e4 * j0), False)


def safe_cholesky_ladder(K, jitters=(0.0, 1e-7, 1e-5, 1e-3, 1e-1, 1.0,
                                     1e1, 1e3)):
    """Cholesky with a *relative* jitter ladder, for matrices that are PSD
    by construction (the collapsed bound's B = I + AA^T), where a failure
    is floating-point garbage that scales with the matrix: rung j adds
    j * mean(diag K) I.  The first rung is 0.0, so a healthy matrix gets
    ``torch.linalg.cholesky(K)`` (bit for bit on the CPU; on the card the
    batched factorization may round otherwise, PERF.md).  The deep rungs
    (up to 1e3) are the net for float32 B at the damianou_large shape,
    where whether the factorization of B squeaks through can turn on
    psi2's last ulp (the JAX docstring records it); jitter on B only
    lowers the bound.  Same
    per-element selection and grad-safe backward as :func:`safe_cholesky`.
    ``safe_cholesky_ladder.escalations`` (a :class:`DeviceCount`) counts
    the calls whose first rung failed."""
    return _SafeCholesky.apply(K, tuple(float(j) for j in jitters), True)


safe_cholesky_ladder.escalations = DeviceCount()


def cholesky_nan(K):
    """Cholesky of K with NaN factors where it fails, as the JAX
    ``jnp.linalg.cholesky`` returns (``cholesky_ex``, no host read, where
    ``torch.linalg.cholesky`` reads the status on the host to raise)."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def inv_lower(L):
    """Inverse of a lower-triangular matrix (batched over leading dims)."""
    eye = _eye_like(L).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def tri_solve(L, B, lower=True, trans=False, mode="solve"):
    """Solve op(L) X = B for triangular L, op(L) = L^T when ``trans``:
    ``mode='solve'`` by triangular substitution, ``'inverse'`` by forming
    the triangular inverse once and multiplying (the JAX ``tri_solve``)."""
    if mode == "inverse":
        Li = inv_lower(L) if lower else inv_lower(L.mT).mT
        return (Li.mT if trans else Li) @ B
    if trans:
        return torch.linalg.solve_triangular(L.mT, B, upper=lower)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def mvn_logpdf(Y, mu, L):
    """Columnwise multivariate-normal log density: each column of Y (N, D)
    a draw from N(mu[:, d], L L^T), L (N, N) lower.  Returns (D,)."""
    N = Y.shape[0]
    alpha = torch.linalg.solve_triangular(L, Y - mu, upper=False)
    p = -0.5 * torch.sum(alpha ** 2, dim=0)
    p = p - 0.5 * N * math.log(2 * math.pi)
    return p - torch.sum(torch.log(torch.diagonal(L)))


def reparameterize(mean, var, z, jitter, full_cov=False):
    """Reparameterized sample from mean (S, N, D) and unit normals z (S, N,
    D).  Diagonal: mean + z * sqrt(max(var, 0) + jitter), var (S, N, D)
    (the clamp absorbs float32 cancellation in Kff - Qff).  ``full_cov``:
    var (S, N, N, D), mean + chol(var + jitter I) z batched over (S, D),
    D-major; where a factorization fails, its samples are NaN, as in the
    JAX package (``cholesky_ex``, no host read)."""
    if var is None:
        return mean
    if not full_cov:
        return mean + z * torch.sqrt(torch.clamp(var, min=0.0) + jitter)
    var_sdnn = var.permute(0, 3, 1, 2)                   # (S, D, N, N)
    chol = cholesky_nan(add_jitter(var_sdnn, jitter))
    f = mean.transpose(1, 2) + torch.einsum("sdnm,sdm->sdn", chol,
                                            z.transpose(1, 2))
    return f.transpose(1, 2)                             # (S, N, D)


def _kl_common(q_mu, q_sqrt):
    M, D = q_mu.shape
    diag = torch.diagonal(q_sqrt, dim1=-2, dim2=-1)
    return -0.5 * D * M - 0.5 * torch.sum(torch.log(diag ** 2))


def gauss_kl_white(q_mu, q_sqrt):
    """KL( N(q_mu, L L^T) || N(0, I) ), summed over output dims.
    q_mu: (M, D); q_sqrt: (D, M, M) lower-triangular."""
    return (_kl_common(q_mu, q_sqrt) + 0.5 * torch.sum(q_sqrt ** 2)
            + 0.5 * torch.sum(q_mu ** 2))


def gauss_kl_nonwhite(q_mu, q_sqrt, Lu):
    """KL( N(q_mu, L L^T) || N(0, Ku) ) with Ku = Lu Lu^T (Lu lower)."""
    D = q_mu.shape[1]
    kl = _kl_common(q_mu, q_sqrt)
    kl = kl + D * torch.sum(torch.log(torch.diagonal(Lu)))
    # trace term || Lu^{-1} q_sqrt ||_F^2, batched over D
    LiQ = torch.linalg.solve_triangular(Lu.expand_as(q_sqrt), q_sqrt,
                                        upper=False)
    kl = kl + 0.5 * torch.sum(LiQ ** 2)
    # Mahalanobis term q_mu^T Ku^{-1} q_mu
    Li_m = torch.linalg.solve_triangular(Lu, q_mu, upper=False)
    return kl + 0.5 * torch.sum(Li_m ** 2)
