"""Closed-form kernel expectations (psi statistics) for RBF and Linear
kernels under diagonal-Gaussian inputs x_n ~ N(mu_n, diag(S_n)):

    psi0[n]     = E[k(x_n, x_n)]
    psi1[n, m]  = E[k(x_n, z_m)]
    psi2[m, m'] = sum_n E[k(x_n, z_m) k(x_n, z_m')]

Counterpart of ``doubly_stochastic_dgp_tpu/ops/psi_stats.py``: RBF,
Linear, and a ``Sum`` of RBFs, Linears and Whites with every pairwise psi2
cross term (RBF x RBF, Linear x Linear, RBF x Linear).  The RBF
psi2 data sum stages the one-sided quadratics U, V, the widths w and
logdet as (N, M) / (N, D) arrays and takes one of two routes, which
:func:`psi2_route` picks from ``Config.psi2_impl`` (carried by the layer),
the device, M, D and the dtype before anything launches: the kernel
route, ``ops.cuda.psi2.psi2_core`` (on a CUDA tensor the CUDA kernel,
which launches or raises; on a CPU tensor its plain version), or the
plain route, which forms the (block, M, M) terms in row blocks on any
device.  A single RBF's psi2 is symmetric, and its kernel call says so
(``symmetric=True``: each a <= b computed once).  Every contraction is a
plain fp32/f64 matmul: the port never enables TF32, which is the JAX
package's HIGHEST-precision contract here.  The Linear kernel's terms
and the cross terms with a Linear are plain PyTorch on every device, as
they are plain XLA in the JAX package.
"""

from __future__ import annotations

import torch

from .cuda.psi2 import kernel_supports, psi2_core
from .kernels import RBF, Linear, Sum, White

__all__ = ["psi_statistics", "psi2_route"]

# Rows per block of the plain psi2 data sum, and the element budget of one
# (block, M, M) transient (the JAX PSI2_BLOCK_ROWS / PSI2_BLOCK_ELEMS)
PSI2_BLOCK_ROWS = 8192
PSI2_BLOCK_ELEMS = 8192 * 100 * 100


def _psi2_block_rows(M):
    return min(PSI2_BLOCK_ROWS, max(128, PSI2_BLOCK_ELEMS // (M * M)))


def psi2_route(psi2_impl, device, M, D, dtype):
    """'kernel' or 'plain': the route of an RBF psi2 data sum.

    'xla' takes the plain route.  'auto' takes the kernel route on a CPU
    tensor (the kernel's plain version) and on a CUDA tensor wherever the
    kernel takes the call (:func:`~.cuda.psi2.kernel_supports`: float32,
    M <= 512, 1 <= D <= 32), else the plain route, as the JAX
    ``_psi2_route`` gives the kernel only what it supports; the kernel
    route won on the card where it runs (PERF.md).  'pallas' is the
    explicit request for the kernel: it takes the kernel route, which on a
    CUDA tensor raises where the kernel cannot take the call.  There the
    JAX 'pallas' falls back to XLA; the port does not.  On any other device
    'auto' takes the plain route.  Chosen from these alone, before any
    launch: the kernel route never falls back after a failed launch."""
    if psi2_impl == "xla":
        return "plain"
    if psi2_impl == "pallas":
        return "kernel"
    device = torch.device(device)
    if device.type == "cpu":
        return "kernel"
    if device.type == "cuda" and kernel_supports(M, D, dtype):
        return "kernel"
    return "plain"


def _blocked_data_sum(block_fn, N, out_shape, dtype, device):
    """Sum ``block_fn(rows) -> out_shape`` over slices of the N data rows,
    so the per-row intermediates stay O(block * ...) as N grows."""
    block = _psi2_block_rows(out_shape[0])
    if N <= block:
        return block_fn(slice(0, N))
    out = torch.zeros(out_shape, dtype=dtype, device=device)
    for n0 in range(0, N, block):
        out = out + block_fn(slice(n0, n0 + block))
    return out


def _z_center(Z):
    """Common per-dimension shift for the rank-separated quadratics, which
    are exactly invariant under mu -> mu - c, Z -> Z - c; centring on the
    inducing points anchors the mu^2 - 2 mu z + z^2 expansion where the
    psi mass lives.  Detached: d(out)/dc is 0 analytically."""
    return torch.mean(Z, dim=0).detach()


def _sep_quad(mu, inv, Z):
    """-0.5 sum_d (mu_nd - z_md)^2 inv_nd, rank-separated into two
    matmuls; mathematically <= 0, clamped so that expansion cancellation
    cannot push exp past 1.  mu and Z come centred by a common shift."""
    t_mu2 = torch.sum(mu ** 2 * inv, dim=-1)                     # (B,)
    return torch.clamp(
        -0.5 * (t_mu2[:, None] - 2.0 * (mu * inv) @ Z.T
                + inv @ (Z ** 2).T), max=0.0)                    # (B, M)


def _rbf_cross_psi2(ka, kb, mu, S, Z, psi2_impl):
    """sum_n E[k_a(x_n, z_m) k_b(x_n, z_m')] for two (ARD) RBF kernels,
    (M, M).  The product of the two per-dimension Gaussians in x has width
    h = ab/(a+b) (a, b the squared lengthscales) and centre c = beta z +
    alpha z' (alpha = a/(a+b), beta = b/(a+b)), times exp(-(z-z')^2 /
    (2(a+b))); E_x of what is left is sqrt(h/(h+s)) exp(-(mu-c)^2 /
    (2(h+s))).  With a == b it is the single-RBF psi2, symmetric in
    (m, m'): the kernel route then computes each m <= m' once."""
    va = ka.variance.value
    vb = kb.variance.value
    a = ka.lengthscales.value ** 2 + torch.zeros_like(mu[0])     # (D,)
    b = kb.lengthscales.value ** 2 + torch.zeros_like(mu[0])     # (D,)
    h = a * b / (a + b)
    zz = Z[:, None, :] - Z[None, :, :]                           # (M, M, D)
    log_zz = -0.5 * torch.sum(zz ** 2 / (a + b), dim=-1)         # (M, M)
    alpha = a / (a + b)
    beta = b / (a + b)
    c = _z_center(Z)
    Z = Z - c
    mu = mu - c
    M = Z.shape[0]
    # the one-sided quadratic halves Uq, Vq (N, M), the widths wq (N, D)
    # and logdet (N, 1): with c = beta z_a + alpha z_b, (mu - c)^2
    # separates so that only sum_d wq_nd z_ad z_bd is a true three-way term
    denom = h + S                                                # (N, D)
    logdet = 0.5 * torch.sum(torch.log(h) - torch.log(denom), dim=-1,
                             keepdim=True)                       # (N, 1)
    inv = 1.0 / denom
    t_mu2 = torch.sum(mu ** 2 * inv, dim=-1)                     # (N,)
    P1 = (mu * inv * beta) @ Z.T                                 # (N, M)
    P2 = (mu * inv * alpha) @ Z.T
    Q1 = (inv * beta ** 2) @ (Z ** 2).T
    Q2 = (inv * alpha ** 2) @ (Z ** 2).T
    Uq = -0.5 * (t_mu2[:, None] - 2.0 * P1 + Q1)
    Vq = -0.5 * (Q2 - 2.0 * P2)
    wq = inv * alpha * beta
    if psi2_route(psi2_impl, mu.device, M, Z.shape[1], mu.dtype) == "kernel":
        # the kernel assembles, exponentiates and sums the (N, M, M) terms
        # (on a CUDA tensor it launches or raises; there is no fallback)
        T = psi2_core(Uq.contiguous(), Vq.contiguous(), wq.contiguous(),
                      logdet.contiguous(), Z.contiguous(),
                      symmetric=ka is kb)                        # (M, M)
        return va * vb * torch.exp(log_zz) * T

    def block_sum(rows):
        """The plain route's sum over one row block: the three-way term as
        one batched matmul, the rest as rank-1 broadcasts."""
        Zw = Z[None, :, :] * wq[rows][:, None, :]                # (B, M, D)
        R = torch.matmul(Zw, Z.T)                                # (B, M, M)
        # mathematically <= 0; clamp float32 cancellation noise
        quad = torch.clamp(Uq[rows][:, :, None] + Vq[rows][:, None, :] - R,
                           max=0.0)
        psi2_n = va * vb * torch.exp(
            logdet[rows][:, :, None] + log_zz[None, :, :] + quad)
        return torch.sum(psi2_n, dim=0)

    return _blocked_data_sum(block_sum, mu.shape[0], (M, M), mu.dtype,
                             mu.device)


def _rbf_psi(kern, mu, S, Z, psi2_impl):
    """psi0 (N,), psi1 (N, M), psi2 summed over n (M, M)."""
    var = kern.variance.value
    ls2 = kern.lengthscales.value ** 2                           # (D,)
    N = mu.shape[0]
    psi0 = torch.ones(N, dtype=mu.dtype, device=mu.device) * var
    logdet1 = -0.5 * torch.sum(torch.log1p(S / ls2), dim=-1)     # (N,)
    c = _z_center(Z)
    psi1 = var * torch.exp(logdet1[:, None]
                           + _sep_quad(mu - c, 1.0 / (ls2 + S), Z - c))
    psi2 = _rbf_cross_psi2(kern, kern, mu, S, Z, psi2_impl)
    return psi0, psi1, psi2


def _rbf_lin_cross_psi2(kr, kl, mu, S, Z):
    """sum_n E[k_rbf(x_n, z_m) k_lin(x_n, z_m')] for an (ARD) RBF and an
    (ARD) Linear kernel, (M, M), the RBF indexing m.  The RBF factor
    reweights x_n to a Gaussian of mean xbar_nmd = (a_d mu_nd + S_nd z_md)
    / (a_d + S_nd) (a = ls^2) with psi1's normalizer, where the linear
    factor is evaluated: C = sum_n psi1[n, m] sum_d v_d xbar_nmd z_m'd."""
    var = kr.variance.value
    a = kr.lengthscales.value ** 2 + torch.zeros_like(mu[0])     # (D,)
    v = kl.variance.value + torch.zeros_like(mu[0])              # (D,)
    c = _z_center(Z)
    Zc = Z - c      # the RBF quadratic is centred; the linear factor needs
                    # absolute coordinates and stays uncentred

    def block_sum(rows):
        mu_b, S_b = mu[rows], S[rows]
        logdet = -0.5 * torch.sum(torch.log1p(S_b / a), dim=-1)  # (B,)
        inv = 1.0 / (a + S_b)                                    # (B, D)
        psi1 = var * torch.exp(
            logdet[:, None] + _sep_quad(mu_b - c, inv, Zc))      # (B, M)
        # xbar = (a mu inv)[n, d] + (S inv)[n, d] z[m, d] separates, so
        # sum_n psi1[n, m] xbar[n, m, d] is two (M, B) @ (B, D) matmuls
        U = psi1.T @ (a * mu_b * inv) + Z * (psi1.T @ (S_b * inv))
        return (U * v) @ Z.T                                     # (M, M)

    M = Z.shape[0]
    return _blocked_data_sum(block_sum, mu.shape[0], (M, M), mu.dtype,
                             mu.device)


def _x_second_moment(mu, S):
    """sum_n E[x_n x_n^T] = mu^T mu + diag(sum_n S_n), (D, D)."""
    return mu.T @ mu + torch.diag(torch.sum(S, dim=0))


def _lin_lin_cross_psi2(ka, kb, mu, S, Z):
    """sum_n E[k_a(x_n, z_m) k_b(x_n, z_m')] for two Linear kernels:
    (Z va) (sum_n E[x x^T]) (Z vb)^T."""
    va = ka.variance.value + torch.zeros_like(mu[0])
    vb = kb.variance.value + torch.zeros_like(mu[0])
    return (Z * va) @ _x_second_moment(mu, S) @ (Z * vb).T


def _linear_psi(kern, mu, S, Z):
    """The (ARD) Linear kernel k(x, z) = sum_d v_d x_d z_d: psi0 = sum_d
    v_d (mu^2 + S), psi1 = (mu v) Z^T, and psi2 the a == b case of the
    cross second moment."""
    v = kern.variance.value + torch.zeros_like(mu[0])            # (D,)
    psi0 = torch.sum(v * (mu ** 2 + S), dim=-1)                  # (N,)
    psi1 = (mu * v) @ Z.T                                        # (N, M)
    return psi0, psi1, _lin_lin_cross_psi2(kern, kern, mu, S, Z)


def _flatten(k):
    if isinstance(k, Sum):
        return [c for part in k.kernels for c in _flatten(part)]
    return [k]


def psi_statistics(kern, mu, S, Z, psi2_impl="auto"):
    """(psi0, psi1, psi2) for an RBF, a Linear, or a Sum of RBFs, Linears
    and Whites, with the psi2 cross terms of every pair of components in
    the JAX order (RBF x RBF, Linear x Linear, RBF x Linear).  A White adds
    its variance to psi0 only (its cross-covariance vanishes in
    expectation)."""
    if isinstance(kern, RBF):
        return _rbf_psi(kern, mu, S, Z, psi2_impl)
    if isinstance(kern, Linear):
        return _linear_psi(kern, mu, S, Z)
    if not isinstance(kern, Sum):
        raise NotImplementedError(
            f"psi statistics not implemented for {type(kern).__name__}")
    N, M = mu.shape[0], Z.shape[0]
    psi0 = torch.zeros(N, dtype=mu.dtype, device=mu.device)
    psi1 = torch.zeros(N, M, dtype=mu.dtype, device=mu.device)
    psi2 = torch.zeros(M, M, dtype=mu.dtype, device=mu.device)
    rbfs, lins = [], []
    for k in _flatten(kern):
        if isinstance(k, White):
            psi0 = psi0 + k.variance.value
            continue
        if isinstance(k, RBF):
            p0, p1, p2 = _rbf_psi(k, mu, S, Z, psi2_impl)
            rbfs.append(k)
        elif isinstance(k, Linear):
            p0, p1, p2 = _linear_psi(k, mu, S, Z)
            lins.append(k)
        else:
            raise NotImplementedError(
                f"psi statistics for {type(k).__name__} in a Sum")
        psi0, psi1, psi2 = psi0 + p0, psi1 + p1, psi2 + p2
    # E[(sum_i k_i)(z) (sum_j k_j)(z')] adds C_ij + C_ij^T for each
    # unordered pair of distinct components
    for i in range(len(rbfs)):
        for j in range(i + 1, len(rbfs)):
            C = _rbf_cross_psi2(rbfs[i], rbfs[j], mu, S, Z, psi2_impl)
            psi2 = psi2 + C + C.T
    for i in range(len(lins)):
        for j in range(i + 1, len(lins)):
            C = _lin_lin_cross_psi2(lins[i], lins[j], mu, S, Z)
            psi2 = psi2 + C + C.T
    for kr in rbfs:
        for kl in lins:
            C = _rbf_lin_cross_psi2(kr, kl, mu, S, Z)
            psi2 = psi2 + C + C.T
    return psi0, psi1, psi2
