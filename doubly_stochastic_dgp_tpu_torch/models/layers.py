"""The SVGP layer of the main path: multisample conditionals, sampling,
the sparse conditional on its three branches (diagonal and full
covariance) and the KL term; the MCMC layers (``SGPMCLayer``,
``GPMCLayer``); the collapsed layers.

Counterpart of ``doubly_stochastic_dgp_tpu/models/layers.py``
(``Layer``, ``_fusable_rbf``, the build-time host helpers,
``SVGPLayer``, ``SGPMCLayer``, ``GPMCLayer``, ``GPRLayer``,
``SGPRLayer``).  ``conditional_ND`` has three branches:

- the fused branch (``use_pallas=True``, an RBF(+White) kernel and the
  diagonal): staging factors LiT = Lu^{-T}, alpha = Li q_mu and W = Li SK
  Li^T are formed here and the gram -> staging -> mean/var pipeline runs
  in the fused conditional kernel (``ops/cuda/conditional.py``), forward
  and backward; ``use_pallas='saved'`` takes its save-gram pair;
- the staged-inverse branch (``solve_mode='inverse'``, diagonal): G = Li
  Kuf with the sum-of-squares variance Kff - colsum(G*G) + colsum(H*H),
  H = C^T G;
- the solve branch (``solve_mode='solve'``, and every full covariance):
  A = Lu^{-1} Kuf (then Lu^{-T} A unless white) by triangular solves,
  mean A^T q_mu and variance Kff + A^T SK A, the diagonal clamped at 0.

On a CUDA tensor every RBF gram here (Kuu, Kuf, the full-covariance Kff)
is the ``rbf_gram`` kernel, also where the RBF is a factor of a ``Sum``
or a ``Product``; the other kernels take the solve or staged-inverse
branch.  With ``input_prop_dim`` p a layer's samples, means and variances
carry the first p columns of its input in front of its outputs (input
propagation: the next layer sees the data beside the hidden samples).

The collapsed final layer of ``DGPCollapsed`` and every layer of
``DGPDamianou`` is ``SGPRLayer`` (the JAX ``CollapsedLayer`` /
``SGPRLayer``): the Titsias bound with certain inputs, or with Gaussian
inputs through the psi statistics (``ops/psi_stats.py``, whose RBF psi2
data sum runs in the psi2 kernel), and its diagonal predictive
conditional.  ``GPRLayer`` is the collapsed exact-GPR layer with its exact
marginal likelihood (the single-layer ``GPR`` baseline).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..graphs import randn
from ..ops.kernels import RBF, Sum, White
from ..ops.linalg import (add_jitter, cholesky_nan, gauss_kl_nonwhite,
                          gauss_kl_white, inv_lower, mvn_logpdf,
                          reparameterize, safe_cholesky,
                          safe_cholesky_ladder, tri_solve)
from ..ops.cuda.conditional import fused_conditional, fused_conditional_saved
from ..ops.psi_stats import psi_statistics
from ..utils.params import Param
from .mean_functions import Zero

__all__ = ["Layer", "SVGPLayer", "SGPMCLayer", "GPMCLayer", "CollapsedData",
           "CollapsedLayer", "GPRLayer", "SGPRLayer"]


class Layer(nn.Module):
    """Base layer: multisample conditional, reparameterized sampling and
    input propagation.  Subclasses set ``jitter``, the sampling jitter,
    and may set ``input_prop_dim``."""

    input_prop_dim = None

    @property
    def num_outputs(self):
        raise NotImplementedError

    def conditional_ND(self, X, full_cov=False):
        """Mean (B, D_out) and variance (B, D_out), or (B, B, D_out) with
        ``full_cov``, at X (B, D_in)."""
        raise NotImplementedError

    def KL(self):
        """0: a layer without an inducing posterior adds no KL term."""
        t = next(self.parameters(), None)
        return torch.zeros((), dtype=torch.float64 if t is None else t.dtype,
                           device=None if t is None else t.device)

    def conditional_SND(self, X, full_cov=False):
        """Conditional over X (S, N, D_in), independent over S.  Diagonal:
        one flattened (S*N, D_in) batch; ``full_cov``: one conditional per
        sample, var (S, N, N, D_out)."""
        S, N, D = X.shape
        if full_cov:
            outs = [self.conditional_ND(x, full_cov=True) for x in X]
            mean = torch.stack([m for m, _ in outs])
            var = torch.stack([v for _, v in outs])
            if var.shape[-1] == 1 and self.num_outputs > 1:
                var = var.expand(S, N, N, self.num_outputs)
            return mean, var
        mean, var = self.conditional_ND(X.reshape(S * N, D))
        if var.shape[-1] == 1 and self.num_outputs > 1:
            var = var.expand(S * N, self.num_outputs)
        return (mean.reshape(S, N, self.num_outputs),
                var.reshape(S, N, self.num_outputs))

    def draw_z(self, X, generator):
        """The unit normals a sample at X (S, N, D_in) draws from
        ``generator`` (a ``torch.Generator`` or a ``graphs.DrawTape``):
        (S, N, D_out) in X's dtype, on X's device."""
        if generator is None:
            raise ValueError("need a generator when z is not given")
        return randn((X.shape[0], X.shape[1], self.num_outputs), generator,
                     X.dtype, X.device)

    def sample_from_conditional(self, X, z=None, generator=None,
                                full_cov=False):
        """Conditional + reparameterized sample.  X: (S, N, D_in).  Give
        either fixed unit normals ``z`` (broadcastable to (S, N, D_out)) or
        a ``torch.Generator`` on X's device.  With ``input_prop_dim`` p the
        first p columns of X go in front of the samples and the means, with
        zero variance."""
        mean, var = self.conditional_SND(X, full_cov=full_cov)
        S, N = X.shape[0], X.shape[1]
        if z is None:
            z = self.draw_z(X, generator)
        else:
            z = torch.as_tensor(z, dtype=mean.dtype, device=mean.device
                                ).expand(S, N, self.num_outputs)
        samples = reparameterize(mean, var, z, self.jitter, full_cov=full_cov)
        p = self.input_prop_dim
        if p:
            X_prop = X[:, :, :p]
            samples = torch.cat([X_prop, samples], dim=2)
            mean = torch.cat([X_prop, mean], dim=2)
            zeros = (var.new_zeros(S, N, N, p) if full_cov
                     else torch.zeros_like(X_prop))
            var = torch.cat([zeros, var], dim=-1)
        return samples, mean, var


def _fusable_rbf(kern):
    """(rbf, total white variance) if the kernel is RBF or Sum(RBF,
    White...), else None (the fused conditional covers only that
    family)."""
    if isinstance(kern, RBF):
        return kern, None
    if isinstance(kern, Sum):
        rbf, white = None, None
        for k in kern.kernels:
            if isinstance(k, RBF) and rbf is None:
                rbf = k
            elif isinstance(k, White):
                v = k.variance.value
                white = v if white is None else white + v
            else:
                return None
        if rbf is not None:
            return rbf, white
    return None


def _check_use_pallas(use_pallas):
    """``Config`` admits False, True and 'saved' only; a value set past it
    (``with_config(m, use_pallas='auto')``) is refused here, as the JAX
    layer refuses 'auto' and 'auto_saved': nothing routes a path through
    the fused kernel by a shape gate."""
    if use_pallas not in (False, True, "saved"):
        raise ValueError(
            f"use_pallas={use_pallas!r} is not a layer setting: use "
            f"use_pallas=True or 'saved' to opt in to the fused_conditional "
            f"kernel explicitly, or False")


def _host_gram(kern, Z):
    """Build-time gram in float64 on the host, never on the card: an f32
    gram there can leave the initial q_sqrt indefinite."""
    host = copy.deepcopy(kern).to(device="cpu", dtype=torch.float64)
    with torch.no_grad():
        return host.K(torch.as_tensor(Z, dtype=torch.float64)).numpy()


def _host_cholesky(K, jitter):
    """numpy Cholesky with escalating jitter (build-time analogue of
    ops.linalg.safe_cholesky)."""
    M = K.shape[0]
    for factor in (1.0, 1e2, 1e4, 1e6):
        try:
            return np.linalg.cholesky(K + np.eye(M) * (jitter * factor))
        except np.linalg.LinAlgError:
            continue
    raise np.linalg.LinAlgError(
        "gram not positive definite even with escalated jitter")


def _init_q_sqrt(Z, kern, num_outputs, white, jitter):
    """Identity init (white) or prior Cholesky init (non-white)."""
    M = Z.shape[0]
    if white:
        return np.tile(np.eye(M)[None], [num_outputs, 1, 1])
    Lu = _host_cholesky(_host_gram(kern, Z), jitter)
    return np.tile(Lu[None], [num_outputs, 1, 1])


class SVGPLayer(Layer):
    """Sparse variational GP layer: kernel, inducing inputs Z (M, D_in),
    q_mu (M, D_out), lower-triangular q_sqrt (D_out, M, M), mean function,
    the whitening flag and ``input_prop_dim`` (None: no input
    propagation).  Numerics fields are snapshotted from ``config``.  A
    subclass without a ``q_sqrt`` (``SGPMCLayer``: q(u) is a point mass)
    gets the (1, M, M) covariance core -{I | Ku} and a 1-column variance
    on every branch but the fused one, which gives (B, D_out)."""

    _has_q_sqrt = True

    def __init__(self, kern, Z, num_outputs, mean_function=None,
                 white=False, input_prop_dim=None, config=Config()):
        super().__init__()
        Z = np.asarray(Z, dtype=np.float64)
        if Z.shape[1] != kern.input_dim:
            raise ValueError(
                f"SVGPLayer: kernel expects input_dim={kern.input_dim} but "
                f"Z has shape {Z.shape}")
        M = Z.shape[0]
        self.kern = kern
        self.num_outputs_ = int(num_outputs)
        self.white = bool(white)
        self.input_prop_dim = input_prop_dim
        self.jitter = float(config.jitter)
        self.solve_mode = config.solve_mode
        self.use_pallas = config.use_pallas
        self.precision = config.precision
        self.Z = Param(Z)
        self.q_mu = Param(np.zeros((M, num_outputs)))
        self.q_sqrt = (Param(_init_q_sqrt(Z, kern, num_outputs, white,
                                          self.jitter), "triangular")
                       if self._has_q_sqrt else None)
        # registered last, as the JAX field order (kern, Z, q_mu, q_sqrt,
        # mean_function), which ``named_parameters`` and ``summary`` follow
        self.mean_function = (Zero(num_outputs) if mean_function is None
                              else mean_function)

    @property
    def num_outputs(self):
        return self.num_outputs_

    @property
    def num_inducing(self):
        return self.Z.unconstrained.shape[0]

    def _chol_Kuu(self):
        K = self.kern.K(self.Z.value)
        return add_jitter(K, self.jitter), safe_cholesky(K, self.jitter)

    def _SK(self, Ku):
        """q_sqrt q_sqrt^T - {I | Ku}: the (D, M, M) covariance core, or
        (1, M, M) without a q_sqrt."""
        I = torch.eye(self.num_inducing, dtype=Ku.dtype, device=Ku.device)
        SK = -I[None] if self.white else -Ku[None]
        if self.q_sqrt is None:
            return SK
        q_sqrt = self.q_sqrt.value
        return SK + torch.einsum("dij,dkj->dik", q_sqrt, q_sqrt)

    def conditional_ND(self, X, full_cov=False):
        """Sparse conditional at X (B, D_in): mean (B, D_out), var (B,
        D_out), or (B, B, D_out) with ``full_cov``."""
        _check_use_pallas(self.use_pallas)
        if (self.use_pallas and not full_cov
                and _fusable_rbf(self.kern) is not None):
            return self._conditional_fused(X)
        Kuf = self.kern.K(self.Z.value, X)                      # (M, B)
        if self.solve_mode == "solve" or full_cov:
            return self._conditional_solve(X, Kuf, full_cov)
        # staged inverse, sum-of-squares variance (JAX layers.py:337-409)
        _, Lu = self._chol_Kuu()
        Li = inv_lower(Lu)
        G = Li @ Kuf                                            # (M, B)
        q_sqrt = None if self.q_sqrt is None else self.q_sqrt.value
        if self.white:
            alpha, C = self.q_mu.value, q_sqrt
        else:
            alpha = Li @ self.q_mu.value                        # (M, D)
            C = (None if q_sqrt is None
                 else torch.einsum("ij,djk->dik", Li, q_sqrt))
        mean = G.T @ alpha                                      # (B, D)
        resid = self.kern.Kdiag(X) - torch.sum(G * G, dim=0)    # (B,)
        if C is None:
            var = resid[:, None]                                # (B, 1)
        else:
            D_, M_, _ = C.shape
            CT = C.transpose(-1, -2).reshape(D_ * M_, M_)
            H = (CT @ G).reshape(D_, M_, G.shape[1])            # (D, M, B)
            var = resid[:, None] + torch.sum(H * H, dim=1).T
        var = torch.clamp(var, min=0.0)
        return mean + self.mean_function(X), var

    def _conditional_solve(self, X, Kuf, full_cov):
        """Triangular-solve branch (JAX layers.py:411-431): A = Lu^{-1}
        Kuf, then Lu^{-T} A unless white; var = Kff + A^T SK A."""
        Ku, Lu = self._chol_Kuu()
        SK = self._SK(Ku)
        A = tri_solve(Lu, Kuf, lower=True, mode=self.solve_mode)
        if not self.white:
            A = tri_solve(Lu, A, lower=True, trans=True,
                          mode=self.solve_mode)                 # Ku^{-1} Kuf
        mean = A.T @ self.q_mu.value                            # (B, D)
        B = torch.einsum("dij,jb->dib", SK, A)                  # (D|1, M, B)
        if full_cov:
            delta = torch.einsum("ib,dic->dbc", A, B)           # (D, B, B)
            var = (self.kern.K(X)[None] + delta).permute(1, 2, 0)
        else:
            delta = torch.einsum("ib,dib->db", A, B)            # (D, B)
            # clamp float32 cancellation noise (Kff ~ Qff) at zero
            var = torch.clamp((self.kern.Kdiag(X)[None] + delta).T, min=0.0)
        return mean + self.mean_function(X), var

    def _conditional_fused(self, X):
        """Fused branch: stage LiT, alpha, W here (fp32 in the order of the
        JAX code, so the f32 cancellation in SK and W matches), then one
        fused kernel call for gram, staging, mean and variance."""
        rbf, white_var = _fusable_rbf(self.kern)
        Ku, Lu = self._chol_Kuu()
        SK = self._SK(Ku)
        Li = inv_lower(Lu)
        if self.white:
            alpha, W = self.q_mu.value, SK
        else:
            alpha = Li @ self.q_mu.value                        # (M, D)
            W = (Li @ SK) @ Li.T                                # (D|1, M, M)
        if W.shape[0] != alpha.shape[1]:
            # no q_sqrt: the broadcast (1, M, M) core, one per output for
            # the kernel; autograd sums its W gradient over the outputs
            W = W.expand(alpha.shape[1], -1, -1)
        ls = rbf.lengthscales.value
        kvar = rbf.variance.value
        kdiag = kvar if white_var is None else kvar + white_var
        fc = (fused_conditional_saved if self.use_pallas == "saved"
              else fused_conditional)
        mean, var = fc(
            (X / ls).contiguous(), (self.Z.value / ls).contiguous(),
            Li.T.contiguous(), alpha.contiguous(), W.contiguous(),
            kvar, kdiag)
        return mean + self.mean_function(X), var

    def KL(self):
        """Analytic KL(q(u) || p(u)), summed over output dims; 0 without a
        q_sqrt (the prior then enters through ``log_prior``)."""
        if self.q_sqrt is None:
            return torch.zeros((), dtype=self.q_mu.unconstrained.dtype,
                               device=self.q_mu.unconstrained.device)
        q_mu, q_sqrt = self.q_mu.value, self.q_sqrt.value
        if self.white:
            return gauss_kl_white(q_mu, q_sqrt)
        _, Lu = self._chol_Kuu()
        return gauss_kl_nonwhite(q_mu, q_sqrt, Lu)


class SGPMCLayer(SVGPLayer):
    """Sparse layer for MCMC over the inducing values: no q_sqrt, a unit
    Gaussian prior on q_mu, ``KL() == 0`` (the prior enters the sampler's
    target through ``log_prior``)."""

    _has_q_sqrt = False

    def __init__(self, kern, Z, num_outputs, mean_function=None,
                 white=False, input_prop_dim=None, config=Config()):
        super().__init__(kern, Z, num_outputs, mean_function, white,
                         input_prop_dim, config)
        self.q_mu.prior = ("gaussian", 0.0, 1.0)


class GPMCLayer(Layer):
    """Dense layer on fixed inputs X (N, D_in) for MCMC: buffers
    ``X_fixed`` and ``Lu`` = chol(K(X) + jitter I), computed on the host in
    float64 at build time; q_mu (N, D_out) carries a unit Gaussian prior.
    Its latents at X are the deterministic ``build_latents``, and at new
    inputs the whitened dense conditional.  Numerics fields (``jitter``,
    ``solve_mode``) are snapshotted from ``config``."""

    def __init__(self, kern, X, num_outputs, mean_function=None,
                 input_prop_dim=None, config=Config()):
        super().__init__()
        X = np.asarray(X, dtype=np.float64)
        self.kern = kern
        self.num_outputs_ = int(num_outputs)
        self.input_prop_dim = input_prop_dim
        self.jitter = float(config.jitter)
        self.solve_mode = config.solve_mode
        Lu = _host_cholesky(_host_gram(kern, X), self.jitter)
        self.register_buffer("X_fixed", torch.as_tensor(X))
        self.register_buffer("Lu", torch.as_tensor(Lu))
        self.q_mu = Param(np.zeros((X.shape[0], num_outputs)),
                          prior=("gaussian", 0.0, 1.0))
        # after q_mu, as the JAX field order
        self.mean_function = (Zero(num_outputs) if mean_function is None
                              else mean_function)

    @property
    def num_outputs(self):
        return self.num_outputs_

    def build_latents(self):
        """The latents at X: Lu q_mu + m(X), (N, D_out), with the first
        ``input_prop_dim`` columns of X in front."""
        f = self.Lu @ self.q_mu.value + self.mean_function(self.X_fixed)
        if self.input_prop_dim:
            f = torch.cat([self.X_fixed[:, :self.input_prop_dim], f], dim=1)
        return f

    def conditional_ND(self, X, full_cov=False):
        """Whitened dense conditional with q_sqrt None at X (B, D_in): A =
        Lu^{-1} K(X_fixed, X), mean A^T q_mu + m(X), var K(X) - A^T A
        (diagonal clamped at 0) repeated over the outputs."""
        Kuf = self.kern.K(self.X_fixed, X)                      # (N, B)
        A = tri_solve(self.Lu, Kuf, lower=True, mode=self.solve_mode)
        mean = A.T @ self.q_mu.value + self.mean_function(X)
        D = self.num_outputs
        if full_cov:
            var = self.kern.K(X) - A.T @ A                      # (B, B)
            return mean, var[:, :, None].expand(-1, -1, D)
        var = torch.clamp(self.kern.Kdiag(X) - torch.sum(A ** 2, dim=0),
                          min=0.0)
        return mean, var[:, None].expand(-1, D)


class CollapsedData(NamedTuple):
    """The data a collapsed layer is collapsed on: inputs N(X_mean,
    diag(X_var)) (X_var None: certain inputs), targets Y and the noise
    variance."""
    X_mean: torch.Tensor
    X_var: Optional[torch.Tensor]
    Y: torch.Tensor
    lik_variance: torch.Tensor


class CollapsedLayer(Layer):
    """A layer whose output GP is integrated out analytically.  The data
    it is collapsed on is passed explicitly: ``set_data`` returns a
    shallow view of the layer whose ``data`` holds it (the view shares
    the layer's parameters and submodules, so gradients reach them; a
    deep copy would not)."""

    data = None

    def set_data(self, X_mean, X_var, Y, lik_variance):
        view = copy.copy(self)
        view.data = CollapsedData(X_mean, X_var, Y, lik_variance)
        return view

    def build_likelihood(self):
        raise NotImplementedError


class GPRLayer(CollapsedLayer):
    """Collapsed exact-GPR layer on certain inputs: the data's own gram K +
    sigma^2 I, its exact marginal likelihood and predictive conditional.
    Numerics fields (``jitter``, the sampling jitter, and ``solve_mode``)
    are snapshotted from ``config``."""

    def __init__(self, kern, mean_function, num_outputs, config=Config()):
        super().__init__()
        self.kern = kern
        self.mean_function = mean_function
        self.num_outputs_ = int(num_outputs)
        self.jitter = float(config.jitter)
        self.solve_mode = config.solve_mode

    @property
    def num_outputs(self):
        return self.num_outputs_

    def _chol(self):
        """chol(K(X) + sigma^2 I), NaN where it fails (the JAX
        ``jnp.linalg.cholesky``: no jitter, no escalation)."""
        X = self.data.X_mean
        return cholesky_nan(add_jitter(self.kern.K(X),
                                       self.data.lik_variance))

    def conditional_ND(self, X, full_cov=False):
        """Predictive conditional at X (B, D_in): mean (B, D_Y) and var
        (B, D_Y), or (B, B, D_Y) with ``full_cov``."""
        X_data, Y = self.data.X_mean, self.data.Y
        L = self._chol()
        A = tri_solve(L, self.kern.K(X_data, X), lower=True,
                      mode=self.solve_mode)                    # (N, B)
        V = tri_solve(L, Y - self.mean_function(X_data), lower=True,
                      mode=self.solve_mode)
        mean = A.T @ V + self.mean_function(X)
        D_Y = Y.shape[1]
        if full_cov:
            var = self.kern.K(X) - A.T @ A
            return mean, var[:, :, None].expand(-1, -1, D_Y)
        # clamp float32 cancellation noise at zero (the SVGP policy)
        var = torch.clamp(self.kern.Kdiag(X) - torch.sum(A ** 2, dim=0),
                          min=0.0)
        return mean, var[:, None].expand(-1, D_Y)

    def build_likelihood(self):
        """The exact log marginal likelihood, summed over the outputs."""
        X_data, Y = self.data.X_mean, self.data.Y
        return torch.sum(mvn_logpdf(Y, self.mean_function(X_data),
                                    self._chol()))


class SGPRLayer(CollapsedLayer):
    """Collapsed sparse (Titsias) layer with inducing inputs Z (M, D_in),
    on certain inputs (``X_var`` None) or on Gaussian inputs N(X_mean,
    diag(X_var)) through the psi statistics.  Numerics fields
    (``jitter``, ``solve_mode``, ``psi2_impl``) are snapshotted from
    ``config``."""

    # In float32 the bound's +-||Y||^2 / (2 sigma^2)-scale terms lose all
    # significance once sigma^2 drops below ~1e-4 (the B-solve error grows
    # like cond(B) eps ~ eps / sigma^2, and an optimizer then chases the
    # positive bias); the float32 bound clamps the variance it uses here,
    # which also zeroes the runaway gradient direction at the floor.
    F32_VARIANCE_FLOOR = 1e-4

    def __init__(self, kern, Z, num_outputs, mean_function, config=Config()):
        super().__init__()
        Z = np.asarray(Z, dtype=np.float64)
        if Z.shape[1] != kern.input_dim:
            raise ValueError(
                f"SGPRLayer: kernel expects input_dim={kern.input_dim} but "
                f"Z has shape {Z.shape}")
        self.kern = kern
        self.Z = Param(Z)
        self.mean_function = mean_function
        self.num_outputs_ = int(num_outputs)
        self.jitter = float(config.jitter)
        self.solve_mode = config.solve_mode
        self.psi2_impl = config.psi2_impl

    @property
    def num_outputs(self):
        return self.num_outputs_

    def _bound_variance(self):
        v = self.data.lik_variance
        if v.dtype == torch.float32:
            return torch.clamp(v, min=self.F32_VARIANCE_FLOOR)
        return v

    def _common(self):
        """The factorization pieces of the bound: (L, A, AAT, LB, c and
        err) on certain inputs, (L, A, AAT, LB, c and psi0) through the
        psi statistics on Gaussian inputs.  Every contraction is full
        fp32 (or f64): a reduced-precision B = I + L^-1 psi2 L^-T /
        sigma^2 goes indefinite at scale.  LB uses the 0.0-first relative
        jitter ladder: B >= I by construction, so a failure is rounding
        garbage, and the float64 path stays exact."""
        Z = self.Z.value
        M = Z.shape[0]
        variance = self._bound_variance()
        sigma = torch.sqrt(variance)
        mode = self.solve_mode
        I = torch.eye(M, dtype=Z.dtype, device=Z.device)
        X_mean, X_var, Y, _ = self.data
        L = safe_cholesky(self.kern.K(Z), self.jitter)
        if X_var is None:
            err = Y - self.mean_function(X_mean)
            Kuf = self.kern.K(Z, X_mean)
            A = tri_solve(L, Kuf, lower=True, mode=mode) / sigma
            AAT = A @ A.T
            LB = safe_cholesky_ladder(AAT + I)
            c = tri_solve(LB, A @ err, lower=True, mode=mode) / sigma
            return dict(L=L, A=A, AAT=AAT, LB=LB, c=c, err=err)
        psi0, psi1, psi2s = psi_statistics(self.kern, X_mean, X_var, Z,
                                           self.psi2_impl)
        A = tri_solve(L, psi1.T, lower=True, mode=mode) / sigma
        tmp = tri_solve(L, psi2s, lower=True, mode=mode)
        AAT = tri_solve(L, tmp.T, lower=True, mode=mode) / variance
        # exact symmetry before the Cholesky (the two sequential solves
        # are not numerically symmetric).  Do NOT put jitter on psi2 and
        # refactor: eps I on psi2 leaks through L^-1 (psi2 + eps I) L^-T as
        # eps tr(Kuu^-1) / sigma^2 into the trace term and *raises* the
        # bound invalidly; jitter on B only grows log|B|, which lowers it.
        AAT = 0.5 * (AAT + AAT.T)
        LB = safe_cholesky_ladder(AAT + I)
        c = tri_solve(LB, A @ Y, lower=True, mode=mode) / sigma
        return dict(L=L, A=A, AAT=AAT, LB=LB, c=c, psi0=psi0)

    def build_likelihood(self, cm=None):
        """The collapsed bound.  ``cm``: a precomputed ``_common()``, for
        callers that also need its pieces (``DGPDamianou.elbo``)."""
        variance = self._bound_variance()
        X_mean, X_var, Y, _ = self.data
        num_data, output_dim = Y.shape
        cm = self._common() if cm is None else cm
        LB, c, AAT = cm["LB"], cm["c"], cm["AAT"]
        if X_var is None:
            err = cm["err"]
            Kdiag = self.kern.Kdiag(X_mean)
            bound = -0.5 * num_data * output_dim * np.log(2 * np.pi)
            bound = bound - output_dim * torch.sum(torch.log(
                torch.diagonal(LB)))
            bound = bound - 0.5 * num_data * output_dim * torch.log(variance)
            bound = bound - 0.5 * torch.sum(err ** 2) / variance
            bound = bound + 0.5 * torch.sum(c ** 2)
            bound = bound - 0.5 * output_dim * torch.sum(Kdiag) / variance
            return bound + 0.5 * output_dim * torch.sum(torch.diagonal(AAT))
        psi0 = cm["psi0"]
        log_det_B = 2.0 * torch.sum(torch.log(torch.diagonal(LB)))
        bound = -0.5 * Y.numel() * torch.log(2 * np.pi * variance)
        bound = bound - 0.5 * output_dim * log_det_B
        bound = bound - 0.5 * torch.sum(Y ** 2) / variance
        bound = bound + 0.5 * torch.sum(c ** 2)
        return bound - 0.5 * output_dim * (torch.sum(psi0) / variance
                                           - torch.sum(torch.diagonal(AAT)))

    def conditional_ND(self, X, full_cov=False):
        """Predictive conditional at X (B, D_in): mean (B, D_Y) and var
        (B, D_Y), or (B, B, D_Y) with ``full_cov``."""
        cm = self._common()
        L, LB, c = cm["L"], cm["LB"], cm["c"]
        tmp1 = tri_solve(L, self.kern.K(self.Z.value, X), lower=True,
                         mode=self.solve_mode)
        tmp2 = tri_solve(LB, tmp1, lower=True, mode=self.solve_mode)
        mean = tmp2.T @ c
        D_Y = self.data.Y.shape[1]
        if full_cov:
            var = self.kern.K(X) + tmp2.T @ tmp2 - tmp1.T @ tmp1
            var = var[:, :, None].expand(-1, -1, D_Y)
        else:
            # clamp float32 cancellation noise at zero (the SVGP policy)
            var = torch.clamp(self.kern.Kdiag(X)
                              + torch.sum(tmp2 ** 2, dim=0)
                              - torch.sum(tmp1 ** 2, dim=0), min=0.0)
            var = var[:, None].expand(-1, D_Y)
        return mean + self.mean_function(X), var
