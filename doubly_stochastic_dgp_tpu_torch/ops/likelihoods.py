"""Likelihoods: Gaussian, Bernoulli, MultiClass (robust-max), Poisson,
Exponential, StudentT, Gamma, Beta, Ordinal.

Counterpart of ``doubly_stochastic_dgp_tpu/ops/likelihoods.py``: the
methods ``logp``, ``conditional_mean``, ``conditional_variance``,
``variational_expectations``, ``predict_mean_and_var`` and
``predict_density``, each broadcasting over leading sample dims, so (S,
N, D) moments against (N, D) targets work as in the JAX package.  The
expectations without a closed form use Gauss-Hermite quadrature
(``ops/quadrature.py``, 20 points by default).  Parameters are ``Param``s
and buffers under the JAX field names, so ``convert.load_reference_state``
carries a JAX likelihood over.

Labels arrive as floats, (N, 1), and are cast with ``.long()``.  One-hot
rows are formed by a comparison with ``arange``: ``F.one_hot`` reads the
labels' minimum and maximum on the host when they lie on the CPU, which a
captured CUDA graph (and ``graphs.no_host_reads``) cannot have.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.params import Param
from .quadrature import gh_tensors, ndiagquad

__all__ = [
    "Likelihood", "Gaussian", "Bernoulli", "MultiClass", "Poisson",
    "Exponential", "StudentT", "Gamma", "Beta", "Ordinal",
]

DEFAULT_NUM_GH = 20


def _inv_probit(x):
    jitter = 1e-3  # keeps the output strictly inside (0, 1), as in GPflow
    return (0.5 * (1.0 + torch.erf(x / math.sqrt(2.0))) * (1 - 2 * jitter)
            + jitter)


def _one_hot(idx, K, dtype):
    """(..., K) one-hot rows of the integer tensor ``idx``, in ``dtype``."""
    return (idx[..., None] == torch.arange(K, device=idx.device)).to(dtype)


class Likelihood(nn.Module):
    """Base likelihood with the quadrature defaults.  Fmu/Fvar may be (N,
    D) or (S, N, D); Y is (N, D)."""

    # does log p(Y | F) split into per-output-dim terms?  True for every
    # elementwise likelihood; MultiClass (robust-max couples the K latent
    # dims) overrides it.  A property of the type, not of an instance
    factorizes_over_dims = True

    def __init__(self, num_gauss_hermite_points=DEFAULT_NUM_GH):
        super().__init__()
        self.num_gauss_hermite_points = int(num_gauss_hermite_points)

    # -- to be provided by subclasses ------------------------------------
    def logp(self, F, Y):
        raise NotImplementedError

    def conditional_mean(self, F):
        raise NotImplementedError

    def conditional_variance(self, F):
        raise NotImplementedError

    # -- quadrature defaults ----------------------------------------------
    def variational_expectations(self, Fmu, Fvar, Y):
        """E_{N(f; Fmu, Fvar)}[log p(Y | f)], elementwise."""
        return ndiagquad(lambda X, Y: self.logp(X, Y),
                         self.num_gauss_hermite_points, Fmu, Fvar, Y=Y)

    def predict_mean_and_var(self, Fmu, Fvar):
        """Mean and variance of Y under the predictive: the conditional
        moments integrated over N(f; Fmu, Fvar)."""
        integrands = [
            lambda X: self.conditional_mean(X),
            lambda X: (self.conditional_variance(X)
                       + self.conditional_mean(X) ** 2),
        ]
        E_y, E_y2 = ndiagquad(integrands, self.num_gauss_hermite_points,
                              Fmu, Fvar)
        return E_y, E_y2 - E_y ** 2

    def predict_density(self, Fmu, Fvar, Y):
        """log E_{N(f; Fmu, Fvar)}[p(Y | f)], elementwise."""
        return ndiagquad(lambda X, Y: self.logp(X, Y),
                         self.num_gauss_hermite_points, Fmu, Fvar,
                         logspace=True, Y=Y)


class Gaussian(Likelihood):
    """Gaussian noise, every expectation in closed form."""

    def __init__(self, variance=1.0, trainable=True,
                 num_gauss_hermite_points=DEFAULT_NUM_GH):
        super().__init__(num_gauss_hermite_points)
        self.variance = Param(variance, "positive", trainable)

    def logp(self, F, Y):
        v = self.variance.value
        return -0.5 * torch.log(2 * math.pi * v) - 0.5 * (Y - F) ** 2 / v

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        return torch.ones_like(F) * self.variance.value

    def variational_expectations(self, Fmu, Fvar, Y):
        v = self.variance.value
        return (-0.5 * math.log(2 * math.pi) - 0.5 * torch.log(v)
                - 0.5 * ((Y - Fmu) ** 2 + Fvar) / v)

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance.value

    def predict_density(self, Fmu, Fvar, Y):
        v = Fvar + self.variance.value
        return -0.5 * torch.log(2 * math.pi * v) - 0.5 * (Y - Fmu) ** 2 / v


class Bernoulli(Likelihood):
    """Bernoulli with the probit link.  Y == 1 is success; anything else
    (0 or -1) is failure."""

    @staticmethod
    def _bernoulli(p, Y):
        return torch.where(Y == 1, p, 1.0 - p)

    def logp(self, F, Y):
        return torch.log(self._bernoulli(_inv_probit(F), Y))

    def conditional_mean(self, F):
        return _inv_probit(F)

    def conditional_variance(self, F):
        p = _inv_probit(F)
        return p - p ** 2

    def predict_mean_and_var(self, Fmu, Fvar):
        # closed form for the probit link
        p = _inv_probit(Fmu / torch.sqrt(1.0 + Fvar))
        return p, p - p ** 2

    def predict_density(self, Fmu, Fvar, Y):
        p = _inv_probit(Fmu / torch.sqrt(1.0 + Fvar))
        return torch.log(self._bernoulli(p, Y))


class MultiClass(Likelihood):
    """Multiclass classification with the robust-max link:

    p(y = k | f) = 1 - eps            if k == argmax(f)
                 = eps / (K - 1)      otherwise

    F is (..., N, K); Y is (N, 1) class labels (floats holding integers).
    The variational expectations and the predictive probabilities need
    the probability that dimension k is the largest under independent
    Gaussians: 1D Gauss-Hermite quadrature over the selected dimension of
    a product of normal CDFs (GPflow's RobustMax construction)."""

    factorizes_over_dims = False

    def __init__(self, num_classes, epsilon=1e-3,
                 num_gauss_hermite_points=DEFAULT_NUM_GH):
        super().__init__(num_gauss_hermite_points)
        self.num_classes = int(num_classes)
        self.epsilon = float(epsilon)

    def _rm_probs(self, F):
        """(1 - eps) at the argmax, eps / (K - 1) elsewhere; F (..., K)."""
        K = self.num_classes
        oh = _one_hot(torch.argmax(F, dim=-1), K, F.dtype)
        return oh * (1.0 - self.epsilon) + (1.0 - oh) * (self.epsilon
                                                         / (K - 1))

    def _prob_is_largest(self, Y, Fmu, Fvar):
        """P[f_y >= f_j for all j] under independent N(Fmu, Fvar).

        Fmu, Fvar (..., N, K); Y (N, 1).  Returns (..., N, 1)."""
        gh_x, gh_w = gh_tensors(self.num_gauss_hermite_points, Fmu.dtype,
                                Fmu.device)
        oh = _one_hot(Y[..., 0].long(), self.num_classes, Fmu.dtype)
        mu_sel = torch.sum(Fmu * oh, dim=-1, keepdim=True)     # (..., N, 1)
        # floor: the conditional variance is clamped at 0 upstream, and
        # d sqrt(v)/dv is infinite at v = 0 (a finite forward with
        # infinite gradients); clamp_min has zero gradient below the
        # floor, so the floor is safe for gradients
        var_sel = torch.clamp_min(
            torch.sum(Fvar * oh, dim=-1, keepdim=True), 1e-10)
        X = mu_sel + torch.sqrt(2.0 * var_sel) * gh_x          # (..., N, H)
        dist = (X[..., None, :] - Fmu[..., None]) / torch.sqrt(
            torch.clamp_min(Fvar[..., None], 1e-10))          # (..., N, K, H)
        cdfs = 0.5 * (1.0 + torch.erf(dist / math.sqrt(2.0)))
        cdfs = cdfs * (1 - 2e-4) + 1e-4
        # drop the selected dimension from the product
        cdfs = cdfs * (1.0 - oh[..., None]) + oh[..., None]
        p = torch.sum(torch.prod(cdfs, dim=-2) * gh_w, dim=-1)  # (..., N)
        return p[..., None]

    def logp(self, F, Y):
        hits = torch.argmax(F, dim=-1) == Y[..., 0].long()
        no = torch.full(hits.shape, math.log(
            self.epsilon / (self.num_classes - 1)), dtype=F.dtype,
            device=F.device)
        return torch.where(hits, math.log(1.0 - self.epsilon), no)[..., None]

    def conditional_mean(self, F):
        return self._rm_probs(F)

    def conditional_variance(self, F):
        p = self._rm_probs(F)
        return p - p ** 2

    def _mix(self, p):
        K = self.num_classes
        return p * (1.0 - self.epsilon) + (1.0 - p) * (self.epsilon
                                                       / (K - 1))

    def variational_expectations(self, Fmu, Fvar, Y):
        p = self._prob_is_largest(Y, Fmu, Fvar)
        K = self.num_classes
        return (p * math.log(1.0 - self.epsilon)
                + (1.0 - p) * math.log(self.epsilon / (K - 1)))

    def predict_mean_and_var(self, Fmu, Fvar):
        N = Fmu.shape[-2]
        p = torch.cat([
            self._prob_is_largest(
                torch.full((N, 1), k, dtype=Fmu.dtype, device=Fmu.device),
                Fmu, Fvar)
            for k in range(self.num_classes)], dim=-1)        # (..., N, K)
        mu = self._mix(p)
        return mu, mu - mu ** 2

    def predict_density(self, Fmu, Fvar, Y):
        return torch.log(self._mix(self._prob_is_largest(Y, Fmu, Fvar)))


class Poisson(Likelihood):
    """Poisson with the exp link; closed-form variational expectations."""

    def __init__(self, binsize=1.0, num_gauss_hermite_points=DEFAULT_NUM_GH):
        super().__init__(num_gauss_hermite_points)
        self.binsize = float(binsize)

    def logp(self, F, Y):
        lam = torch.exp(F) * self.binsize
        return Y * torch.log(lam) - lam - torch.lgamma(Y + 1.0)

    def conditional_mean(self, F):
        return torch.exp(F) * self.binsize

    def conditional_variance(self, F):
        return torch.exp(F) * self.binsize

    def variational_expectations(self, Fmu, Fvar, Y):
        return (Y * Fmu - torch.exp(Fmu + Fvar / 2.0) * self.binsize
                - torch.lgamma(Y + 1.0) + Y * math.log(self.binsize))


class Exponential(Likelihood):
    """Exponential with the exp link: p(y | f) = exp(-y e^{-f} - f)."""

    def logp(self, F, Y):
        return -F - Y * torch.exp(-F)

    def conditional_mean(self, F):
        return torch.exp(F)

    def conditional_variance(self, F):
        return torch.exp(2.0 * F)

    def variational_expectations(self, Fmu, Fvar, Y):
        return -Fmu - Y * torch.exp(-Fmu + Fvar / 2.0)


class StudentT(Likelihood):
    """Student-t observation noise with the identity link."""

    def __init__(self, scale=1.0, df=3.0, trainable=True,
                 num_gauss_hermite_points=DEFAULT_NUM_GH):
        super().__init__(num_gauss_hermite_points)
        self.scale = Param(scale, "positive", trainable)
        self.df = float(df)

    def logp(self, F, Y):
        nu = self.df
        s = self.scale.value
        const = (math.lgamma((nu + 1.0) / 2.0) - math.lgamma(nu / 2.0)
                 - 0.5 * torch.log(nu * math.pi * s ** 2))
        return const - (nu + 1.0) / 2.0 * torch.log1p(((Y - F) / s) ** 2
                                                      / nu)

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        nu = self.df
        return torch.ones_like(F) * (self.scale.value ** 2 * nu
                                     / (nu - 2.0))


class Gamma(Likelihood):
    """Gamma with the exp link on the scale: y ~ Gamma(shape, scale=e^f)."""

    def __init__(self, shape=1.0, trainable=True,
                 num_gauss_hermite_points=DEFAULT_NUM_GH):
        super().__init__(num_gauss_hermite_points)
        self.shape_param = Param(shape, "positive", trainable)

    def logp(self, F, Y):
        a = self.shape_param.value
        return (-a * F - torch.lgamma(a) + (a - 1.0) * torch.log(Y)
                - Y * torch.exp(-F))

    def conditional_mean(self, F):
        return self.shape_param.value * torch.exp(F)

    def conditional_variance(self, F):
        return self.shape_param.value * torch.exp(2.0 * F)

    def variational_expectations(self, Fmu, Fvar, Y):
        a = self.shape_param.value
        return (-a * Fmu - torch.lgamma(a) + (a - 1.0) * torch.log(Y)
                - Y * torch.exp(-Fmu + Fvar / 2.0))


class Beta(Likelihood):
    """Beta with the probit mean link and a scale parameter: alpha = m
    scale, beta = (1 - m) scale, m = probit(f)."""

    def __init__(self, scale=1.0, trainable=True,
                 num_gauss_hermite_points=DEFAULT_NUM_GH):
        super().__init__(num_gauss_hermite_points)
        self.scale = Param(scale, "positive", trainable)

    def logp(self, F, Y):
        m = _inv_probit(F)
        s = self.scale.value
        alpha = m * s
        beta = s - alpha
        return ((alpha - 1.0) * torch.log(Y) + (beta - 1.0) * torch.log1p(-Y)
                + torch.lgamma(alpha + beta) - torch.lgamma(alpha)
                - torch.lgamma(beta))

    def conditional_mean(self, F):
        return _inv_probit(F)

    def conditional_variance(self, F):
        m = _inv_probit(F)
        return m * (1.0 - m) / (self.scale.value + 1.0)


class Ordinal(Likelihood):
    """Ordinal regression with fixed bin edges (a buffer, as the JAX leaf
    is an array) and a trainable latent scale: p(Y = k | f) = Phi((a_k -
    f) / sigma) - Phi((a_{k-1} - f) / sigma), GPflow's construction."""

    def __init__(self, bin_edges, sigma=1.0, trainable=True,
                 num_gauss_hermite_points=DEFAULT_NUM_GH):
        super().__init__(num_gauss_hermite_points)
        self.register_buffer("bin_edges",
                             torch.as_tensor(bin_edges, dtype=torch.float64))
        self.sigma = Param(sigma, "positive", trainable)

    @property
    def num_bins(self):
        return self.bin_edges.shape[0] + 1

    def _cum_probs(self, F):
        """P(Y <= k | f) at each bin edge, padded with 0 and 1: (...,
        E + 2)."""
        cdf = _inv_probit((self.bin_edges - F[..., None]) / self.sigma.value)
        return torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                          torch.ones_like(cdf[..., :1])], dim=-1)

    def logp(self, F, Y):
        cum = self._cum_probs(F)
        k = torch.broadcast_to(Y, torch.broadcast_shapes(F.shape, Y.shape))
        k = k.long()[..., None]
        upper = torch.gather(cum, -1, k + 1)[..., 0]
        lower = torch.gather(cum, -1, k)[..., 0]
        return torch.log(torch.clamp_min(upper - lower, 1e-10))

    def _all_probs(self, F):
        cum = self._cum_probs(F)
        return cum[..., 1:] - cum[..., :-1]

    def conditional_mean(self, F):
        p = self._all_probs(F)
        ks = torch.arange(self.num_bins, dtype=F.dtype, device=F.device)
        return torch.sum(p * ks, dim=-1)

    def conditional_variance(self, F):
        p = self._all_probs(F)
        ks = torch.arange(self.num_bins, dtype=F.dtype, device=F.device)
        m = torch.sum(p * ks, dim=-1)
        return torch.sum(p * ks ** 2, dim=-1) - m ** 2
