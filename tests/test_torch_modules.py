"""PyTorch port: module-by-module parity with the JAX package in float64
on the CPU (bijectors and priors, kernels, Cholesky with escalation and
its gradient, the relative jitter ladder (both also with no host read,
per batch element), triangular inverse and solves,
the diagonal and full-covariance reparameterization, the Gaussian KL
terms, mean functions, Gaussian likelihood, the SVGP conditional on its
fused, staged-inverse and solve branches, diagonal and full-covariance,
with its KL term and gradients, the cached layer (also full-covariance,
and its KL refusal), the RBF psi statistics and their gradients on both
psi2 routes (and the route rule, and which psi2 calls are symmetric),
the Linear kernel's psi statistics and the Sum cross terms with a
Linear, the collapsed SGPR layer on certain and Gaussian inputs,
diagonal and full-covariance), every other kernel of the JAX package
(Matern, rational quadratic, cosine, periodic, arc-cosine, Constant,
Linear, Product) with its gradients, the Constant mean function; the
natural-gradient update (and its reject net), the frozen-parameter
optimizer, the fused Cholesky-and-inverse and the other linalg helpers,
the single-layer baselines (SVGP, GPR on GPRLayer, SGPR, GPRFITC) with
their caches; the collapsed DGPs' data-parallel bounds and steps on
gloo ranks (``parallel/collapsed.py`` against the JAX package's, and the
mesh helpers), and output-dimension and pipeline parallelism on gloo
ranks (``parallel/outdim.py`` and ``parallel/pp.py`` against the JAX
package's); plus the port's import and device rules, and the port's
spans and counters (``tests/test_torch_tracing.py``).

One test item that loops over its cases and names the failing case in
every assertion message."""

import inspect
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P
from numpy.testing import assert_allclose

import doubly_stochastic_dgp_tpu as dsd
from doubly_stochastic_dgp_tpu.config import temp_config
from doubly_stochastic_dgp_tpu.data import datasets as jdata
from doubly_stochastic_dgp_tpu.data import native as jnative
from doubly_stochastic_dgp_tpu.models import posterior as jposterior
from doubly_stochastic_dgp_tpu.models.layers import SGPRLayer as JSGPRLayer
from doubly_stochastic_dgp_tpu.ops import linalg as jlinalg
from doubly_stochastic_dgp_tpu.ops import likelihoods as jlik
from doubly_stochastic_dgp_tpu.ops import quadrature as jquad
from doubly_stochastic_dgp_tpu.ops.psi_stats import (
    psi_statistics as jax_psi_statistics)
from doubly_stochastic_dgp_tpu.training import optim as jax_optim
from doubly_stochastic_dgp_tpu.training.natgrad import (
    natgrad_update as jax_natgrad_update)
from doubly_stochastic_dgp_tpu.utils import modules as jmodules
import doubly_stochastic_dgp_tpu_torch as port
from doubly_stochastic_dgp_tpu_torch.convert import _torch_key
from doubly_stochastic_dgp_tpu_torch.data import datasets as tdata
from doubly_stochastic_dgp_tpu_torch.data import native as tnative
from doubly_stochastic_dgp_tpu_torch.graphs import no_host_reads
from doubly_stochastic_dgp_tpu_torch.models import posterior as tposterior
from doubly_stochastic_dgp_tpu_torch.ops import likelihoods as tlik
from doubly_stochastic_dgp_tpu_torch.ops import linalg as tlinalg
from doubly_stochastic_dgp_tpu_torch.ops import quadrature as tquad
from doubly_stochastic_dgp_tpu_torch.ops import psi_stats as tpsi_stats
from doubly_stochastic_dgp_tpu_torch.ops.cuda.psi2 import psi2_core
from doubly_stochastic_dgp_tpu_torch.ops.psi_stats import (
    psi2_route, psi_statistics)
from doubly_stochastic_dgp_tpu_torch.training import optim as toptim
from doubly_stochastic_dgp_tpu_torch.utils import params as tparams

RTOL, ATOL = 1e-8, 1e-10


def _close(case, got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                    err_msg=case)


def _state(jax_tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _check_bijectors(rng):
    u = np.concatenate([rng.randn(20) * 5, [-40.0, 0.0, 25.0, 60.0]])
    _close("bijector positive", tparams.positive(_t(u)),
           jmodules.positive(jnp.asarray(u)))
    v = np.concatenate([np.exp(rng.randn(20)), [1e-6, 5e-7, 1e-3, 40.0]])
    _close("bijector positive_inverse", tparams.positive_inverse(_t(v)),
           jmodules.positive_inverse(jnp.asarray(v)))
    _close("bijector positive round trip",
           tparams.positive(tparams.positive_inverse(_t(v[:20]))), v[:20])
    A = rng.randn(3, 5, 5)
    for bij in ("identity", "positive", "triangular"):
        val = np.abs(A) + 0.1 if bij == "positive" else A
        jp = jmodules.Param.create(val, bijector=bij)
        tp = tparams.Param(val, bij)
        _close(f"Param[{bij}] unconstrained", tp.unconstrained,
               jp.unconstrained)
        _close(f"Param[{bij}] value", tp.value, jp.value)
    assert not tparams.Param(1.0, trainable=False).trainable, "trainable flag"
    # a Gaussian prior on a constrained value: log density and gradient
    val = np.abs(rng.randn(4)) + 0.2
    jp = jmodules.Param.create(val, bijector="positive",
                               prior=("gaussian", 0.5, 1.3))
    tp = tparams.Param(val, "positive", prior=("gaussian", 0.5, 1.3))
    lp = tparams.log_prior(torch.nn.ModuleList([tp, tparams.Param(val)]))
    _close("log_prior gaussian", lp, jmodules.log_prior(jp))
    lp.backward()
    _close("log_prior gaussian grad", tp.unconstrained.grad,
           jax.grad(lambda p: jmodules.log_prior(p))(jp).unconstrained)


def _kernel_pair(D, white, ls=0.8, var=1.3):
    jk = dsd.RBF.make(D, variance=var, lengthscales=ls)
    tk = port.RBF(D, variance=var, lengthscales=ls)
    if white:
        jk = jk + dsd.White.make(D, variance=2e-6)
        tk = tk + port.White(D, variance=2e-6)
    return jk, port.load_reference_state(tk, _state(jk))


def _check_kernels(rng):
    X, X2 = rng.randn(17, 4), rng.randn(9, 4)
    for white in (False, True):
        jk, tk = _kernel_pair(4, white, ls=rng.uniform(0.5, 2.0, 4))
        case = f"kernel RBF{'+White' if white else ''}"
        _close(f"{case} K(X)", tk.K(_t(X)), jk.K(jnp.asarray(X)))
        _close(f"{case} K(X, X2)", tk.K(_t(X), _t(X2)),
               jk.K(jnp.asarray(X), jnp.asarray(X2)))
        _close(f"{case} Kdiag", tk.Kdiag(_t(X)), jk.Kdiag(jnp.asarray(X)))


# the kernels beyond RBF and White: values to 1e-10 relative, gradients in
# every parameter to 1e-8
KERNEL_RTOL, KERNEL_GRAD_RTOL, KERNEL_ATOL = 1e-10, 1e-8, 1e-12


def _more_kernels(D, rng):
    """(name, JAX kernel, port kernel) for every kernel of the JAX package
    beyond RBF and White, a Product and an RBF * Linear."""
    ls = rng.uniform(0.6, 1.6, D)
    stat = dict(variance=1.3, lengthscales=ls)
    pairs = [
        ("Matern12", dsd.Matern12.make(D, **stat), port.Matern12(D)),
        ("Matern32", dsd.Matern32.make(D, **stat), port.Matern32(D)),
        ("Matern52", dsd.Matern52.make(D, **stat), port.Matern52(D)),
        ("RationalQuadratic",
         dsd.RationalQuadratic.make(D, alpha=0.7, **stat),
         port.RationalQuadratic(D)),
        ("Cosine", dsd.Cosine.make(D, **stat), port.Cosine(D)),
        ("Periodic", dsd.Periodic.make(D, period=1.7, **stat),
         port.Periodic(D)),
        ("Constant", dsd.Constant.make(D, variance=0.8), port.Constant(D)),
        ("Linear", dsd.LinearKernel.make(D, variance=0.8),
         port.LinearKernel(D)),
        ("Linear ARD", dsd.LinearKernel.make(D, variance=ls[::-1], ard=True),
         port.LinearKernel(D, ard=True)),
        ("Product(RBF, Matern32)",
         dsd.Product(kernels=[dsd.RBF.make(D, **stat),
                              dsd.Matern32.make(D, lengthscales=0.9)],
                     input_dim=D),
         port.Product([port.RBF(D), port.Matern32(D)])),
        ("RBF * Linear", dsd.RBF.make(D, lengthscales=ls)
         * dsd.LinearKernel.make(D, variance=0.6),
         port.RBF(D) * port.LinearKernel(D)),
    ]
    pairs += [(f"ArcCosine order {o}",
               dsd.ArcCosine.make(D, order=o, variance=1.2,
                                  weight_variances=ls, bias_variance=0.4),
               port.ArcCosine(D, order=o)) for o in (0, 1, 2)]
    return [(n, jk, port.load_reference_state(tk, _state(jk)))
            for n, jk, tk in pairs]


def _close_grad(case, got, want):
    """Gradients to KERNEL_GRAD_RTOL where the JAX one is finite; where it
    is not, the port's must be non-finite at the same entries."""
    got = got.detach().numpy()
    want = np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin), (
        f"{case}: non-finite at {np.argwhere(~np.isfinite(got))}, JAX at "
        f"{np.argwhere(~fin)}")
    assert_allclose(got[fin], want[fin], rtol=KERNEL_GRAD_RTOL,
                    atol=KERNEL_ATOL, err_msg=case)


# the parameters whose K(X) gradient is non-finite in the JAX package, and
# so in the port: at the diagonal of an arc-cosine K(X) num / denom is 1
# up to rounding, and where it rounds to exactly 1 the clip passes the
# gradient of arccos at 1, which is infinite (both packages give NaN)
NONFINITE_KX_GRADS = {
    f"ArcCosine order {o}": {"weight_variances.unconstrained",
                             "bias_variance.unconstrained"}
    for o in (0, 1, 2)}


def _jax_kernel_value_and_grad(k, method, args, R):
    """Eager, not jitted: on K(X)'s diagonal the squared distance is a
    cancellation to about 0, which the jitted program rounds to another
    tiny value (1e-17 against 0), and the Matern kernels' sqrt makes that
    a 5e-9 difference; eager JAX rounds it as the port does."""
    def f(k):
        out = getattr(k, method)(*args)
        return jnp.sum(out * R), out
    (_, out), g = jax.value_and_grad(f, has_aux=True)(k)
    return out, g


def _check_more_kernels(rng):
    """K(X, X2) (distinct rows), K(X) and Kdiag of every other kernel and
    the gradients of each in every parameter, at N=7, M=5, D=3; the
    non-finite K(X) gradients are the ones NONFINITE_KX_GRADS names, in
    both packages."""
    D = 3
    X, X2 = rng.randn(7, D), rng.randn(5, D)
    for name, jk, tk in _more_kernels(D, rng):
        for what, method, args in (("K(X, X2)", "K", (X, X2)),
                                   ("K(X)", "K", (X,)),
                                   ("Kdiag", "Kdiag", (X,))):
            case = f"kernel {name} {what}"
            jargs = [jnp.asarray(a) for a in args]
            R = rng.randn(X.shape[0], *(() if method == "Kdiag" else
                                        (args[-1].shape[0],)))
            want, jg = _jax_kernel_value_and_grad(jk, method, jargs, R)
            jg = {_torch_key(jax.tree_util.keystr(p)): g for p, g in
                  jax.tree_util.tree_flatten_with_path(jg)[0]}
            tk.zero_grad(set_to_none=True)
            got = getattr(tk, method)(*map(_t, args))
            assert_allclose(got.detach().numpy(), np.asarray(want),
                            rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                            err_msg=f"{case} value")
            (got * _t(R)).sum().backward()
            nonfinite = set()
            for pname, p in tk.named_parameters():
                g = torch.zeros_like(p) if p.grad is None else p.grad
                _close_grad(f"{case} grad {pname}", g, jg[pname])
                if not np.isfinite(np.asarray(jg[pname])).all():
                    nonfinite.add(pname)
            want_nonfinite = (NONFINITE_KX_GRADS.get(name, set())
                              if what == "K(X)" else set())
            assert nonfinite == want_nonfinite, (
                f"{case}: non-finite gradients in {sorted(nonfinite)}, "
                f"expected {sorted(want_nonfinite)}")


def _check_linalg(rng):
    Zh = rng.randn(12, 3)
    K = np.exp(-0.5 * ((Zh[:, None] - Zh[None]) ** 2).sum(-1))
    _close("safe_cholesky healthy", tlinalg.safe_cholesky(_t(K), 1e-6),
           jlinalg.safe_cholesky(jnp.asarray(K), 1e-6))
    # duplicated inducing rows: K is singular and the first rung fails
    Z = rng.randn(6, 3)
    Z = np.concatenate([Z, Z[:3]], 0)
    Kd = np.exp(-0.5 * ((Z[:, None] - Z[None]) ** 2).sum(-1))
    for j in (1e-16, 1e-18):
        case = f"safe_cholesky escalation jitter={j}"
        info = torch.linalg.cholesky_ex(_t(Kd) + j * torch.eye(9)).info
        assert int(info) != 0, f"{case}: the first rung did not fail"
        Lt = tlinalg.safe_cholesky(_t(Kd), j)
        assert torch.isfinite(Lt).all(), f"{case}: non-finite factor"
        _close(case, Lt, jlinalg.safe_cholesky(jnp.asarray(Kd), j))
    # batched: only the singular element escalates
    Kb = np.stack([Kd, K[:9, :9]])
    _close("safe_cholesky batched per-element escalation",
           tlinalg.safe_cholesky(_t(Kb), 1e-16),
           jlinalg.safe_cholesky(jnp.asarray(Kb), 1e-16))
    # gradients: the pullback on the selected factor, finite where a
    # rejected rung's factor is not
    for case, A, j in (("healthy", K, 1e-6), ("escalated", Kd, 1e-16)):
        case = f"safe_cholesky grad {case}"
        R = rng.randn(*A.shape)
        At = _t(A).requires_grad_()
        (tlinalg.safe_cholesky(At, j) * _t(R)).sum().backward()
        assert torch.isfinite(At.grad).all(), f"{case}: non-finite gradient"
        _close(case, At.grad, jax.grad(lambda a: jnp.sum(
            jlinalg.safe_cholesky(a, j) * R))(jnp.asarray(A)))
    _close("add_jitter", tlinalg.add_jitter(_t(K), 1e-3),
           jlinalg.add_jitter(jnp.asarray(K), 1e-3))
    L = np.linalg.cholesky(K + 1e-6 * np.eye(12))
    _close("inv_lower", tlinalg.inv_lower(_t(L)),
           jlinalg.inv_lower(jnp.asarray(L)))
    Lb = np.stack([L, np.linalg.cholesky(K + np.eye(12))])
    _close("inv_lower batched", tlinalg.inv_lower(_t(Lb)),
           jlinalg.inv_lower(jnp.asarray(Lb)))
    # Gaussian KL terms, values and gradients
    M_, D_ = 12, 3
    q_mu = rng.randn(M_, D_)
    q_sqrt = np.tril(rng.randn(D_, M_, M_) * 0.3) + np.eye(M_) * 0.7
    for name, jfn, tfn, extra in (
            ("gauss_kl_white", jlinalg.gauss_kl_white,
             tlinalg.gauss_kl_white, ()),
            ("gauss_kl_nonwhite", jlinalg.gauss_kl_nonwhite,
             tlinalg.gauss_kl_nonwhite, (L,))):
        arrays = (q_mu, q_sqrt) + extra
        leaves = [_t(a).requires_grad_() for a in arrays]
        kl = tfn(*leaves)
        kl.backward()
        _close(f"{name} value", kl, jfn(*map(jnp.asarray, arrays)))
        jg = jax.grad(jfn, argnums=tuple(range(len(arrays))))(
            *map(jnp.asarray, arrays))
        for what, t, g in zip(("q_mu", "q_sqrt", "Lu"), leaves, jg):
            _close(f"{name} grad {what}", t.grad, g)
    mean, var, z = rng.randn(3, 4, 2), rng.randn(3, 4, 2), rng.randn(3, 4, 2)
    _close("reparameterize diag",
           tlinalg.reparameterize(_t(mean), _t(var), _t(z), 1e-6),
           jlinalg.reparameterize(jnp.asarray(mean), jnp.asarray(var),
                                  jnp.asarray(z), jitter=1e-6))
    # full covariance (S, N, N, D); the factor of (s=1, d=0) fails, and its
    # samples are NaN in both packages (own stream: the cases after this
    # keep their draws)
    rng = np.random.RandomState(7)
    A = rng.randn(3, 2, 5, 5)
    cov = np.einsum("sdij,sdkj->sdik", A, A) + 0.1 * np.eye(5)
    cov[1, 0] = -np.eye(5)
    cov = np.transpose(cov, (0, 2, 3, 1))                       # (S, N, N, D)
    mean, z = rng.randn(3, 5, 2), rng.randn(3, 5, 2)
    got = tlinalg.reparameterize(_t(mean), _t(cov), _t(z), 1e-6,
                                 full_cov=True)
    _close("reparameterize full_cov (one failed factor -> NaN)", got,
           jlinalg.reparameterize(jnp.asarray(mean), jnp.asarray(cov),
                                  jnp.asarray(z), full_cov=True,
                                  jitter=1e-6))
    nan = torch.isnan(got)
    assert nan[1, :, 0].all() and nan.sum() == 5, (
        "reparameterize full_cov: NaN outside the failed factor's samples")


def _check_ladder_and_solves(rng):
    """safe_cholesky_ladder: exactly torch.linalg.cholesky when healthy,
    per-element escalation with a finite gradient when not; tri_solve in
    both modes."""
    Zh = rng.randn(10, 3)
    K = np.exp(-0.5 * ((Zh[:, None] - Zh[None]) ** 2).sum(-1)) + np.eye(10)
    ladder = tlinalg.safe_cholesky_ladder
    ladder.escalations.reset()
    assert torch.equal(ladder(_t(K)), torch.linalg.cholesky(_t(K))), (
        "safe_cholesky_ladder healthy: not bit-identical to cholesky")
    assert ladder.escalations == 0, "safe_cholesky_ladder healthy escalated"
    # a slightly indefinite matrix fails the 0.0 rung; in a batch, only
    # that element escalates
    Kb = K - (np.linalg.eigvalsh(K)[0] + 1e-9) * np.eye(10)
    for case, A in (("escalated", Kb), ("batched", np.stack([Kb, K]))):
        case = f"safe_cholesky_ladder {case}"
        R = rng.randn(*A.shape)
        At = _t(A).requires_grad_()
        L = ladder(At)
        (L * _t(R)).sum().backward()
        assert torch.isfinite(At.grad).all(), f"{case}: non-finite gradient"
        _close(case, L, jlinalg.safe_cholesky_ladder(jnp.asarray(A)))
        _close(f"{case} grad", At.grad, jax.grad(lambda a: jnp.sum(
            jlinalg.safe_cholesky_ladder(a) * R))(jnp.asarray(A)))
    assert ladder.escalations == 2, (
        f"safe_cholesky_ladder escalations {ladder.escalations} != 2")
    L = np.linalg.cholesky(K)
    B = rng.randn(10, 4)
    for mode in ("solve", "inverse"):
        for lower, T in ((True, L), (False, L.T)):
            for trans in (False, True):
                _close(f"tri_solve mode={mode} lower={lower} trans={trans}",
                       tlinalg.tri_solve(_t(T), _t(B), lower=lower,
                                         trans=trans, mode=mode),
                       jlinalg.tri_solve(jnp.asarray(T), jnp.asarray(B),
                                         lower=lower, trans=trans,
                                         mode=mode))


def _psi_kernels(D, rng):
    """(name, JAX kernel, port kernel) for RBF and Sum(RBF, RBF, White)."""
    ls1, ls2 = rng.uniform(0.6, 1.6, D), rng.uniform(0.6, 1.6, D)
    j1 = dsd.RBF.make(D, variance=1.3, lengthscales=ls1)
    jsum = (dsd.RBF.make(D, variance=0.7, lengthscales=ls1)
            + dsd.RBF.make(D, variance=1.1, lengthscales=ls2)
            + dsd.White.make(D, variance=1e-3))
    tsum = (port.RBF(D, lengthscales=ls1) + port.RBF(D, lengthscales=ls2)
            + port.White(D))
    return [("RBF", j1, port.load_reference_state(port.RBF(D), _state(j1))),
            ("Sum(RBF, RBF, White)", jsum,
             port.load_reference_state(tsum, _state(jsum)))]


def _check_psi2_route():
    """The psi2 route rule (plain, so checked without a card): 'xla' plain;
    'auto' the kernel route on the CPU and, on CUDA, where the kernel takes
    the call (float32, M <= 512, 1 <= D <= 32), else plain; 'pallas' the
    kernel route always (on CUDA it raises where the kernel cannot)."""
    for mode in ("auto", "pallas", "xla"):
        for device in ("cpu", "cuda", torch.device("cuda", 0)):
            for dtype in (torch.float32, torch.float64):
                for M, D in ((100, 8), (513, 2), (100, 33)):
                    case = (f"psi2_route {mode} {device} {dtype} M={M} "
                            f"D={D}")
                    fits = dtype == torch.float32 and M <= 512 and D <= 32
                    on_cpu = str(device) == "cpu"
                    want = {"xla": "plain", "pallas": "kernel",
                            "auto": ("kernel" if on_cpu or fits
                                     else "plain")}[mode]
                    got = psi2_route(mode, device, M, D, dtype)
                    assert got == want, f"{case}: {got} != {want}"


def _check_psi_statistics(rng):
    """psi0/psi1/psi2 on the plain route ('xla') and the psi2 kernel route
    ('auto' and 'pallas': on the CPU the kernel's plain version), with Z
    and the inputs centred far from zero; on the kernel route a single
    RBF's psi2 call says symmetric=True and a Sum's cross term False."""
    N, M, D = 41, 13, 3
    inner = tpsi_stats.psi2_core
    calls = []

    def record(*args, symmetric=False):
        calls.append(symmetric)
        return inner(*args, symmetric=symmetric)

    for centre in (4.0,):
        mu = rng.randn(N, D) + centre
        Sv = np.exp(rng.randn(N, D)) * 0.1
        Z = rng.randn(M, D) + centre
        for kname, jk, tk in _psi_kernels(D, rng):
            want = jax_psi_statistics(jk, jnp.asarray(mu), jnp.asarray(Sv),
                                      jnp.asarray(Z))
            for impl in ("xla", "auto", "pallas"):
                calls.clear()
                tpsi_stats.psi2_core = record
                try:
                    got = psi_statistics(tk, _t(mu), _t(Sv), _t(Z), impl)
                finally:
                    tpsi_stats.psi2_core = inner
                # Sum(RBF, RBF, White): two single-RBF terms, one cross
                want_calls = {"xla": [], "RBF": [True]}.get(
                    impl if impl == "xla" else kname, [True, True, False])
                assert calls == want_calls, (
                    f"psi_statistics {kname} psi2_impl={impl}: psi2_core "
                    f"calls (symmetric) {calls} != {want_calls}")
                for what, g, w in zip(("psi0", "psi1", "psi2"), got, want):
                    _close(f"psi_statistics {kname} centre={centre} "
                           f"psi2_impl={impl} {what}", g, w)
            _check_psi_gradients(f"psi_statistics {kname}", jk, tk, mu, Sv,
                                 Z, rng.randn(N, M), rng.randn(M, M))


def _linear_psi_kernels(D, rng):
    """(name, JAX kernel, port kernel, expected symmetric psi2_core calls on
    the kernel route) for Linear, Sum(RBF, Linear ARD, White) and
    Sum(Linear, Linear)."""
    ls, v = rng.uniform(0.6, 1.6, D), rng.uniform(0.3, 1.2, D)
    pairs = [
        ("Linear", dsd.LinearKernel.make(D, variance=0.7),
         port.LinearKernel(D), []),
        ("Sum(RBF, Linear ARD, White)",
         dsd.RBF.make(D, variance=1.1, lengthscales=ls)
         + dsd.LinearKernel.make(D, variance=v, ard=True)
         + dsd.White.make(D, variance=1e-3),
         port.RBF(D) + port.LinearKernel(D, ard=True) + port.White(D),
         [True]),
        ("Sum(Linear, Linear)",
         dsd.LinearKernel.make(D, variance=0.7)
         + dsd.LinearKernel.make(D, variance=v, ard=True),
         port.LinearKernel(D) + port.LinearKernel(D, ard=True), []),
    ]
    return [(n, jk, port.load_reference_state(tk, _state(jk)), calls)
            for n, jk, tk, calls in pairs]


def _check_linear_psi_statistics(rng):
    """psi0/psi1/psi2 with a Linear kernel, alone and in Sums (the Linear
    x Linear and RBF x Linear cross terms), on the plain route and the
    psi2 kernel route (whose one call is the RBF's own symmetric psi2; the
    cross terms are plain on every route), with their gradients in mu, S,
    Z and every kernel parameter, against the JAX package."""
    N, M, D = 41, 13, 3
    mu = rng.randn(N, D) + 2.0
    Sv = np.exp(rng.randn(N, D)) * 0.1
    Z = rng.randn(M, D) + 2.0
    inner = tpsi_stats.psi2_core
    calls = []

    def record(*args, symmetric=False):
        calls.append(symmetric)
        return inner(*args, symmetric=symmetric)

    for kname, jk, tk, want_calls in _linear_psi_kernels(D, rng):
        want = jax_psi_statistics(jk, jnp.asarray(mu), jnp.asarray(Sv),
                                  jnp.asarray(Z))
        for impl in ("xla", "auto"):
            calls.clear()
            tpsi_stats.psi2_core = record
            try:
                got = psi_statistics(tk, _t(mu), _t(Sv), _t(Z), impl)
            finally:
                tpsi_stats.psi2_core = inner
            expected = [] if impl == "xla" else want_calls
            assert calls == expected, (
                f"psi_statistics {kname} psi2_impl={impl}: psi2_core calls "
                f"(symmetric) {calls} != {expected}")
            for what, g, w in zip(("psi0", "psi1", "psi2"), got, want):
                assert_allclose(g.detach().numpy(), np.asarray(w),
                                rtol=KERNEL_RTOL,
                                atol=KERNEL_ATOL,
                                err_msg=f"psi_statistics {kname} "
                                        f"psi2_impl={impl} {what}")
        _check_psi_gradients(f"psi_statistics {kname}", jk, tk, mu, Sv, Z,
                             rng.randn(N, M), rng.randn(M, M))


def _check_psi_gradients(case, jk, tk, mu, Sv, Z, R1, R2):
    """Gradients of sum(psi1 R1) + sum(psi2 R2) reach mu, S, Z and every
    kernel hyperparameter alike on the plain route ('xla': autograd
    through the blocked sum) and on the kernel route ('auto': the psi2
    Function, whose backward on the CPU is the kernel's plain version),
    and equal jax.grad's."""
    def jobj(k, m, s, z):
        _, p1, p2 = jax_psi_statistics(k, m, s, z)
        return jnp.sum(p1 * R1) + jnp.sum(p2 * R2)

    jgk, *jg = jax.grad(jobj, argnums=(0, 1, 2, 3))(
        jk, jnp.asarray(mu), jnp.asarray(Sv), jnp.asarray(Z))
    jgk = {_torch_key(jax.tree_util.keystr(p)): g for p, g in
           jax.tree_util.tree_flatten_with_path(jgk)[0]}
    before = psi2_core.backward_launches
    for impl in ("xla", "auto"):
        leaves = [_t(a).requires_grad_() for a in (mu, Sv, Z)]
        tk.zero_grad(set_to_none=True)
        _, p1, p2 = psi_statistics(tk, *leaves, impl)
        (torch.sum(p1 * _t(R1)) + torch.sum(p2 * _t(R2))).backward()
        for what, t, w in zip(("mu", "S", "Z"), leaves, jg):
            _close(f"{case} psi2_impl={impl} grad {what}", t.grad, w)
        for name, p in tk.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            _close(f"{case} psi2_impl={impl} grad {name}", g, jgk[name])
    assert psi2_core.backward_launches == before, (
        f"{case}: the psi2 backward kernel launched for CPU tensors")


def _check_sgpr_layer(rng):
    """SGPRLayer's bound and diagonal conditional on certain inputs and on
    Gaussian inputs, both solve modes and psi2 routes, and the bound's
    gradient (certain: every parameter; Gaussian: also the inputs)."""
    N, M, D, Dy = 35, 11, 3, 2
    Z, mu = rng.randn(M, D), rng.randn(N, D)
    Sv, Y = np.exp(rng.randn(N, D)) * 0.1, rng.randn(N, Dy)
    Xs = rng.randn(9, D)
    jk = dsd.RBF.make(D, variance=1.2, lengthscales=rng.uniform(0.7, 1.5, D))
    Wm = rng.randn(D, Dy)
    for mode, impl, uncertain in (("solve", "xla", False),
                                  ("inverse", "pallas", True)):
        case = (f"SGPRLayer {'Gaussian' if uncertain else 'certain'} inputs "
                f"solve_mode={mode} psi2_impl={impl}")
        jmf = dsd.models.mean_functions.Linear.make(Wm)
        jl = JSGPRLayer.make(jk, Z, Dy, jmf, jitter=1e-6, solve_mode=mode)
        cfg = port.Config(jitter=1e-6, solve_mode=mode, psi2_impl=impl)
        tl = port.load_reference_state(port.SGPRLayer(
            port.RBF(D), Z, Dy, port.Linear(np.zeros((D, Dy))), config=cfg),
            _state(jl))
        Svar = Sv if uncertain else None
        jdata = (jnp.asarray(mu), None if Svar is None else jnp.asarray(Svar),
                 jnp.asarray(Y), jnp.asarray(0.07))
        tmu = _t(mu).requires_grad_()
        tdata = (tmu, None if Svar is None else _t(Svar), _t(Y), _t(0.07))

        @jax.jit
        def jax_side(layer, m):
            def bound(layer, m):
                return layer.set_data(m, *jdata[1:]).build_likelihood()
            view = layer.set_data(m, *jdata[1:])
            return (bound(layer, m), view.conditional_ND(jnp.asarray(Xs)),
                    view.conditional_ND(jnp.asarray(Xs), full_cov=True),
                    jax.grad(bound, argnums=(0, 1))(layer, m))

        jbound, jcond, jfull, (jgrad, jgmu) = jax_side(jl, jdata[0])
        tview = tl.set_data(*tdata)
        bound = tview.build_likelihood()
        _close(f"{case} bound", bound, jbound)
        for what, got, want in zip(("mean", "var"),
                                   tview.conditional_ND(_t(Xs)), jcond):
            _close(f"{case} conditional {what}", got, want)
        for what, got, want in zip(
                ("mean", "var"), tview.conditional_ND(_t(Xs), full_cov=True),
                jfull):
            _close(f"{case} full_cov conditional {what}", got, want)
        kl = tl.KL()
        assert kl.item() == 0.0 and kl.dtype == torch.float64, (
            f"{case}: Layer.KL() is {kl!r}, not 0 in the model's dtype")
        bound.backward()
        want = {_torch_key(jax.tree_util.keystr(p)): g for p, g in
                jax.tree_util.tree_flatten_with_path(jgrad)[0]}
        for name, p in tl.named_parameters():
            # the Gaussian-input bound does not use the mean function
            g = torch.zeros_like(p) if p.grad is None else p.grad
            _close(f"{case} bound grad {name}", g, want[name])
        _close(f"{case} bound grad X_mean", tmu.grad, jgmu)


def _check_mean_functions_and_likelihood(rng):
    X = rng.randn(2, 7, 4)
    W, b = rng.randn(4, 3), rng.randn(3)
    jl = dsd.models.mean_functions.Linear.make(W, b)
    tl = port.load_reference_state(port.Linear(np.zeros((4, 3))), _state(jl))
    _close("mean function Linear", tl(_t(X)), jl(jnp.asarray(X)))
    _close("mean function Identity", port.Identity()(_t(X)), X)
    _close("mean function Zero", port.Zero(3)(_t(X)),
           dsd.models.mean_functions.Zero(output_dim=3)(jnp.asarray(X)))
    for c in (rng.randn(3), 0.4):
        jc = dsd.ConstantMean.make(c)
        tc = port.load_reference_state(port.ConstantMean(np.zeros_like(c)),
                                       _state(jc))
        _close(f"mean function Constant c={c}", tc(_t(X)), jc(jnp.asarray(X)))
    jg = dsd.Gaussian.make(0.07)
    tg = port.load_reference_state(port.Gaussian(1.0), _state(jg))
    Fm, Fv, Y = rng.randn(5, 6, 2), np.exp(rng.randn(5, 6, 2)), rng.randn(6, 2)
    for got, want, what in zip(
            tg.predict_mean_and_var(_t(Fm), _t(Fv)),
            jg.predict_mean_and_var(jnp.asarray(Fm), jnp.asarray(Fv)),
            ("mean", "var")):
        _close(f"Gaussian predict_mean_and_var {what}", got, want)
    _close("Gaussian predict_density",
           tg.predict_density(_t(Fm), _t(Fv), _t(Y)),
           jg.predict_density(jnp.asarray(Fm), jnp.asarray(Fv),
                              jnp.asarray(Y)))
    _close("Gaussian logp", tg.logp(_t(Fm), _t(Y)),
           jg.logp(jnp.asarray(Fm), jnp.asarray(Y)))
    ve = tg.variational_expectations(_t(Fm), _t(Fv), _t(Y))
    _close("Gaussian variational_expectations", ve,
           jg.variational_expectations(jnp.asarray(Fm), jnp.asarray(Fv),
                                       jnp.asarray(Y)))
    ve.sum().backward()
    _close("Gaussian variational_expectations grad",
           tg.variance.unconstrained.grad,
           jax.grad(lambda g: jnp.sum(g.variational_expectations(
               jnp.asarray(Fm), jnp.asarray(Fv), jnp.asarray(Y))))(
               jg).variance.unconstrained)


# the quadrature and the likelihoods: the same float64 arithmetic in both
# packages, summed in other orders (20-point rules, products of K CDFs)
LIK_RTOL, LIK_ATOL = 1e-10, 1e-12
QUAD_RTOL = 1e-12


def _check_quadrature(rng):
    for H in (1, 5, 20):
        for got, want, what in zip(tquad.hermgauss(H), jquad.hermgauss(H),
                                   ("nodes", "weights")):
            np.testing.assert_array_equal(
                got, want, err_msg=f"hermgauss H={H} {what}: not bit for bit")
    for H, Dq in ((3, 2), (4, 3)):
        for got, want, what in zip(tquad.mvhermgauss(H, Dq),
                                   jquad.mvhermgauss(H, Dq),
                                   ("nodes", "weights")):
            np.testing.assert_array_equal(
                got, want, err_msg=f"mvhermgauss H={H} D={Dq} {what}: not "
                                   f"bit for bit")
    Fmu, Fvar, Y = rng.randn(3, 7, 2), np.exp(rng.randn(3, 7, 2)), rng.randn(
        7, 2)
    Fvar[0, :2] = 0.0                     # below the 1e-12 floor
    funcs = [lambda X, Y: X ** 2 * Y, lambda X, Y: -0.5 * (X - Y) ** 2]
    jfuncs = [lambda X, Y: jnp.sin(X) * Y + X ** 2,
              lambda X, Y: -0.5 * (X - Y) ** 2]
    tfuncs = [lambda X, Y: torch.sin(X) * Y + X ** 2, funcs[1]]
    for logspace in (False, True):
        got = tquad.ndiagquad(tfuncs, 20, _t(Fmu), _t(Fvar), logspace, Y=_t(Y))
        want = jquad.ndiagquad(jfuncs, 20, jnp.asarray(Fmu),
                               jnp.asarray(Fvar), logspace, Y=jnp.asarray(Y))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_allclose(g.numpy(), np.asarray(w), rtol=QUAD_RTOL,
                            atol=1e-300, err_msg=f"ndiagquad logspace="
                                                 f"{logspace} integrand {i}")


def _likelihood_cases(rng, N):
    """(name, JAX likelihood, port likelihood, latent width, Y)."""
    edges = np.array([-1.0, 0.0, 1.5])
    cases = [
        ("Gaussian", jlik.Gaussian.make(0.3), tlik.Gaussian(), 2,
         rng.randn(N, 2)),
        ("Bernoulli", jlik.Bernoulli.make(), tlik.Bernoulli(), 1,
         rng.randint(0, 2, (N, 1)).astype(float)),
        ("Poisson", jlik.Poisson.make(binsize=0.7), tlik.Poisson(0.7), 1,
         rng.poisson(2.0, (N, 1)).astype(float)),
        ("Exponential", jlik.Exponential.make(), tlik.Exponential(), 1,
         rng.exponential(1.0, (N, 1))),
        ("StudentT", jlik.StudentT.make(0.6, df=4.0), tlik.StudentT(df=4.0),
         1, rng.randn(N, 1)),
        ("Gamma", jlik.Gamma.make(1.7), tlik.Gamma(), 1,
         rng.gamma(2.0, 1.0, (N, 1))),
        ("Beta", jlik.Beta.make(2.5), tlik.Beta(), 1,
         rng.uniform(0.05, 0.95, (N, 1))),
        ("Ordinal", jlik.Ordinal.make(edges, sigma=0.8),
         tlik.Ordinal(np.zeros(3)), 1,
         rng.randint(0, 4, (N, 1)).astype(float)),
    ]
    for K in (3, 10):
        cases.append((f"MultiClass K={K}", jlik.MultiClass.make(K),
                      tlik.MultiClass(K), K,
                      rng.randint(0, K, (N, 1)).astype(float)))
    return cases


def _lik_methods(Y):
    """(method, f(lik, Fmu, Fvar, Y) -> output or (mean, var))."""
    return [("logp", lambda l, m, v, y: l.logp(m, y)),
            ("variational_expectations",
             lambda l, m, v, y: l.variational_expectations(m, v, y)),
            ("predict_mean_and_var",
             lambda l, m, v, y: l.predict_mean_and_var(m, v)),
            ("predict_density",
             lambda l, m, v, y: l.predict_density(m, v, y))]


def _weighted_sum(out, weights, sum_):
    outs = out if isinstance(out, tuple) else (out,)
    return sum_(o * w for o, w in zip(outs, weights))


def _check_likelihoods(rng):
    """Each of the nine likelihoods, every method, values and gradients
    with respect to Fmu, Fvar and each parameter, at (S=3, N=7, D) with
    Fvar = 0 entries (the floors)."""
    S_, N_ = 3, 7
    for name, jl, tl, Dl, Y in _likelihood_cases(rng, N_):
        tl = port.load_reference_state(tl, _state(jl))
        Fmu = rng.randn(S_, N_, Dl)
        Fvar = np.exp(rng.randn(S_, N_, Dl) - 1.0)
        Fvar[0, :2] = 0.0
        Fvar[1, 3, 0] = 0.0
        weights = [rng.randn(S_, N_, Dl), rng.randn(S_, N_, Dl)]
        params = dict(tl.named_parameters())
        methods = _lik_methods(Y)

        def joracle(l, m, v, y, w):
            """Every method's output and its weighted sum's gradients in
            (lik, Fmu, Fvar): one jitted oracle a likelihood."""
            def obj(f):
                def val(l, m, v):
                    out = f(l, m, v, y)
                    return _weighted_sum(out, w, lambda t: sum(
                        jnp.sum(x) for x in t)), out
                return val
            return [jax.value_and_grad(obj(f), argnums=(0, 1, 2),
                                       has_aux=True)(l, m, v)
                    for _, f in methods]

        oracle = jax.jit(joracle)(jl, jnp.asarray(Fmu), jnp.asarray(Fvar),
                                  jnp.asarray(Y),
                                  [jnp.asarray(w) for w in weights])
        for (method, f), ((_, jout), jg) in zip(methods, oracle):
            case = f"likelihood {name} {method}"
            m, v = _t(Fmu).requires_grad_(), _t(Fvar).requires_grad_()
            tout = f(tl, m, v, _t(Y))
            loss = _weighted_sum(tout, [_t(w) for w in weights],
                                 lambda t: sum(torch.sum(x) for x in t))
            inputs = [m, v] + list(params.values())
            grads = (torch.autograd.grad(loss, inputs, allow_unused=True)
                     if loss.requires_grad else [None] * len(inputs))
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(inputs, grads)]
            for i, (a, b) in enumerate(zip(
                    tout if isinstance(tout, tuple) else (tout,),
                    jout if isinstance(jout, tuple) else (jout,))):
                assert_allclose(a.detach().numpy(), np.asarray(b),
                                rtol=LIK_RTOL, atol=LIK_ATOL,
                                err_msg=f"{case} output {i}")
            jgp = _state(jg[0])
            named = [("Fmu", jg[1]), ("Fvar", jg[2])] + [
                (k, jgp["." + k.replace(".unconstrained", "")
                        + ".unconstrained"]) for k in params]
            for (what, want), got in zip(named, grads):
                assert_allclose(got.numpy(), np.asarray(want), rtol=LIK_RTOL,
                                atol=LIK_ATOL, err_msg=f"{case} grad {what}")
            assert np.isfinite([g.sum().item() for g in grads]).all(), (
                f"{case}: non-finite gradient at Fvar = 0")


FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _raises(case, exc, match, fn):
    try:
        fn()
    except exc as e:
        assert re.search(match, str(e)), f"{case}: {e}"
        return str(e)
    raise AssertionError(f"{case}: did not raise {exc.__name__}")


def _check_data(rng):
    """The loaders against the JAX package's, bit for bit: load_mnist_npz
    and its four rejections, Kin8nm on the committed CSV, the synthetic
    sets and the registry; the missing-CSV refusal; data/native.py against
    its numpy fallback and the JAX binding of the same library."""
    mnist = str(FIXTURES / "mnist_tiny.npz")
    got, want = tdata.load_mnist_npz(mnist), jdata.load_mnist_npz(mnist)
    for k in ("X", "Y", "Xs", "Ys"):
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), f"load_mnist_npz {k}"
    d = want
    with tempfile.TemporaryDirectory() as tmp:
        bad = os.path.join(tmp, "bad.npz")
        for case, arrays, match in (
                ("missing Ys", dict(X=d["X"], Y=d["Y"], Xs=d["Xs"]),
                 "missing"),
                ("pixels x 255", dict(X=d["X"] * 255.0, Y=d["Y"],
                                      Xs=d["Xs"], Ys=d["Ys"]), r"\[0, 1\]"),
                ("labels + 0.5", dict(X=d["X"], Y=d["Y"] + 0.5, Xs=d["Xs"],
                                      Ys=d["Ys"]), "integer"),
                ("10 labels", dict(X=d["X"], Y=d["Y"][:10], Xs=d["Xs"],
                                   Ys=d["Ys"]), "labels")):
            np.savez(bad, **arrays)
            msg = _raises(f"load_mnist_npz rejects {case}", ValueError,
                          match, lambda: tdata.load_mnist_npz(bad))
            jmsg = _raises(f"JAX load_mnist_npz rejects {case}", ValueError,
                           match, lambda: jdata.load_mnist_npz(bad))
            assert msg == jmsg, f"load_mnist_npz {case}: {msg} vs {jmsg}"

        # a missing CSV raises without a download (no loader has one)
        missing = tdata.Kin8nm(data_path=tmp)
        assert not hasattr(missing, "download_data"), "a loader downloads"
        _raises("Kin8nm without its CSV", FileNotFoundError,
                "never downloads.*SyntheticRegression", missing.get_data)

        # data/native.py: the library against its numpy fallback
        A = rng.randn(57, 6)
        path = os.path.join(tmp, "a.csv")
        np.savetxt(path, A, delimiter=",", header="a,b,c,d,e,f",
                   comments="")
        assert tnative.native_available(), "native: g++ build failed"
        np.testing.assert_array_equal(
            tnative.read_csv(path, True), tnative.read_csv_numpy(path, True),
            err_msg="native read_csv vs numpy, with a header")
        assert_allclose(tnative.read_csv(path, True), A, rtol=1e-15,
                        err_msg="native read_csv vs the written array")
    kin = str(FIXTURES / "kin8nm.csv")
    np.testing.assert_array_equal(tnative.read_csv(kin),
                                  tnative.read_csv_numpy(kin),
                                  err_msg="native read_csv vs numpy, kin8nm")
    idx = tnative.shuffled_indices(57, 5)
    np.testing.assert_array_equal(idx, jnative.shuffled_indices(57, 5),
                                  err_msg="native shuffled_indices vs JAX")
    for perm in (idx, tnative.shuffled_indices_numpy(57, 5)):
        assert np.array_equal(np.sort(perm), np.arange(57)), (
            "shuffled_indices: not a permutation")
    np.testing.assert_array_equal(tnative.gather_rows(A, idx[:20]),
                                  A[idx[:20]], err_msg="native gather_rows")
    stream = tnative.MinibatchStream(A[:, :5], A[:, 5:], 10, seed=3)
    with tnative.PrefetchingLoader(A[:, :5], A[:, 5:], 10, seed=3,
                                   depth=2) as pre:
        for i in range(12):   # two epochs
            for a, b in zip(stream.next(), pre.next()):
                np.testing.assert_array_equal(
                    a, b, err_msg=f"PrefetchingLoader batch {i}")

    # the UCI loader on the committed CSV, and the synthetic sets
    for name, tds, jds in (
            ("Kin8nm", tdata.Kin8nm(data_path=str(FIXTURES)),
             jdata.Kin8nm(data_path=str(FIXTURES))),
            ("SyntheticRegression", tdata.make_synthetic_regression(
                N=300, D=3, seed=4), jdata.make_synthetic_regression(
                N=300, D=3, seed=4)),
            ("CompositionalRegression", tdata.CompositionalRegression(
                N=300, D=4), jdata.CompositionalRegression(N=300, D=4)),
            ("ConjugateRegression", tdata.ConjugateRegression(N=200, D=3),
             jdata.ConjugateRegression(N=200, D=3))):
        got, want = tds.get_data(seed=1, split=2), jds.get_data(seed=1,
                                                                  split=2)
        assert set(got) == set(want), f"{name} keys"
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name} {k}")
    reg, jreg = tdata.Datasets(), jdata.Datasets()
    assert {k: (v.N, v.D, v.url) for k, v in reg.all_datasets.items()} == {
        k: (v.N, v.D, v.url) for k, v in jreg.all_datasets.items()}, (
        "Datasets registry")


def _layer_pair(rng, white, fused, kern_white, mode="inverse", M=15):
    D_in, D_out = 3, 2
    Z = rng.randn(M, D_in)
    W = rng.randn(D_in, D_out)
    jk, tk = _kernel_pair(D_in, kern_white, ls=rng.uniform(0.7, 1.5, D_in))
    jl = dsd.SVGPLayer.make(
        jk, Z, D_out, dsd.models.mean_functions.Linear.make(W),
        white=white, jitter=1e-6, solve_mode=mode, use_pallas=fused)
    q_sqrt = np.tril(rng.randn(D_out, M, M) * 0.3) + np.eye(M) * 0.5
    jl = jl.replace(q_mu=jl.q_mu.with_value(rng.randn(M, D_out)),
                    q_sqrt=jl.q_sqrt.with_value(q_sqrt))
    cfg = port.Config(jitter=1e-6, solve_mode=mode, use_pallas=fused)
    tl = port.SVGPLayer(tk, Z, D_out, port.Linear(np.zeros((D_in, D_out))),
                        white=white, config=cfg)
    return jl, port.load_reference_state(tl, _state(jl))


def _check_layer(case, jl, tl, X, rng, full_cov=False):
    """Mean, var, KL, and the gradient of sum(mean R1) + sum(var R2) + KL
    with respect to every parameter of the layer, against one jitted JAX
    oracle."""
    B = X.shape[0]
    R1 = rng.randn(B, 2)
    R2 = rng.randn(B, B, 2) if full_cov else rng.randn(B, 2)

    def jobj(layer):
        m, v = layer.conditional_ND(jnp.asarray(X), full_cov=full_cov)
        return jnp.sum(m * R1) + jnp.sum(v * R2) + layer.KL()

    @jax.jit
    def oracle(layer):
        return (layer.conditional_ND(jnp.asarray(X), full_cov=full_cov),
                layer.KL(), jax.grad(jobj)(layer))

    (jm, jv), jkl, jgrad = oracle(jl)
    m, v = tl.conditional_ND(_t(X), full_cov=full_cov)
    _close(f"{case} mean", m, jm)
    _close(f"{case} var", v, jv)
    _close(f"{case} KL", tl.KL(), jkl)
    (torch.sum(m * _t(R1)) + torch.sum(v * _t(R2)) + tl.KL()).backward()
    want = {_torch_key(jax.tree_util.keystr(p)): g for p, g in
            jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    params = dict(tl.named_parameters())
    assert set(params) == set(want), f"{case}: parameter sets differ"
    for name, p in params.items():
        _close(f"{case} grad {name}", p.grad, want[name])


# (branch, solve_mode, use_pallas, full_cov): the fused and staged-inverse
# diagonal branches, the solve branch diagonal and full-covariance, and the
# full covariance under solve_mode='inverse' (which takes the solves)
LAYER_BRANCHES = [("fused", "inverse", True, False),
                  ("inverse", "inverse", False, False),
                  ("solve", "solve", False, False),
                  ("solve full_cov", "solve", False, True),
                  ("inverse full_cov", "inverse", False, True)]


def _check_layers(rng):
    X = rng.randn(23, 3)
    for branch, mode, fused, full_cov in LAYER_BRANCHES:
        for white, kern_white in ((True, False), (False, True)):
            case = (f"SVGPLayer {branch} white={white} "
                    f"kernel={'RBF+White' if kern_white else 'RBF'}")
            jl, tl = _layer_pair(rng, white, fused, kern_white, mode,
                                 M=15 if branch in ("fused", "inverse")
                                 else 12)
            _check_layer(case, jl, tl, X, rng, full_cov)
            if mode == "solve" and white:
                continue            # the cache does not depend on the mode
            jc = jposterior._cache_svgp(jl)
            tc = tposterior._cache_svgp(tl)
            for what, got, want in zip(
                    ("mean", "var"), tc.conditional_ND(_t(X), full_cov),
                    jc.conditional_ND(jnp.asarray(X), full_cov)):
                _close(f"CachedSVGPLayer from {case} {what}", got, want)
    try:
        jc.KL()
    except NotImplementedError as e:
        want = str(e)
    try:
        tc.KL()
    except NotImplementedError as e:
        assert str(e) == want, f"CachedSVGPLayer.KL message: {e}"
    else:
        raise AssertionError("CachedSVGPLayer.KL did not raise")


def _check_sync_free_cholesky(rng):
    """safe_cholesky and safe_cholesky_ladder with no host read (every
    rung factorized, per-element selection on the device) on a healthy,
    an escalated and a mixed batch whose elements take different rungs:
    values and gradients against the JAX functions; the ladder's
    escalation count kept on the device."""
    Q = np.linalg.qr(rng.randn(8, 8))[0]
    P = Q @ np.diag(np.logspace(-8, 0, 8)) @ Q.T
    P = 0.5 * (P + P.T)
    j = 1e-3
    # absolute rungs j, 1e2 j, 1e4 j: P takes the first, P - 1e-2 I the
    # second, P - I the third
    absolute = {"healthy": np.stack([P, P + np.eye(8)]),
                "escalated": np.stack([P - 1e-2 * np.eye(8),
                                       P - np.eye(8)]),
                "mixed": np.stack([P, P - 1e-2 * np.eye(8), P - np.eye(8)])}
    # relative rungs (0, 1e-7, ..., 1e3) x mean(diag): B + I is healthy,
    # B - 0.05 m I first succeeds at 1e-1, B - 0.8 m I at 1e1
    m = np.trace(P) / 8
    relative = {"healthy": np.stack([P + np.eye(8), P + 2 * np.eye(8)]),
                "escalated": np.stack([P - 0.05 * m * np.eye(8)]),
                "mixed": np.stack([P + np.eye(8), P - 0.05 * m * np.eye(8),
                                   P - 0.8 * m * np.eye(8)])}
    ladder = tlinalg.safe_cholesky_ladder
    for name, cases, tfn, jfn in (
            ("safe_cholesky", absolute,
             lambda a: tlinalg.safe_cholesky(a, j),
             lambda a: jlinalg.safe_cholesky(a, j)),
            ("safe_cholesky_ladder", relative, ladder,
             jlinalg.safe_cholesky_ladder)):
        for batch, A in cases.items():
            case = f"{name} with no host read, {batch} batch"
            R = rng.randn(*A.shape)
            At = _t(A).requires_grad_()
            ladder.escalations.reset()
            with no_host_reads():
                L = tfn(At)
                (L * _t(R)).sum().backward()
            assert torch.isfinite(L).all() and torch.isfinite(
                At.grad).all(), f"{case}: non-finite factor or gradient"
            _close(case, L, jfn(jnp.asarray(A)))
            _close(f"{case} grad", At.grad, jax.grad(
                lambda a: jnp.sum(jfn(a) * R))(jnp.asarray(A)))
            if name == "safe_cholesky_ladder":
                want = 0 if batch == "healthy" else 1
                assert ladder.escalations == want, (
                    f"{case}: escalations {ladder.escalations} != {want}")


# ---------------------------------------------------------------------------
# natural gradients, the frozen-parameter optimizer, the single-layer
# baselines and their serving caches
# ---------------------------------------------------------------------------

NATGRAD_RTOL = 1e-9


def _check_natgrad_update(rng):
    """natgrad_update at M=7, D=3 against the JAX function: gamma 0.1 and
    1.0 on gradients a natural step can take, and gamma 1.0 where output
    dimension 1's stepped precision goes indefinite, so the reject net
    keeps its old (m, L) and counts one rejection (on the device)."""
    M_, D_ = 7, 3
    q_mu = rng.randn(M_, D_)
    q_sqrt = np.tril(rng.randn(D_, M_, M_) * 0.3) + np.eye(M_)
    dq_mu = 0.1 * rng.randn(M_, D_)
    dq_sqrt = 0.02 * np.tril(rng.randn(D_, M_, M_))
    wild = dq_sqrt.copy()
    wild[1] = 50.0 * np.tril(rng.randn(M_, M_))
    for case, gamma, dL, want_rejected in (("gamma 0.1", 0.1, dq_sqrt, 0),
                                           ("gamma 1.0", 1.0, dq_sqrt, 0),
                                           ("reject net", 1.0, wild, 1)):
        case = f"natgrad_update {case}"
        args = (q_mu, q_sqrt, dq_mu, dL)
        rejected = torch.zeros((), dtype=torch.int64)
        with no_host_reads():
            m, L = port.natgrad_update(*map(_t, args), gamma,
                                       rejected=rejected)
        jm, jL = jax.jit(jax_natgrad_update, static_argnums=4)(
            *map(jnp.asarray, args), gamma)
        for what, got, want in (("q_mu", m, jm), ("q_sqrt", L, jL)):
            assert_allclose(got.numpy(), np.asarray(want), rtol=NATGRAD_RTOL,
                            atol=1e-12, err_msg=f"{case} {what}")
        assert int(rejected) == want_rejected, (
            f"{case}: {int(rejected)} rejected, not {want_rejected}")
        moved = [not np.allclose(m.numpy()[:, d], q_mu[:, d])
                 for d in range(D_)]
        assert moved == [True, not want_rejected, True], (
            f"{case}: output dimensions moved {moved}")


def _check_frozen_optimizer(rng):
    """freeze_q_params with masked_optimizer(freeze=) train the parameters
    that the JAX trainable_mask(freeze=freeze_q_params(...)) keeps, for
    the last layer and for layers (0, -1) of a 3-layer DGP;
    partition_trainable's flat vector and its rebuild."""
    X, Y = rng.randn(20, 3), rng.randn(20, 1)
    with temp_config(jitter=1e-6):
        jm = dsd.DGP.build(X, Y, X[:5], [dsd.RBF.make(3) for _ in range(3)],
                           dsd.Gaussian.make(0.1))
    tm = port.DGP.build(X, Y, X[:5], [port.RBF(3) for _ in range(3)],
                        port.Gaussian(0.1), device="cpu")
    port.load_reference_state(tm, {k: v for k, v in _state(jm).items()})
    for ng in ((-1,), (0, -1)):
        jmask = jmodules.trainable_mask(
            jm, freeze=jax_optim.freeze_q_params(ng, 3))
        want = {_torch_key(jax.tree_util.keystr(p)) for p, v in
                jax.tree_util.tree_flatten_with_path(jmask)[0] if v}
        freeze = toptim.freeze_q_params(ng, 3)
        names = {n for n, p in tm.named_parameters()
                 if p.requires_grad and not freeze(n, p)}
        assert names == want, (
            f"freeze_q_params{ng}: trainable {sorted(names ^ want)} differ")
        params = toptim.masked_optimizer(tm, 0.01, freeze=freeze).params
        assert [id(p) for p in params] == [
            id(p) for n, p in tm.named_parameters() if n in names], (
            f"masked_optimizer(freeze=) over {ng}: not the trainable set")
        flat, rebuild = toptim.partition_trainable(tm, freeze)
        assert flat.numel() == sum(p.numel() for p in params), (
            f"partition_trainable{ng}: size {flat.numel()}")
        before = [p.detach().clone() for p in tm.parameters()]
        rebuild(flat + 1.0)
        rebuild(flat)
        assert all(torch.equal(a, b) for a, b in zip(before,
                                                     tm.parameters())), (
            f"partition_trainable{ng}: rebuild(flat) is not the identity")


def _check_linalg_helpers(rng):
    """tri_solve in inverse mode; mvn_logpdf with its gradient;
    cholesky_nan's NaN on an indefinite matrix; safe_cholesky NaN where
    every rung fails, as the JAX Cholesky (the port once returned
    cholesky_ex's partial factor there)."""
    Zh = rng.randn(6, 3)
    Zh = np.concatenate([Zh, Zh[:3]], 0)          # duplicated rows
    B = np.exp(-0.5 * ((Zh[:, None] - Zh[None]) ** 2).sum(-1)) + np.eye(9)
    L = np.linalg.cholesky(B)
    Rb = rng.randn(9, 4)
    for lower, T in ((True, L), (False, L.T)):
        for trans in (False, True):
            _close(f"tri_solve inverse lower={lower} trans={trans}",
                   tlinalg.tri_solve(_t(T), _t(Rb), lower=lower, trans=trans,
                                     mode="inverse"),
                   jlinalg.tri_solve(jnp.asarray(T), jnp.asarray(Rb),
                                     lower=lower, trans=trans,
                                     mode="inverse"))
    Yv, mu = rng.randn(9, 2), rng.randn(9, 2)
    Lt = _t(L).requires_grad_()
    lp = tlinalg.mvn_logpdf(_t(Yv), _t(mu), Lt)
    lp.sum().backward()
    _close("mvn_logpdf", lp, jlinalg.mvn_logpdf(*map(jnp.asarray,
                                                     (Yv, mu, L))))
    _close("mvn_logpdf grad L", Lt.grad, jax.grad(lambda l: jnp.sum(
        jlinalg.mvn_logpdf(jnp.asarray(Yv), jnp.asarray(mu), l)))(
        jnp.asarray(L)))
    with no_host_reads():
        nan = tlinalg.cholesky_nan(_t(np.stack([B, -np.eye(9)])))
        every_rung_fails = tlinalg.safe_cholesky(_t(-np.eye(9)), 1e-12)
    assert torch.equal(nan[0], torch.linalg.cholesky(_t(B))) and \
        torch.isnan(nan[1]).any(), "cholesky_nan"
    _close("safe_cholesky where every rung fails (NaN)",
           torch.nan_to_num(every_rung_fails, nan=7.0),
           np.nan_to_num(jlinalg.safe_cholesky(-jnp.eye(9), 1e-12), nan=7.0))


SINGLE_RTOL = 1e-9


def _single_layer_pairs(rng):
    """(name, JAX model, port model) of SVGP (white and not), GPR, SGPR
    and GPRFITC at N=14, D=2, D_Y=2, M=5 with a Linear mean function and
    moved kernel parameters, carried over with load_reference_state."""
    N_, D_, DY, M_ = 14, 2, 2, 5
    X, Y, Z = rng.rand(N_, D_), rng.randn(N_, DY), rng.rand(M_, D_)
    W = 0.3 * rng.randn(D_, DY)
    ls = rng.uniform(0.4, 0.9, D_)
    cfg = port.Config(jitter=1e-10)
    pairs = []
    with temp_config(jitter=1e-10):
        def jk():
            return dsd.RBF.make(D_, variance=1.2, lengthscales=ls)

        def jmf():
            return dsd.models.mean_functions.Linear.make(W)

        def tmf():
            return port.Linear(np.zeros((D_, DY)))

        for white in (True, False):
            jm = dsd.SVGP.build(X, Y, jk(), dsd.Gaussian.make(0.2), Z,
                                white=white, mean_function=jmf())
            layer = jm.layers[0]
            jm = jm.replace(layers=[layer.replace(
                q_mu=layer.q_mu.with_value(rng.randn(M_, DY)),
                q_sqrt=layer.q_sqrt.with_value(
                    np.tril(rng.randn(DY, M_, M_) * 0.2) + np.eye(M_)))])
            tm = port.SVGP.build(X, Y, port.RBF(D_), port.Gaussian(1.0), Z,
                                 white=white, mean_function=tmf(),
                                 config=cfg, device="cpu")
            pairs.append((f"SVGP white={white}", jm, tm))
        pairs.append(("GPR", dsd.GPR.build(X, Y, jk(), jmf(), 0.15),
                      port.GPR.build(X, Y, port.RBF(D_), tmf(), config=cfg,
                                     device="cpu")))
        pairs.append(("SGPR", dsd.SGPR.build(X, Y, jk(), Z, jmf(), 0.15),
                      port.SGPR.build(X, Y, port.RBF(D_), Z, tmf(),
                                      config=cfg, device="cpu")))
        pairs.append(("GPRFITC", dsd.GPRFITC.build(X, Y, jk(), Z, jmf(),
                                                    0.15),
                      port.GPRFITC.build(X, Y, port.RBF(D_), Z, tmf(),
                                         config=cfg, device="cpu")))
    return [(name, jm, port.load_reference_state(tm, _state(jm)))
            for name, jm, tm in pairs]


@jax.jit
def _jax_single_layer(model, Xs, Ys):
    """Bound and its gradient, predict_f(_full_cov), predict_y and
    predict_density of a JAX single-layer model, and of its precompute."""
    bound, grads = jax.value_and_grad(lambda m: m.log_likelihood())(model)
    cached = dsd.precompute(model)
    return (bound, grads, model.predict_f(Xs), model.predict_f_full_cov(Xs),
            model.predict_y(Xs), model.predict_density(Xs, Ys),
            cached.predict_f(Xs), cached.predict_f_full_cov(Xs),
            cached.predict_y(Xs), cached.predict_density(Xs, Ys))


def _check_single_layer(rng):
    """SVGP, GPR (on GPRLayer), SGPR and GPRFITC against the JAX package
    in float64 at rtol 1e-9: the bound and
    its gradients, predict_f(_full_cov), predict_y, predict_density; their
    precompute against JAX's precompute (mean, variance, y moments,
    density, full covariance) and against the live model; a cached
    request with no host read; GPR/SGPR/GPRFITC's full-batch bound
    refusing a minibatch, the cache refusing a bound."""
    Xs, Ys = rng.rand(6, 2), rng.randn(6, 2)
    for name, jm, tm in _single_layer_pairs(rng):
        (jbound, jgrads, jf, jfull, jy, jd, jcf, jcfull, jcy,
         jcd) = _jax_single_layer(jm, jnp.asarray(Xs), jnp.asarray(Ys))
        bound = tm.log_likelihood()
        assert_allclose(bound.item(), float(jbound), rtol=SINGLE_RTOL,
                        err_msg=f"{name} bound")
        bound.backward()
        want = {_torch_key(jax.tree_util.keystr(p)): g for p, g in
                jax.tree_util.tree_flatten_with_path(jgrads)[0]}
        for pname, p in tm.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            assert_allclose(g.numpy(), np.asarray(want[pname]),
                            rtol=SINGLE_RTOL, atol=1e-11,
                            err_msg=f"{name} bound gradient {pname}")
        live = (tm.predict_f(Xs), tm.predict_f_full_cov(Xs),
                tm.predict_y(Xs), (tm.predict_density(Xs, Ys),))
        cached = port.precompute(tm)
        got_c = (cached.predict_f(Xs), cached.predict_f_full_cov(Xs),
                 cached.predict_y(Xs), (cached.predict_density(Xs, Ys),))
        for what, got, cgot, want, cwant in zip(
                ("predict_f", "predict_f_full_cov", "predict_y",
                 "predict_density"), live, got_c, (jf, jfull, jy, (jd,)),
                (jcf, jcfull, jcy, (jcd,))):
            for k, (a, c, w, cw) in enumerate(zip(got, cgot, want, cwant)):
                case = f"{name} {what} output {k}"
                assert a.shape == tuple(np.shape(w)), f"{case} shape"
                assert_allclose(a.numpy(), np.asarray(w), rtol=SINGLE_RTOL,
                                atol=1e-11, err_msg=f"{case} live")
                assert_allclose(c.numpy(), np.asarray(cw), rtol=SINGLE_RTOL,
                                atol=1e-11, err_msg=f"{case} cached")
                assert_allclose(c.numpy(), a.numpy(), rtol=1e-7, atol=1e-9,
                                err_msg=f"{case} cached vs live")
        assert not any(p.requires_grad for p in cached.parameters()), (
            f"{name}: a cached parameter is trainable")
        with no_host_reads():
            request = port.make_server(tm, S=1)(Xs, seed=1)
        assert all(torch.equal(a, b) for a, b in zip(request,
                                                     cached.predict_y(Xs))), (
            f"{name}: the cached server's request")
        if name.startswith("SVGP"):
            continue
        assert tm.full_batch_bound, f"{name}: not a full-batch bound"
        for what, fn in (("fit(batch_size=5)",
                          lambda: port.fit(tm, iterations=1, batch_size=5)),
                         ("the cache's bound", cached.elbo)):
            try:
                fn()
            except (ValueError, NotImplementedError):
                pass
            else:
                raise AssertionError(f"{name}: {what} did not raise")


# ---------------------------------------------------------------------------
# the collapsed DGPs' data-parallel bounds: the port's gloo ranks (spawned
# CPU processes running tests/test_torch_ranks.py) against the JAX
# package's shard_map functions on the CPU devices of tests/conftest.py
# ---------------------------------------------------------------------------

RANKS_TIMEOUT_S = 240.0


def _collapsed_dp_models(rng):
    """(JAX model, port model) of DGPDamianou (L=2, hidden width 2, its
    q(H) moved off the initialization) and of DGPCollapsed with an SGPR
    and with a GPR final layer (an SVGP inner layer of width 2, its q_mu
    moved), 16 rows, M=5; and DGPHeinonen (for its refusal)."""
    from doubly_stochastic_dgp_tpu.models.layers import GPRLayer as JGPR
    N, D, Mi = 16, 2, 5
    X = rng.randn(N, D)
    Y = np.sin(X[:, :1]) + 0.1 * rng.randn(N, 1)
    Z = X[:Mi]
    cfg = port.Config()
    out = {}
    with temp_config(jitter=1e-6, solve_mode="solve", use_pallas=False):
        jd = dsd.DGPDamianou.build(
            X, Y, Z, [dsd.RBF.make(D), dsd.RBF.make(D, lengthscales=1.3)],
            dsd.Gaussian.make(0.05))
        jd = jd.replace(
            h_var=[p.with_value(np.exp(rng.randn(N, D)) * 0.05)
                   for p in jd.h_var],
            h_mean=[p.with_value(p.value + 0.3 * rng.randn(N, D))
                    for p in jd.h_mean])
        td = port.DGPDamianou.build(X, Y, Z, [port.RBF(D), port.RBF(D)],
                                    port.Gaussian(1.0), config=cfg,
                                    device="cpu")
        out["damianou"] = (jd, td)
        for last in ("sgpr", "gpr"):
            jl = dsd.init_layers_linear(
                X, Y, Z, [dsd.RBF.make(D), dsd.RBF.make(D, lengthscales=1.2)],
                num_outputs=1)
            top = jl[-1]
            fin = (JSGPRLayer.make(top.kern, np.asarray(top.Z.value), 1,
                                   top.mean_function) if last == "sgpr"
                   else JGPR.make(top.kern, top.mean_function, 1))
            inner = jl[0].replace(q_mu=jl[0].q_mu.with_value(
                rng.randn(Mi, D) * 0.4))
            jc = dsd.DGPCollapsed.make(X, Y, dsd.Gaussian.make(0.05),
                                       [inner, fin])
            tl = port.init_layers_linear(X, Y, Z, [port.RBF(D),
                                                   port.RBF(D)],
                                         num_outputs=1, config=cfg)
            tfin = (port.SGPRLayer(tl[-1].kern, Z, 1, tl[-1].mean_function,
                                   config=cfg) if last == "sgpr"
                    else port.GPRLayer(tl[-1].kern, tl[-1].mean_function, 1,
                                       config=cfg))
            tc = port.DGPCollapsed.make(X, Y, port.Gaussian(1.0),
                                        [tl[0], tfin], config=cfg,
                                        device="cpu")
            out[last] = (jc, tc)
        jh = dsd.DGPHeinonen.make(X, Y, dsd.Gaussian.make(0.05), [
            dsd.GPMCLayer.make(dsd.RBF.make(D), X, D, dsd.Identity()),
            dsd.GPRLayer.make(dsd.RBF.make(D), dsd.Zero(output_dim=1), 1)])
    th = port.DGPHeinonen.make(X, Y, port.Gaussian(0.05), [
        port.GPMCLayer(port.RBF(D), X, D, port.Identity(), config=cfg),
        port.GPRLayer(port.RBF(D), port.Zero(1), 1, config=cfg)],
        config=cfg, device="cpu")
    for key, (jm, tm) in out.items():
        port.load_reference_state(tm, _state(jm))
    out["heinonen"] = (jh, th)
    return out


def _jax_replicated_damianou(m):
    """The Damianou bound with every per-row sum held constant
    (stop_gradient): the gradient of its replicated algebra alone."""
    from doubly_stochastic_dgp_tpu.parallel import collapsed as jcoll
    sg = jax.lax.stop_gradient
    total, L = 0.0, len(m.layers)
    for l, layer in enumerate(m.layers):
        mu, sv, T, var_l = m._layer_data(l)
        sigma2 = layer.set_data(mu, sv, T, var_l)._bound_variance()
        phi, P2, P1T, st2, sp0 = map(sg, jcoll._layer_moments(layer, mu, sv,
                                                              T))
        Lc, LB, c, tr = jcoll._assemble(layer, P2, P1T, sigma2)
        g = jcoll._layer_bound(mu.shape[0], T.shape[1], sigma2, LB, c, st2,
                               sp0, tr, mu.dtype)
        if l < L - 1:
            s = sg(m.h_var[l].value)
            Vh = jlinalg.tri_solve(Lc, jnp.eye(P2.shape[0]), lower=True)
            V = jlinalg.tri_solve(LB, Vh, lower=True) / sigma2
            g = g + 0.5 * jnp.sum(jnp.sum((V @ phi) ** 2, axis=0)[:, None]
                                  * s) - 0.5 * jnp.sum(s) / sigma2
        total = total + g
    return total


def _named(jax_tree):
    """{port parameter name: numpy array} of a JAX pytree."""
    return {_torch_key(k): v for k, v in _state(jax_tree).items()}


def _jax_collapsed_bound(m, zs):
    """The single-device DGPCollapsed bound at fixed inner draws."""
    last = m._collapsed_last_layer(key=jax.random.PRNGKey(0), zs=zs)
    KL = sum((layer.KL() for layer in m.layers[:-1]),
             jnp.zeros((), dtype=m.X_data.dtype))
    return last.build_likelihood() - KL


def _check_parallel(rng):
    """dp_damianou_elbo and dp_collapsed_elbo (SGPR and GPR final layers)
    on 2 gloo ranks: values against the JAX package's on 2 devices (rtol
    1e-10), gradients against its single-device gradients (rtol 1e-8),
    each rank's q(H) rows with their own rows' gradients, the replicated
    algebra counted once; one step of each collapsed train step against
    the port's single-process Adam step on the same draws; the refusals
    (DGPHeinonen, shapes that do not divide); the mesh helpers.

    Output-dimension and pipeline parallelism (``parallel/outdim.py``,
    ``parallel/pp.py``) on the same 2 ranks and on 4: ``outdim_elbo``,
    ``elbo_2d``, ``elbo_3d`` and ``pp_elbo`` within rtol 1e-10 of the JAX
    functions on the same zs, their gradients within rtol 1e-8 of
    ``jax.grad`` of JAX's single-device bound (MultiClass, input
    propagation, split-final heads, remat, the shift),
    seeded draws against a one-process emulation of the port's scheme,
    one step of each factory against one process's Adam step, the
    placements, specs, asserts, refusals and the bubble warning.  JAX's
    own tests run 2 x 4, 4 x 2 and 2 x 2 x 2 meshes of 8 devices; here
    they are 2 x 2, (2 x 1 x 2) and (1 x 2 x 2) on 4 ranks: 8 spawned
    ranks beside the test workers would overload the host."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor
    import test_torch_ranks as ranks
    from doubly_stochastic_dgp_tpu.parallel import collapsed as jcoll
    from doubly_stochastic_dgp_tpu.parallel import mesh as jmesh
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import (
        rank_generator, run_ranks)

    pairs = _collapsed_dp_models(rng)
    N = pairs["sgpr"][1].X_data.shape[0]
    zs = [rng.randn(1, N, 2), rng.randn(1, N, 1)]
    payload = {k: pickle.dumps(tm) for k, (_, tm) in pairs.items()}
    payload["zs"] = zs
    od = _outdim_pp_setup()
    payload["outdim_pp"] = od["payload"]
    # the ranks run while this process computes the JAX oracles
    pool = ThreadPoolExecutor(2)
    run = pool.submit(run_ranks, ranks.modules_ranks, 2, (payload,),
                      device="cpu", threads=1, timeout_s=RANKS_TIMEOUT_S)
    run4 = pool.submit(run_ranks, ranks.outdim_pp_mesh4_ranks, 4,
                       (od["payload"],), device="cpu", threads=1,
                       timeout_s=RANKS_TIMEOUT_S)
    pool.shutdown(wait=False)
    mesh2 = jmesh.make_mesh(num_devices=2)
    jzs = [jnp.asarray(z) for z in zs]
    jd, td = pairs["damianou"]
    want_dam = float(jax.jit(lambda m: jcoll.dp_damianou_elbo(m, mesh2))(
        jcoll.damianou_shard(jd, mesh2)))
    grads_dam = _named(jax.jit(jax.grad(lambda m: m.elbo()))(jd))
    rep = _named(jax.jit(jax.grad(_jax_replicated_damianou))(jd))
    want_c = {case: (float(jax.jit(lambda m, z: jcoll.dp_collapsed_elbo(
        m, mesh2, zs=z))(pairs[case][0], jzs)), _named(jax.jit(jax.grad(
            _jax_collapsed_bound))(pairs[case][0], jzs)))
        for case in ("sgpr", "gpr")}
    od_oracles = _outdim_pp_oracles(od)
    res = run.result()
    _outdim_pp_checks(od, od_oracles, [x["outdim_pp"] for x in res],
                      run4.result())
    for key in res[0]:
        if key not in ("damianou placed", "damianou step", "shard_along",
                       "gather", "outdim_pp"):
            assert pickle.dumps(res[0][key]) == pickle.dumps(res[1][key]), (
                f"collapsed dp {key}: the ranks disagree")
    out = res[0]
    want, grads = want_dam, grads_dam
    assert_allclose(out["damianou whole"], want, rtol=1e-10,
                    err_msg="dp_damianou_elbo (whole model) vs JAX")
    rows = {n for n in grads if n.startswith(("h_mean", "h_var"))}
    for r, (value, got) in enumerate(x["damianou placed"] for x in res):
        assert_allclose(value, want, rtol=1e-10,
                        err_msg="dp_damianou_elbo (placed) vs JAX")
        for name, g in got.items():
            w = grads[name][r * N // 2:(r + 1) * N // 2] if name in rows \
                else grads[name]
            assert_allclose(g, w, rtol=1e-8, atol=1e-10,
                            err_msg=f"dp_damianou_elbo rank {r}: gradient "
                                    f"of {name} (q(H) rows: its own)")
    margin = max(float(np.max(np.abs(rep[k]) / (
        1e-10 + 1e-8 * np.abs(grads[k])))) for k in grads if k not in rows)
    assert margin > 1e3, (
        f"dp_damianou_elbo (a replicated term counted once): counting the "
        f"replicated algebra twice would move the gradient by only "
        f"{margin:.3g} tolerances")
    specs = {_torch_key(jax.tree_util.keystr(p)): (None if s == P() else
                                                   s[0])
             for p, s in jax.tree_util.tree_flatten_with_path(
                 jcoll.damianou_specs(jd),
                 is_leaf=lambda x: isinstance(x, P))[0]}
    assert out["damianou specs"] == {k: specs[k]
                                     for k in out["damianou specs"]}, (
        f"damianou_specs: {out['damianou specs']} vs JAX {specs}")
    # one step: the single-process Adam step on the whole rows
    opt = toptim.masked_optimizer(td, 0.01)
    toptim.make_train_step(lambda m: -(m.elbo() + port.log_prior(m)),
                           opt)(td)
    for r, (_, params) in enumerate(x["damianou step"] for x in res):
        for name, p in td.named_parameters():
            w = p.detach().numpy()
            if name.startswith(("h_mean", "h_var")):
                w = w[r * N // 2:(r + 1) * N // 2]
            assert_allclose(params[name], w, rtol=1e-9, atol=1e-12,
                            err_msg=f"make_dp_damianou_train_step rank "
                                    f"{r}: {name}")

    for case in ("sgpr", "gpr"):
        value, got = out[f"collapsed {case}"]
        want, grads = want_c[case]
        assert_allclose(value, want, rtol=1e-10,
                        err_msg=f"dp_collapsed_elbo {case} vs JAX")
        assert_allclose(out[f"collapsed {case} placed"], want, rtol=1e-10,
                        err_msg=f"dp_collapsed_elbo {case} (placed) vs JAX")
        for name, g in got.items():
            assert_allclose(g, grads[name], rtol=1e-8, atol=1e-10,
                            err_msg=f"dp_collapsed_elbo {case}: gradient "
                                    f"of {name}")
    # one step at seed 5: rank r draws its rows' inner normals from
    # rank_generator(5, r)
    _, tc = pairs["sgpr"]
    z = torch.cat([torch.randn((1, N // 2, 2), generator=rank_generator(
        5, r, "cpu"), dtype=torch.float64) for r in range(2)], dim=1)
    opt = toptim.masked_optimizer(tc, 0.01)
    loss = toptim.make_train_step(
        lambda m: -(m.elbo(zs=[z]) + port.log_prior(m)), opt)(tc)
    step_loss, params = out["collapsed step"]
    assert_allclose(step_loss, float(loss), rtol=1e-10,
                    err_msg="make_dp_collapsed_train_step: loss")
    for name, p in tc.named_parameters():
        assert_allclose(params[name], p.detach().numpy(), rtol=1e-9,
                        atol=1e-12,
                        err_msg=f"make_dp_collapsed_train_step: {name}")

    try:
        jcoll.dp_collapsed_elbo(pairs["heinonen"][0], mesh2)
    except NotImplementedError as e:
        assert out["heinonen"] == ("NotImplementedError", str(e)), (
            f"dp_collapsed_elbo on DGPHeinonen: {out['heinonen']}")
    assert_allclose(out["pad"], np.asarray(jmesh.pad_to_multiple(
        jnp.arange(10.0).reshape(5, 2), 4)[0]), rtol=0,
        err_msg="pad_to_multiple vs JAX")
    assert [x["shard_along"].tolist() for x in res] == [[0, 1, 2],
                                                        [3, 4, 5]], (
        "shard_along: each rank its block")
    assert out["shard_along 5"][0] == "ValueError", "shard_along: 5 rows"
    assert [x["replicate"].tolist() for x in res] == [[1.0] * 3] * 2, (
        "replicate: rank 0's values everywhere")
    assert [x["gather"].ravel().tolist() for x in res] == [
        [0, 0, 1, 1]] * 2, "all_gather: the ranks' blocks in order"
    assert out["make_mesh 3"][0] == "ValueError", "make_mesh(num_devices=3)"


# ---------------------------------------------------------------------------
# output-dimension and pipeline parallelism on gloo ranks against the JAX
# package's parallel/outdim.py and parallel/pp.py
# ---------------------------------------------------------------------------

def _pair(jm, tm):
    port.load_reference_state(tm, _state(jm))
    return jm, tm


def _od_pair(seed, N=12, D=4, M=5, S=3, D_Y=4):
    """A Gaussian DGP of two D -> D -> D_Y layers (Identity, then Zero
    mean), its q_mu moved off zero: (JAX model, port model)."""
    rng = np.random.RandomState(seed)
    X, Y, Z = rng.randn(N, D), rng.randn(N, D_Y), rng.randn(M, D)
    jm = dsd.DGP.build(X, Y, Z, [dsd.RBF.make(D), dsd.RBF.make(D)],
                       dsd.Gaussian.make(0.1), num_samples=S,
                       num_outputs=D_Y)
    jm = jm.replace(layers=[l.replace(q_mu=l.q_mu.with_value(
        0.5 * rng.randn(*l.q_mu.value.shape))) for l in jm.layers])
    tm = port.DGP.build(X, Y, Z, [port.RBF(D), port.RBF(D)],
                        port.Gaussian(0.1), num_samples=S, num_outputs=D_Y,
                        device="cpu")
    return _pair(jm, tm)


def _mc_pair(seed, N=16, D=784, H=12, K=10, M=8, S=2):
    """The MNIST-shaped MultiClass DGP of ``tests/test_outdim.py`` (D ->
    H with a Linear mean -> K latent GPs under robust-max)."""
    rng = np.random.RandomState(seed)
    X, Y = rng.randn(N, D), rng.randint(0, K, size=(N, 1))
    Z = X[:M].copy()
    jm = dsd.DGP.build(X, Y, Z, [dsd.RBF.make(D), dsd.RBF.make(H)],
                       dsd.MultiClass.make(K), num_samples=S, num_outputs=K)
    jm = jm.replace(layers=[l.replace(q_mu=l.q_mu.with_value(
        0.5 * rng.randn(*l.q_mu.value.shape))) for l in jm.layers])
    tm = port.DGP.build(X, Y, Z, [port.RBF(D), port.RBF(H)],
                        port.MultiClass(K), num_samples=S, num_outputs=K,
                        device="cpu")
    return _pair(jm, tm)


def _prop_pair(seed, N=10, D=2, M=5, S=2, D_Y=2):
    """An input-propagation stack D -> (2 hidden + D propagated) ->
    D_Y."""
    rng = np.random.RandomState(seed)
    X, Y, Z = rng.randn(N, D), rng.randn(N, D_Y), rng.randn(M, D)
    jl = dsd.init_layers_input_prop(X, Y, Z, [dsd.RBF.make(D),
                                              dsd.RBF.make(D + 2)],
                                    num_outputs=D_Y)
    jl = [l.replace(q_mu=l.q_mu.with_value(0.5 * rng.randn(
        *l.q_mu.value.shape))) for l in jl]
    jm = dsd.DGPBase.make(X, Y, dsd.Gaussian.make(0.1), jl,
                                     num_samples=S)
    tl = port.init_layers_input_prop(X, Y, Z, [port.RBF(D),
                                               port.RBF(D + 2)],
                                     num_outputs=D_Y)
    tm = port.DGPBase.make(X, Y, port.Gaussian(0.1), tl, num_samples=S,
                           device="cpu")
    return _pair(jm, tm)


def _pp_pair(seed, N=16, D=3, M=6, S=2, L=4):
    """The homogeneous D -> D Identity-mean stack of ``tests/test_pp.py``,
    each layer's kernel and q_mu its own."""
    rng = np.random.RandomState(seed)
    X, Y, Z = rng.randn(N, D), rng.randn(N, D), rng.randn(M, D)
    jm = dsd.DGP.build(X, Y, Z, [dsd.RBF.make(D, variance=0.5 + 0.3 * l,
                                              lengthscales=1.0 + 0.2 * l)
                                 for l in range(L)],
                       dsd.Gaussian.make(0.1), num_outputs=D,
                       mean_function=dsd.Identity(), num_samples=S)
    jm = jm.replace(layers=[l.replace(q_mu=l.q_mu.with_value(
        0.3 * rng.randn(M, D))) for l in jm.layers])
    tm = port.DGP.build(X, Y, Z, [port.RBF(D) for _ in range(L)],
                        port.Gaussian(0.1), num_outputs=D,
                        mean_function=port.Identity(), num_samples=S,
                        device="cpu")
    return _pair(jm, tm)


def _flag_pair(seed, N=16, D=3, M=5, S=2, L=3):
    """The paper's shape: RBF+White D -> D trunk layers under a distinct
    RBF D -> 1 Zero-mean head."""
    rng = np.random.RandomState(seed)
    X, Y, Z = rng.randn(N, D), rng.randn(N, 1), rng.randn(M, D)
    jm = dsd.DGP.build(X, Y, Z, [
        dsd.RBF.make(D, lengthscales=1.0 + 0.2 * l)
        + dsd.White.make(D, variance=2e-6, trainable=False)
        for l in range(L - 1)] + [dsd.RBF.make(D)], dsd.Gaussian.make(0.1),
        num_samples=S)
    layers = list(jm.layers)
    layers[:-1] = [l.replace(q_mu=l.q_mu.with_value(0.3 * rng.randn(M, D)))
                   for l in layers[:-1]]
    jm = jm.replace(layers=layers)
    tm = port.DGP.build(X, Y, Z, [
        port.RBF(D) + port.White(D, variance=2e-6, trainable=False)
        for _ in range(L - 1)] + [port.RBF(D)], port.Gaussian(0.1),
        num_samples=S, device="cpu")
    return _pair(jm, tm)


def _jax_single_elbo(m, zs):
    """The single-device bound of ``tests/test_outdim.py`` at fixed zs."""
    _, Fm, Fv = m.propagate(m.X_data, zs=zs, S=m.num_samples)
    ve = m.likelihood.variational_expectations(Fm[-1], Fv[-1], m.Y_data)
    KL = sum((l.KL() for l in m.layers), jnp.zeros((), dtype=ve.dtype))
    return jnp.sum(jnp.mean(ve, 0)) - KL


def _zs(rng, m, rows):
    S = m.num_samples
    return [rng.randn(S, rows, l.num_outputs) for l in m.layers]


def _block(full, shape, r):
    """Rank r's block of a whole leaf where its placed ``shape`` differs
    (its columns, rows or layers)."""
    full = np.asarray(full)
    for d, (a, b) in enumerate(zip(full.shape, shape)):
        if a != b:
            return np.take(full, range(r * b, (r + 1) * b), axis=d)
    return full


def _check_grads(case, res, grads, r=0):
    value, got = res
    for name, g in got.items():
        assert_allclose(g, _block(grads[name], g.shape, r), rtol=1e-8,
                        atol=1e-10, err_msg=f"{case} rank {r}: gradient of "
                                            f"{name}")
    return value


def _single_step(tm, zs):
    """The port's single-process Adam step on -(elbo + log prior) at fixed
    draws, on a copy: (loss, parameters)."""
    import copy
    m = copy.deepcopy(tm)
    zs = [torch.as_tensor(z) for z in zs]
    loss = toptim.make_train_step(
        lambda m: -(m.elbo(zs=zs) + port.log_prior(m)),
        toptim.masked_optimizer(m, 0.01))(m)
    return float(loss), {n: p.detach().numpy()
                         for n, p in m.named_parameters()}


def _check_step(case, got, want, stacked=None):
    """A rank's step (loss, parameters) against one process's; a placed
    rank's blocks against the whole parameters' (``stacked``: the number
    of trunk layers of a pp-stacked model)."""
    (loss, params), r = got
    assert_allclose(loss, want[0], rtol=1e-10, err_msg=f"{case}: loss")
    for name, p in params.items():
        if stacked is not None and name.startswith("layers.0."):
            rest = name.split(".", 2)[2]
            w = np.stack([want[1][f"layers.{i}.{rest}"]
                          for i in range(stacked)])
        elif stacked is not None and name.startswith("layers.1."):
            w = want[1][f"layers.{stacked}.{name.split('.', 2)[2]}"]
        else:
            w = want[1][name]
        assert_allclose(p, _block(w, p.shape, r), rtol=1e-9, atol=1e-12,
                        err_msg=f"{case} rank {r}: {name}")


def _specs_of(jspecs):
    return {_torch_key(jax.tree_util.keystr(p)): tuple(s)
            for p, s in jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, P))[0]}


def _port_pp_model(seed, N=16, D=3, M=6, S=2, L=2):
    """The port's side of :func:`_pp_pair` alone (cases with no JAX
    oracle)."""
    rng = np.random.RandomState(seed)
    X, Y, Z = rng.randn(N, D), rng.randn(N, D), rng.randn(M, D)
    tm = port.DGP.build(X, Y, Z, [port.RBF(D) for _ in range(L)],
                        port.Gaussian(0.1), num_outputs=D,
                        mean_function=port.Identity(), num_samples=S,
                        device="cpu")
    for layer in tm.layers:
        layer.q_mu.set_value(0.3 * rng.randn(M, D))
    return tm


def _outdim_pp_setup():
    """The output-dimension and pipeline cases' models (JAX and port
    pairs; port models alone where no JAX oracle is compared), their
    fixed draws and the ranks' payload."""
    import pickle
    odd = port.DGP.build(*np.random.RandomState(43).randn(3, 6, 3),
                         [port.RBF(3), port.RBF(3)], port.Gaussian(0.1),
                         num_outputs=3, device="cpu")
    pairs = {"gauss4": _od_pair(44, N=16, S=4),
             "mc": _mc_pair(41, N=8, D=12, H=4, K=4, M=4, S=2),
             "prop": _prop_pair(42), "pp4": _pp_pair(49),
             "flag": _flag_pair(52, N=8, S=1)}
    alone = {"odd": odd, "keyed": _port_pp_model(50, N=12, S=3),
             "pp3": _port_pp_model(54, L=3)}
    # a prior on sharded leaves (q_mu), for the steps' MAP objective: a
    # placed rank's share of it summed over the dim or stage axis
    for k in ("gauss4", "flag"):
        for layer in pairs[k][1].layers:
            layer.q_mu.prior = ("gaussian", 0.0, 1.0)
    zrng = np.random.RandomState(55)
    zs = {k: _zs(zrng, pairs[k][1], 1) for k in ("gauss4", "mc", "prop")}
    zs["pp4"] = np.stack(_zs(zrng, pairs["pp4"][1], 16))
    # the trunk's draws; the head draws nothing (its moments are scored)
    zs["flag"] = np.stack(_zs(zrng, pairs["flag"][1], 8)[:-1])
    payload = {k: pickle.dumps(tm) for k, (_, tm) in pairs.items()}
    payload.update({k: pickle.dumps(tm) for k, tm in alone.items()})
    payload.update({f"zs {k}": z for k, z in zs.items()})
    return {"pairs": pairs, "alone": alone, "zs": zs, "payload": payload}


def _outdim_pp_oracles(od):
    """The JAX package's values (its mesh functions, jitted: eager, each
    shard_map and stack op compiles on its own), its single-device
    gradients, specs and messages; the port's single-process steps and
    the one-process emulations of its seeded draws."""
    from jax.sharding import Mesh
    from doubly_stochastic_dgp_tpu.parallel import mesh as jmesh
    from doubly_stochastic_dgp_tpu.parallel import outdim as jod
    from doubly_stochastic_dgp_tpu.parallel import pp as jpp
    from doubly_stochastic_dgp_tpu_torch.graphs import randn
    from doubly_stochastic_dgp_tpu_torch.parallel import pp as tpp
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import rank_generator

    pairs, zs = od["pairs"], od["zs"]
    devs = np.asarray(jax.devices()[:4])
    meshes = {"dim2": jmesh.make_mesh(num_devices=2, axis="dim"),
              "stage2": jmesh.make_mesh(num_devices=2, axis="stage"),
              "dd": Mesh(devs.reshape(2, 2), ("data", "dim")),
              "212": Mesh(devs.reshape(2, 1, 2), ("data", "sample", "dim")),
              "122": Mesh(devs.reshape(1, 2, 2), ("data", "sample", "dim")),
              "121": Mesh(devs[:2].reshape(1, 2, 1), ("data", "sample",
                                                     "dim")),
              "ds": Mesh(devs.reshape(2, 2), ("data", "stage"))}
    jzs = {k: (jnp.asarray(z) if isinstance(z, np.ndarray)
               else [jnp.asarray(a) for a in z]) for k, z in zs.items()}
    def outdim(fn, mesh, **kw):
        return lambda m, z: fn(m, m.X_data, m.Y_data, None, meshes[mesh],
                               zs=z, **kw)

    def pp(mesh, split=False, **kw):
        return lambda m, z: jpp.pp_elbo(
            jpp.pp_stack(m, split_final=split), m.X_data, m.Y_data, None,
            meshes[mesh], zs=z, **kw)

    def single(split=None):
        """JAX's single-device bound and its gradients (stacked, for a
        stacked (L, S, N, D) zs; the split-final head's draw is not used:
        zeros in its place)."""
        vg = jax.value_and_grad(_jax_single_elbo)
        if split is None:
            return vg
        head = [jnp.zeros((1, 8, 1))] if split else []

        def f(m, z):
            value, g = vg(m, list(z) + head)
            return value, jpp.pp_stack(g, split_final=split)

        return f

    # one jitted program a model and device set (eager, each shard_map
    # and stack op compiles on its own): (model, {case: its value, or the
    # single-device (value, gradients)}); each mesh function of JAX's
    # runs once, the other port cases are held against the single-device
    # bound, which those functions equal (tests/test_outdim.py and
    # tests/test_pp.py)
    programs = [
        ("gauss4", {"gauss4": single(),
                    "3d gauss4": outdim(jod.elbo_3d, "212")}),
        ("mc", {"mc": single(), "2d mc": outdim(jod.elbo_2d, "dd")}),
        ("prop", {"prop": single(),
                  "outdim prop": outdim(jod.outdim_elbo, "dim2",
                                        axis="dim")}),
        ("pp4", {"pp4": single(False),
                 "ppdp": pp("ds", n_micro=2, data_axis="data")}),
        ("flag", {"flag": single(True),
                  "pp flag": pp("stage2", split=True, n_micro=2)}),
    ]
    want, grads = {}, {}
    for model, fns in programs:
        outs = jax.jit(lambda m, z, fns=fns: {k: f(m, z) for k, f in
                                              fns.items()})(
            pairs[model][0], jzs[model])
        for k, v in outs.items():
            if isinstance(v, tuple):
                v, grads[k] = v[0], _named(v[1])
            want[k] = float(v)
    jspecs = {"gauss4": _specs_of(jod.outdim_specs(pairs["gauss4"][0])),
              "mc": _specs_of(jod.outdim_specs(pairs["mc"][0])),
              "pp4": _specs_of(jpp.pp_specs(jax.eval_shape(
                  jpp.pp_stack, pairs["pp4"][0]))),
              "flag": _specs_of(jpp.pp_specs(jax.eval_shape(
                  lambda m: jpp.pp_stack(m, split_final=True),
                  pairs["flag"][0])))}
    jf = pairs["flag"][0]
    j3 = _error(lambda: jod.elbo_3d(jf, jf.X_data, jf.Y_data,
                                    jax.random.PRNGKey(0), meshes["121"]))
    _check_pp_refusals(jpp, tpp, pairs["pp4"])
    # the port's single-process steps on the same draws
    steps = {"gauss4": _single_step(pairs["gauss4"][1], zs["gauss4"]),
             "flag": _single_step(pairs["flag"][1], list(zs["flag"]) + [
                 np.zeros((1, 8, 1))]),
             "pp4": _single_step(pairs["pp4"][1], list(zs["pp4"]))}
    # the seeded draws, emulated in one process: outdim's rank k draws
    # its columns of each layer from rank_generator(5, k); pp's layer gl
    # on microbatch j from rank_generator(7, gl * n_micro + j)
    tm = pairs["gauss4"][1]
    per_rank = [[randn((4, 16, l.num_outputs // 2), g, torch.float64, "cpu")
                 for l in tm.layers]
                for g in (rank_generator(5, k, "cpu") for k in range(2))]
    with torch.no_grad():
        seeded = {"outdim": float(tm.elbo(zs=[torch.cat(
            [d[i] for d in per_rank], dim=2) for i in range(2)]))}
        tk = od["alone"]["keyed"]
        S, b, nm = tk.num_samples, 4, 3
        ve_sum = 0.0
        for j in range(nm):
            zj = [randn((S, b, 3), rank_generator(7, gl * nm + j, "cpu"),
                        torch.float64, "cpu") for gl in range(2)]
            Fm, Fv = tk._predict(tk.X_data[j * b:(j + 1) * b], S=S, zs=zj)
            ve = tk.likelihood.variational_expectations(
                Fm, Fv, tk.Y_data[j * b:(j + 1) * b])
            ve_sum += float(torch.sum(torch.mean(ve, dim=0)))
        seeded["pp"] = ve_sum - float(sum(l.KL() for l in tk.layers))
    return {"want": want, "grads": grads, "specs": jspecs, "j3": j3,
            "steps": steps, "seeded": seeded}


def _outdim_pp_checks(od, oracles, res2, res4):
    """The ranks' outdim and pp results against the oracles: values
    within rtol 1e-10 of JAX's mesh functions, gradients (whole and
    placed models, each rank's block) within rtol 1e-8 of JAX's
    single-device ones, the steps, the seeded draws, the placements and
    the messages."""
    import pickle
    pairs = od["pairs"]
    want, grads, jspecs, steps = (oracles[k] for k in ("want", "grads",
                                                       "specs", "steps"))
    for res, what in ((res2, "2"), (res4, "4")):
        for key in res[0]:
            if "placed" in key or key.startswith(("coords", "shift")):
                continue
            assert pickle.dumps(res[0][key]) == pickle.dumps(
                res[1][key]), f"outdim/pp {key} on {what} ranks: the ranks " \
                              f"disagree"
    out, out4 = res2[0], res4[0]
    # each port value against JAX's mesh function where it ran, else its
    # single-device bound
    ref = {"prop": "outdim prop", "dim4": "gauss4", "2d gauss4": "gauss4",
           "2d mc": "2d mc", "3d gauss4": "3d gauss4", "3d mc": "mc"}
    for case in ("gauss4", "mc", "prop"):
        for r, x in enumerate(res2):
            for kind in ("", " placed"):
                value = _check_grads(f"outdim_elbo {case}{kind}",
                                     x[f"outdim {case}{kind}"], grads[case],
                                     r)
                for w in {case, ref.get(case, case)}:
                    assert_allclose(value, want[w], rtol=1e-10,
                                    err_msg=f"outdim_elbo {case}{kind} vs "
                                            f"JAX's {w}")
    for case in ("dim4", "2d gauss4", "2d mc", "3d gauss4", "3d mc"):
        assert_allclose(out4[case], want[ref[case]], rtol=1e-10,
                        err_msg=f"outdim {case} vs JAX's {ref[case]}")
    assert_allclose(out["outdim seed"], oracles["seeded"]["outdim"],
                    rtol=1e-10,
                    err_msg="outdim_elbo seeded vs its one-process emulation")
    for name in ("gauss4", "mc"):
        got = out[f"outdim specs {name}"]
        assert got == jspecs[name], f"outdim_specs {name}: {got} vs JAX " \
                                    f"{jspecs[name]}"
    for r, x in enumerate(res2):
        _check_step("make_outdim_train_step (placed)",
                    (x["outdim step placed"], r), steps["gauss4"])
        _check_step("make_outdim_train_step (whole)",
                    (x["outdim step whole"], 0), steps["gauss4"])
        for name, shape in x["outdim placed shapes"].items():
            full = pairs["gauss4"][1].get_parameter(name).shape
            block = tuple(n // 2 if ax == "dim" else n
                          for n, ax in zip(full, jspecs["gauss4"][name]))
            assert shape == block, (
                f"outdim_shard: {name} holds {shape}, its block is {block}")
    assert out["outdim original unchanged"], (
        "outdim: a step on the placed model changed the model it was placed "
        "from")
    assert out["outdim whole structure"] == [
        (l.num_outputs_, type(l.mean_function).__name__,
         tuple(l.q_mu.unconstrained.shape)) for l in pairs["gauss4"][1].layers
    ], f"outdim: a step changed the layers {out['outdim whole structure']}"
    assert out["outdim odd"] == ("AssertionError", "layer D_out=3 not "
                                 "divisible by mesh axis size 2"), (
        f"outdim_elbo on D_out=3 over 2 ranks: {out['outdim odd']}")
    j3 = oracles["j3"]
    assert j3[0] == "AssertionError" and out["elbo_3d S=1"] == j3, (
        f"elbo_3d with S=1 over 2 sample ranks: {out['elbo_3d S=1']} vs "
        f"JAX {j3}")
    for r, x in enumerate(res4):
        _check_step("make_2d_train_step (placed)", (x["2d step placed"],
                                                   x["coords"][1]),
                    steps["gauss4"])
        _check_step("make_3d_train_step (whole)", (x["3d step whole"], 0),
                    steps["gauss4"])
        _check_step("make_pp_train_step data x stage (placed)",
                    (x["pp data step placed"], r % 2), steps["pp4"],
                    stacked=4)

    assert_allclose(out["pp 2 a stage"], want["pp4"], rtol=1e-10,
                    err_msg="pp_elbo 2 layers a stage, 8 microbatches vs "
                            "JAX's single-device bound")
    assert_allclose(out4["pp data"], want["ppdp"], rtol=1e-10,
                    err_msg="pp_elbo on data x stage vs JAX")
    assert_allclose(out["pp keyed"], oracles["seeded"]["pp"], rtol=1e-10,
                    err_msg="pp_elbo seeded vs its one-process emulation")
    for case in ("pp4", "flag"):
        for r, x in enumerate(res2):
            for kind in ("", " placed", " remat"):
                value = _check_grads(f"pp_elbo {case}{kind}",
                                     x[f"pp {case}{kind}"], grads[case], r)
                for w in {case, "pp flag" if case == "flag" else case}:
                    assert_allclose(value, want[w], rtol=1e-10,
                                    err_msg=f"pp_elbo {case}{kind} vs JAX's "
                                            f"{w}")
            assert pickle.dumps(x[f"pp {case} remat"]) == pickle.dumps(
                x[f"pp {case}"]), (
                f"pp_elbo {case}: remat changed the value or a gradient")
        assert out[f"pp {case} specs"] == jspecs[case], (
            f"pp_specs {case}: {out[f'pp {case} specs']} vs JAX "
            f"{jspecs[case]}")
    for r, x in enumerate(res2):
        for name, shape in x["pp placed shapes"].items():
            if name.startswith("layers.0."):
                assert shape[0] == 1, f"pp_shard: {name} holds {shape}"
        _check_step("make_pp_train_step split_final (placed)",
                    (x["pp step placed"], r), steps["flag"], stacked=2)
    msgs, n_warned = out["pp bubble warnings"]
    assert n_warned == 1 and len(msgs) == 1 and "bubbles" in msgs[0], (
        f"pp_elbo bubble warning: {msgs}, {n_warned} at n_micro=2")
    assert out["pp L=3"] == ("ValueError", "L=3 layers must divide over the "
                             "'stage' axis (2 stages)"), out["pp L=3"]
    # rank r holds x0 + 10 r: rank 1 receives rank 0's; the gradient of
    # sum(y (1 + y)) reaches rank 0's x from rank 1, and none the last's
    x0 = np.arange(6.0).reshape(3, 2)
    for r, x in enumerate(res2):
        y_want = np.zeros((3, 2)) if r == 0 else x0
        g_want = 1 + 2 * x0 if r == 0 else np.zeros((3, 2))
        y, g = x["shift"]
        assert np.array_equal(y, y_want) and np.array_equal(g, g_want), (
            f"shift rank {r}: {y}, {g}")


def _check_pp_refusals(jpp, tpp, pair):
    """pp_stack's and pp_elbo's refusals, with JAX's texts (``pair``: a
    homogeneous stack, cut to its first 2 layers)."""
    import copy
    jm, tm = pair
    jm = jm.replace(layers=jm.layers[:2])
    tm = copy.deepcopy(tm)
    tm.layers = torch.nn.ModuleList(list(tm.layers)[:2])
    rng = np.random.RandomState(61)
    X, Y, Z = rng.randn(10, 3), rng.randn(10, 1), rng.randn(4, 3)
    jh = dsd.DGP.build(X, Y, Z, [dsd.RBF.make(3), dsd.RBF.make(3)],
                       dsd.Gaussian.make(0.1))
    th = port.DGP.build(X, Y, Z, [port.RBF(3), port.RBF(3)],
                        port.Gaussian(0.1), device="cpu")
    tprop = copy.deepcopy(tm)
    for l in tprop.layers:
        l.input_prop_dim = 3
    tone = copy.deepcopy(tm)
    tone.layers = torch.nn.ModuleList(list(tone.layers)[:1])
    jq = dsd.DGPQuad.build(np.asarray(jm.X_data), np.asarray(jm.Y_data),
                           jm.likelihood, jm.layers, H=3)
    tq = port.DGPQuad.build(tm.X_data.numpy(), tm.Y_data.numpy(),
                            tm.likelihood, list(copy.deepcopy(tm).layers),
                            H=3, device="cpu")
    cases = {
        "heterogeneous": (lambda: jpp.pp_stack(jh),
                          lambda: tpp.pp_stack(th)),
        "input propagation": (
            lambda: jpp.pp_stack(jm.replace(layers=[
                l.replace(input_prop_dim=3) for l in jm.layers])),
            lambda: tpp.pp_stack(tprop)),
        "one layer": (lambda: jpp.pp_stack(jm.replace(layers=jm.layers[:1])),
                      lambda: tpp.pp_stack(tone)),
        "split_final of 2": (lambda: jpp.pp_stack(jm, split_final=True),
                             lambda: tpp.pp_stack(tm, split_final=True)),
        "quadrature": (lambda: jax.jit(lambda m: jpp.pp_elbo(
            jpp.pp_stack(m), m.X_data, m.Y_data, None, None))(jq),
                       lambda: tpp.pp_elbo(tpp.pp_stack(tq), tq.X_data,
                                           tq.Y_data, None, None)),
    }
    for case, (jfn, tfn) in cases.items():
        want, got = _error(jfn), _error(tfn)
        assert want[0] == "ValueError" and got == want, (
            f"pp refusal {case}: {got} vs JAX {want}")


def _error(fn):
    try:
        fn()
    except Exception as e:                              # noqa: BLE001
        return type(e).__name__, str(e)
    return None


def _check_import_and_device_rules():
    code = ("import sys, doubly_stochastic_dgp_tpu_torch\n"
            "import doubly_stochastic_dgp_tpu_torch.ops.psi_stats\n"
            "import doubly_stochastic_dgp_tpu_torch.ops.cuda.psi2\n"
            "import doubly_stochastic_dgp_tpu_torch.models.zoo\n"
            "import doubly_stochastic_dgp_tpu_torch.models.damianou\n"
            "import doubly_stochastic_dgp_tpu_torch.models.layers\n"
            "import doubly_stochastic_dgp_tpu_torch.ops.cuda.build\n"
            "import doubly_stochastic_dgp_tpu_torch.training.loop\n"
            "import doubly_stochastic_dgp_tpu_torch.training.optim\n"
            "import doubly_stochastic_dgp_tpu_torch.training.checkpoint\n"
            "import doubly_stochastic_dgp_tpu_torch.graphs\n"
            "import doubly_stochastic_dgp_tpu_torch.ops.quadrature\n"
            "import doubly_stochastic_dgp_tpu_torch.ops.likelihoods\n"
            "import doubly_stochastic_dgp_tpu_torch.data.datasets\n"
            "import doubly_stochastic_dgp_tpu_torch.data.native\n"
            "import doubly_stochastic_dgp_tpu_torch.training.monitor\n"
            "import doubly_stochastic_dgp_tpu_torch.utils.timing\n"
            "import doubly_stochastic_dgp_tpu_torch.ops.kernels\n"
            "import doubly_stochastic_dgp_tpu_torch.models.dgp\n"
            "import doubly_stochastic_dgp_tpu_torch.models.mean_functions\n"
            "import doubly_stochastic_dgp_tpu_torch.models.initializations\n"
            "import doubly_stochastic_dgp_tpu_torch.models.posterior\n"
            "import doubly_stochastic_dgp_tpu_torch.models.single_layer\n"
            "import doubly_stochastic_dgp_tpu_torch.training.natgrad\n"
            "import doubly_stochastic_dgp_tpu_torch.convert\n"
            "import doubly_stochastic_dgp_tpu_torch.models.dynamic\n"
            "import doubly_stochastic_dgp_tpu_torch.training.hmc\n"
            "import doubly_stochastic_dgp_tpu_torch.training.nuts\n"
            "import doubly_stochastic_dgp_tpu_torch.serving\n"
            "import doubly_stochastic_dgp_tpu_torch.tracing\n"
            "import doubly_stochastic_dgp_tpu_torch.parallel\n"
            "import doubly_stochastic_dgp_tpu_torch.parallel.mesh\n"
            "import doubly_stochastic_dgp_tpu_torch.parallel.dp\n"
            "import doubly_stochastic_dgp_tpu_torch.parallel.collapsed\n"
            "import doubly_stochastic_dgp_tpu_torch.parallel.outdim\n"
            "import doubly_stochastic_dgp_tpu_torch.parallel.pp\n"
            "import test_torch_ranks\n"
            "import test_torch_tracing\n"
            "bad = [m for m in ('jax', 'doubly_stochastic_dgp_tpu') "
            "if m in sys.modules]\n"
            "bad += [m for m in sys.modules if m.startswith(('jax.', "
            "'doubly_stochastic_dgp_tpu.'))]\n"
            "print(repr(bad))\n")
    # the ranks' side of the parallel cases (tests/test_torch_ranks.py)
    # too: a spawned rank imports it and must not import JAX; and the
    # tracing cases (tests/test_torch_tracing.py), which run on a card
    code = (f"sys_path = {str(Path(__file__).resolve().parent)!r}\n"
            "import sys; sys.path.insert(0, sys_path)\n" + code)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, f"import rule: {out.stderr}"
    assert out.stdout.strip() == "[]", (
        f"import rule: the port imported {out.stdout.strip()}")
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    found = re.findall(r"^\s*(?:import|from)\s+(jax|doubly_stochastic_dgp_tpu)"
                       r"(?:[\s.]|$)", smoke, flags=re.M)
    assert not found, f"import rule: chip_smoke.py imports {found}"
    X = np.random.RandomState(1).randn(10, 2)
    args = (X, X[:, :1], X[:4], [port.RBF(2)], port.Gaussian(0.1))

    def stack(init):
        return init(X, X[:, :1], X[:4], [port.RBF(2), port.RBF(3)])

    builders = {
        cls.__name__: lambda cls=cls, **kw: cls.build(*args, **kw)
        for cls in (port.DGP, port.DGPCollapsed, port.DGPDamianou,
                    port.DGPHeteroscedastic)}
    builders["DGPQuad"] = lambda **kw: port.DGPQuad.build(
        X, X[:, :1], port.Gaussian(0.1), stack(port.init_layers_linear),
        H=3, **kw)
    builders["DGPBase.make"] = lambda **kw: port.DGPBase.make(
        X, X[:, :1], port.Gaussian(0.1), stack(port.init_layers_input_prop),
        **kw)
    builders["SVGP"] = lambda **kw: port.SVGP.build(
        X, X[:, :1], port.RBF(2), port.Gaussian(0.1), X[:4], **kw)
    for cls in (port.GPR, port.SGPR, port.GPRFITC):
        builders[cls.__name__] = lambda cls=cls, **kw: cls.build(
            X, X[:, :1], port.RBF(2), *(() if cls is port.GPR else (X[:4],)),
            **kw)
    builders["DGPBase.make of SGPMCLayers"] = lambda **kw: port.DGPBase.make(
        X, X[:, :1], port.Gaussian(0.1),
        [port.SGPMCLayer(port.RBF(2), X[:4], 1)], **kw)
    builders["DGPHeinonen"] = lambda **kw: port.DGPHeinonen.make(
        X, X[:, :1], port.Gaussian(0.1),
        [port.GPMCLayer(port.RBF(2), X, 2),
         port.GPRLayer(port.RBF(2), port.Zero(1), 1)], **kw)
    # a process group: NCCL on the card by default, never gloo in its place
    init = port.parallel.mesh.initialize_distributed
    builders["initialize_distributed"] = lambda config=None: init(
        "127.0.0.1:1", 1, 0)
    # local ranks: on the card unless the caller asks for the CPU
    ranks_device = inspect.signature(
        port.parallel.mesh.run_ranks).parameters["device"].default
    assert ranks_device == "cuda", (
        f"device rule: run_ranks places its ranks on {ranks_device}")
    if not torch.cuda.is_available():
        try:
            init("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
        except RuntimeError as e:
            assert "nccl" in str(e), f"device rule: nccl on the CPU: {e}"
        else:
            raise AssertionError("device rule: backend='nccl' on the CPU "
                                 "did not raise")
    for name, build in builders.items():
        if name == "initialize_distributed" and torch.cuda.is_available():
            continue
        if torch.cuda.is_available():
            model = build(config=port.Config(dtype=torch.float32))
            assert model.X_data.device.type == "cuda", (
                f"device rule: {name} not on CUDA")
            continue
        try:
            build()
        except RuntimeError as e:
            assert "CUDA" in str(e), f"device rule: {name}: {e}"
        else:
            raise AssertionError(f"device rule: {name} without a device "
                                 f"did not raise although CUDA is absent")


def test_modules_match_jax():
    rng = np.random.RandomState(0)
    _check_bijectors(rng)
    _check_kernels(rng)
    _check_linalg(rng)
    _check_ladder_and_solves(rng)
    _check_sync_free_cholesky(np.random.RandomState(11))
    _check_mean_functions_and_likelihood(rng)
    # their own streams, so that the cases after them keep their data
    _check_quadrature(np.random.RandomState(21))
    _check_likelihoods(np.random.RandomState(22))
    _check_data(np.random.RandomState(23))
    _check_layers(rng)
    psi2_core.launches = 0
    _check_psi2_route()
    _check_psi_statistics(rng)
    _check_sgpr_layer(rng)
    # their own streams, so that the cases before them keep their data
    _check_more_kernels(np.random.RandomState(31))
    _check_linear_psi_statistics(np.random.RandomState(32))
    _check_natgrad_update(np.random.RandomState(33))
    _check_frozen_optimizer(np.random.RandomState(34))
    _check_linalg_helpers(np.random.RandomState(35))
    _check_single_layer(np.random.RandomState(36))
    _check_parallel(np.random.RandomState(37))
    assert psi2_core.launches == 0, "psi2_core launched for CPU tensors"
    _check_import_and_device_rules()
    # the spans and counters of tracing.py (tests/test_torch_tracing.py)
    import test_torch_tracing
    test_torch_tracing.check_tracing()
