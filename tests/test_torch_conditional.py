"""PyTorch port: the fused staged conditional's plain versions (forward,
backward, save-gram pair) against the JAX package's Pallas kernels
(interpret mode on CPU) and its jnp reference, in float64.

One test item that loops over its cases and names the failing case in
every assertion message.  On the CPU the port's wrappers and autograd
Functions take the plain versions (the CUDA kernels themselves are
checked against them on the card by ``chip_smoke.py``), so no launch
counter may move."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from numpy.testing import assert_allclose

from doubly_stochastic_dgp_tpu.ops.pallas.conditional import (
    fused_conditional as jax_fused_conditional, fused_conditional_reference,
    fused_conditional_saved as jax_fused_conditional_saved)
from doubly_stochastic_dgp_tpu_torch.ops.cuda.conditional import (
    fused_conditional, fused_conditional_backward_plain,
    fused_conditional_plain, fused_conditional_saved,
    fused_conditional_saved_plain)

RTOL, ATOL = 1e-9, 1e-11     # as tests/test_pallas_conditional.py
# gradients: as the gradient tests of tests/test_pallas_conditional.py
GRAD_RTOL, GRAD_ATOL = 1e-7, 1e-9
GRAD_NAMES = ["dXs", "dZs", "dLiT", "dalpha", "dW", "dkvar", "dkdiag"]


def _inputs(B, M, Do, Dx=8, seed=0, identity_lit=False, clamp=False):
    rng = np.random.RandomState(seed)
    Xs = rng.randn(B, Dx)
    Zs = rng.randn(M, Dx)
    LiT = np.eye(M) if identity_lit else np.eye(M) + 0.1 * rng.randn(M, M)
    alpha = rng.randn(M, Do) * 0.3
    Wh = rng.randn(Do, M, M) * 0.1
    W = (Wh + np.swapaxes(Wh, 1, 2)) / 2
    if clamp:
        # strongly negative definite W_d: rows near Z get var < 0 -> 0
        W = -np.einsum("dij,dkj->dik", Wh, Wh) * 20.0
    return Xs, Zs, LiT, alpha, W, np.float64(1.4), np.float64(1.4 + 2e-6)


CASES = [
    ("B700_M100_Do4", dict(B=700, M=100, Do=4)),
    ("B512_M128_Do1", dict(B=512, M=128, Do=1)),
    ("B130_M37_Do3", dict(B=130, M=37, Do=3)),
    ("B1100_M100_Do8", dict(B=1100, M=100, Do=8)),
    ("identity_LiT", dict(B=130, M=37, Do=2, identity_lit=True)),
    ("clamp_active", dict(B=260, M=50, Do=3, Dx=5, seed=1, clamp=True)),
]


# the gradient cases of tests/test_pallas_conditional.py: one tile, several
# tiles, and the variance clamp active (kdiag = -0.5)
GRAD_CASES = [
    ("grad_single_tile", dict(B=260, M=50, Do=3, Dx=5, seed=1), None),
    ("grad_multi_tile", dict(B=1100, M=40, Do=2, Dx=4, seed=5), None),
    ("grad_clamp_active", dict(B=200, M=30, Do=2, Dx=4, seed=3), -0.5),
]


def _check_gradients():
    """The plain backward and the autograd Functions on the CPU against
    jax.vjp through the interpret-mode Pallas backward kernels, for all
    seven gradients, on the recompute and the save-gram variants."""
    for name, kw, kdiag in GRAD_CASES:
        args = list(_inputs(**kw))
        if kdiag is not None:
            args[6] = np.float64(kdiag)
        rng = np.random.RandomState(kw["seed"] + 1)
        gm, gv = rng.randn(kw["B"], kw["Do"]), rng.randn(kw["B"], kw["Do"])
        targs = [torch.from_numpy(np.asarray(a)) for a in args]
        tg = (torch.from_numpy(gm), torch.from_numpy(gv))
        for variant, jfn, tfn in (
                ("recompute", jax_fused_conditional, fused_conditional),
                ("saved", jax_fused_conditional_saved,
                 fused_conditional_saved)):
            (jm, jv), vjp = jax.vjp(lambda *a: jfn(*a, True),
                                    *[jnp.asarray(a) for a in args])
            want = vjp((jnp.asarray(gm), jnp.asarray(gv)))
            if kdiag is not None:
                assert (np.asarray(jv) == 0).any() and (
                    np.asarray(jv) > 0).any(), (
                    f"{name}: the variance clamp is not active")
            mean, var, K = fused_conditional_saved_plain(*targs)
            plain = fused_conditional_backward_plain(
                *targs, mean, var, *tg, K if variant == "saved" else None)
            leaves = [t.clone().requires_grad_() for t in targs]
            m, v = tfn(*leaves)
            torch.autograd.backward((m, v), tg)
            got = {"plain backward": plain,
                   "autograd Function": [t.grad for t in leaves]}
            for gname, grads in got.items():
                for g, w, what in zip(grads, want, GRAD_NAMES):
                    assert_allclose(
                        g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                        atol=GRAD_ATOL,
                        err_msg=f"{name} {variant}: {gname} {what} vs "
                                f"jax.vjp of the interpret-mode kernel")


def _counts():
    return (fused_conditional.launches, fused_conditional.backward_launches,
            fused_conditional_saved.launches,
            fused_conditional_saved.backward_launches)


def test_fused_conditional_plain_matches_jax():
    for f in (fused_conditional, fused_conditional_saved):
        f.launches = f.backward_launches = 0
    for name, kw in CASES:
        args = _inputs(**kw)
        jargs = [jnp.asarray(a) for a in args]
        refs = {
            "fused_conditional_reference":
                fused_conditional_reference(*jargs),
            "interpret-mode Pallas kernel":
                jax_fused_conditional(*jargs, True),
        }
        targs = [torch.from_numpy(np.asarray(a)) for a in args]
        ports = {"plain": fused_conditional_plain(*targs),
                 "wrapper on CPU": fused_conditional(*targs)}
        for pname, (pm, pv) in ports.items():
            assert pm.dtype == torch.float64, f"{name}: {pname} dtype"
            for rname, (rm, rv) in refs.items():
                assert_allclose(pm.numpy(), np.asarray(rm), rtol=RTOL,
                                atol=ATOL,
                                err_msg=f"{name}: {pname} mean vs {rname}")
                assert_allclose(pv.numpy(), np.asarray(rv), rtol=RTOL,
                                atol=ATOL,
                                err_msg=f"{name}: {pname} var vs {rname}")
        if kw.get("clamp"):
            v = ports["plain"][1].numpy()
            assert (v == 0).any() and (v > 0).any(), (
                f"{name}: the variance clamp is not active")
    _check_gradients()
    assert _counts() == (0, 0, 0, 0), (
        "the wrappers launched a CUDA kernel for CPU tensors")

    # the CPU path stays autograd-able, and honours needs_input_grad
    targs = [torch.from_numpy(np.asarray(a)).requires_grad_()
             for a in _inputs(B=40, M=9, Do=2)]
    targs[5].requires_grad_(False)
    mean, var = fused_conditional(*targs)
    (mean.sum() + var.sum()).backward()
    assert targs[5].grad is None, "grad_on_cpu: kvar got a gradient"
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for i, t in enumerate(targs) if i != 5), (
        "grad_on_cpu: missing or non-finite grad")
