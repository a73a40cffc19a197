"""PyTorch port: the fused staged conditional's plain version against the
JAX package's Pallas kernel (interpret mode on CPU) and its jnp reference,
in float64.

One test item that loops over its cases and names the failing case in
every assertion message.  On the CPU the port's wrapper takes the plain
version (the CUDA kernel itself is checked against it on the card by
``chip_smoke.py``), so the wrapper's launch counter must not move."""

import jax.numpy as jnp
import numpy as np
import torch
from numpy.testing import assert_allclose

from doubly_stochastic_dgp_tpu.ops.pallas.conditional import (
    fused_conditional as jax_fused_conditional, fused_conditional_reference)
from doubly_stochastic_dgp_tpu_torch.ops.cuda.conditional import (
    fused_conditional, fused_conditional_plain)

RTOL, ATOL = 1e-9, 1e-11     # as tests/test_pallas_conditional.py


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


def test_fused_conditional_plain_matches_jax():
    fused_conditional.launches = 0
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
    assert fused_conditional.launches == 0, (
        "the wrapper launched the CUDA kernel for CPU tensors")

    # the CPU path stays autograd-able
    targs = [torch.from_numpy(np.asarray(a)).requires_grad_()
             for a in _inputs(B=40, M=9, Do=2)]
    mean, var = fused_conditional(*targs)
    (mean.sum() + var.sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in targs), "grad_on_cpu: missing or non-finite grad"
