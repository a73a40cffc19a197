"""Fused staged sparse-GP conditional (diagonal), forward: the CUDA kernel
wrapper and its plain PyTorch version.

Replaces the TPU kernel ``doubly_stochastic_dgp_tpu/ops/pallas/
conditional.py::_fused_forward`` (``_fwd_kernel``/``_fwd_body``, the
forward of ``fused_conditional``); the kernel is
``csrc/fused_conditional.cu``.  Per row x of the lengthscale-scaled batch:

    K = kvar exp(-0.5 ||x - z||^2)   (M,)      G = K LiT
    mean = G alpha                   (Do,)     var_d = max(kdiag + G.(G W_d), 0)

What bounds it on an H100: operations.  Per row it does about
2 M Dx + 2 M^2 + 2 M Do + Do (2 M^2 + 2 M) flops against reading Dx and
writing 2 Do floats (see :func:`flops`), so it is compute-bound in fp32.
The kernel keeps each row tile's K and G in shared memory through the
mean and every var_d (G is computed once per row, as the TPU kernel held
it in VMEM across its d axis) and runs both products as register-tiled
fp32 FFMA; every operand shared across rows stays in L2.

Routing: a CPU tensor takes :func:`fused_conditional_plain`; a CUDA
tensor launches the kernel or raises — there is no fallback.  The kernel
is forward only (its backward is ROADMAP B2), so on CUDA it raises when
autograd would need a gradient through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["fused_conditional", "fused_conditional_plain", "flops",
           "MAX_M"]

MAX_M = 512   # the JAX kernel's cap (conditional.py pallas_profitable)


def fused_conditional_plain(Xs, Zs, LiT, alpha, W, kvar, kdiag):
    """Plain PyTorch version; the counterpart of
    ``fused_conditional_reference``, and autograd-able."""
    d = Xs[:, None, :] - Zs[None, :, :]
    K = kvar * torch.exp(-0.5 * torch.sum(d * d, -1))     # (B, M)
    G = K @ LiT                                            # (B, M)
    mean = G @ alpha
    T = torch.einsum("bm,dmn->dbn", G, W)
    var = kdiag + torch.einsum("bm,dbm->bd", G, T)
    return mean, torch.clamp(var, min=0.0)


def flops(B, M, Dx, Do):
    """Floating-point operations of one call (an FMA counts as two)."""
    return B * (2 * M * Dx + 2 * M * M + 2 * M * Do
                + Do * (2 * M * M + 2 * M))


@functools.cache
def _lib():
    from .build import load_library
    lib = load_library("fused_conditional")
    fn = lib.fused_conditional_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(Xs, Zs, LiT, alpha, W):
    B, Dx = Xs.shape
    M = Zs.shape[0]
    Do = alpha.shape[1] if alpha.ndim == 2 else -1
    if (Zs.shape != (M, Dx) or LiT.shape != (M, M)
            or alpha.shape != (M, Do) or W.shape != (Do, M, M)):
        raise ValueError(
            f"fused_conditional: inconsistent shapes Xs {tuple(Xs.shape)}, "
            f"Zs {tuple(Zs.shape)}, LiT {tuple(LiT.shape)}, alpha "
            f"{tuple(alpha.shape)}, W {tuple(W.shape)}")
    if M > MAX_M:
        raise ValueError(f"fused_conditional: M={M} exceeds the kernel's "
                         f"cap of {MAX_M} inducing points")
    for name, t in (("Xs", Xs), ("Zs", Zs), ("LiT", LiT),
                    ("alpha", alpha), ("W", W)):
        if t.device != Xs.device:
            raise ValueError(f"fused_conditional: {name} is on {t.device}, "
                             f"Xs on {Xs.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_conditional: the CUDA kernel takes "
                            f"float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_conditional: {name} must be "
                             f"contiguous")
    return B, M, Dx, Do


def fused_conditional(Xs, Zs, LiT, alpha, W, kvar, kdiag):
    """mean (B, Do), var (B, Do) of the fused staged sparse conditional.

    Xs (B, Dx), Zs (M, Dx): lengthscale-scaled inputs and inducing points;
    LiT = Lu^{-T} (M, M); alpha (M, Do); W (Do, M, M); kvar, kdiag: 0-dim
    tensors or floats.  ``fused_conditional.launches`` counts kernel
    launches."""
    if Xs.device.type == "cpu":
        return fused_conditional_plain(Xs, Zs, LiT, alpha, W, kvar, kdiag)
    if Xs.device.type != "cuda":
        raise ValueError(f"fused_conditional: unsupported device "
                         f"{Xs.device}")
    B, M, Dx, Do = _check(Xs, Zs, LiT, alpha, W)
    scal = torch.stack([torch.as_tensor(kvar, device=Xs.device),
                        torch.as_tensor(kdiag, device=Xs.device)])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (Xs, Zs, LiT, alpha, W, scal)):
        raise NotImplementedError(
            "fused_conditional: the CUDA kernel is forward only (its "
            "backward is ROADMAP B2); run under torch.no_grad()")
    scal = scal.to(torch.float32).contiguous()
    mean = torch.empty(B, Do, dtype=torch.float32, device=Xs.device)
    var = torch.empty(B, Do, dtype=torch.float32, device=Xs.device)
    if B == 0:
        return mean, var
    with torch.cuda.device(Xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(Xs.data_ptr(), Zs.data_ptr(), LiT.data_ptr(),
                     alpha.data_ptr(), W.data_ptr(), scal.data_ptr(),
                     mean.data_ptr(), var.data_ptr(), B, M, Dx, Do, stream)
    if err != 0:
        raise RuntimeError(f"fused_conditional: kernel launch failed with "
                           f"CUDA error {err}")
    fused_conditional.launches += 1
    return mean, var


fused_conditional.launches = 0
