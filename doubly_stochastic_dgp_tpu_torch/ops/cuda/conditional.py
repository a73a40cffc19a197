"""Fused staged sparse-GP conditional (diagonal): the CUDA kernels of its
forward, backward and save-gram pair, their plain PyTorch versions, and
the autograd Functions around them.

Replaces the TPU kernels of ``doubly_stochastic_dgp_tpu/ops/pallas/
conditional.py``:

- ``_fused_forward`` (``_fwd_kernel``/``_fwd_body``) and its
  ``save_gram=True`` form (``_fwd_kernel_sg``): ``csrc/fused_conditional.cu``;
- ``_fused_backward`` (``_bwd_kernel``/``_bwd_body``) and its form that
  reads the saved gram (``_bwd_kernel_sg``): ``csrc/fused_conditional_bwd.cu``.

Per row x of the lengthscale-scaled batch:

    K = kvar exp(-0.5 ||x - z||^2)   (M,)      G = K LiT
    mean = G alpha                   (Do,)     var_d = max(kdiag + G.(G W_d), 0)

W is symmetric (W = Li SK Li^T), so d var_d / dG = 2 G W_d, as in the JAX
backward.  What bounds both on an H100: operations (see :func:`flops`,
:func:`flops_bwd`), so both run as register-tiled fp32 FFMA with K and G
kept in shared memory; the backward sums its row reductions (dW, dLiT,
dalpha, dZ) per block into scratch and then over blocks in a fixed order,
so it is deterministic.  dkvar and dkdiag come from the saved forward
outputs (``_scalar_grads``, as in the JAX package).

Routing: a CPU tensor takes the plain versions (forward and backward); a
CUDA tensor launches the kernels or raises — there is no fallback.
Launch counters: ``fused_conditional.launches`` and
``fused_conditional.backward_launches`` count the plain variant's forward
and backward kernel launches, ``fused_conditional_saved.launches`` and
``fused_conditional_saved.backward_launches`` the save-gram pair's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["fused_conditional", "fused_conditional_saved",
           "fused_conditional_forward", "fused_conditional_backward",
           "fused_conditional_plain", "fused_conditional_saved_plain",
           "fused_conditional_backward_plain", "flops", "flops_bwd", "MAX_M"]

MAX_M = 512   # the JAX kernel's cap (conditional.py pallas_profitable)


def _gram_plain(Xs, Zs, kvar):
    d = Xs[:, None, :] - Zs[None, :, :]
    return kvar * torch.exp(-0.5 * torch.sum(d * d, -1))   # (B, M)


def fused_conditional_plain(Xs, Zs, LiT, alpha, W, kvar, kdiag):
    """Plain PyTorch version; the counterpart of
    ``fused_conditional_reference``, and autograd-able."""
    mean, var, _ = fused_conditional_saved_plain(Xs, Zs, LiT, alpha, W,
                                                 kvar, kdiag)
    return mean, var


def fused_conditional_saved_plain(Xs, Zs, LiT, alpha, W, kvar, kdiag):
    """Plain version of the save-gram forward: (mean, var, K)."""
    K = _gram_plain(Xs, Zs, kvar)
    G = K @ LiT                                            # (B, M)
    mean = G @ alpha
    T = torch.einsum("bm,dmn->dbn", G, W)
    var = kdiag + torch.einsum("bm,dbm->bd", G, T)
    return mean, torch.clamp(var, min=0.0), K


def _scalar_grads(gm, gv_eff, mean, var, kvar, kdiag):
    """dkvar, dkdiag from the saved forward outputs: mean is linear and
    (var - kdiag) quadratic in K, which is proportional to kvar."""
    dkdiag = torch.sum(gv_eff)
    dkvar = (torch.sum(gm * mean)
             + 2.0 * torch.sum(gv_eff * (var - kdiag))) / kvar
    return dkvar, dkdiag


def _tensor_grads_plain(Xs, Zs, LiT, alpha, W, kvar, gm, gv_eff, K=None):
    """(dXs, dZs, dLiT, dalpha, dW) with the math of ``_fused_backward``;
    K is the saved gram or None (recomputed)."""
    if K is None:
        K = _gram_plain(Xs, Zs, kvar)
    G = K @ LiT
    T = torch.einsum("bm,dmn->dbn", G, W)
    dG = 2.0 * torch.einsum("bd,dbn->bn", gv_eff, T) + gm @ alpha.T
    dalpha = G.T @ gm
    dLiT = K.T @ dG
    dW = (G.T[None] * gv_eff.T[:, None, :]) @ G               # (Do, M, M)
    Gd = -0.5 * (dG @ LiT.T) * K                              # dL/d dist
    dXs = 2.0 * (Xs * Gd.sum(1, keepdim=True) - Gd @ Zs)
    dZs = 2.0 * (Zs * Gd.sum(0)[:, None] - Gd.T @ Xs)
    return dXs, dZs, dLiT, dalpha, dW


def _mask(var, gv):
    # clamp VJP: where the forward clamped var at 0, no variance cotangent
    return torch.where(var > 0.0, gv, 0.0)


def fused_conditional_backward_plain(Xs, Zs, LiT, alpha, W, kvar, kdiag,
                                     mean, var, gm, gv, K=None):
    """Plain version of the backward: the seven gradients (dXs, dZs, dLiT,
    dalpha, dW, dkvar, dkdiag) from the forward's inputs, its outputs and
    the output cotangents, mirroring ``_fc_bwd``/``_fcs_bwd`` (K: the saved
    gram, or None)."""
    gv_eff = _mask(var, gv)
    return (*_tensor_grads_plain(Xs, Zs, LiT, alpha, W, kvar, gm, gv_eff, K),
            *_scalar_grads(gm, gv_eff, mean, var, kvar, kdiag))


def fused_conditional_forward(Xs, Zs, LiT, alpha, W, kvar, kdiag,
                              save_gram=False):
    """(mean, var, K) of the fused conditional, K the (B, M) gram when
    ``save_gram`` else None: the plain version for CPU tensors, the
    forward kernel (or its save-gram variant) for CUDA tensors.  Not
    differentiable: :func:`fused_conditional` is."""
    kvar, kdiag = _scalars(kvar, kdiag, Xs)
    if _on_cpu(Xs):
        mean, var, K = fused_conditional_saved_plain(Xs, Zs, LiT, alpha, W,
                                                     kvar, kdiag)
        return mean, var, (K if save_gram else None)
    return _forward_kernel(Xs, Zs, LiT, alpha, W, kvar, kdiag, save_gram)


def fused_conditional_backward(Xs, Zs, LiT, alpha, W, kvar, kdiag, mean,
                               var, gm, gv, K=None):
    """The seven gradients of :func:`fused_conditional` (K None) or
    :func:`fused_conditional_saved` (K the saved gram): the plain version
    for CPU tensors, the backward kernel for CUDA tensors."""
    kvar, kdiag = _scalars(kvar, kdiag, Xs)
    if _on_cpu(Xs):
        return fused_conditional_backward_plain(
            Xs, Zs, LiT, alpha, W, kvar, kdiag, mean, var, gm, gv, K)
    gv_eff = _mask(var, gv)
    return (*_backward_kernel(Xs, Zs, LiT, alpha, W, kvar, kdiag, gm,
                              gv_eff, K),
            *_scalar_grads(gm, gv_eff, mean, var, kvar, kdiag))


def flops(B, M, Dx, Do):
    """Floating-point operations of one forward call (an FMA counts as
    two)."""
    return B * (2 * M * Dx + 2 * M * M + 2 * M * Do
                + Do * (2 * M * M + 2 * M))


def flops_bwd(B, M, Dx, Do, saved=False):
    """Floating-point operations of one backward call: per row the gram
    (2 M Dx, not redone when the gram is saved), G, dK and dLiT (2 M^2
    each), dX and dZ (2 M Dx each), the mean term and dalpha (2 M Do
    each), and for each d the products G W_d and dW_d (2 M^2 each) and
    dG's 2 M."""
    gram = 0 if saved else 2 * M * Dx
    return B * (gram + 4 * M * Dx + 6 * M * M + 4 * M * Do
                + Do * (4 * M * M + 2 * M))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

@functools.cache
def _fwd_fn():
    from .build import load_library
    fn = load_library("fused_conditional").fused_conditional_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fns():
    from .build import load_library
    lib = load_library("fused_conditional_bwd")
    scratch = lib.fused_conditional_bwd_scratch
    scratch.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int]
    scratch.restype = ctypes.c_int64
    fn = lib.fused_conditional_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return scratch, fn


def _on_cpu(Xs):
    if Xs.device.type == "cpu":
        return True
    if Xs.device.type != "cuda":
        raise ValueError(f"fused_conditional: unsupported device "
                         f"{Xs.device}")
    return False


def _check(Xs, Zs, LiT, alpha, W, *rows):
    """Shapes, device, dtype and contiguity of the kernels' operands;
    ``rows`` are (name, tensor, columns) of further (B, columns) operands.
    Returns (B, M, Dx, Do)."""
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
    for name, t, cols in rows:
        if tuple(t.shape) != (B, cols):
            raise ValueError(f"fused_conditional: {name} has shape "
                             f"{tuple(t.shape)}, expected {(B, cols)}")
    named = [("Xs", Xs), ("Zs", Zs), ("LiT", LiT), ("alpha", alpha),
             ("W", W)] + [(name, t) for name, t, _ in rows]
    for name, t in named:
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


def _scalars(kvar, kdiag, like):
    return (torch.as_tensor(kvar, dtype=like.dtype, device=like.device),
            torch.as_tensor(kdiag, dtype=like.dtype, device=like.device))


def _scal(kvar, kdiag, like):
    return torch.stack([kvar.detach(), kdiag.detach()]).to(
        device=like.device, dtype=torch.float32).contiguous()


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")


def _forward_kernel(Xs, Zs, LiT, alpha, W, kvar, kdiag, save_gram):
    B, M, Dx, Do = _check(Xs, Zs, LiT, alpha, W)
    scal = _scal(kvar, kdiag, Xs)
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=Xs.device)
    mean, var = new(B, Do), new(B, Do)
    K = new(B, M) if save_gram else None
    if B == 0:
        return mean, var, K
    with torch.cuda.device(Xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_fn()(Xs.data_ptr(), Zs.data_ptr(), LiT.data_ptr(),
                        alpha.data_ptr(), W.data_ptr(), scal.data_ptr(),
                        mean.data_ptr(), var.data_ptr(),
                        None if K is None else K.data_ptr(),
                        B, M, Dx, Do, stream)
    _raise_on(err, "fused_conditional forward")
    (fused_conditional_saved if save_gram else fused_conditional
     ).launches += 1
    return mean, var, K


def _backward_kernel(Xs, Zs, LiT, alpha, W, kvar, kdiag, gm, gv_eff, K):
    gm, gv_eff = gm.contiguous(), gv_eff.contiguous()
    Do, M = alpha.shape[-1], Zs.shape[0]
    rows = [("gm", gm, Do), ("gv", gv_eff, Do)] + (
        [] if K is None else [("K", K, M)])
    B, M, Dx, Do = _check(Xs, Zs, LiT, alpha, W, *rows)
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=Xs.device)
    dXs = new(B, Dx)
    nW, nL, nA = Do * M * M, M * M, M * Do
    out = new(nW + nL + nA + M * Dx)
    if B == 0:
        out.zero_()
    else:
        scratch_floats, fn = _bwd_fns()
        LiTT = LiT.t().contiguous()
        scal = _scal(kvar, kdiag, Xs)
        with torch.cuda.device(Xs.device):
            n = scratch_floats(B, M, Dx, Do)
            if n <= 0:
                raise ValueError(f"fused_conditional backward: shape B={B} "
                                 f"M={M} Dx={Dx} Do={Do} is not supported")
            scratch = new(n)
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(Xs.data_ptr(), Zs.data_ptr(), LiT.data_ptr(),
                     LiTT.data_ptr(), alpha.data_ptr(), W.data_ptr(),
                     scal.data_ptr(), gm.data_ptr(), gv_eff.data_ptr(),
                     None if K is None else K.data_ptr(), dXs.data_ptr(),
                     out.data_ptr(), scratch.data_ptr(), n, B, M, Dx, Do,
                     stream)
        _raise_on(err, "fused_conditional backward")
        (fused_conditional if K is None else fused_conditional_saved
         ).backward_launches += 1
    dW = out[:nW].view(Do, M, M)
    dLiT = out[nW:nW + nL].view(M, M)
    dalpha = out[nW + nL:nW + nL + nA].view(M, Do)
    dZs = out[nW + nL + nA:].view(M, Dx)
    return dXs, dZs, dLiT, dalpha, dW


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _FusedConditional(torch.autograd.Function):
    """Forward and backward of the fused conditional: the plain versions
    on the CPU, the kernels on CUDA.  ``save_gram`` selects the save-gram
    pair (the forward also returns K, the backward reads it)."""

    @staticmethod
    def forward(ctx, Xs, Zs, LiT, alpha, W, kvar, kdiag, save_gram):
        mean, var, K = fused_conditional_forward(Xs, Zs, LiT, alpha, W, kvar,
                                                 kdiag, save_gram)
        ctx.save_for_backward(Xs, Zs, LiT, alpha, W, kvar, kdiag, mean, var,
                              K)
        return mean, var

    @staticmethod
    def backward(ctx, gm, gv):
        needs = ctx.needs_input_grad[:7]
        grads = fused_conditional_backward(*ctx.saved_tensors[:9], gm, gv,
                                           ctx.saved_tensors[9])
        return tuple(g if n else None for g, n in zip(grads, needs)) + (None,)


def _apply(Xs, Zs, LiT, alpha, W, kvar, kdiag, save_gram):
    return _FusedConditional.apply(Xs, Zs, LiT, alpha, W,
                                   *_scalars(kvar, kdiag, Xs), save_gram)


def fused_conditional(Xs, Zs, LiT, alpha, W, kvar, kdiag):
    """mean (B, Do), var (B, Do) of the fused staged sparse conditional,
    differentiable in all seven inputs.

    Xs (B, Dx), Zs (M, Dx): lengthscale-scaled inputs and inducing points;
    LiT = Lu^{-T} (M, M); alpha (M, Do); W (Do, M, M) symmetric; kvar,
    kdiag: 0-dim tensors or floats."""
    return _apply(Xs, Zs, LiT, alpha, W, kvar, kdiag, False)


def fused_conditional_saved(Xs, Zs, LiT, alpha, W, kvar, kdiag):
    """Save-gram variant of :func:`fused_conditional`: the forward also
    writes the gram K (B, M) and the backward reads it instead of
    recomputing.  Same values and gradients."""
    return _apply(Xs, Zs, LiT, alpha, W, kvar, kdiag, True)


fused_conditional.launches = 0
fused_conditional.backward_launches = 0
fused_conditional_saved.launches = 0
fused_conditional_saved.backward_launches = 0
