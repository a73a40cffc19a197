"""psi2 data-sum forward: the CUDA kernel, its plain PyTorch version and
the autograd Function around them.

Replaces the TPU kernel ``doubly_stochastic_dgp_tpu/ops/pallas/psi2.py::
_psi2_core_fwd_call`` (``_fwd_kernel``) with ``csrc/psi2.cu``.  For U, V
(N, M), w (N, D) with w >= 0, logdet (N, 1) and Z (M, D):

    out[a, b] = sum_n exp(min(U[n,a] + V[n,b] - sum_d w[n,d] Z[a,d] Z[b,d], 0)
                          + logdet[n])                              (M, M)

What bounds it on an H100: operations (one exp and 4 + 2D flops per (n, a,
b) term, see :func:`terms` and :func:`flops`), so the kernel keeps the
(N, M, M) block out of memory, one row at a time in registers, and adds
its row chunks' partial outputs in a fixed order (deterministic).

Routing: a CPU tensor takes the plain version, which stays autograd-able;
a CUDA tensor launches the kernel or raises — there is no fallback.  The
kernel's backward is not ported yet: on CUDA the Function's backward
raises (ROADMAP B5).  ``psi2_core.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["psi2_core", "psi2_core_forward", "psi2_core_plain", "terms",
           "flops", "MAX_M", "MAX_D"]

# the kernel's limits (the JAX kernel's _MAX_M, _MAX_D); N is not limited:
# the kernel streams rows and stages nothing of size N
MAX_M = 512
MAX_D = 32
FAST_EXP = True      # __expf in the kernel (see PERF.md for the choice)
_ROWS, _TILE, _BLOCKS_PER_SM = 32, 64, 4   # as in csrc/psi2.cu


def _block_rows(M):
    """Rows per block of the plain version: the rule of the JAX
    ``_xla_blocked_core``."""
    return max(128, (8192 * 100 * 100) // (M * M) // 8 * 8)


def psi2_core_plain(U, V, w, logdet, Z):
    """Plain PyTorch version: a blocked mirror of the JAX
    ``_xla_blocked_core`` (same block rows and d-loop arithmetic);
    autograd-able."""
    N, M = U.shape
    D = Z.shape[1]

    def block(Ub, Vb, wb, ldb):
        pre = Ub[:, :, None] + Vb[:, None, :]
        for d in range(D):
            zd = Z[:, d][None, :]                                # (1, M)
            pre = pre - (wb[:, d:d + 1] * zd)[:, :, None] * zd[:, None, :]
        return torch.sum(torch.exp(torch.clamp(pre, max=0.0)
                                   + ldb[:, :, None]), dim=0)

    rows = _block_rows(M)
    if N <= rows:
        return block(U, V, w, logdet)
    out = torch.zeros(M, M, dtype=U.dtype, device=U.device)
    for n0 in range(0, N, rows):
        out = out + block(U[n0:n0 + rows], V[n0:n0 + rows], w[n0:n0 + rows],
                          logdet[n0:n0 + rows])
    return out


def terms(N, M):
    """(n, a, b) terms of one call: each is one exp."""
    return N * M * M


def flops(N, M, D):
    """fp32 flops of one call besides the exps: per term U + V, D
    multiply-adds, the clamp, + logdet and the sum (an FMA counts as
    two)."""
    return terms(N, M) * (4 + 2 * D)


def _chunks(N, M, sms):
    """Row chunks of one launch: enough (tiles x chunks) blocks to give
    each SM about four, and no more chunks than 32-row steps."""
    tiles = (-(-M // _TILE)) ** 2
    steps = -(-N // _ROWS)
    target = max(1, _BLOCKS_PER_SM * sms // tiles)
    per = -(-steps // target)
    return -(-steps // per)


@functools.cache
def _fwd_fn():
    from .build import load_library
    fn = load_library("psi2").psi2_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(U, V, w, logdet, Z):
    N, M = U.shape
    D = Z.shape[1] if Z.ndim == 2 else -1
    if (V.shape != (N, M) or w.shape != (N, D) or logdet.shape != (N, 1)
            or Z.shape != (M, D)):
        raise ValueError(
            f"psi2_core: inconsistent shapes U {tuple(U.shape)}, V "
            f"{tuple(V.shape)}, w {tuple(w.shape)}, logdet "
            f"{tuple(logdet.shape)}, Z {tuple(Z.shape)}")
    if M > MAX_M or not 1 <= D <= MAX_D:
        raise ValueError(f"psi2_core: M={M}, D={D} outside the kernel's "
                         f"limits M <= {MAX_M}, 1 <= D <= {MAX_D} "
                         f"(Config.psi2_impl='xla' takes the plain psi2 "
                         f"route)")
    for name, t in (("U", U), ("V", V), ("w", w), ("logdet", logdet),
                    ("Z", Z)):
        if t.device != U.device:
            raise ValueError(f"psi2_core: {name} is on {t.device}, U on "
                             f"{U.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"psi2_core: the CUDA kernel takes float32; "
                            f"{name} is {t.dtype} (Config.psi2_impl='xla' "
                            f"takes the plain psi2 route)")
        if not t.is_contiguous():
            raise ValueError(f"psi2_core: {name} must be contiguous")
    return N, M, D


def _forward_kernel(U, V, w, logdet, Z, fast_exp):
    N, M, D = _check(U, V, w, logdet, Z)
    out = torch.empty(M, M, dtype=torch.float32, device=U.device)
    if N == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(U.device).multi_processor_count
    chunks = _chunks(N, M, sms)
    scratch = (torch.empty(chunks * M * M, dtype=torch.float32,
                           device=U.device) if chunks > 1 else None)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_fn()(U.data_ptr(), V.data_ptr(), w.data_ptr(),
                        logdet.data_ptr(), Z.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        N, M, D, chunks, int(fast_exp), stream)
    if err != 0:
        raise RuntimeError(f"psi2_core: kernel launch failed with CUDA "
                           f"error {err}")
    psi2_core.launches += 1
    return out


def psi2_core_forward(U, V, w, logdet, Z, fast_exp=FAST_EXP):
    """The (M, M) data sum: the plain version for CPU tensors, the kernel
    for CUDA tensors (``fast_exp``: __expf, else expf).  Not
    differentiable: :func:`psi2_core` is."""
    if U.device.type == "cpu":
        return psi2_core_plain(U, V, w, logdet, Z)
    if U.device.type != "cuda":
        raise ValueError(f"psi2_core: unsupported device {U.device}")
    return _forward_kernel(U, V, w, logdet, Z, fast_exp)


class _Psi2Core(torch.autograd.Function):
    """Forward: the plain version on the CPU, the kernel on CUDA.
    Backward: on the CPU the gradient of the plain version; on CUDA not
    ported yet (ROADMAP B5), so it raises."""

    @staticmethod
    def forward(ctx, U, V, w, logdet, Z):
        ctx.save_for_backward(U, V, w, logdet, Z)
        return psi2_core_forward(U, V, w, logdet, Z)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        if inputs[0].device.type != "cpu":
            raise NotImplementedError(
                "psi2_core backward on CUDA: the psi2 backward kernel is not "
                "ported yet (ROADMAP B5)")
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = psi2_core_plain(*leaves)
            return torch.autograd.grad(out, leaves, g, allow_unused=True)


def psi2_core(U, V, w, logdet, Z):
    """sum_n exp(logdet_n + min(U_na + V_nb - sum_d w_nd Z_ad Z_bd, 0)),
    (M, M); the counterpart of the JAX ``psi2_core``."""
    return _Psi2Core.apply(U, V, w, logdet, Z)


psi2_core.launches = 0
