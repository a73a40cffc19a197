"""RBF gram: the CUDA kernel, its plain PyTorch version and the autograd
Function around them.

Replaces the TPU kernel ``doubly_stochastic_dgp_tpu/ops/pallas/gram.py::
_gram_pallas_call`` (``_gram_kernel``) with ``csrc/rbf_gram.cu``; the
Function is the counterpart of the JAX ``rbf_gram`` with its
``_fwd``/``_bwd``.  For X (N, D), Z (M, D), lengthscales (D,) or a scalar
and a scalar variance, in float32 or float64:

    K[n, m] = var exp(-0.5 sum_d ((X[n,d] - Z[m,d]) / ls_d)^2)      (N, M)

The kernel takes X, Z, the lengthscales and the variance as given and
divides each operand by the lengthscales itself, as the JAX ``rbf_gram``
does before its TPU kernel, so the wrapper launches no other device op;
the distance is the direct sum of squared differences, so K(X, X) is
bitwise symmetric with its diagonal exactly var.  The plain version keeps
the JAX form ||x||^2 + ||z||^2 - 2 x.z clipped at 0 (:func:`square_dist`),
which ``RBF.K`` computes on the CPU.
What bounds the kernel on an H100: bytes, the (N, M) output, at D <= 8;
operations at the MNIST DGP's D = 784 (see :func:`bytes_moved`,
:func:`flops`, :func:`exps`).  Two kernels: the narrow one for D <= 8 and
the wide one above, whose d sum a thread-block cluster splits
(:func:`launch_plan`, the plain-Python plan the wrapper hands the C entry
point).  The backward is the
JAX ``_bwd`` closed form on the saved K, as torch ops on either device:
it sits outside the Pallas kernel in JAX too.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises: there is no fallback.  Both go through the registered
op ``torch.ops.dsdgp.rbf_gram`` (with a shape function for tracing), so
``torch.export`` carries the gram into an exported program.  ``rbf_gram.launches`` counts the
kernel's launches.  Inside :func:`plain_on_card` CUDA tensors take the
plain version: a reference for measurements, which the package itself
never enters.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

__all__ = ["rbf_gram", "rbf_gram_kernel", "rbf_gram_plain", "square_dist",
           "plain_on_card", "launch_plan", "flops", "exps", "bytes_moved",
           "FAST_EXP", "F64_EXP_FLOPS"]

# expf in the float32 kernel (__expf when True; see PERF.md for the choice)
FAST_EXP = False
# fp64 flops of one exp in the float64 kernel, where exp is not an SFU op
# but fp64 instructions: 13 DFMA, 1 DADD and 1 DMUL an exp, counted in the
# SASS of the sm_90a build with CUDA 12 (chip_smoke.py prints the fp64
# opcode counts of the D = 8 float64 kernel)
F64_EXP_FLOPS = 28


def square_dist(X, X2):
    """Pairwise squared Euclidean distance ||x||^2 + ||z||^2 - 2 x.z,
    clipped at 0 (the JAX form; X2 None: X against itself)."""
    Xs = torch.sum(X ** 2, dim=-1, keepdim=True)              # (N, 1)
    if X2 is None:
        d = Xs + Xs.T - 2.0 * (X @ X.T)
    else:
        X2s = torch.sum(X2 ** 2, dim=-1, keepdim=True)        # (M, 1)
        d = Xs + X2s.T - 2.0 * (X @ X2.T)
    return torch.clamp(d, min=0.0)


def rbf_gram_plain(X, Z, lengthscales, variance):
    """Plain PyTorch version: the expression of ``RBF.K`` on the CPU."""
    return variance * torch.exp(-0.5 * square_dist(X / lengthscales,
                                                   Z / lengthscales))


def flops(N, M, D):
    """Flops of one call besides the exps: per output D differences and D
    FMAs (3D), the -0.5 scale and the variance (2); the divisions by the
    lengthscales are per row and per column.  In float64 each exp adds
    ``F64_EXP_FLOPS``."""
    return N * M * (3 * D + 2)


def exps(N, M):
    """exps of one call: one per output."""
    return N * M


def bytes_moved(N, M, D, itemsize):
    """Bytes one call must move: X, Z, the lengthscales and the variance
    read once, the (N, M) output written once."""
    return itemsize * ((N + M + 1) * D + 1 + N * M)


# csrc/rbf_gram.cu: the narrow kernel (D <= NARROW_MAX_D) tiles of 16 rows
# x 128 columns; the wide kernel 64 x 64 tiles, d in chunks of 16,
# clusters of at most 8 blocks a tile
NARROW_MAX_D = 8
_NARROW_ROWS, _NARROW_COLS = 16, 128
_WIDE_TILE, _WIDE_CHUNK, _MAX_SPLITS = 64, 16, 8
_MAX_GRID = 2 ** 31 - 1


def launch_plan(N, M, D, sms=132):
    """The kernel's launch for an (N, M) gram over D dims on a card of
    ``sms`` SMs; the C entry point takes ``splits`` from it and refuses
    any other.

    D <= 8 (``path`` "narrow"): one block a tile of 16 rows x 128
    columns, ``grid`` = ``tiles`` blocks, ``splits`` 1.  D > 8 ("wide"):
    64 x 64 tiles, ``chunks`` = ceil(D / 16) chunks of d; a tile's chunks
    are split over a thread-block cluster of ``splits`` blocks (each an
    even share, in order), doubled from 1 while the grid is below one
    block an SM, ``splits`` < 8 and each block keeps a chunk at least, so
    ``grid`` = ``tiles`` x ``splits``.  The partial sums meet in
    distributed shared memory: ``workspace_bytes`` is 0.  Raises
    ValueError on sizes the kernel refuses (an empty dimension, a grid
    past 2^31 - 1 blocks)."""
    if min(N, M, D) < 1:
        raise ValueError(f"rbf_gram: no launch for N={N}, M={M}, D={D}")
    if D <= NARROW_MAX_D:
        tiles = -(-M // _NARROW_COLS) * -(-N // _NARROW_ROWS)
        plan = {"path": "narrow", "tiles": tiles, "chunks": 1, "splits": 1,
                "grid": tiles}
    else:
        tiles = -(-N // _WIDE_TILE) * -(-M // _WIDE_TILE)
        chunks = -(-D // _WIDE_CHUNK)
        splits = 1
        while (splits < _MAX_SPLITS and tiles * splits < sms
               and 2 * splits <= chunks):
            splits *= 2
        plan = {"path": "wide", "tiles": tiles, "chunks": chunks,
                "splits": splits, "grid": tiles * splits}
    if plan["grid"] > _MAX_GRID:
        raise ValueError(f"rbf_gram: N={N}, M={M} needs {plan['grid']} "
                         f"blocks, past {_MAX_GRID}")
    plan["workspace_bytes"] = 0
    return plan


@contextlib.contextmanager
def plain_on_card():
    """CUDA tensors take the plain version while inside."""
    rbf_gram.plain_on_card = True
    try:
        yield
    finally:
        rbf_gram.plain_on_card = False


@functools.cache
def _fns():
    from .build import load_library
    lib = load_library("rbf_gram")
    f32, f64 = lib.rbf_gram_f32, lib.rbf_gram_f64
    args = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    f32.argtypes = args + [ctypes.c_int, ctypes.c_void_p]
    f64.argtypes = args + [ctypes.c_void_p]
    f32.restype = f64.restype = ctypes.c_int
    return f32, f64


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_args(X, Z, lengthscales):
    """(N, M, D, ls_stride) of a launch: the kernel reads lengthscale d at
    element d * ls_stride of ``lengthscales`` (stride 0 for a scalar, so
    one value serves every d without a device op)."""
    (N, D), M = X.shape, Z.shape[0]
    return N, M, D, lengthscales.stride(0) if lengthscales.ndim else 0


def _launch(X, Z, lengthscales, variance, fast_exp):
    """The launch, for operands already checked: X, Z contiguous CUDA
    tensors of one dtype, float32 or float64, lengthscales (D,) or a
    scalar and a one-element variance of that dtype on that device."""
    N, M, D, ls_stride = _kernel_args(X, Z, lengthscales)
    K = torch.empty(N, M, dtype=X.dtype, device=X.device)
    if N == 0 or M == 0:
        return K
    f32, f64 = _fns()
    index = X.device.index
    plan = launch_plan(N, M, D, _sm_count(index))
    args = (X.data_ptr(), Z.data_ptr(), lengthscales.data_ptr(), ls_stride,
            variance.data_ptr(), K.data_ptr(), N, M, D, plan["splits"])

    def launch():
        stream = torch._C._cuda_getCurrentRawStream(index)
        return (f32(*args, int(fast_exp), stream)
                if X.dtype == torch.float32 else f64(*args, stream))

    # the kernel launches on the current device: enter X's only if needed
    if index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(index):
            err = launch()
    if err != 0:
        raise RuntimeError(f"rbf_gram: kernel launch failed with CUDA error "
                           f"{err}")
    rbf_gram.launches += 1
    return K


def _check_kernel_dtype(name, t):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rbf_gram: {name} is {t.dtype}; the kernel takes "
                        f"float32 or float64, one dtype for all")


def rbf_gram_kernel(X, Z, lengthscales, variance, fast_exp=FAST_EXP):
    """var exp(-0.5 ||(x - z) / ls||^2) for X (N, D), Z (M, D), the
    lengthscales (D,) or a scalar and a one-element ``variance``, all CUDA
    tensors of one dtype, float32 or float64, on one device, with X and Z
    contiguous; raises on anything else, before any launch.
    ``fast_exp``: __expf in float32."""
    if X.ndim != 2 or Z.ndim != 2 or X.shape[1] != Z.shape[1]:
        raise ValueError(f"rbf_gram: X {tuple(X.shape)} and Z "
                         f"{tuple(Z.shape)} must be (N, D) and (M, D)")
    if lengthscales.ndim > 1 or (lengthscales.ndim == 1
                                 and lengthscales.shape[0] != X.shape[1]):
        raise ValueError(f"rbf_gram: lengthscales of shape "
                         f"{tuple(lengthscales.shape)} for D={X.shape[1]}")
    if variance.numel() != 1:
        raise ValueError(f"rbf_gram: variance must hold one value; got "
                         f"shape {tuple(variance.shape)}")
    for name, t in (("X", X), ("Z", Z), ("lengthscales", lengthscales),
                    ("variance", variance)):
        if t.device.type != "cuda" or t.device != X.device:
            raise ValueError(f"rbf_gram: {name} is on {t.device}; the kernel "
                             f"takes CUDA tensors on one device")
        _check_kernel_dtype(name, t)
        if t.dtype != X.dtype:
            raise TypeError(f"rbf_gram: {name} is {t.dtype}, X {X.dtype}; "
                            f"the kernel takes one dtype for all")
    for name, t in (("X", X), ("Z", Z)):
        if not t.is_contiguous():
            raise ValueError(f"rbf_gram: {name} must be contiguous")
    return _launch(X, Z, lengthscales, variance, fast_exp)


def _forward(X, Z, lengthscales, variance):
    if X.device.type == "cuda" and rbf_gram.plain_on_card:
        return rbf_gram_plain(X, Z, lengthscales, variance)
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rbf_gram: unsupported device {X.device}")
    if X.device.type == "cuda":
        # rbf_gram checked the shapes, dtypes and devices; what is left is
        # the kernel's own: its dtypes, one variance value, contiguous rows
        _check_kernel_dtype("X", X)
        if variance.numel() != 1:
            raise ValueError(f"rbf_gram: variance must hold one value; got "
                             f"shape {tuple(variance.shape)}")
        X, Z = X.contiguous(), Z.contiguous()
    return torch.ops.dsdgp.rbf_gram(X, Z, lengthscales, variance)


@torch.library.custom_op("dsdgp::rbf_gram", mutates_args=())
def _gram_op(X: torch.Tensor, Z: torch.Tensor, lengthscales: torch.Tensor,
             variance: torch.Tensor) -> torch.Tensor:
    """The forward as a registered op (so ``torch.export`` can carry it):
    the plain version on the CPU, the kernel on CUDA."""
    if X.device.type == "cpu":
        return rbf_gram_plain(X, Z, lengthscales, variance)
    return _launch(X, Z, lengthscales, variance, FAST_EXP)


@_gram_op.register_fake
def _(X, Z, lengthscales, variance):
    return X.new_empty(X.shape[0], Z.shape[0])


class _RBFGram(torch.autograd.Function):
    """Forward: the plain version on the CPU, the kernel on CUDA.
    Backward: the JAX ``_bwd`` on the saved K, on either device."""

    @staticmethod
    def forward(ctx, X, Z, lengthscales, variance):
        K = _forward(X, Z, lengthscales, variance)
        ctx.save_for_backward(X, Z, lengthscales, variance, K)
        return K

    @staticmethod
    def backward(ctx, g):
        X, Z, ls, var, K = ctx.saved_tensors
        W = g * K                                           # (N, M)
        inv2 = 1.0 / (ls * ls)
        rowsum = torch.sum(W, dim=1, keepdim=True)          # (N, 1)
        colsum = torch.sum(W, dim=0, keepdim=True)          # (1, M)
        WZ = W @ Z                                          # (N, D)
        dX = -(X * rowsum - WZ) * inv2
        dZ = -(Z * colsum.T - W.T @ X) * inv2
        # sum_nm W_nm (x_nd - z_md)^2 / ls_d^3 as three contractions
        x2 = torch.sum((X * X).T * rowsum.T, dim=1)         # (D,)
        z2 = torch.sum((Z * Z).T * colsum, dim=1)           # (D,)
        xz = torch.sum(X * WZ, dim=0)                       # (D,)
        dls = (x2 + z2 - 2.0 * xz) / ls ** 3
        if ls.ndim == 0:                                    # not ARD
            dls = torch.sum(dls)
        dvar = torch.sum(W) / var
        return tuple(gr if need else None for gr, need in
                     zip((dX, dZ, dls, dvar), ctx.needs_input_grad))


def rbf_gram(X, Z, lengthscales, variance):
    """var exp(-0.5 ||(x - z) / ls||^2), (N, M), differentiable in all
    four inputs; the counterpart of the JAX ``rbf_gram``.  The four are
    tensors of one dtype on one device; ``lengthscales`` is (D,) or a
    scalar, ``variance`` a scalar."""
    if X.ndim != 2 or Z.ndim != 2 or X.shape[1] != Z.shape[1]:
        raise ValueError(f"rbf_gram: X {tuple(X.shape)} and Z "
                         f"{tuple(Z.shape)} must be (N, D) and (M, D)")
    if lengthscales.ndim > 1 or (lengthscales.ndim == 1
                                 and lengthscales.shape[0] != X.shape[1]):
        raise ValueError(f"rbf_gram: lengthscales of shape "
                         f"{tuple(lengthscales.shape)} for D={X.shape[1]}")
    for name, t in (("Z", Z), ("lengthscales", lengthscales),
                    ("variance", variance)):
        if t.dtype != X.dtype:
            raise TypeError(f"rbf_gram: {name} is {t.dtype}, X {X.dtype}")
        if t.device != X.device:
            raise ValueError(f"rbf_gram: {name} is on {t.device}, X on "
                             f"{X.device}")
    return _RBFGram.apply(X, Z, lengthscales, variance)


rbf_gram.launches = 0
rbf_gram.plain_on_card = False
