"""psi2 data sum, forward and backward: the CUDA kernels, their plain
PyTorch versions and the autograd Function around them.

Replaces the TPU kernels ``doubly_stochastic_dgp_tpu/ops/pallas/psi2.py::
_psi2_core_fwd_call`` (``_fwd_kernel``) with ``csrc/psi2.cu`` and
``_psi2_core_bwd_call`` (``_bwd_kernel``, ``_bwd_kernel_mxu``) with
``csrc/psi2_bwd.cu``.  For U, V (N, M), w (N, D) with w >= 0, logdet
(N, 1) and Z (M, D):

    pre[n, a, b] = U[n,a] + V[n,b] - sum_d w[n,d] Z[a,d] Z[b,d]
    out[a, b] = sum_n exp(min(pre, 0) + logdet[n])                  (M, M)

and for a cotangent g (M, M), with ge = g[a,b] exp(min(pre, 0) + logdet[n])
and P = ge where pre < 0, else 0 (at an exact tie pre == 0 the clamp takes
the whole cotangent: the convention of the JAX kernels, which the JAX
``psi2_core`` always differentiates through):

    gU[n,a] = sum_b P,   gV[n,b] = sum_a P,   glogdet[n] = sum_ab ge,
    gw[n,d] = -sum_ab P Z[a,d] Z[b,d],
    gZ[c,d] = -sum_n w[n,d] (sum_b P[n,c,b] Z[b,d] + sum_a P[n,a,c] Z[a,d]).

``symmetric=True`` says that U and V make ``out`` symmetric (one RBF
kernel's staging, where U = V - t/2 row by row): the forward then computes
each a <= b once and mirrors it, so the output is bitwise symmetric.  The
backward is the general one either way: U and V are functions of the same
parameters, so the total derivative with respect to them is unchanged;
only its split between gU and gV differs, which no caller reads.

What bounds them on an H100: operations (one exp per (n, a, b) term and
4 + 2D flops forward, 8 + 6D backward; see :func:`terms`, :func:`flops`
and :func:`backward_flops`), so the kernels keep the (N, M, M) block out
of memory: the backward recomputes the exponentials.  Both add their
partial sums in a fixed order (deterministic).

Routing: a CPU tensor takes the plain versions; a CUDA tensor launches the
kernels or raises: there is no fallback (:func:`kernel_supports` says
beforehand what the kernels take).  The forward on either device is the
registered op ``torch.ops.dsdgp.psi2_core_fwd`` (with a shape function for
tracing), so ``torch.export`` carries it into an exported program.
``psi2_core.launches`` counts the forward kernel's launches,
``psi2_core.backward_launches`` the backward's.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["psi2_core", "psi2_core_forward", "psi2_core_plain",
           "psi2_core_backward", "psi2_core_backward_plain", "terms", "flops",
           "backward_flops", "forward_plan", "backward_plan",
           "kernel_supports", "MAX_M", "MAX_D"]

# the kernel's limits (the JAX kernel's _MAX_M, _MAX_D); N is not limited:
# the kernel streams rows and stages nothing of size N
MAX_M = 512
MAX_D = 32
# csrc/psi2.cu's forward, mirrored by forward_plan: warps a block (tile
# warps x row groups), rows a row group a step, chunks x tile warps a
# group's last block adds (x 512 floats), chunks, dynamic shared memory a
# block
_FWD_WARPS, _FWD_KR, _FWD_REDUCE, _FWD_CHUNKS = 16, 8, 96, 16
# the plan's cost model: staging a row costs about 0.7 of a tile warp's
# terms on it, and an SM's rate grows as the square root of its warps up
# to 16.  Held to chip_smoke.py's wt sweep (every wt timed at both
# collapsed cells' shapes, PERF.md section 6): on an H100 it picks the
# fastest wt there, symmetric and general
_FWD_STAGE_COST = 0.7
_FWD_SMEM_MAX = 200 * 1024
# csrc/psi2_bwd.cu's tiling, mirrored by backward_plan: threads a block
# (16 x 16), b's a sub-tile, rows a step, d's of gw and Q a block when
# D > 8, the row stride of the per-thread partials; shared memory a block
# may use, and an SM's (less 1 KB a block that the card reserves)
_BWD_THREADS, _BWD_SUB_B, _BWD_RS, _BWD_GROUP_D, _BWD_PAD = 256, 64, 4, 8, 17
SMEM_MAX, _SMEM_SM, _SMEM_RESERVED = 232448, 233472, 1024


def _block_rows(M):
    """Rows per block of the plain version: the rule of the JAX
    ``_xla_blocked_core``."""
    return max(128, (8192 * 100 * 100) // (M * M) // 8 * 8)


def _pre(Ub, Vb, wb, Z):
    """(B, M, M) clamp argument of a row block: U + V, then the d terms."""
    pre = Ub[:, :, None] + Vb[:, None, :]
    for d in range(Z.shape[1]):
        zd = Z[:, d][None, :]                                    # (1, M)
        pre = pre - (wb[:, d:d + 1] * zd)[:, :, None] * zd[:, None, :]
    return pre


def psi2_core_plain(U, V, w, logdet, Z, symmetric=False):
    """Plain PyTorch version: a blocked mirror of the JAX
    ``_xla_blocked_core`` (same block rows and d-loop arithmetic); with
    ``symmetric`` its upper triangle, mirrored."""
    out = _plain_sum(U, V, w, logdet, Z)
    if not symmetric:
        return out
    upper = torch.triu(out)
    return upper + torch.triu(out, 1).T


def _plain_sum(U, V, w, logdet, Z):
    N, M = U.shape

    def block(Ub, Vb, wb, ldb):
        return torch.sum(torch.exp(torch.clamp(_pre(Ub, Vb, wb, Z), max=0.0)
                                   + ldb[:, :, None]), dim=0)

    rows = _block_rows(M)
    if N <= rows:
        return block(U, V, w, logdet)
    out = torch.zeros(M, M, dtype=U.dtype, device=U.device)
    for n0 in range(0, N, rows):
        out = out + block(U[n0:n0 + rows], V[n0:n0 + rows], w[n0:n0 + rows],
                          logdet[n0:n0 + rows])
    return out


def psi2_core_backward_plain(U, V, w, logdet, Z, g):
    """Plain PyTorch version of the backward, blocked over rows like
    :func:`psi2_core_plain`: (gU, gV, gw, glogdet, gZ) for the cotangent g
    (M, M), with the ``pre < 0`` gate.  Any dtype."""
    N, M = U.shape
    gU, gV = torch.empty_like(U), torch.empty_like(V)
    gw, glogdet = torch.empty_like(w), torch.empty_like(logdet)
    gZ = torch.zeros_like(Z)
    rows = _block_rows(M)
    for n0 in range(0, max(N, 1), rows):
        sl = slice(n0, n0 + rows)
        pre = _pre(U[sl], V[sl], w[sl], Z)
        ge = g[None, :, :] * torch.exp(torch.clamp(pre, max=0.0)
                                       + logdet[sl][:, :, None])
        P = torch.where(pre < 0.0, ge, torch.zeros_like(ge))
        gU[sl] = P.sum(dim=2)
        gV[sl] = P.sum(dim=1)
        glogdet[sl] = ge.sum(dim=(1, 2))[:, None]
        for d in range(Z.shape[1]):
            # per-d products and sums, as the JAX ``_bwd_kernel`` forms them
            zd = Z[:, d]
            s_a = (P * zd[None, None, :]).sum(dim=2)             # by a
            s_b = (P * zd[None, :, None]).sum(dim=1)             # by b
            gw[sl, d] = -(s_a * zd[None, :]).sum(dim=1)
            gZ[:, d] -= (w[sl, d:d + 1] * (s_a + s_b)).sum(dim=0)
    return gU, gV, gw, glogdet, gZ


def terms(N, M, symmetric=False):
    """(n, a, b) terms of one call, each one exp: all M x M, or the upper
    triangle's M (M + 1) / 2 for a symmetric call."""
    return N * (M * (M + 1) // 2 if symmetric else M * M)


def flops(N, M, D, symmetric=False):
    """fp32 flops of one call besides the exps: per term U + V, D
    multiply-adds, the clamp, + logdet and the sum (an FMA counts as
    two)."""
    return terms(N, M, symmetric) * (4 + 2 * D)


def kernel_supports(M, D, dtype):
    """Whether the CUDA kernels take a call: float32, M <= MAX_M and
    1 <= D <= MAX_D (N is not limited).  The JAX ``psi2_kernel_supported``
    also caps N M; the port's kernels stream rows and need no cap."""
    return dtype == torch.float32 and M <= MAX_M and 1 <= D <= MAX_D


def _fwd_smem_floats(M, D, row_groups, box, threads, stages):
    """Shared memory of a forward block in floats: csrc/psi2.cu's
    smem_floats (the ring of ``stages`` stages for the widest box, the
    per-thread totals and compensations and, for D > 4, Z)."""
    stage = -(-_FWD_KR * row_groups * (box + D + 1) // 4) * 4
    return (stages * stage + 32 * threads
            + (D * 4 * -(-M // 4) if D > 4 else 0))


def _decode(k, P, symmetric):
    """csrc/psi2.cu's decode: micro-tile number -> (i, j), row-major over
    P x P or over i <= j."""
    if not symmetric:
        return divmod(k, P)
    i = 0
    while k >= P - i:
        k -= P - i
        i += 1
    return i, i + k


def _group_box(g, width, tiles, P, symmetric):
    """(a_lo, a's, b_lo, b's) in micro-tiles of the box that group g of
    ``width`` micro-tiles stages (csrc/psi2.cu, psi2_fwd_kernel): its
    micro-rows i0..i1; on one row its micro-columns, else from the first
    row's j0 (or the next row's diagonal) to the end."""
    (i0, j0) = _decode(g * width, P, symmetric)
    (i1, j1) = _decode(min(tiles, (g + 1) * width) - 1, P, symmetric)
    if i0 == i1:
        return i0, 1, j0, j1 + 1 - j0
    b_lo = min(j0, i0 + 1) if symmetric else 0
    return i0, i1 - i0 + 1, b_lo, P - b_lo


@functools.lru_cache(maxsize=256)
def forward_plan(N, M, D, sms=132, symmetric=False, wt=None):
    """The forward kernel's launch plan.

    A thread owns a 4 x 4 micro-tile of (a, b); the ``tiles`` micro-tiles
    (all P x P, P = ceil(M / 4), or the ``symmetric`` upper triangle's P
    (P + 1) / 2) are taken row-major by ``groups`` groups of ``wt`` warps'
    worth (32 wt).  A block is a group's ``row_groups`` x ``wt`` warps over
    one of ``chunks`` chunks of ``rows_per_chunk`` rows, 8 rows a row
    group a step (``rows_per_step`` = 8 row_groups).  A group stages the
    U and V columns of its box, at most ``box`` floats a row, through a
    ring of ``stages`` steps (3, or 2 where shared memory is short).  wt (and
    row_groups = 16 // wt) is chosen by a cost model of the kernel's time:
    waves of blocks x a block's rows x (wt + the staging's cost) over the
    SM's rate at its warps; the chunks are as many as fill the SMs once,
    at most 16 and 96 / wt (the floats that a group's last block adds are
    512 x chunks x wt), and a chunk holds at least 8 rows.  With
    more than one chunk the launch's scratch holds ``scratch_floats`` =
    chunks x groups x 512 wt floats of the chunks' sums and the ``groups``
    ticket counters, bounded whatever N.  ``wt`` (private, for timing
    the choices) fixes wt.  Cached: the wrapper asks at every launch."""
    P = -(-M // 4)
    tiles = P * (P + 1) // 2 if symmetric else P * P
    tile_warps = -(-tiles // 32)
    best = None
    for wt in ([wt] if wt else range(1, min(tile_warps, _FWD_WARPS) + 1)):
        groups = -(-tile_warps // wt)
        R = _FWD_WARPS // wt
        S = _FWD_KR * R
        threads = 32 * wt * R
        box = 4 * max(na + nb for _, na, _, nb in (
            _group_box(g, 32 * wt, tiles, P, symmetric)
            for g in range(groups)))
        stages = 3 if 4 * _fwd_smem_floats(
            M, D, R, box, threads, 3) <= _FWD_SMEM_MAX else 2
        smem = 4 * _fwd_smem_floats(M, D, R, box, threads, stages)
        if smem > _FWD_SMEM_MAX:
            continue
        chunks = max(1, min(sms // groups, _FWD_CHUNKS, _FWD_REDUCE // wt,
                            N // _FWD_KR))
        rows = -(-N // chunks)
        chunks = -(-N // rows)
        waves = -(-groups * chunks // sms)
        cost = (waves * rows * (wt + _FWD_STAGE_COST)
                / math.sqrt(wt * R / _FWD_WARPS))
        if best is None or cost < best[0]:
            best = (cost, {
                "symmetric": bool(symmetric), "tiles": tiles, "wt": wt,
                "groups": groups, "row_groups": R, "rows_per_step": S,
                "box": box, "threads": threads, "chunks": chunks,
                "rows_per_chunk": rows, "blocks": groups * chunks,
                "stages": stages, "smem_bytes": smem,
                "scratch_floats": (chunks * groups * 512 * wt + groups
                                   if chunks > 1 else 0)})
    if best is None:
        raise ValueError(f"psi2_core forward: M={M}, D={D} leaves no room "
                         f"for a block's shared memory")
    return best[1]


def backward_flops(N, M, D):
    """fp32 flops of one backward call besides the exps.  Per (n, a, b)
    term: pre, the clamp and + logdet as forward (3 + 2D), g e, the gate,
    the three sums gU, gV and glogdet (3), and a multiply-add per d for
    each of sum_b P Z[b,d] and sum_a P Z[a,d] (4D): 8 + 6D.  Per (n, a, d):
    the gw and gZ products and sums (5)."""
    return terms(N, M) * (8 + 6 * D) + 5 * N * M * D


def _bwd_geometry(D):
    """(D template, a's a thread, d's of gw and Q a block, blocks an SM)
    of csrc/psi2_bwd.cu at this D."""
    dt = D if D <= 8 else 0
    return (dt, 4 if 1 <= dt <= 4 else 2, dt if dt else _BWD_GROUP_D,
            2 if 1 <= dt <= 2 else 1)


def _bwd_smem_floats(M, D, rc):
    """Shared memory of a backward block in floats: csrc/psi2_bwd.cu's
    smem_floats, term for term."""
    dt, ta, ds, _ = _bwd_geometry(D)
    sa, sb = 16 * ta, _BWD_SUB_B
    return (2 * rc * M + rc * (1 + ds) + 2 * M * ds
            + _BWD_RS * sa * _BWD_PAD + _BWD_RS * sb * _BWD_PAD
            + _BWD_RS * (1 + ds) * _BWD_THREADS
            + 2 * _BWD_RS * (sa + sb + D + 1)
            + (D * (sa + sb) if dt == 0 else 0))


def backward_plan(N, M, D, sms=132):
    """The backward kernel's launch plan.

    A block owns ``rows_per_chunk`` rows (a multiple of 4) and all M x M
    terms of them, walked in ``sub_tiles`` sub-tiles of 16
    ``a_per_thread`` a's x 64 b's; its shared memory holds the chunk's gU
    and gV sums, so ``rows_per_chunk`` is what fits beside the fixed part
    in the SM's share of a block (``blocks_per_sm`` blocks an SM: two up to
    D = 2, else one).  The rows are cut into ``chunks`` chunks of about
    equal size, as many as give every block slot one a wave; ``grid``
    blocks (at most the slots) take chunks i, i + grid, ...; ``groups``
    blocks along y split the d's of gw and Q when D > 8.  Each block
    writes its gZ sums (M x D) to the scratch: ``scratch_floats`` = grid x
    M x D, whatever N."""
    dt, ta, ds, per_sm = _bwd_geometry(D)
    budget = min(SMEM_MAX, _SMEM_SM // per_sm - _SMEM_RESERVED)
    per_row = 2 * M + 1 + ds
    rc_max = ((budget // 4 - _bwd_smem_floats(M, D, 0)) // per_row
              // _BWD_RS * _BWD_RS)
    if rc_max < _BWD_RS:
        raise ValueError(f"psi2_core backward: M={M}, D={D} leaves no room "
                         f"for a chunk in a block's shared memory")
    slots = sms * per_sm
    waves = -(-N // (slots * rc_max))
    rc = -(-max(1, -(-N // (slots * waves))) // _BWD_RS) * _BWD_RS
    chunks = -(-N // rc)
    grid = min(chunks, slots)
    return {"dt": dt, "a_per_thread": ta, "d_group": ds,
            "blocks_per_sm": per_sm,
            "groups": 1 if dt else -(-D // _BWD_GROUP_D),
            "sub_tiles": -(-M // (16 * ta)) * -(-M // _BWD_SUB_B),
            "rows_per_chunk": rc, "chunks": chunks, "grid": grid,
            "smem_bytes": 4 * _bwd_smem_floats(M, D, rc),
            "scratch_floats": grid * M * D}


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _fwd_fn():
    from .build import load_library
    fn = load_library("psi2").psi2_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    from .build import load_library
    fn = load_library("psi2_bwd").psi2_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(U, V, w, logdet, Z, g=None):
    N, M = U.shape
    D = Z.shape[1] if Z.ndim == 2 else -1
    if (V.shape != (N, M) or w.shape != (N, D) or logdet.shape != (N, 1)
            or Z.shape != (M, D) or (g is not None and g.shape != (M, M))):
        raise ValueError(
            f"psi2_core: inconsistent shapes U {tuple(U.shape)}, V "
            f"{tuple(V.shape)}, w {tuple(w.shape)}, logdet "
            f"{tuple(logdet.shape)}, Z {tuple(Z.shape)}"
            + ("" if g is None else f", g {tuple(g.shape)}"))
    if M > MAX_M or not 1 <= D <= MAX_D:
        raise ValueError(f"psi2_core: M={M}, D={D} outside the kernel's "
                         f"limits M <= {MAX_M}, 1 <= D <= {MAX_D} "
                         f"(Config.psi2_impl='auto' or 'xla' takes the "
                         f"plain psi2 route there)")
    for name, t in (("U", U), ("V", V), ("w", w), ("logdet", logdet),
                    ("Z", Z)) + (() if g is None else (("g", g),)):
        if t.device != U.device:
            raise ValueError(f"psi2_core: {name} is on {t.device}, U on "
                             f"{U.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"psi2_core: the CUDA kernel takes float32; "
                            f"{name} is {t.dtype} (Config.psi2_impl='auto' "
                            f"or 'xla' takes the plain psi2 route there)")
        if not t.is_contiguous():
            raise ValueError(f"psi2_core: {name} must be contiguous")
    return N, M, D


def _forward_kernel(U, V, w, logdet, Z, symmetric=False, wt=None):
    """Launch the forward kernel.  The launch's scratch (the chunks' sums
    and its ticket counters) comes from the caching allocator on the
    current stream, so launches on several streams, or in several CUDA
    graphs, never share it.  Private, for timing: ``wt`` fixes the plan's
    wt (:func:`forward_plan`)."""
    N, M, D = _check(U, V, w, logdet, Z)
    out = torch.empty(M, M, dtype=torch.float32, device=U.device)
    if N == 0:
        return out.zero_()
    sms = _sm_count(U.device)
    plan = forward_plan(N, M, D, sms, bool(symmetric), wt)
    scratch = (torch.empty(plan["scratch_floats"], dtype=torch.float32,
                           device=U.device)
               if plan["chunks"] > 1 else None)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_fn()(
            U.data_ptr(), V.data_ptr(), w.data_ptr(), logdet.data_ptr(),
            Z.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), N, M, D,
            int(symmetric), plan["wt"], plan["row_groups"],
            plan["rows_per_chunk"], plan["box"], plan["stages"],
            plan["groups"], plan["chunks"], plan["smem_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"psi2_core: kernel launch failed with CUDA "
                           f"error {err}")
    psi2_core.launches += 1
    return out


def psi2_core_forward(U, V, w, logdet, Z, symmetric=False):
    """The (M, M) data sum: the plain version for CPU tensors, the kernel
    for CUDA tensors (``symmetric``: U and V make the output symmetric,
    and each a <= b is computed once).  Not differentiable:
    :func:`psi2_core` is."""
    if U.device.type not in ("cpu", "cuda"):
        raise ValueError(f"psi2_core: unsupported device {U.device}")
    return torch.ops.dsdgp.psi2_core_fwd(U, V, w, logdet, Z, bool(symmetric))


@torch.library.custom_op("dsdgp::psi2_core_fwd", mutates_args=())
def _fwd_op(U: torch.Tensor, V: torch.Tensor, w: torch.Tensor,
            logdet: torch.Tensor, Z: torch.Tensor,
            symmetric: bool) -> torch.Tensor:
    """The forward as a registered op (so ``torch.export`` can carry it):
    the plain version on the CPU, the kernel on CUDA."""
    if U.device.type == "cpu":
        return psi2_core_plain(U, V, w, logdet, Z, symmetric)
    return _forward_kernel(U, V, w, logdet, Z, symmetric)


@_fwd_op.register_fake
def _(U, V, w, logdet, Z, symmetric):
    return U.new_empty(Z.shape[0], Z.shape[0])


def _backward_kernel(U, V, w, logdet, Z, g):
    N, M, D = _check(U, V, w, logdet, Z, g)
    gU, gV = torch.empty_like(U), torch.empty_like(V)
    gw, glogdet = torch.empty_like(w), torch.empty_like(logdet)
    gZ = torch.empty_like(Z)
    if N == 0:
        return gU, gV, gw, glogdet, gZ.zero_()
    plan = backward_plan(N, M, D, _sm_count(U.device))
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                          device=U.device)
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_fn()(U.data_ptr(), V.data_ptr(), w.data_ptr(),
                        logdet.data_ptr(),
                        Z.data_ptr(), g.data_ptr(), gU.data_ptr(),
                        gV.data_ptr(), gw.data_ptr(), glogdet.data_ptr(),
                        gZ.data_ptr(), scratch.data_ptr(), N, M, D,
                        plan["rows_per_chunk"], plan["chunks"], plan["grid"],
                        plan["smem_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"psi2_core backward: kernel launch failed with "
                           f"CUDA error {err}")
    psi2_core.backward_launches += 1
    return gU, gV, gw, glogdet, gZ


def psi2_core_backward(U, V, w, logdet, Z, g):
    """(gU, gV, gw, glogdet, gZ) for the cotangent g (M, M): the plain
    version for CPU tensors, the kernel for CUDA tensors, which raises on
    what it does not take (float64, M > 512, D outside 1..32, a
    non-contiguous operand, mixed devices)."""
    if U.device.type == "cpu":
        return psi2_core_backward_plain(U, V, w, logdet, Z, g)
    if U.device.type != "cuda":
        raise ValueError(f"psi2_core: unsupported device {U.device}")
    return _backward_kernel(U, V, w, logdet, Z, g)


class _Psi2Core(torch.autograd.Function):
    """Forward and backward: the plain versions on the CPU, the kernels on
    CUDA.  The backward computes all five gradients and hands back those
    of the inputs that need one."""

    @staticmethod
    def forward(ctx, U, V, w, logdet, Z, symmetric):
        ctx.save_for_backward(U, V, w, logdet, Z)
        return psi2_core_forward(U, V, w, logdet, Z, symmetric)

    @staticmethod
    def backward(ctx, g):
        grads = psi2_core_backward(*ctx.saved_tensors, g.contiguous())
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad)) + (
            None,)


def psi2_core(U, V, w, logdet, Z, symmetric=False):
    """sum_n exp(logdet_n + min(U_na + V_nb - sum_d w_nd Z_ad Z_bd, 0)),
    (M, M); the counterpart of the JAX ``psi2_core``.  ``symmetric``: U
    and V make the output symmetric (one RBF kernel's staging); the
    forward computes each a <= b once and mirrors it, the backward is the
    general one (see the module's docstring)."""
    return _Psi2Core.apply(U, V, w, logdet, Z, symmetric)


psi2_core.launches = 0
psi2_core.backward_launches = 0
