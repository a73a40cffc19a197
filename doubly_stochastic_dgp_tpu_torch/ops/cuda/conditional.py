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
backward; the kernels read W_d as given, row-major (W_d, not W_d^T, which
differ at the rounding level).  What bounds both on an H100: operations
(see :func:`flops`, :func:`flops_bwd`), nearly all in GEMM-shaped
products, which both run as register-tiled fp32 FFMA (fp32-accurate: the
3xTF32 tensor-core designs missed the float64 gate, and plain TF32 is
never used), streaming LiT and W_d through shared memory.  The forward
also exposes those 3xTF32 designs (``design``) for the precision
comparison that ``chip_smoke.py`` prints.  The backward is two passes: a
row pass (the row panels G, dG, Gd, K, and dX at Dx <= 4) and a
reduction over fixed row slices (dW, dLiT, dalpha, dZ, and dX on tiles at
Dx > 4) whose partials are added in slice order, so it is deterministic
and its scratch is bounded independently of B (:func:`backward_plan`).
dkvar and dkdiag come from the saved forward outputs (``_scalar_grads``,
as in the JAX package).

Routing: a CPU tensor takes the plain versions (forward and backward); a
CUDA tensor launches the kernels or raises — there is no fallback.  The
forward is the registered op ``torch.ops.dsdgp.fused_conditional_fwd``
(with a shape function for tracing), so ``torch.export`` carries it into
an exported program, which then runs the kernel on the card.
Launch counters: ``fused_conditional.launches`` and
``fused_conditional.backward_launches`` count the plain variant's forward
and backward kernel launches, ``fused_conditional_saved.launches`` and
``fused_conditional_saved.backward_launches`` the save-gram pair's.  They
tick where the wrapper runs, so not in a CUDA-graph replay
(``graphs.py``): ``graph.replays`` counts the replays, and
``tracing.counters()`` reads both in one snapshot.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["fused_conditional", "fused_conditional_saved",
           "fused_conditional_forward", "fused_conditional_backward",
           "fused_conditional_plain", "fused_conditional_saved_plain",
           "fused_conditional_backward_plain", "forward_plan",
           "backward_plan", "gram_tile_rows", "flops", "flops_bwd", "MAX_M"]

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
    mean, var, K = torch.ops.dsdgp.fused_conditional_fwd(
        Xs, Zs, LiT, alpha, W, kvar, kdiag, bool(save_gram))
    return mean, var, (K if save_gram else None)


@torch.library.custom_op("dsdgp::fused_conditional_fwd", mutates_args=())
def _fwd_op(Xs: torch.Tensor, Zs: torch.Tensor, LiT: torch.Tensor,
            alpha: torch.Tensor, W: torch.Tensor, kvar: torch.Tensor,
            kdiag: torch.Tensor, save_gram: bool
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward as a registered op (so ``torch.export`` can carry it):
    the plain version on the CPU, the kernel on CUDA; K is (B, M) with
    ``save_gram``, else empty."""
    if _on_cpu(Xs):
        mean, var, K = fused_conditional_saved_plain(Xs, Zs, LiT, alpha, W,
                                                     kvar, kdiag)
    else:
        mean, var, K = _forward_kernel(Xs, Zs, LiT, alpha, W, kvar, kdiag,
                                       save_gram)
    return mean, var, (K if save_gram else Xs.new_empty(0))


@_fwd_op.register_fake
def _(Xs, Zs, LiT, alpha, W, kvar, kdiag, save_gram):
    B, M, Do = Xs.shape[0], Zs.shape[0], alpha.shape[1]
    return (Xs.new_empty(B, Do), Xs.new_empty(B, Do),
            Xs.new_empty(B, M) if save_gram else Xs.new_empty(0))


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
    return (*_backward_kernel(Xs, Zs, LiT, alpha, W, kvar, gm, gv_eff, K),
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
# launch plans (plain Python: the CPU tests reach them)
# ---------------------------------------------------------------------------

SMEM_MAX = 232448              # bytes of shared memory a block may use
MAX_CLUSTER = 8                # blocks of a thread-block cluster (portable)
SCRATCH_MAX_BYTES = 8_000_000  # the backward's slice partials, whatever B
# fused_conditional.cuh / fused_conditional_bwd.cu: threads of a row-kernel
# block, row groups a block at most, k rows of a streamed slice, slices in
# the rings, d of a staged chunk of the gram
_THREADS, _MAX_RG, _KS, _STAGES, _GRAM_CHUNK = 256, 32, 16, 4, 16
# widest Dx whose dX the backward's row pass forms (one thread an output);
# wider, the reduction launch forms it on tiles.  Both give the same bits;
# by CUDA-graph replays on an H100 the whole backward with dX in the row
# pass was 0.6% faster at Dx = 1 (B = 100,000), level at 2 and 4, 0.8-1.7%
# slower at 8 and 16 (B = 10,000) and 1.55x slower at 784 (B = 1000)
# (tools/backward_bitwise.py, PERF.md §6)
DX_IN_ROWS_MAX = 4


def _round_up(x, m):
    return -(-x // m) * m


def _row_geometry(M):
    """(rows a block, column groups, row groups, k rows) of the row
    kernels: one 4 x 4 register tile a thread over ceil(M / 4) column
    groups, as many row groups as 256 threads allow (at most 32); k rows
    padded to whole 16-row slices."""
    cg = -(-M // 4)
    rg = min(_THREADS // cg, _MAX_RG)
    return 4 * rg, cg, rg, _round_up(M, _KS)


def gram_stage_floats(tb, M):
    """Floats of the gram stage's two-stage ring (``fused_conditional.cuh``
    gram_stage_floats): tb rows of Xs and 4 ceil(M / 4) rows of Zs, each a
    16-wide chunk of Dx padded to 20 floats.  The forward lays it over
    its product ring, the backward's row pass over its two tiles (in a
    cluster over its second tile and the T buffers)."""
    return 2 * (tb + 4 * -(-M // 4)) * (_GRAM_CHUNK + 4)


def gram_tile_rows(tb, ncg, cluster):
    """Rows of a gram-stage register tile (``fused_conditional.cuh``
    gram_stage): 4 outside a cluster; in one, the fewest of 1, 2 and 4 at
    which a block's tb rows by ncg column groups take one pass of its 256
    threads (gram_tile_rows)."""
    if cluster > 1:
        for r in (1, 2):
            if (tb // r) * ncg <= _THREADS:
                return r
    return 4


def _forward_smem(M):
    """The forward's shared memory a block (``fused_conditional.cu``
    smem_floats): the (P x tb) gram, then the product ring and the
    variance partials or the gram stage's ring, whichever is larger."""
    tb, cg, _, P = _row_geometry(M)
    products = _STAGES * _KS * 4 * cg + 2 * tb * cg
    return 4 * (P * tb + max(products, gram_stage_floats(tb, M)))


def _rows_smem(M, Do, cluster):
    """The backward row pass's shared memory a block
    (``fused_conditional_bwd.cu`` rows_smem_floats): the tiles K and G (in a
    cluster also the two T buffers) or the gram stage's ring, then the
    product ring and the cotangent rows."""
    tb, cg, _, P = _row_geometry(M)
    pt = P * tb
    if cluster > 1:
        tiles = max(2 * pt + 2 * tb * 4 * cg, pt + gram_stage_floats(tb, M))
    else:
        tiles = max(2 * pt, gram_stage_floats(tb, M))
    return 4 * (tiles + _STAGES * _KS * 4 * cg + 2 * tb * Do)


def _cluster_size(B, M, Dx, Do, sms, fits):
    """Blocks of a cluster of the row kernels, whose blocks take as many
    rows as the 4 x 4 tiles of 256 threads take (``_row_geometry``).  At a
    batch whose row blocks leave SMs idle, a thread-block cluster shares
    each row block: the most blocks, a power of two (clusters then pack
    the SMs of a GPC), that keep two blocks an SM or fewer, at most
    MAX_CLUSTER, Do (a d a block at least) and the column groups (one a
    block at least), and that ``fits(cluster)`` (shared memory) lets;
    then halved while the blocks are more than the SMs and a block's work
    is under 3 products (its ceil(Do / cluster) W_d, the gram counted as
    Dx / 64 of them, split cluster ways).  Fitted to CUDA-graph replays on
    an H100 (tools/backward_bitwise.py --plans; PERF.md §6): at M = 100 it
    takes 8 at B = 1000 with Do = 30, and with Dx = 784, Do = 15; 4 with
    Dx = 30, Do = 10; 2 at B = 2640 and 5280 with Dx = Do = 8 (at each the
    fastest of clusters of 1-6 and 8), and none from B = 5281 up."""
    tb, cg, _, _ = _row_geometry(M)
    blocks, cluster = -(-B // tb), 1
    while (2 * cluster <= min(MAX_CLUSTER, Do, cg)
           and blocks * 2 * cluster <= 2 * sms and fits(2 * cluster)):
        cluster *= 2
    while (cluster > 1 and blocks * cluster > sms
           and -(-Do // cluster) + Dx / (64 * cluster) < 3):
        cluster //= 2
    return cluster


def forward_plan(B, M, Dx, Do, sms=132):
    """The forward kernel's launch: rows a block ``tb`` (``row_blocks`` of
    them), blocks of a cluster ``cluster`` (1: none; in a cluster, block q
    builds the gram and G at its column groups, ``col_groups`` of them at
    most, and forms var and mean at d = q, q + cluster, ...), ``blocks`` =
    row_blocks x cluster, the rows of a gram tile ``gram_rows``, busy
    threads of the 256 a block in the W_d products, and shared memory a
    block ``smem_bytes``."""
    cs = _cluster_size(B, M, Dx, Do, sms, lambda c: True)
    tb, cg, _, _ = _row_geometry(M)
    ncg = -(-cg // cs)
    rows = -(-B // tb)
    return {"tb": tb, "cluster": cs, "row_blocks": rows,
            "blocks": rows * cs, "col_groups": ncg,
            "gram_rows": gram_tile_rows(tb, ncg, cs),
            "busy_threads": (tb // 4) * cg, "smem_bytes": _forward_smem(M)}


def backward_plan(B, M, Dx, Do, sms=132, saved=False):
    """The backward's launch plan.

    Row pass: ``tb`` rows a block, blocks of a cluster ``cluster`` (as the
    forward's, :func:`forward_plan`; in a cluster block q builds K, G, dG
    and dK at its column groups, ``col_groups`` at most, and forms T_d at d
    = q, q + cluster, ... in ``rounds`` rounds), ``row_blocks`` blocks in
    all, ``gram_rows``, and ``smem_bytes`` (the tiles K and G, in a cluster
    also two T buffers, or the gram stage's ring, then the product ring and
    the cotangent rows).  It writes the row panels G, dG, Gd and (unless
    ``saved``) K, each (B, P) with P = M rounded up to 4: ``panel_floats``;
    and dX where ``dx_in_rows`` (Dx <= DX_IN_ROWS_MAX).  Reduction, one
    launch of
    ``reduce_blocks`` jobs (``reduce_threads`` threads a block,
    ``reduce_smem_bytes``: the largest job's ring) over ``nslices`` slices
    of ``rows_per_slice`` rows: dW_d and dLiT on square output tiles of
    ``tile`` = min(M rounded up to 8, 128) columns, one block a tile and
    slice (an 8 x 8 register tile a thread; ``product_blocks``); dZ and
    dalpha as column-sum tiles of 4 ``sum_groups`` inducing points by 4
    ``dz_groups`` or 4 ``dalpha_groups`` columns a slice (a 4 x 4 register
    tile a thread; ``dz_blocks``, ``dalpha_blocks``); and, unless
    ``dx_in_rows``, dX on tiles of 4 ``dx_row_groups`` rows by 4
    ``dx_col_groups`` columns (``dx_blocks``; 0 and 0 otherwise).  With
    more than one slice, each writes its partial outputs (``out_floats`` E)
    to the scratch and a last kernel adds them in slice order:
    ``scratch_floats`` = nslices x E (0 for one slice), at most
    SCRATCH_MAX_BYTES and independent of B.  Slices: two output-tile
    blocks an SM, as far as the scratch allows."""
    cs = _cluster_size(B, M, Dx, Do, sms,
                       lambda c: _rows_smem(M, Do, c) <= SMEM_MAX)
    tb, cg, _, P = _row_geometry(M)
    ncg = -(-cg // cs)
    smem = _rows_smem(M, Do, cs)
    if smem > SMEM_MAX:
        raise ValueError(f"fused_conditional backward: M={M}, Do={Do} needs "
                         f"{smem} bytes of shared memory a block, above "
                         f"{SMEM_MAX}")
    tile = min(_round_up(M, 8), 128)
    rthreads = 32 * -(-((tile // 8) ** 2) // 32)
    tiles = (Do + 1) * (-(-M // tile)) ** 2
    E = Do * M * M + M * M + M * Do + M * Dx
    nslices = max(1, min(2 * sms // tiles, SCRATCH_MAX_BYTES // (4 * E)))
    rows_per_slice = _round_up(max(-(-B // nslices), 1), _KS)
    # the column sums: up to 32 groups of 4 inducing points a tile, as many
    # groups of 4 columns as the threads allow, no more than the columns
    sg = min(cg, 32)
    zg = max(1, min(rthreads // sg, -(-Dx // 4)))
    ag = max(1, min(rthreads // sg, -(-Do // 4)))
    m_tiles = -(-M // (4 * sg))
    dx_in_rows = Dx <= DX_IN_ROWS_MAX
    # dX: up to 16 groups of 4 columns a tile, up to 16 groups of 4 rows
    xjg = 0 if dx_in_rows else min(16, -(-Dx // 4))
    xrg = 0 if dx_in_rows else min(rthreads // xjg, 16)
    dx_blocks = 0 if dx_in_rows else (-(-B // (4 * xrg))
                                      * -(-Dx // (4 * xjg)))
    dz_blocks = nslices * m_tiles * -(-Dx // (4 * zg))
    dalpha_blocks = nslices * m_tiles * -(-Do // (4 * ag))
    reduce_smem = 4 * _STAGES * max(
        2 * _KS * tile + _KS, _KS * 4 * (sg + max(zg, ag)),
        4 * xrg * (_GRAM_CHUNK + 4) + _KS * 4 * xjg)
    return {"tb": tb, "cluster": cs, "row_blocks": -(-B // tb) * cs,
            "col_groups": ncg, "gram_rows": gram_tile_rows(tb, ncg, cs),
            "rounds": -(-Do // cs), "smem_bytes": smem, "tile": tile,
            "reduce_threads": rthreads,
            "reduce_smem_bytes": reduce_smem,
            "nslices": nslices, "rows_per_slice": rows_per_slice,
            "product_blocks": nslices * tiles, "sum_groups": sg,
            "dz_groups": zg, "dalpha_groups": ag, "dz_blocks": dz_blocks,
            "dalpha_blocks": dalpha_blocks, "dx_in_rows": dx_in_rows,
            "dx_row_groups": xrg, "dx_col_groups": xjg,
            "dx_blocks": dx_blocks,
            "reduce_blocks": (nslices * tiles + dz_blocks + dalpha_blocks
                              + dx_blocks),
            "out_floats": E,
            "scratch_floats": nslices * E if nslices > 1 else 0,
            "panel_floats": (3 if saved else 4) * B * 4 * cg}


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

# the forward's designs (fused_conditional.cu): the kernel (fp32 FFMA) and
# the two 3xTF32 tensor-core designs kept for the precision comparison
DESIGN_FFMA, DESIGN_3XTF32, DESIGN_3XTF32_CHAINED = 0, 1, 2


@functools.cache
def _fwd_fn():
    from .build import load_library
    return _bind_fwd(load_library("fused_conditional"))


def _bind_fwd(lib):
    """The forward's C entry point of a loaded library, with its types."""
    fn = lib.fused_conditional_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bind_bwd(lib):
    """The backward's C entry point of a loaded library, with its types."""
    fn = lib.fused_conditional_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_fn():
    from .build import load_library
    return _bind_bwd(load_library("fused_conditional_bwd"))


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _on_cpu(Xs):
    if Xs.device.type == "cpu":
        return True
    if Xs.device.type != "cuda":
        raise ValueError(f"fused_conditional: unsupported device "
                         f"{Xs.device}")
    return False


def _check(Xs, Zs, LiT, alpha, W, *rows):
    """Shapes, device, dtype and contiguity of the kernels' operands;
    ``rows`` are (name, tensor, shape) of further operands.  Returns (B,
    M, Dx, Do)."""
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
    for name, t, shape in rows:
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_conditional: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
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


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")


def _forward_kernel(Xs, Zs, LiT, alpha, W, kvar, kdiag, save_gram,
                    design=DESIGN_FFMA):
    """The forward kernel; kvar and kdiag are read on the device (0-dim
    float32 tensors beside Xs).  ``design`` other than DESIGN_FFMA selects
    a 3xTF32 comparison design (chip_smoke.py's precision check; no saved
    gram)."""
    B, M, Dx, Do = _check(Xs, Zs, LiT, alpha, W, ("kvar", kvar, ()),
                          ("kdiag", kdiag, ()))
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=Xs.device)
    mean, var = new(B, Do), new(B, Do)
    K = new(B, M) if save_gram else None
    if B == 0:
        return mean, var, K
    plan = forward_plan(B, M, Dx, Do, _sm_count(Xs.device))
    with torch.cuda.device(Xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_fn()(Xs.data_ptr(), Zs.data_ptr(), LiT.data_ptr(),
                        alpha.data_ptr(), W.data_ptr(), kvar.data_ptr(),
                        kdiag.data_ptr(), mean.data_ptr(), var.data_ptr(),
                        None if K is None else K.data_ptr(), B, M, Dx, Do,
                        design, plan["cluster"], stream)
    _raise_on(err, "fused_conditional forward")
    (fused_conditional_saved if save_gram else fused_conditional
     ).launches += 1
    return mean, var, K


def _backward_kernel(Xs, Zs, LiT, alpha, W, kvar, gm, gv_eff, K):
    gm, gv_eff = gm.contiguous(), gv_eff.contiguous()
    B, M, Dx, Do = Xs.shape[0], Zs.shape[0], Xs.shape[1], alpha.shape[-1]
    rows = [("kvar", kvar, ()), ("gm", gm, (B, Do)), ("gv", gv_eff, (B, Do))]
    if K is not None:
        rows.append(("K", K, (B, M)))
    B, M, Dx, Do = _check(Xs, Zs, LiT, alpha, W, *rows)
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=Xs.device)
    dXs = new(B, Dx)
    nW, nL, nA = Do * M * M, M * M, M * Do
    out = new(nW + nL + nA + M * Dx)
    if B == 0:
        out.zero_()
    else:
        plan = backward_plan(B, M, Dx, Do, _sm_count(Xs.device),
                             saved=K is not None)
        panels = new(plan["panel_floats"])
        part = new(plan["scratch_floats"]) if plan["nslices"] > 1 else None
        with torch.cuda.device(Xs.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _bwd_fn()(
                Xs.data_ptr(), Zs.data_ptr(), LiT.data_ptr(),
                alpha.data_ptr(), W.data_ptr(), kvar.data_ptr(),
                gm.data_ptr(), gv_eff.data_ptr(),
                None if K is None else K.data_ptr(), dXs.data_ptr(),
                out.data_ptr(), panels.data_ptr(),
                None if part is None else part.data_ptr(), B, M, Dx, Do,
                plan["nslices"], plan["rows_per_slice"], plan["tile"],
                plan["reduce_threads"], plan["sum_groups"],
                plan["dz_groups"], plan["dalpha_groups"],
                plan["dx_row_groups"], plan["dx_col_groups"],
                plan["reduce_smem_bytes"], plan["cluster"], stream)
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
