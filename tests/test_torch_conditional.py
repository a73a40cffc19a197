"""PyTorch port: the fused staged conditional's plain versions (forward,
backward, save-gram pair), the psi2 data sum's plain versions (forward
and backward) and the RBF gram's Function (plain forward, closed-form
backward) against the JAX package's Pallas kernels (interpret mode on
CPU) and its jnp references, in float64 (the gram's forward also in
float32, as the JAX gram tests).

One test item that loops over its cases and names the failing case in
every assertion message; it also checks the CUDA kernels' launch plans,
which are plain Python (``forward_plan``, ``backward_plan``, the psi2
forward's and backward's, rbf_gram's ``launch_plan``), the psi2 forward
kernel's base-2 arithmetic, emulated in float64, and the wide grams'
summation order, emulated in float32.  On the CPU the port's wrappers
and autograd Functions take the plain versions (the CUDA kernels
themselves are checked against them on the card by ``chip_smoke.py``),
so no launch counter may move.

It also holds the MCMC samplers against the JAX package draw for draw: a
draw source replays the JAX key schedule (momenta, accept uniforms, the
NUTS direction, leaf and merge uniforms), and HMC (single chain and
chains, on a correlated 3-D Gaussian and on a 2-layer SGPMC DGP of width
2) and NUTS (the 3-D Gaussian) must take the same decisions and land on
the same positions; and the two chain diagnostics on fixed arrays.

And data and sample parallelism on gloo ranks (spawned CPU processes,
``tests/test_torch_ranks.py``): ``dp_elbo`` and ``sp_elbo`` on 2 ranks and
on a 2 x 2 mesh against the JAX package's ``shard_map`` functions, their
gradients against its single-device gradients (a replicated term counted
once), and the HMC and NUTS chains split over 2 ranks draw for draw."""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch
from numpy.testing import assert_allclose

from doubly_stochastic_dgp_tpu.ops.pallas.conditional import (
    fused_conditional as jax_fused_conditional, fused_conditional_reference,
    fused_conditional_saved as jax_fused_conditional_saved)
import doubly_stochastic_dgp_tpu as dsd
from doubly_stochastic_dgp_tpu.ops.pallas import psi2 as jpsi2
from doubly_stochastic_dgp_tpu.ops.pallas.gram import rbf_gram as jax_rbf_gram
from doubly_stochastic_dgp_tpu.utils import timing as jtiming
from doubly_stochastic_dgp_tpu.ops.pallas.psi2 import (
    _psi2_core_bwd_call, psi2_core as jax_psi2_core, psi2_core_pallas_fwd,
    psi2_core_reference)
from doubly_stochastic_dgp_tpu.config import temp_config
from doubly_stochastic_dgp_tpu.training import hmc as jhmc
from doubly_stochastic_dgp_tpu.training import nuts as jnuts
from doubly_stochastic_dgp_tpu.training.optim import (
    partition_trainable as jax_partition_trainable)
from doubly_stochastic_dgp_tpu.utils.modules import Module as JModule
from doubly_stochastic_dgp_tpu.utils.modules import Param as JParam
from doubly_stochastic_dgp_tpu.utils.modules import log_prior as jlog_prior
import doubly_stochastic_dgp_tpu_torch as port
from doubly_stochastic_dgp_tpu_torch.convert import _torch_key
from doubly_stochastic_dgp_tpu_torch.ops import psi_stats as tpsi_stats
from doubly_stochastic_dgp_tpu_torch.training import hmc as thmc
from doubly_stochastic_dgp_tpu_torch.training import nuts as tnuts
from doubly_stochastic_dgp_tpu_torch.utils.params import Param as TParam
from doubly_stochastic_dgp_tpu_torch.ops.cuda import gram as tgram
from doubly_stochastic_dgp_tpu_torch.ops.cuda import psi2 as tpsi2
from doubly_stochastic_dgp_tpu_torch.ops.cuda import conditional as tcond
from doubly_stochastic_dgp_tpu_torch.utils import timing as ttiming
from doubly_stochastic_dgp_tpu_torch.ops.cuda.conditional import (
    backward_plan, forward_plan, fused_conditional,
    fused_conditional_backward_plain, fused_conditional_plain,
    fused_conditional_saved, fused_conditional_saved_plain)

RTOL, ATOL = 1e-9, 1e-11     # as tests/test_pallas_conditional.py
# gradients: as the gradient tests of tests/test_pallas_conditional.py
GRAD_RTOL, GRAD_ATOL = 1e-7, 1e-9
GRAD_NAMES = ["dXs", "dZs", "dLiT", "dalpha", "dW", "dkvar", "dkdiag"]


def _inputs(B, M, Do, Dx=8, seed=0, identity_lit=False, clamp=False,
            spread=1.0):
    rng = np.random.RandomState(seed)
    Xs = rng.randn(B, Dx) * spread
    Zs = rng.randn(M, Dx) * spread
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
    # the MNIST DGP's layer widths (784 -> 30 -> 10), few rows; inputs
    # with std 1/sqrt(Dx), whose scaled distances are O(1)
    ("mnist_Dx784_Do30", dict(B=70, M=24, Do=30, Dx=784, seed=2,
                              spread=784 ** -0.5)),
    ("mnist_Dx30_Do10", dict(B=70, M=24, Do=10, Dx=30, seed=3,
                             spread=30 ** -0.5)),
]


# the gradient cases of tests/test_pallas_conditional.py: one tile, several
# tiles, and the variance clamp active (kdiag = -0.5)
GRAD_CASES = [
    ("grad_single_tile", dict(B=260, M=50, Do=3, Dx=5, seed=1), None),
    ("grad_multi_tile", dict(B=1100, M=40, Do=2, Dx=4, seed=5), None),
    ("grad_clamp_active", dict(B=200, M=30, Do=2, Dx=4, seed=3), -0.5),
    ("grad_mnist_Dx784_Do30", dict(B=60, M=20, Do=30, Dx=784, seed=6,
                                   spread=784 ** -0.5), None),
    ("grad_mnist_Dx30_Do10", dict(B=60, M=20, Do=10, Dx=30, seed=7,
                                  spread=30 ** -0.5), None),
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


# (B, M, Dx, Do) the kernels' launch plans are checked at: the training
# and serving shapes, M=512, M=1, a ragged M, Do=13, one row, and one row
# past a 40-row block (M=100) and past a 16-row reduction slice
PLAN_SHAPES = [(10000, 100, 8, 8), (100000, 100, 8, 8), (10000, 100, 8, 1),
               (513, 512, 3, 2), (513, 512, 3, 8), (300, 1, 4, 2),
               (1300, 37, 8, 3), (2000, 100, 8, 13), (1, 100, 8, 8),
               (41, 100, 8, 8), (17, 100, 8, 8),
               # the MNIST DGP's layers (minibatch 1000, S=1) and its
               # serving shape (1000 rows, S=100) at layer 0; layer 0 of
               # its output-dimension rank (Do=15); a ragged M with one
               # row past a 40-row block and Dx one past a chunk; one row
               (1000, 100, 784, 30), (1000, 100, 30, 30),
               (1000, 100, 30, 10), (100000, 100, 784, 30),
               (1000, 100, 784, 15), (41, 37, 785, 3), (1, 100, 784, 8),
               # the row kernels' cluster plan: the last B with clusters of
               # 4 at M=100 and the first with 2; the last with clusters
               # and the first without; rows past B in a cluster's row
               # block; Do not a multiple of the cluster; Do=1 (no
               # cluster); M=37 (clusters of 8 over 10 column groups)
               (2640, 100, 8, 8), (2641, 100, 8, 8), (5280, 100, 8, 8),
               (5281, 100, 8, 8), (1001, 100, 30, 30), (1000, 100, 30, 13),
               (1000, 100, 30, 1), (1000, 37, 30, 30)]
SCRATCH_MAX = 8_000_000   # bytes of the backward's slice partials
# (nslices, rows_per_slice) of the backward's reduction at each plan shape,
# as the kernels were built with them when dZ and dX were one thread an
# output: they fix the order of dW's, dLiT's, dalpha's and dZ's sums (one
# chain a slice, the slices added in order), so they may not drift
SLICES = {(10000, 100, 8, 8): (21, 480), (100000, 100, 8, 8): (21, 4768),
          (10000, 100, 8, 1): (95, 112), (513, 512, 3, 2): (2, 272),
          (513, 512, 3, 8): (1, 528), (300, 1, 4, 2): (88, 16),
          (1300, 37, 8, 3): (66, 32), (2000, 100, 8, 13): (14, 144),
          (1, 100, 8, 8): (21, 16), (41, 100, 8, 8): (21, 16),
          (17, 100, 8, 8): (21, 16), (1000, 100, 784, 30): (5, 208),
          (1000, 100, 30, 30): (6, 176), (1000, 100, 30, 10): (17, 64),
          (100000, 100, 784, 30): (5, 20000), (1000, 100, 784, 15): (8, 128),
          (41, 37, 785, 3): (57, 16), (1, 100, 784, 8): (11, 16),
          (2640, 100, 8, 8): (21, 128), (2641, 100, 8, 8): (21, 128),
          (5280, 100, 8, 8): (21, 256), (5281, 100, 8, 8): (21, 256),
          (1001, 100, 30, 30): (6, 176), (1000, 100, 30, 13): (13, 80),
          (1000, 100, 30, 1): (86, 16), (1000, 37, 30, 30): (8, 128)}
# (B, M, Do): the row kernels' plans that stay one block of 40 rows a row
# block, no cluster, as before clusters: the headline's training layer and
# its serving shape, Do=1, and the MNIST DGP's serving shape at layer 0
ROW_PLANS_KEPT = [(10000, 100, 8), (100000, 100, 8), (10000, 100, 1),
                  (100000, 100, 30)]


def _covered_once(n, starts, width):
    """Rows 0 .. n-1 each lie in exactly one of the row ranges
    [start, start + width)."""
    hits = np.zeros(n, dtype=int)
    for s in starts:
        hits[s:s + width] += 1
    return bool((hits == 1).all())


def _tiles_once(case, what, origins, tile, extent, groups, fast, threads):
    """A tiled pass writes each of its outputs once: the blocks' tile
    origins ((blocks, 2) array, per slice) are distinct and cover the
    (rows, cols) ``extent`` with tiles of ``tile`` (no empty tile), and the
    active threads of a block (t < groups[0] x groups[1], a 4 x 4 tile at
    group (t // g1, t % g1), or (t % g0, t // g0) when ``fast`` == 0) cover
    a tile once; the kernel writes an entry only below the extent."""
    th, tw = tile
    assert th == 4 * groups[0] and tw == 4 * groups[1], f"{case}: {what}"
    assert groups[0] * groups[1] <= threads, (
        f"{case}: {what}: {groups} groups for {threads} threads")
    grid = (-(-extent[0] // th), -(-extent[1] // tw))
    assert len(origins) == grid[0] * grid[1], (
        f"{case}: {what}: {len(origins)} blocks for a {grid} grid")
    o = np.asarray(origins)
    assert (o[:, 0] % th == 0).all() and (o[:, 1] % tw == 0).all() and (
        o[:, 0] < extent[0]).all() and (o[:, 1] < extent[1]).all(), (
        f"{case}: {what}: a tile origin off the grid")
    cells = np.zeros(grid, dtype=int)
    np.add.at(cells, (o[:, 0] // th, o[:, 1] // tw), 1)
    assert (cells == 1).all(), f"{case}: {what}: a tile not written once"
    hits = np.zeros(tile, dtype=int)
    g0, g1 = groups
    for t in range(threads):
        if t >= g0 * g1:
            continue
        r, c = ((t // g1, t % g1) if fast else (t % g0, t // g0))
        hits[4 * r:4 * r + 4, 4 * c:4 * c + 4] += 1
    assert (hits == 1).all(), f"{case}: {what}: threads overlap in a tile"


def _check_reduction_jobs(case, bp, B, M, Dx, Do):
    """The reduction launch's jobs, by the kernel's decoding of its block
    index (``ReduceJobs`` and ``fused_conditional_bwd_reduce_kernel``),
    replayed: the product tiles of every slice, then dZ's and dalpha's
    column-sum tiles of every slice, then dX's tiles.  Every entry of dW,
    dLiT, dalpha and dZ written once a slice, by one block and one thread
    tile of it; every dX entry once (or, ``dx_in_rows``, by the row pass);
    the grid within 2^31 - 1 blocks."""
    ns_, T, nthreads = bp["nslices"], bp["tile"], bp["reduce_threads"]
    nt = -(-M // T)
    big = (Do + 1) * nt * nt
    sg, zg, ag = bp["sum_groups"], bp["dz_groups"], bp["dalpha_groups"]
    nmt = -(-M // (4 * sg))
    nz, na = nmt * -(-Dx // (4 * zg)), nmt * -(-Do // (4 * ag))
    xrg, xjg = bp["dx_row_groups"], bp["dx_col_groups"]
    assert bp["dx_in_rows"] == (xrg == 0) and (xrg == 0) == (xjg == 0), (
        f"{case}: dX groups {xrg}, {xjg}")
    nx = -(-B // (4 * xrg)) * -(-Dx // (4 * xjg)) if xrg else 0
    blocks = ns_ * (big + nz + na) + nx
    assert bp["reduce_blocks"] == blocks and blocks <= 2 ** 31 - 1, (
        f"{case}: reduce blocks {bp['reduce_blocks']}, replayed {blocks}")
    assert (bp["product_blocks"], bp["dz_blocks"], bp["dalpha_blocks"],
            bp["dx_blocks"]) == (ns_ * big, ns_ * nz, ns_ * na, nx), (
        f"{case}: job counts")
    b = np.arange(blocks, dtype=np.int64)
    kind = np.select([b < ns_ * big, b < ns_ * (big + nz),
                      b < ns_ * (big + nz + na)], [0, 1, 2], 3)
    # product tiles: per slice, (Do + 1) tiles of ceil(M / T)^2; in a tile,
    # thread t owns rows (t % (T / 8)) * 8 and columns (t // (T / 8)) * 8
    hits = np.zeros((Do + 1, nt * T, nt * T), dtype=int)
    tg = T // 8
    for job in range(big):
        q, tile = divmod(job, nt * nt)
        m0, n0 = (tile // nt) * T, (tile % nt) * T
        for t in range(tg * tg):
            r0, c0 = m0 + (t % tg) * 8, n0 + (t // tg) * 8
            hits[q, r0:r0 + 8, c0:c0 + 8] += 1
    slices = b[kind == 0] // big
    assert (hits[:, :M, :M] == 1).all() and (
        np.bincount(slices, minlength=ns_) == big).all(), (
        f"{case}: a dW or dLiT entry not written once a slice")
    # column sums: per slice, job = m-tile + nmt x column tile, 4 sg
    # inducing points by 4 g columns; thread t at (t % sg, t // sg)
    for k, (what, g, W, n) in enumerate((("dZ", zg, Dx, nz),
                                         ("dalpha", ag, Do, na)), 1):
        rel = b[kind == k] - ns_ * (big + (nz if k == 2 else 0))
        sl, job = rel // n, rel % n
        for s_ in range(ns_):
            j_ = job[sl == s_]
            origins = np.stack([(j_ % nmt) * 4 * sg, (j_ // nmt) * 4 * g], 1)
            _tiles_once(f"{case} slice {s_}", what, origins,
                        (4 * sg, 4 * g), (M, W), (sg, g), 0, nthreads)
    if xrg:
        rel = b[kind == 3] - ns_ * (big + nz + na)
        ncol = -(-Dx // (4 * xjg))
        origins = np.stack([(rel // ncol) * 4 * xrg, (rel % ncol) * 4 * xjg],
                           1)
        _tiles_once(case, "dX", origins, (4 * xrg, 4 * xjg), (B, Dx),
                    (xrg, xjg), 1, nthreads)


def _check_row_plan(case, plan, B, M, Do, backward):
    """A row kernel's plan, by the kernel's decoding of its block and
    thread indices (``split_of``, ``gram_tiles``, the products' tiles and,
    in the backward, the rounds and the fold), replayed: every row in one
    cluster (or block); every (row, d) of the variance products formed by
    one block; every column of K, G, dG and dK by one block of its cluster
    and one thread tile of it (the gram's R x 4 tiles in one pass of 256
    threads); in the backward, the rounds' T_d made once each and folded in
    d order 0 .. Do - 1."""
    tb, cs, R = plan["tb"], plan["cluster"], plan["gram_rows"]
    cg = -(-M // 4)
    rows = -(-B // tb)
    blocks = plan["row_blocks"] if backward else plan["blocks"]
    assert blocks == rows * cs and blocks <= 2 ** 31 - 1, (
        f"{case}: {blocks} blocks for {rows} row blocks of {cs}")
    assert 1 <= cs <= tcond.MAX_CLUSTER and cs <= min(Do, cg) and (
        tb == _row_rows(M)), f"{case}: plan {plan}"
    assert _covered_once(B, range(0, rows * tb, tb), tb) and (
        (rows - 1) * tb < B), f"{case}: a row not in exactly one cluster"
    bounds = [(q * cg // cs, (q + 1) * cg // cs) for q in range(cs)]
    ncg = max(g1 - g0 for g0, g1 in bounds)
    assert plan["col_groups"] == ncg == -(-cg // cs) and all(
        g1 > g0 for g0, g1 in bounds), f"{case}: column groups {bounds}"
    fewest = min([r for r in (1, 2) if (tb // r) * ncg <= 256] or [4])
    assert R == (fewest if cs > 1 else 4) and (tb // R) * ncg <= 256, (
        f"{case}: gram tile rows {R}, one pass takes {fewest}")
    cols = np.zeros(4 * cg, dtype=int)
    for g0, g1 in bounds:
        n = g1 - g0
        cols[4 * g0:4 * g1] += 1
        # the gram: R x 4 tiles, rows R (t // n), columns 4 g0 + t % n + n j
        gram = np.zeros((tb, 4 * n), dtype=int)
        for t in range((tb // R) * n):
            for j in range(4):
                gram[R * (t // n):R * (t // n) + R, t % n + n * j] += 1
        # G and dK: 4 x 4 tiles packed into the first threads, row group
        # t // n, columns 4 (g0 + t % n) ..
        prod = np.zeros((tb, 4 * n), dtype=int)
        for t in range((tb // 4) * n):
            prod[4 * (t // n):4 * (t // n) + 4,
                 4 * (t % n):4 * (t % n) + 4] += 1
        # the backward's fold: 4 rows of one column a step
        fold = np.zeros((tb, 4 * n), dtype=int)
        for e in range((tb // 4) * 4 * n):
            fold[4 * (e // (4 * n)):4 * (e // (4 * n)) + 4, e % (4 * n)] += 1
        assert (gram == 1).all() and (prod == 1).all() and (fold == 1).all(), (
            f"{case}: a column of K, G, dG or dK not written once by one "
            f"thread tile of the block owning columns {4 * g0}..")
    assert (cols == 1).all(), f"{case}: a column not owned by one block"
    # the variance products: block q at d = q, q + cs, ...; every (row, d)
    # of a row block once
    hits = np.zeros(Do, dtype=int)
    for q in range(cs):
        nd = -(-(Do - q) // cs)
        assert nd >= 1, f"{case}: block {q} has no d"
        hits[[q + cs * k for k in range(nd)]] += 1
    assert (hits == 1).all(), f"{case}: a variance product not formed once"
    if backward:
        rounds = plan["rounds"]
        assert rounds == -(-Do // cs), f"{case}: {rounds} rounds"
        made = [j * cs + q for j in range(rounds) for q in range(cs)
                if j * cs + q < Do]
        folded = [j * cs + r for j in range(rounds) for r in range(cs)
                  if j * cs + r < Do]
        assert made == sorted(made) and folded == list(range(Do)), (
            f"{case}: the rounds' T_d {made}, folded in the order {folded}")


def _row_rows(M):
    """Rows a block of the row kernels without a cluster (256 threads of
    4 x 4 tiles, at most 32 row groups)."""
    return 4 * min(256 // -(-M // 4), 32)


def _check_plans():
    """The launch plans of the forward and backward kernels (plain Python,
    handed to the kernels): every row in one row-pass block and one
    reduction slice; every output entry of dW, dLiT, dalpha, dZ and dX
    written once (a slice), by one reduction block and one thread tile of
    it (the kernel's decoding of its block and thread indices, replayed),
    with dX formed by the row pass at narrow Dx and by the reduction's
    tiles above it, both plans replayed at every shape; the slices as they
    were (SLICES); shared memory within a block's 227 KB; the backward's
    slice-partial scratch within 8 MB and independent of B."""
    for B, M, Do in ROW_PLANS_KEPT:
        fp = forward_plan(B, M, 8, Do)
        assert (fp["tb"], fp["cluster"], fp["blocks"]) == (40, 1, B // 40), (
            f"forward plan B={B} M={M} Do={Do}: {fp}")
        for saved in (False, True):
            bp = backward_plan(B, M, 8, Do, saved=saved)
            assert (bp["tb"], bp["cluster"], bp["row_blocks"]) == (
                40, 1, B // 40), f"backward plan B={B} M={M} Do={Do}: {bp}"
    for B, M, Dx, Do in PLAN_SHAPES:
        case = f"plan B={B} M={M} Dx={Dx} Do={Do}"
        fp = forward_plan(B, M, Dx, Do)
        bp = backward_plan(B, M, Dx, Do)
        P, P4 = -(-M // 8) * 8, -(-M // 4) * 4
        tb = fp["tb"]
        # 4 x 4 register tiles: tb / 4 row groups x P4 / 4 column groups,
        # one a thread of 256
        assert tb == bp["tb"] == _row_rows(M) and (
            fp["busy_threads"] == (tb // 4) * (P4 // 4) <= 256), (
            f"{case}: {tb} rows, {fp['busy_threads']} threads")
        # a cluster where one block a row block leaves SMs idle: the most
        # blocks, a power of two, that keep two blocks an SM of 132 or
        # fewer, at most 8, Do and the column groups; the backward's the
        # same where its shared memory fits (the rule's own replay)
        rows = -(-B // tb)
        want = max([1] + [c for c in (2, 4, 8)
                          if c <= min(Do, P4 // 4) and rows * c <= 264])
        # then halved while a block past one an SM has under 3 products
        while want > 1 and rows * want > 132 and (
                -(-Do // want) + Dx / (64 * want) < 3):
            want //= 2
        assert fp["cluster"] == want and bp["cluster"] in (
            want, 1), f"{case}: clusters {fp['cluster']}, " \
            f"{bp['cluster']} (rule {want})"
        if bp["cluster"] < want:
            assert tcond._rows_smem(M, Do, 2) > tcond.SMEM_MAX, (
                f"{case}: a cluster fits")
        _check_row_plan(case + " forward", fp, B, M, Do, False)
        for saved in (False, True):
            _check_row_plan(case + f" backward saved={saved}",
                            backward_plan(B, M, Dx, Do, saved=saved), B, M,
                            Do, True)
        assert (bp["nslices"], bp["rows_per_slice"]) == SLICES[
            (B, M, Dx, Do)], (f"{case}: slices {bp['nslices']} of "
                              f"{bp['rows_per_slice']} rows")
        assert bp["dx_in_rows"] == (Dx <= tcond.DX_IN_ROWS_MAX), (
            f"{case}: dX in the row pass {bp['dx_in_rows']}")
        for limit in (Dx, Dx - 1):   # dX in the row pass, then on tiles
            with mock.patch.object(tcond, "DX_IN_ROWS_MAX", limit):
                plan = backward_plan(B, M, Dx, Do)
            assert all(plan[k] == bp[k] for k in bp if not k.startswith(
                ("dx_", "reduce_"))), f"{case}: dX's form moved another job"
            _check_reduction_jobs(
                f"{case} dx_in_rows={plan['dx_in_rows']}", plan, B, M, Dx,
                Do)
            assert plan["reduce_smem_bytes"] <= tcond.SMEM_MAX, (
                f"{case}: reduction smem {plan['reduce_smem_bytes']}")
        for name, smem in (("forward", fp["smem_bytes"]),
                           ("backward row pass", bp["smem_bytes"]),
                           ("reduction", bp["reduce_smem_bytes"])):
            assert smem <= tcond.SMEM_MAX, f"{case}: {name} smem {smem}"
        rps, ns_ = bp["rows_per_slice"], bp["nslices"]
        assert rps % 16 == 0 and _covered_once(
            B, range(0, ns_ * rps, rps), rps), (
            f"{case}: reduction: a row not in exactly one slice")
        T, rthreads = bp["tile"], bp["reduce_threads"]
        assert T % 8 == 0 and T == min(P, 128), f"{case}: tile {T}"
        assert rthreads % 32 == 0 and (
            rthreads - 32 < (T // 8) ** 2 <= rthreads <= 256), (
            f"{case}: {rthreads} threads for {(T // 8) ** 2} tiles")
        E = Do * M * M + M * M + M * Do + M * Dx
        assert bp["out_floats"] == E, f"{case}: output floats"
        assert bp["scratch_floats"] == (ns_ * E if ns_ > 1 else 0), (
            f"{case}: scratch floats")
        assert 4 * bp["scratch_floats"] <= SCRATCH_MAX, (
            f"{case}: scratch {4 * bp['scratch_floats']} bytes > 8 MB")
        for other in (1, 7 * B, 1000 * B):
            assert backward_plan(other, M, Dx, Do)["scratch_floats"] == bp[
                "scratch_floats"], f"{case}: scratch depends on B ({other})"
        assert bp["panel_floats"] == 4 * B * P4, f"{case}: row panels"
        # the gram stage's ring (two chunks of 16 d, rows padded to 20
        # floats) lies over the product ring: at M=100 no byte is added
        stage = 4 * 2 * (tb + P4) * 20
        assert stage == 4 * tcond.gram_stage_floats(tb, M) and stage <= (
            fp["smem_bytes"] - 4 * (-(-M // 16) * 16) * tb), (
            f"{case}: the gram stage's ring does not fit the forward's")
        if M == 100:
            # a cluster adds the row pass's two T buffers (2 x 40 x 100)
            assert (fp["smem_bytes"], bp["smem_bytes"]) == (
                51520, 4 * (2 * 112 * 40 + 6400 + 80 * Do + (
                    8000 if bp["cluster"] > 1 else 0))), (
                f"{case}: shared memory {fp['smem_bytes']}, "
                f"{bp['smem_bytes']}")
            # two blocks an SM (228 KB, 1 KB of each reserved)
            assert 2 * (max(fp["smem_bytes"], bp["smem_bytes"]) + 1024) <= (
                233472), f"{case}: two blocks an SM do not fit"
            # the column sums' and dX's rings (plan: dX on tiles) fit the
            # product tiles' (53.5 KB): the reduction keeps its blocks an SM
            assert plan["reduce_smem_bytes"] == 4 * 4 * (2 * 16 * 104 + 16), (
                f"{case}: reduction smem")
        assert backward_plan(B, M, Dx, Do, saved=True)["panel_floats"] == (
            3 * B * P4), f"{case}: saved variant's row panels"
    try:
        backward_plan(100, 512, 3, 4000)
    except ValueError:
        pass
    else:
        raise AssertionError("backward_plan: M=512, Do=4000 does not fit a "
                             "block's shared memory and must raise")


def _counts():
    return (fused_conditional.launches, fused_conditional.backward_launches,
            fused_conditional_saved.launches,
            fused_conditional_saved.backward_launches,
            tpsi2.psi2_core.launches, tpsi2.psi2_core.backward_launches,
            tgram.rbf_gram.launches)


def _psi2_inputs(N, M, D, seed=0, spread=0.5, clamp=False):
    """The cases of tests/test_pallas_psi2.py, in float64; ``clamp``
    shifts U up so that min(pre, 0) is active for part of the terms."""
    rng = np.random.RandomState(seed)
    U = rng.randn(N, M) * spread - 0.2 + (1.0 if clamp else 0.0)
    V = rng.randn(N, M) * spread - 0.2
    return (U, V, rng.rand(N, D), rng.randn(N, 1) * 0.3,
            rng.randn(M, D) * 0.5)


# ragged N (not a multiple of the kernel's 32-row step), M not a multiple
# of its 64-wide tile, D above the register-held range, the clamp active
PSI2_CASES = [
    ("N130_M9_D1", dict(N=130, M=9, D=1)),
    ("N301_M100_D2", dict(N=301, M=100, D=2, seed=1)),
    ("N70_M66_D12", dict(N=70, M=66, D=12, seed=2)),
    ("clamp_active", dict(N=90, M=37, D=2, seed=3, clamp=True)),
]
PSI2_GRAD_CASES = ("N70_M66_D12", "clamp_active")


def _check_psi2_limits():
    """The kernel's operand checks, which the wrapper makes before every
    launch (no fallback): M > 512, D outside 1..32, a non-float32 or a
    non-contiguous operand raise; N is not limited."""
    def args(N=40, M=8, D=2, dtype=torch.float32):
        return [torch.zeros(shape, dtype=dtype) for shape in
                ((N, M), (N, M), (N, D), (N, 1), (M, D))]

    assert tpsi2._check(*args(N=10 ** 5)) == (10 ** 5, 8, 2), "large N"
    g = torch.zeros(8, 8)
    assert tpsi2._check(*args(), g) == (40, 8, 2), "with a cotangent"
    bad = args()
    bad[1] = torch.zeros(8, 40).T
    for case, a, err in (("M=513", args(M=tpsi2.MAX_M + 1), ValueError),
                         ("D=33", args(D=tpsi2.MAX_D + 1), ValueError),
                         ("D=0", args(D=0), ValueError),
                         ("float64", args(dtype=torch.float64), TypeError),
                         ("non-contiguous V", bad, ValueError),
                         ("g of another shape", args() + [g[:, :7]],
                          ValueError),
                         ("non-contiguous g", args() + [torch.zeros(
                             8, 16)[:, ::2]], ValueError),
                         ("float64 g", args() + [g.double()], TypeError)):
        try:
            tpsi2._check(*a)
        except err:
            continue
        raise AssertionError(f"psi2_core kernel checks: {case} did not "
                             f"raise {err.__name__}")


def _rbf_staging(N, M, D, seed):
    """The float64 (U, V, w, logdet, Z) and the symmetric flag that a
    single RBF's psi statistics hand psi2_core on the CPU (captured)."""
    rng = np.random.RandomState(seed)
    mu, Sv, Z = rng.randn(N, D) + 2.0, np.exp(rng.randn(N, D)) * 0.2, (
        rng.randn(M, D) + 2.0)
    kern = port.RBF(D, lengthscales=rng.uniform(0.7, 1.5, D)).double()
    got, inner = [], tpsi_stats.psi2_core

    def record(*args, symmetric=False):
        got.append(([a.detach().numpy().copy() for a in args], symmetric))
        return inner(*args, symmetric=symmetric)

    tpsi_stats.psi2_core = record
    try:
        tpsi_stats.psi_statistics(kern, *(torch.from_numpy(a) for a in
                                           (mu, Sv, Z)), "auto")
    finally:
        tpsi_stats.psi2_core = inner
    assert len(got) == 1, f"psi_statistics called psi2_core {len(got)} times"
    return got[0]


def _fma32(a, b, c):
    """fmaf: the float32 product is exact in float64, the sum is rounded
    to float64 and then to float32 (a double rounding, which differs from
    one rounding only at rare ties)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _kahan32(total, comp, x):
    y = x - comp
    t = total + y
    return t, (t - total) - y


def _kernel_forward_f32(U, V, w, logdet, Z, symmetric):
    """csrc/psi2.cu's forward emulated in float32, step for step, on
    forward_plan's plan: pre = U + V, then fmaf(-(w Z[a,d]), Z[b,d], pre)
    for d ascending; 2^fmaf(min(pre, 0), L, logdet L) with L = log2(e)
    rounded to float32 (the kernel's ex2.approx is within 2 ulp of it);
    each row group's rows added in their order into a register sum, which
    goes into a Kahan total every 4 steps; then the row groups' totals
    and the chunks' in order (Kahan); the upper triangle mirrored when
    ``symmetric``."""
    f32 = np.float32
    U, V, w, logdet, Z = (np.asarray(a, f32) for a in (U, V, w, logdet, Z))
    N, M = U.shape
    L = f32(1.4426950408889634)
    pre = U[:, :, None] + V[:, None, :]
    for d in range(Z.shape[1]):
        wz = w[:, d:d + 1] * Z[None, :, d]
        pre = _fma32(-wz[:, :, None], Z[None, None, :, d], pre)
    x = _fma32(np.minimum(pre, f32(0)), L, (logdet * L)[:, :, None])
    e = np.exp2(x.astype(np.float64)).astype(f32)
    p = tpsi2.forward_plan(N, M, Z.shape[1], symmetric=symmetric)
    R, S, rc = p["row_groups"], p["rows_per_step"], p["rows_per_chunk"]
    zero = np.zeros((M, M), f32)
    out, out_c = zero, zero
    for c in range(p["chunks"]):
        n0, n1 = c * rc, min(N, (c + 1) * rc)
        v, v_c = zero, zero
        for rg in range(R):
            part, part_c, reg = zero, zero, zero
            for s, s0 in enumerate(range(n0, n1, S)):
                for q in range(8):
                    if s0 + rg + R * q < min(n1, s0 + S):
                        reg = reg + e[s0 + rg + R * q]
                if s % 4 == 3:
                    part, part_c = _kahan32(part, part_c, reg)
                    reg = zero
            part, part_c = _kahan32(part, part_c, reg)
            v, v_c = _kahan32(v, v_c, part)
        out, out_c = _kahan32(out, out_c, v)
    return np.triu(out) + np.triu(out, 1).T if symmetric else out


def _check_kernel_arithmetic(case, args, symmetric):
    """The emulated kernel (float32) against the float64 JAX reference,
    by phase 10's gates: within 2x the plain float32 version's error, and
    within 1e-4 of the output scale of the plain float32 version.  On
    these operands it fails for a serial float32 sum in place of the
    Kahan sums, or an exp argument off by 1e-4 of itself; not for folding
    log2(e) and logdet into U, which only collapsed_L2's operands on the
    card (phase 10) show."""
    ref = np.asarray(psi2_core_reference(*map(jnp.asarray, args)))
    scale = max(np.abs(ref).max(), 1.0)
    got = _kernel_forward_f32(*args, symmetric)
    plain = tpsi2.psi2_core_plain(
        *(torch.from_numpy(a).float() for a in args),
        symmetric=symmetric).double().numpy()
    e_k = np.abs(got - ref).max() / scale
    e_p = np.abs(plain - ref).max() / scale
    assert e_k <= 2 * e_p and np.abs(got - plain).max() <= 1e-4 * scale, (
        f"{case}: the kernel's float32 arithmetic {e_k:.3e} of scale from "
        f"float64, the plain float32 version {e_p:.3e}")


def _check_psi2_symmetric():
    """A single RBF's staging (captured from psi_statistics): the call says
    symmetric=True; psi2_core_plain, the forward wrapper and the Function
    with symmetric=True on the CPU against the JAX reference and the
    interpret-mode Pallas forward, exactly symmetric; and the kernel's
    float32 arithmetic, emulated, against the reference on it (symmetric)
    and on PSI2_CASES (general)."""
    for N, M, D, seed in ((57, 13, 3, 31), (90, 21, 2, 32)):
        case = f"psi2 symmetric RBF staging N={N} M={M} D={D}"
        args, symmetric = _rbf_staging(N, M, D, seed)
        assert symmetric is True, f"{case}: the call is not symmetric"
        jargs = [jnp.asarray(a) for a in args]
        targs = [torch.from_numpy(a) for a in args]
        refs = {"psi2_core_reference": psi2_core_reference(*jargs),
                "interpret-mode Pallas forward":
                    psi2_core_pallas_fwd(*jargs, True)}
        ports = {"plain": tpsi2.psi2_core_plain(*targs, symmetric=True),
                 "forward wrapper on CPU":
                     tpsi2.psi2_core_forward(*targs, symmetric=True),
                 "autograd Function on CPU":
                     tpsi2.psi2_core(*targs, symmetric=True)}
        for pname, got in ports.items():
            got = got.numpy()
            assert (got == got.T).all(), f"{case}: {pname} not symmetric"
            for rname, want in refs.items():
                assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                                err_msg=f"{case}: {pname} vs {rname}")
        _check_kernel_arithmetic(case, args, True)
    for name, kw in PSI2_CASES:
        _check_kernel_arithmetic(f"psi2 {name}", _psi2_inputs(**kw), False)


# (N, M, D) the psi2 forward's launch plan is checked at: both cells'
# shapes, M = 1, one past a 64 tile, one row, one past a 32-row step, the
# ragged, D = 12, M = 512 and clamp cases of phase 10, D = 32, N far
# beyond one wave
PSI2_FWD_PLAN_SHAPES = [(7372, 256, 2), (1500, 100, 8), (1500, 1, 8),
                        (1500, 65, 2), (1, 100, 8), (33, 100, 8),
                        (1301, 100, 3), (500, 64, 12), (2000, 512, 2),
                        (300, 37, 2), (2000, 512, 32), (10 ** 6, 256, 2)]


def _check_psi2_forward_plan():
    """The psi2 forward's launch plan (plain Python, handed to the
    kernel), symmetric and general, with the kernel's decoding replayed:
    every (a, b) with a <= b (symmetric) or every (a, b) (general) in
    exactly one micro-tile of one group, inside the box the group stages,
    and the ring sized for the widest box; every row in exactly one chunk,
    step and row group; shared memory and threads within the kernel's
    limits; the scratch independent of N."""
    for (N, M, D), sym in [(s, y) for s in PSI2_FWD_PLAN_SHAPES
                           for y in (True, False)]:
        case = f"psi2 forward plan N={N} M={M} D={D} symmetric={sym}"
        p = tpsi2.forward_plan(N, M, D, symmetric=sym)
        P = -(-M // 4)
        T = P * (P + 1) // 2 if sym else P * P
        wt, R, kr = p["wt"], p["row_groups"], 8
        TL, S = 32 * wt, p["rows_per_step"]
        assert p["tiles"] == T and S == R * kr and (
            p["threads"] == TL * R <= 512) and (
            (p["groups"] - 1) * TL < T <= p["groups"] * TL), (
            f"{case}: {p}")
        hits = np.zeros((4 * P, 4 * P), dtype=int)
        widest = 0
        for g in range(p["groups"]):
            a_lo, na, b_lo, nb = tpsi2._group_box(g, TL, T, P, sym)
            widest = max(widest, 4 * (na + nb))
            for k in range(g * TL, min(T, (g + 1) * TL)):
                i, j = tpsi2._decode(k, P, sym)
                assert a_lo <= i < a_lo + na and b_lo <= j < b_lo + nb, (
                    f"{case}: micro-tile {(i, j)} outside group {g}'s box")
                for ii in range(4):
                    for jj in range(4):
                        a, b = 4 * i + ii, 4 * j + jj
                        if not sym or a <= b:
                            hits[a, b] += 1
        want = np.triu(np.ones((M, M), dtype=int)) if sym else 1
        assert (hits[:M, :M] == want).all(), (
            f"{case}: an (a, b) not in exactly one micro-tile")
        rc, chunks = p["rows_per_chunk"], p["chunks"]
        assert (chunks - 1) * rc < N <= chunks * rc and (
            p["blocks"] == p["groups"] * chunks), f"{case}: {chunks} x {rc}"
        if N <= 10 ** 4:
            rows = np.zeros(N, dtype=int)
            for c in range(chunks):
                n0, n1 = c * rc, min(N, (c + 1) * rc)
                for s0 in range(n0, n1, S):
                    for rg in range(R):
                        for q in range(kr):
                            if s0 + rg + R * q < min(n1, s0 + S):
                                rows[s0 + rg + R * q] += 1
            assert (rows == 1).all(), f"{case}: a row not taken once"
        assert p["box"] == widest and p["stages"] in (2, 3) and (
            p["smem_bytes"] == 4 * tpsi2._fwd_smem_floats(
                M, D, R, widest, p["threads"], p["stages"]) <= 200 * 1024), (
            f"{case}: box {p['box']}, smem")
        assert p["scratch_floats"] == (
            chunks * p["groups"] * 512 * wt + p["groups"]
            if chunks > 1 else 0) and (
            chunks * wt <= 96 and chunks <= 16), f"{case}: scratch"
        most = tpsi2.forward_plan(10 ** 8, M, D, symmetric=sym)[
            "scratch_floats"]
        for other in (N, 1000 * N, 10 ** 7):
            q = tpsi2.forward_plan(other, M, D, symmetric=sym)
            assert q["scratch_floats"] <= min(
                most, (512 * 96 + 1) * q["groups"]), (
                f"{case}: scratch at N={other} above the bound")
            assert other < 10 ** 6 or q["scratch_floats"] == most, (
                f"{case}: scratch depends on N ({other})")


def _check_psi2():
    """psi2_core_plain, the forward wrapper and the autograd Function on
    the CPU against the JAX reference, the interpret-mode Pallas forward
    and the JAX psi2_core; the Function's CPU gradient against jax.grad
    of the reference (for the cases named in PSI2_GRAD_CASES); the plain
    version's row blocking (shrunk so that a small N spans several
    blocks)."""
    for name, kw in PSI2_CASES:
        args = _psi2_inputs(**kw)
        jargs = [jnp.asarray(a) for a in args]
        targs = [torch.from_numpy(a) for a in args]
        refs = {"psi2_core_reference": psi2_core_reference(*jargs),
                "interpret-mode Pallas forward":
                    psi2_core_pallas_fwd(*jargs, True),
                "JAX psi2_core": jax_psi2_core(*jargs, True)}
        leaves = [t.clone().requires_grad_() for t in targs]
        ports = {"plain": tpsi2.psi2_core_plain(*targs),
                 "forward wrapper on CPU": tpsi2.psi2_core_forward(*targs),
                 "autograd Function on CPU": tpsi2.psi2_core(*leaves)}
        blocked = tpsi2._block_rows
        tpsi2._block_rows = lambda M: 16
        try:
            ports["plain, 16-row blocks"] = tpsi2.psi2_core_plain(*targs)
        finally:
            tpsi2._block_rows = blocked
        pre = (args[0][:, :, None] + args[1][:, None, :]
               - np.einsum("nd,ad,bd->nab", args[2], args[4], args[4]))
        if kw.get("clamp"):
            assert (pre > 0).any() and (pre < 0).any(), (
                f"psi2 {name}: the clamp is not active")
        for pname, got in ports.items():
            assert got.dtype == torch.float64, f"psi2 {name}: {pname} dtype"
            for rname, want in refs.items():
                assert_allclose(got.detach().numpy(), np.asarray(want),
                                rtol=RTOL, atol=ATOL,
                                err_msg=f"psi2 {name}: {pname} vs {rname}")
        if name not in PSI2_GRAD_CASES:
            continue
        g = np.random.RandomState(kw.get("seed", 0) + 9).randn(
            kw["M"], kw["M"])
        ports["autograd Function on CPU"].backward(torch.from_numpy(g))
        want = jax.grad(lambda *a: jnp.sum(g * psi2_core_reference(*a)),
                        argnums=(0, 1, 2, 3, 4))(*jargs)
        for t, w, what in zip(leaves, want, ("U", "V", "w", "logdet", "Z")):
            assert_allclose(t.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                            atol=GRAD_ATOL,
                            err_msg=f"psi2 {name}: grad {what} vs jax.grad "
                                    f"of psi2_core_reference")


# the backward's cases: those of tests/test_pallas_psi2.py (N=41, M=12,
# D=2; a ragged N over several 16-row blocks; D=12; every term clamped),
# and exact ties pre == 0 on part of the terms
PSI2_BWD_CASES = ("N41_M12_D2", "ragged_blocks_N70_M9_D3", "N50_M20_D12",
                  "fully_clamped", "exact_tie")
PSI2_BWD_SCALE_TOL = 1e-9   # of each gradient tensor's scale, float64
GRADS = ("gU", "gV", "gw", "glogdet", "gZ")


def _psi2_bwd_inputs(case):
    if case == "fully_clamped":
        N, M, D = 16, 6, 2
        Z = np.random.RandomState(3).randn(M, D)
        return (np.full((N, M), 3.0), np.full((N, M), 2.0), np.zeros((N, D)),
                np.full((N, 1), -0.5), Z), np.ones((M, M))
    if case == "exact_tie":
        # rows 0-9: U = V = 0 and w = 0, so pre == 0 exactly
        args = [a.copy() for a in _psi2_inputs(24, 7, 2, seed=5)]
        for a in args[:3]:
            a[:10] = 0.0
    else:
        N, M, D = {"N41_M12_D2": (41, 12, 2),
                   "ragged_blocks_N70_M9_D3": (70, 9, 3),
                   "N50_M20_D12": (50, 20, 12)}[case]
        args = _psi2_inputs(N, M, D, seed=len(case))
    M = args[4].shape[0]
    return tuple(args), np.random.RandomState(7).randn(M, M)


def _check_psi2_backward():
    """psi2_core_backward_plain, the backward wrapper and the Function's
    gradient on the CPU against both interpret-mode Pallas backward kernels
    and (two cases) jax.grad of the JAX psi2_core, which takes the kernel
    backward; the plain backward's row blocking."""
    for case in PSI2_BWD_CASES:
        args, g = _psi2_bwd_inputs(case)
        jargs = [jnp.asarray(a) for a in args]
        targs = [torch.from_numpy(a) for a in args]
        tg = torch.from_numpy(g)
        blocks = (jpsi2._block_rows, tpsi2._block_rows)
        if case.startswith("ragged"):
            jpsi2._block_rows = tpsi2._block_rows = lambda M: 16
        try:
            refs = {f"interpret-mode Pallas backward ({impl})":
                    _psi2_core_bwd_call(*jargs, jnp.asarray(g),
                                        interpret=True, bwd_impl=impl)
                    for impl in ("vpu", "mxu")}
            if case in ("N41_M12_D2", "exact_tie"):
                refs["jax.grad of psi2_core"] = jax.grad(
                    lambda *a: jnp.sum(g * jax_psi2_core(*a, True)),
                    argnums=(0, 1, 2, 3, 4))(*jargs)
            leaves = [t.clone().requires_grad_() for t in targs]
            tpsi2.psi2_core(*leaves).backward(tg)
            ports = {"plain backward":
                     tpsi2.psi2_core_backward_plain(*targs, tg),
                     "backward wrapper on CPU":
                     tpsi2.psi2_core_backward(*targs, tg),
                     "autograd Function on CPU": [t.grad for t in leaves]}
        finally:
            jpsi2._block_rows, tpsi2._block_rows = blocks
        for pname, got in ports.items():
            for rname, want in refs.items():
                for gt, w, what in zip(got, want, GRADS):
                    w = np.asarray(w)
                    assert w.dtype == np.float64, f"{rname} dtype {w.dtype}"
                    scale = max(np.abs(w).max(), 1.0)
                    assert_allclose(
                        gt.numpy() / scale, w / scale, rtol=0,
                        atol=PSI2_BWD_SCALE_TOL,
                        err_msg=f"psi2 backward {case}: {pname} {what} vs "
                                f"{rname}")
        gU, gV, gw, glogdet, gZ = (t.numpy() for t in ports["plain backward"])
        if case == "fully_clamped":
            assert not (gU.any() or gV.any() or gw.any() or gZ.any()), (
                f"psi2 backward {case}: a gated gradient is not exactly 0")
            assert_allclose(glogdet, np.full((16, 1), 36 * np.exp(-0.5)),
                            rtol=1e-12, err_msg=f"psi2 backward {case}: "
                                                f"glogdet")
        if case == "exact_tie":
            # the tied rows pass nothing to U, V, w (and nothing of theirs
            # to Z), and all of g e to logdet
            assert not (gU[:10].any() or gV[:10].any() or gw[:10].any()), (
                f"psi2 backward {case}: a tied row's gated gradient is not "
                f"exactly 0")
            assert_allclose(glogdet[:10], g.sum() * np.exp(args[3][:10]),
                            rtol=1e-12, err_msg=f"psi2 backward {case}: "
                                                f"glogdet of the tied rows")
    # the Function hands back only the gradients that are needed
    leaves = [t.clone().requires_grad_() for t in targs]
    leaves[2].requires_grad_(False)
    tpsi2.psi2_core(*leaves).backward(tg)
    assert leaves[2].grad is None and leaves[4].grad is not None, (
        "psi2 Function: needs_input_grad not honoured")


# (N, M, D) the psi2 backward's launch plan is checked at: both cells'
# shapes, M=512, ragged sizes, D above 8 (d groups), one row, and N far
# beyond one wave
PSI2_PLAN_SHAPES = [(7372, 256, 2), (1500, 100, 8), (2000, 512, 2),
                    (1301, 100, 3), (500, 64, 12), (300, 37, 2), (1, 1, 1),
                    (2000, 512, 32), (10 ** 6, 256, 2)]
PSI2_SCRATCH_MAX = 32_000_000   # bytes of the backward's gZ partials


def _check_psi2_backward_plan():
    """The psi2 backward's launch plan (plain Python, handed to the
    kernel): every row in exactly one chunk, each block's chunks within
    one of each other, every (a, b) term in exactly one sub-tile (the
    kernel's decoding replayed), shared memory within a block's 227 KB,
    d groups covering D, and the gZ scratch within 32 MB and independent
    of N."""
    for N, M, D in PSI2_PLAN_SHAPES:
        case = f"psi2 backward plan N={N} M={M} D={D}"
        p = tpsi2.backward_plan(N, M, D)
        rc, chunks, grid = p["rows_per_chunk"], p["chunks"], p["grid"]
        assert rc % 4 == 0 and (chunks - 1) * rc < N <= chunks * rc, (
            f"{case}: {chunks} chunks of {rc} rows")
        if N <= 10 ** 4:
            assert _covered_once(N, range(0, chunks * rc, rc), rc), (
                f"{case}: a row not in exactly one chunk")
        per_block = [len(range(b, chunks, grid)) for b in range(grid)]
        per_sm = p["blocks_per_sm"]
        assert per_sm == (2 if D <= 2 else 1) and grid <= 132 * per_sm and (
            max(per_block) - min(per_block) <= 1 and min(per_block) >= 1), (
            f"{case}: chunks a block {per_block}")
        sa = 16 * p["a_per_thread"]
        assert sa == (64 if D <= 4 else 32), f"{case}: tile"
        tan, tbn = -(-M // sa), -(-M // 64)
        assert p["sub_tiles"] == tan * tbn, f"{case}: sub-tiles"
        hits = np.zeros((tan * sa, tbn * 64), dtype=int)
        for st in range(p["sub_tiles"]):
            a0, b0 = (st // tbn) * sa, (st % tbn) * 64
            hits[a0:a0 + sa, b0:b0 + 64] += 1
        assert (hits[:M, :M] == 1).all(), f"{case}: a term not in one tile"
        assert p["groups"] * p["d_group"] >= D and (
            (p["groups"] - 1) * p["d_group"] < D), f"{case}: d groups"
        assert p["smem_bytes"] == 4 * tpsi2._bwd_smem_floats(M, D, rc) <= (
            min(tpsi2.SMEM_MAX, 233472 // per_sm - 1024)), (
            f"{case}: smem {p['smem_bytes']}")
        assert p["scratch_floats"] == grid * M * D and (
            4 * p["scratch_floats"] <= PSI2_SCRATCH_MAX), f"{case}: scratch"
        for other in (1000 * N, 10 ** 7):
            assert 4 * tpsi2.backward_plan(other, M, D)[
                "scratch_floats"] <= 4 * 264 * M * D <= PSI2_SCRATCH_MAX, (
                f"{case}: scratch at N={other}")


def _onepass_backward(args, g, plan):
    """The psi2 backward as the kernel takes it, in float64 numpy: per
    chunk of the plan, P once for each term; gU, gV, glogdet and gw from
    it per row; Q_d = sum_n w[n,d] P over the chunk's rows and the
    chunk's share of gZ = -sum_b Z[b,d] (Q_d[c,b] + Q_d[b,c]), the shares
    added in chunk order."""
    U, V, w, logdet, Z = args
    N = U.shape[0]
    rc = plan["rows_per_chunk"]
    pre = (U[:, :, None] + V[:, None, :]
           - np.einsum("nd,ad,bd->nab", w, Z, Z))
    ge = g[None] * np.exp(np.minimum(pre, 0.0) + logdet[:, :, None])
    P = np.where(pre < 0.0, ge, 0.0)
    gZ = np.zeros_like(Z)
    for n0 in range(0, plan["chunks"] * rc, rc):
        sl = slice(n0, min(n0 + rc, N))
        Q = np.einsum("nd,nab->dab", w[sl], P[sl])
        gZ -= (np.einsum("bd,dcb->cd", Z, Q) + np.einsum("ad,dac->cd", Z, Q))
    return (P.sum(axis=2), P.sum(axis=1),
            -np.einsum("nab,ad,bd->nd", P, Z, Z), ge.sum(axis=(1, 2))[:, None],
            gZ)


def _check_psi2_onepass():
    """The one-pass algebra (gZ through Q, the plan's chunks) against
    jax.grad of the JAX psi2_core (interpret-mode kernel backward), in
    float64, on a multi-chunk case and the exact-tie case."""
    for case in ("multi_chunk_N90_M20_D2", "exact_tie"):
        if case == "exact_tie":
            args, g = _psi2_bwd_inputs(case)
        else:
            args = _psi2_inputs(90, 20, 2, seed=11)
            g = np.random.RandomState(12).randn(20, 20)
        N, M = args[0].shape
        plan = tpsi2.backward_plan(N, M, args[4].shape[1], sms=4)
        assert plan["chunks"] > 1, f"psi2 one-pass {case}: one chunk"
        got = _onepass_backward(args, g, plan)
        want = jax.grad(lambda *a: jnp.sum(g * jax_psi2_core(*a, True)),
                        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
        for gt, w, what in zip(got, want, GRADS):
            w = np.asarray(w)
            scale = max(np.abs(w).max(), 1.0)
            assert_allclose(gt / scale, w / scale, rtol=0,
                            atol=PSI2_BWD_SCALE_TOL,
                            err_msg=f"psi2 one-pass {case}: {what} vs "
                                    f"jax.grad of the JAX psi2_core")


# the tolerances of tests/test_pallas_gram.py: forward in float32, the
# gradients in float64
GRAM_RTOL, GRAM_ATOL = 2e-5, 2e-6
GRAM_GRAD_RTOL, GRAM_GRAD_ATOL = 1e-6, 1e-9


def _gram_grads(fn, arrays, G, square=False):
    """Gradients of sum(fn(X, Z, ls, var) * G) in float64 torch; with
    ``square`` Z is X (one leaf, both operands' gradients summed)."""
    leaves = [torch.tensor(np.asarray(a, dtype=np.float64),
                           requires_grad=True) for a in arrays]
    if square:
        leaves[1] = leaves[0]
    (fn(*leaves) * torch.from_numpy(G)).sum().backward()
    return [t.grad for i, t in enumerate(leaves) if not (square and i == 1)]


def _kahan_d2_f32(x, z, splits):
    """The squared distances of the float32 rows x (N, D) and z (M, D) in
    the order of csrc/rbf_gram.cu's wide kernel (and, at ``splits`` 1, of
    the fused conditional's gram stage), emulated in torch float32: every
    term added to its output's total with Kahan's compensation in d order,
    the square folded into one fmaf with the compensation (fmaf as the
    float64 sum of the exact product, rounded); the 16-wide chunks of d in
    even shares over ``splits`` blocks, whose totals less their
    compensations are added in block order with compensation again."""
    t = x[:, None, :] - z[None, :, :]
    sq = t.double() ** 2
    D, chunks = x.shape[1], -(-x.shape[1] // 16)
    zero = torch.zeros(t.shape[:2], dtype=torch.float32)

    def kahan(total, comp, y):
        u = total + y
        return u, (u - total) - y

    parts = []
    for r in range(splits):
        S = C = zero
        for d in range(16 * (r * chunks // splits),
                       min(D, 16 * ((r + 1) * chunks // splits))):
            S, C = kahan(S, C, (sq[..., d] - C.double()).float())
        parts.append(S - C)
    S = C = zero
    for v in parts:
        S, C = kahan(S, C, v - C)
    return S - C


def _check_rbf_gram():
    """The port's rbf_gram on CPU tensors against the interpret-mode Pallas
    rbf_gram (forward in float32; its jax.grad in float64, also with a
    scalar lengthscale, whose gradient is the sum of the ARD ones), and
    rbf_gram(X, X) against the JAX RBF.K(X) with its gradient."""
    # the last: the MNIST layer-0 width, with std 1/sqrt(D) inputs (O(1)
    # scaled distances), the kernel's generic-D path on the card
    for N, M, D in ((64, 48, 8), (300, 130, 3), (64, 40, 784)):
        case = f"rbf_gram forward float32 N={N} M={M} D={D}"
        rng = np.random.RandomState(0)
        spread = 1.0 if D < 100 else D ** -0.5
        X = (rng.randn(N, D) * spread).astype(np.float32)
        Z = (rng.randn(M, D) * spread).astype(np.float32)
        ls = (rng.rand(D) + 0.5).astype(np.float32)
        want = jax_rbf_gram(jnp.asarray(X), jnp.asarray(Z), jnp.asarray(ls),
                            jnp.float32(1.7), True)
        got = tgram.rbf_gram(torch.from_numpy(X), torch.from_numpy(Z),
                             torch.from_numpy(ls),
                             torch.tensor(1.7, dtype=torch.float32))
        assert got.dtype == torch.float32, f"{case}: dtype {got.dtype}"
        assert_allclose(got.numpy(), np.asarray(want), rtol=GRAM_RTOL,
                        atol=GRAM_ATOL, err_msg=f"{case} vs the "
                                                f"interpret-mode kernel")
    rng = np.random.RandomState(1)
    N, M, D = 72, 40, 4
    arrays = (rng.randn(N, D), rng.randn(M, D), rng.rand(D) + 0.5,
              np.float64(1.3))
    G = rng.randn(N, M)
    want = jax.grad(lambda *a: jnp.sum(jax_rbf_gram(*a, True) * G),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrays))
    got = _gram_grads(tgram.rbf_gram, arrays, G)
    for name, g, w in zip(("dX", "dZ", "dls", "dvar"), got, want):
        assert_allclose(g.numpy(), np.asarray(w), rtol=GRAM_GRAD_RTOL,
                        atol=GRAM_GRAD_ATOL,
                        err_msg=f"rbf_gram gradient {name} (72, 40, 4) vs "
                                f"jax.grad of the interpret-mode kernel")
    scalar = _gram_grads(tgram.rbf_gram, (arrays[0], arrays[1],
                                          np.float64(0.9), arrays[3]), G)
    want = jax.grad(lambda *a: jnp.sum(jax_rbf_gram(*a, True) * G),
                    argnums=2)(*map(jnp.asarray, (arrays[0], arrays[1],
                                                  np.full(D, 0.9),
                                                  arrays[3])))
    assert_allclose(scalar[2].numpy(), np.sum(np.asarray(want)),
                    rtol=GRAM_GRAD_RTOL, atol=GRAM_GRAD_ATOL,
                    err_msg="rbf_gram gradient dls, scalar lengthscale")
    assert scalar[2].shape == (), "rbf_gram scalar lengthscale: dls shape"
    # rbf_gram(X, X), the route of RBF.K(X) on the card
    X, ls, var = rng.randn(30, 3), rng.rand(3) + 0.5, 1.3
    G = rng.randn(30, 30)

    def jk(X, ls, var):
        return dsd.RBF.make(3, variance=var, lengthscales=ls).K(X)

    args = (jnp.asarray(X), jnp.asarray(ls), jnp.asarray(var))
    want_K = jk(*args)
    want = jax.grad(lambda *a: jnp.sum(jk(*a) * G), argnums=(0, 1, 2))(*args)
    got_K = tgram.rbf_gram(*(torch.tensor(np.asarray(a, dtype=np.float64))
                             for a in (X, X, ls, var)))
    assert_allclose(got_K.numpy(), np.asarray(want_K), rtol=RTOL, atol=ATOL,
                    err_msg="rbf_gram(X, X) vs the JAX RBF.K(X)")
    got = _gram_grads(tgram.rbf_gram, (X, X, ls, var), G, square=True)
    for name, g, w in zip(("dX", "dls", "dvar"), got, want):
        assert_allclose(g.numpy(), np.asarray(w), rtol=GRAM_GRAD_RTOL,
                        atol=GRAM_GRAD_ATOL,
                        err_msg=f"rbf_gram(X, X) gradient {name} vs "
                                f"jax.grad of the JAX RBF.K(X)")
    # the wide kernels' summation order at D=784 on pixel-like rows (MNIST
    # pixels in [0, 1], ARD lengthscales about 2), emulated in float32 at
    # the plan's splits (8 here) and unsplit (the fused gram stage): d2
    # within 2^-23 (2 units of float32 roundoff) of the float64 sum of the
    # same float32 differences, where a running fp32 sum is off by 25
    # units; 1.4 units measured split, 1.0 unsplit.  The Kuu shape's plan
    # splits too; K(Z, Z) comes out bitwise symmetric with d2 = 0 on the
    # diagonal.
    rng = np.random.RandomState(5)
    pix = [torch.from_numpy(np.clip(0.5 + 0.15 * rng.randn(n, 784), 0, 1)
                            .astype(np.float32)) for n in (48, 24)]
    ls = torch.from_numpy(rng.uniform(1.5, 2.5, 784).astype(np.float32))
    x, z = pix[0] / ls, pix[1] / ls
    ref = ((x.double()[:, None] - z.double()[None]) ** 2).sum(-1)
    plan = tgram.launch_plan(48, 24, 784)
    assert plan["splits"] == 8, f"summation order: plan {plan}"
    tol = 2.0 ** -23
    for splits in (plan["splits"], 1):
        err = ((_kahan_d2_f32(x, z, splits).double() - ref).abs()
               / ref).max().item()
        assert err <= tol, (f"summation order, {splits} splits: d2 off "
                            f"float64 by {err:.3e} > {tol:.3e}")
    running = torch.zeros(48, 24)
    for d in range(784):
        running = (running.double() + (x[:, None, d] - z[None, :, d])
                   .double() ** 2).float()
    assert ((running.double() - ref).abs() / ref).max().item() > 4 * tol, (
        "summation order: the running sum is as close; the check cannot "
        "tell the orders apart")
    sq = _kahan_d2_f32(z, z, tgram.launch_plan(24, 24, 784)["splits"])
    assert torch.equal(sq, sq.T) and (torch.diagonal(sq) == 0).all(), (
        "summation order: K(Z, Z)'s distances not symmetric bit for bit")


def _check_gram_args():
    """rbf_gram's host-side launch arguments, on CPU tensors: the
    lengthscale stride the kernel reads with (0 for a scalar, 1 for a
    vector, a view's own stride), so no divide or copy is launched; the
    kernel's arithmetic on them, x / ls[d * stride] - z / ls[d * stride]
    squared and summed, emulated in float64 against the interpret-mode
    Pallas rbf_gram."""
    rng = np.random.RandomState(21)
    X, Z, ard, var = rng.randn(50, 3), rng.randn(33, 3), rng.rand(3) + 0.5, 1.3
    backing = torch.from_numpy(np.stack([ard, np.zeros(3)], axis=1).ravel())
    cases = {"scalar": (torch.tensor(0.9, dtype=torch.float64),
                        np.full(3, 0.9), 0),
             "ARD": (torch.from_numpy(ard), ard, 1),
             "ARD, strided view": (backing[::2], ard, 2)}
    tX, tZ = torch.from_numpy(X), torch.from_numpy(Z)
    for name, (ls, ls_np, stride) in cases.items():
        N, M, D, got_stride = tgram._kernel_args(tX, tZ, ls)
        assert (N, M, D, got_stride) == (50, 33, 3, stride), (
            f"rbf_gram args {name}: {(N, M, D, got_stride)}")
        read = ls.as_strided((D,), (got_stride,)).numpy()
        assert (read == ls_np).all(), f"rbf_gram args {name}: {read}"
        t = (X / read)[:, None, :] - (Z / read)[None, :, :]
        K = var * np.exp(-0.5 * np.sum(t * t, axis=-1))
        want = jax_rbf_gram(jnp.asarray(X), jnp.asarray(Z),
                            jnp.asarray(ls_np), jnp.float64(var), True)
        assert_allclose(K, np.asarray(want), rtol=RTOL, atol=ATOL,
                        err_msg=f"rbf_gram args {name}: the kernel's "
                                f"arithmetic vs the interpret-mode kernel")
    # the launch plan handed to the C entry point: D <= 8 the narrow
    # kernel's 16 x 128 tiles, one block each; above, 64 x 64 tiles whose
    # chunks of 16 d a cluster of 1-8 blocks splits, each an even share,
    # doubled while the grid is below one block an SM (on 132 SMs and on
    # 114) and each block keeps a chunk; no workspace; and what the C entry
    # point refuses raises here
    for D in (1, 8, 9, 30, 37, 784):
        for N, M in ((100, 100), (1000, 100), (77, 1301), (100, 100000),
                     (100000, 100)):
            for sms in (132, 114):
                case = f"rbf_gram plan N={N} M={M} D={D} sms={sms}"
                p = tgram.launch_plan(N, M, D, sms)
                assert p["workspace_bytes"] == 0, case
                if D <= 8:
                    tiles = -(-M // 128) * -(-N // 16)
                    assert (p["path"], p["splits"], p["grid"]) == (
                        "narrow", 1, tiles), f"{case}: {p}"
                    continue
                tiles, chunks = -(-N // 64) * -(-M // 64), -(-D // 16)
                sp = p["splits"]
                assert p["path"] == "wide" and p["tiles"] == tiles and (
                    p["chunks"] == chunks and p["grid"] == tiles * sp), (
                    f"{case}: {p}")
                assert sp in (1, 2, 4, 8) and sp <= chunks and (
                    sp == 8 or tiles * sp >= sms or 2 * sp > chunks), (
                    f"{case}: {sp} splits")
                assert sp == 1 or tiles * sp // 2 < sms, (
                    f"{case}: {sp} splits past one block an SM")
                shares = [(r * chunks // sp, (r + 1) * chunks // sp)
                          for r in range(sp)]
                assert all(a < b for a, b in shares) and (
                    shares[0][0] == 0 and shares[-1][1] == chunks) and all(
                    shares[r][1] == shares[r + 1][0] for r in range(sp - 1)
                ), f"{case}: shares {shares}"
    # the MNIST DGP's grams: Kuu and Kuf at D=784 in clusters of 8; the
    # serving Kuf (100,000 rows) fills the card with tiles alone
    for (N, M, D), (sp, grid) in (((100, 100, 784), (8, 32)),
                                  ((1000, 100, 784), (8, 256)),
                                  ((100, 100, 30), (2, 8)),
                                  ((100000, 100, 784), (1, 3126))):
        p = tgram.launch_plan(N, M, D)
        assert (p["splits"], p["grid"]) == (sp, grid), f"plan {N, M, D}: {p}"
    for args in ((0, 5, 3), (5, 0, 3), (5, 5, 0), (2 ** 22, 2 ** 22, 784),
                 (2 ** 22, 2 ** 22, 8)):
        try:
            tgram.launch_plan(*args)
        except ValueError:
            continue
        raise AssertionError(f"rbf_gram plan {args}: refused by the C entry "
                             f"point, not raised here")


def _check_timing():
    """utils/timing.py keeps the JAX helper's contract: one warm-up call
    with -1, then ``repeats`` blocks of ``n`` calls with 0 .. repeats n -
    1, and the JAX statistics (here on the host clock)."""
    seen = {"port": [], "jax": []}

    def call(who):
        def f(i):
            seen[who].append(i)
            return torch.full((3,), float(i)) if who == "port" else (
                np.full(3, float(i)))
        return f

    got = ttiming.timed_per_call_stats(call("port"), n=4, repeats=3)
    want = jtiming.timed_per_call_stats(call("jax"), n=4, repeats=3)
    assert seen["port"] == seen["jax"] == [-1] + list(range(12)), (
        f"timing: call indices {seen}")
    assert set(want) <= set(got) and got["repeats"] == 3 and (
        got["clock"] == "host"), f"timing: statistics {got}"
    assert 0 < got["best"] <= got["median"] <= got["max"], (
        f"timing: order of the statistics {got}")
    assert ttiming.timed_per_call(call("port"), n=2, repeats=2) > 0, (
        "timed_per_call")


# ---------------------------------------------------------------------------
# MCMC: HMC and NUTS draw for draw against the JAX samplers
# ---------------------------------------------------------------------------

# draw-for-draw positions, step sizes and statistics, float64
MCMC_RTOL = 1e-8
_QA = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, 0.3], [0.0, 0.3, 0.5]])
_QPREC = np.linalg.inv(_QA @ _QA.T)
_QC = np.array([1.0, -2.0, 0.5])


class _JQuad(JModule):
    v: JParam = None


class _TQuad(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.v = TParam(np.zeros(3))


def _jquad_logp(m):
    d = m.v.value - jnp.asarray(_QC)
    return -0.5 * d @ jnp.asarray(_QPREC) @ d


def _tquad_logp(m):
    d = m.v.value - torch.as_tensor(_QC)
    return -0.5 * d @ torch.as_tensor(_QPREC) @ d


class _Replay:
    """A draw source handing out given arrays in order (the port's draws
    of a run, as the JAX key schedule makes them)."""

    def __init__(self, draws):
        self.draws, self.i = list(draws), 0

    def draw(self, kind, shape, dtype, device, high=None):
        want_kind, a = self.draws[self.i]
        assert (kind, tuple(shape)) == (want_kind, a.shape), (
            f"draw {self.i}: the sampler drew {kind} {tuple(shape)}, the "
            f"schedule has {want_kind} {a.shape}")
        self.i += 1
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _hmc_draws(keys, P):
    """The JAX HMC schedule of one chain (hmc.py:64-78): per iteration
    the momenta, then the accept uniform."""
    draws = []
    for k in keys:
        kp, ku = jax.random.split(k)
        draws.append(("randn", np.asarray(jax.random.normal(
            kp, (P,), dtype=jnp.float64))))
        draws.append(("rand", np.asarray(jax.random.uniform(
            ku, dtype=jnp.float64))))
    return draws


class _ChainsReplay(_Replay):
    """The JAX multi-chain schedule (hmc.py:239-244, nuts.py:333-338) as
    a draw source: the (C, P) normals of the starts, then ``split`` hands
    out each chain's own replay of its key stream."""

    def __init__(self, q0_noise, chains):
        super().__init__([("randn", q0_noise)])
        self.chains = chains

    def split(self, num_chains):
        assert num_chains == len(self.chains), "one key stream a chain"
        return self.chains


class _NutsReplay:
    """The JAX NUTS schedule (nuts.py:120-121,148-149,166-167,178,283) as
    a draw source: per transition the momenta, per doubling the
    direction (a uniform below 0.5 where ``bernoulli(kd)`` is True), the
    subtree's leaf uniforms along its key chain and the merge uniform."""

    def __init__(self, keys):
        self.keys, self.t, self.key = keys, 0, None
        self.state, self.kb, self.ka = "dir", None, None

    def draw(self, kind, shape, dtype, device, high=None):
        shape = tuple(shape)
        if kind == "randn":
            kr, self.key = jax.random.split(self.keys[self.t])
            self.t += 1
            self.state = "dir"
            a = np.asarray(jax.random.normal(kr, shape, dtype=jnp.float64))
        elif self.state == "dir":
            assert shape == (), f"NUTS draw: {kind} {shape} for a direction"
            kd, self.kb, self.ka, self.key = jax.random.split(self.key, 4)
            a = np.array(0.25 if jax.random.bernoulli(kd) else 0.75)
            self.state = "leaves"
        elif self.state == "leaves":
            us, k = [], self.kb
            for _ in range(shape[0]):
                ku, k = jax.random.split(k)
                us.append(np.asarray(jax.random.uniform(
                    ku, dtype=jnp.float64)))
            a = np.array(us)
            self.state = "take"
        else:
            assert shape == (), f"NUTS draw: {kind} {shape} for a merge"
            a = np.asarray(jax.random.uniform(self.ka, dtype=jnp.float64))
            self.state = "dir"
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _sgpmc_pair(rng):
    """A 2-layer SGPMC DGP of width 2 in both packages (white, RBF, M=5,
    N=20, the solve branch), with its posterior moved off zero; the
    target is the ELBO at fixed draws plus the q_mu priors."""
    N, Dx, Mi = 20, 2, 5
    X = rng.randn(N, Dx)
    Y = np.sin(X[:, :1]) + 0.1 * rng.randn(N, 1)
    Z = X[:Mi]
    zs = [rng.randn(1, N, 2), rng.randn(1, N, 1)]
    with temp_config(jitter=1e-6, solve_mode="solve", use_pallas=False):
        jl = [dsd.SGPMCLayer.make(dsd.RBF.make(Dx), Z, 2, white=True),
              dsd.SGPMCLayer.make(dsd.RBF.make(2, lengthscales=1.2), Z, 1,
                                  white=True)]
        jm = dsd.DGPBase.make(X, Y, dsd.Gaussian.make(0.1), jl)
    jm = jm.replace(layers=[
        l.replace(q_mu=l.q_mu.with_value(0.3 * rng.randn(
            *l.q_mu.value.shape))) for l in jm.layers])
    cfg = port.Config(dtype=torch.float64, jitter=1e-6)
    tl = [port.SGPMCLayer(port.RBF(Dx), Z, 2, white=True, config=cfg),
          port.SGPMCLayer(port.RBF(2), Z, 1, white=True, config=cfg)]
    tm = port.DGPBase.make(X, Y, port.Gaussian(0.1), tl, config=cfg,
                           device="cpu")
    state = {_torch_key(jax.tree_util.keystr(p)): np.asarray(v) for p, v in
             jax.tree_util.tree_flatten_with_path(jm)[0]}
    port.load_reference_state(tm, state)
    jzs = [jnp.asarray(z) for z in zs]
    tzs = [torch.as_tensor(z) for z in zs]

    def jlogp(m):
        _, Fm, Fv = m.propagate(m.X_data, S=1, zs=jzs)
        ve = m.likelihood.variational_expectations(Fm[-1], Fv[-1], m.Y_data)
        return jnp.sum(jnp.mean(ve, axis=0)) + jlog_prior(m)

    def tlogp(m):
        return m.elbo(zs=tzs) + port.log_prior(m)

    return jm, tm, jlogp, tlogp


def _close_mcmc(case, got, want):
    assert_allclose(np.asarray(got, dtype=np.float64),
                    np.asarray(want, dtype=np.float64), rtol=MCMC_RTOL,
                    atol=1e-12, err_msg=case)


def _decisions(qs):
    """Per iteration, whether the position moved (an accepted proposal)."""
    qs = np.asarray(qs)
    prev = np.concatenate([qs[:1] * np.nan, qs[:-1]])
    return np.any(qs != prev, axis=-1)


def _check_hmc(name, jm, tm, jlogp, tlogp, jfreeze, tfreeze, step, L):
    """20 iterations (10 burn-in with adaptation, 10 samples) of
    ``hmc_sample`` and 2 chains of ``hmc_sample_chains``: every
    iteration's position (so every accept decision), the accept counts,
    the adapted step sizes and the final log densities."""
    before = [p.detach().clone() for p in tm.parameters()]
    key = jax.random.PRNGKey(5)
    kw = dict(num_samples=10, num_burn=10, step_size=step, num_leapfrog=L,
              adapt_step_size=True)
    # the JAX single chain, every iteration (the runner hmc_sample jits)
    flat0, rebuild = jax_partition_trainable(jm, freeze=jfreeze)

    def logp(v):
        return jlogp(rebuild(v))

    run = jax.jit(jhmc._make_chain_runner(
        jax.value_and_grad(logp), flat0.dtype, 10, 10, step, L, True, 0.8))
    keys = jax.random.split(key, 20)
    carry, jqs = run(flat0, logp(flat0), keys)
    js, jacc, _, jinfo = jhmc.hmc_sample(jm, jlogp, key, freeze=jfreeze,
                                         **kw)
    P = flat0.shape[0]
    chains = thmc.HMCChains(tm, tlogp, _Replay(_hmc_draws(keys, P)),
                            freeze=tfreeze, **kw)
    tqs = chains.run()[:, 0].numpy()
    _close_mcmc(f"HMC {name}: every iteration's position", tqs, jqs)
    td, jd = _decisions(tqs), _decisions(np.asarray(jqs))
    assert (td == jd).all(), f"HMC {name}: accept decisions {td} vs {jd}"
    ts, tacc, _, tinfo = thmc.hmc_sample(
        tm, tlogp, _Replay(_hmc_draws(keys, P)), freeze=tfreeze, **kw)
    _close_mcmc(f"HMC {name}: hmc_sample samples", ts.numpy(), js)
    assert tacc == jacc, f"HMC {name}: accept rate {tacc} vs {jacc}"
    _close_mcmc(f"HMC {name}: adapted step size", tinfo.step_size,
                jinfo.step_size)
    _close_mcmc(f"HMC {name}: final log density", tinfo.final_log_prob,
                jinfo.final_log_prob)
    # chains: the overdispersed starts, then per-chain key splits
    C = 2
    js, jaccs, _, jinfo = jhmc.hmc_sample_chains(
        jm, jlogp, key, num_chains=C, freeze=jfreeze, **kw)
    k_init, k_run = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_init, (C, P), dtype=jnp.float64))
    chain_keys = jax.vmap(lambda k: jax.random.split(k, 20))(
        jax.random.split(k_run, C))
    ts, taccs, _, tinfo = thmc.hmc_sample_chains(
        tm, tlogp, _ChainsReplay(noise, [_Replay(_hmc_draws(k, P))
                                         for k in chain_keys]),
        num_chains=C, freeze=tfreeze, **kw)
    _close_mcmc(f"HMC chains {name}: samples", ts.numpy(), js)
    assert (taccs == np.asarray(jaccs)).all(), (
        f"HMC chains {name}: accept rates {taccs} vs {jaccs}")
    for k in ("step_sizes", "final_log_probs", "rhat"):
        _close_mcmc(f"HMC chains {name}: {k}", tinfo[k], jinfo[k])
    for t in (thmc.potential_scale_reduction, thmc.effective_sample_size):
        assert np.isfinite(t(ts.numpy())).all(), f"{name}: diagnostics"
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(), before)
               ), f"HMC {name}: the samplers changed the model"


def _check_nuts():
    """10 NUTS transitions (5 burn-in with adaptation, 5 samples),
    max_depth=6, on the 3-D Gaussian: samples, mean tree depth,
    divergences, accept statistic and step size against ``nuts_sample``;
    a divergent chain (step 50, no adaptation); and 2 chains of
    ``nuts_sample_chains`` (4 + 4 transitions), each on its own keys."""
    key = jax.random.PRNGKey(9)
    for case, kw in (("adapting", dict(num_samples=5, num_burn=5,
                                       step_size=0.5)),
                     ("divergent", dict(num_samples=6, num_burn=0,
                                        step_size=50.0,
                                        adapt_step_size=False))):
        js, jacc, _, jinfo = jnuts.nuts_sample(_JQuad(v=JParam.create(
            np.zeros(3))), _jquad_logp, key, max_depth=6, **kw)
        keys = jax.random.split(key, kw["num_samples"] + kw["num_burn"])
        ts, tacc, _, tinfo = tnuts.nuts_sample(
            _TQuad(), _tquad_logp, _NutsReplay(keys), max_depth=6, **kw)
        _close_mcmc(f"NUTS {case}: samples", ts.numpy(), js)
        _close_mcmc(f"NUTS {case}: accept statistic", tacc, jacc)
        for k in ("step_size", "mean_tree_depth"):
            _close_mcmc(f"NUTS {case}: {k}", tinfo[k], jinfo[k])
        assert tinfo["divergences"] == jinfo["divergences"], (
            f"NUTS {case}: divergences {tinfo['divergences']} vs "
            f"{jinfo['divergences']}")
        assert tinfo["host_reads"] <= 6 * 10, f"NUTS {case}: host reads"
    assert jinfo["divergences"] > 0, "NUTS divergent: no divergence"
    # chains: the overdispersed starts, then each chain's key stream
    C, kw = 2, dict(num_samples=4, num_burn=4, step_size=0.5, max_depth=6)
    js, jacc, _, jinfo = jnuts.nuts_sample_chains(
        _JQuad(v=JParam.create(np.zeros(3))), _jquad_logp, key,
        num_chains=C, **kw)
    k_init, k_run = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_init, (C, 3), dtype=jnp.float64))
    chain_keys = jax.vmap(lambda k: jax.random.split(k, 8))(
        jax.random.split(k_run, C))
    ts, tacc, _, tinfo = tnuts.nuts_sample_chains(
        _TQuad(), _tquad_logp, _ChainsReplay(
            noise, [_NutsReplay(k) for k in chain_keys]), num_chains=C, **kw)
    _close_mcmc("NUTS chains: samples", ts.numpy(), js)
    _close_mcmc("NUTS chains: accept statistics", tacc, jacc)
    for k in ("step_sizes", "mean_tree_depths", "rhat"):
        _close_mcmc(f"NUTS chains: {k}", tinfo[k], jinfo[k])
    assert (tinfo["divergences"] == np.asarray(jinfo["divergences"])).all(
    ), f"NUTS chains: divergences {tinfo['divergences']}"


def _check_diagnostics():
    """Split R-hat and ESS on fixed arrays (a sticky chain, iid chains,
    an odd sample count) against the JAX functions."""
    rng = np.random.RandomState(61)
    iid = rng.randn(3, 41, 4)
    sticky = np.cumsum(rng.randn(2, 40, 3), axis=1)
    for case, x in (("iid, odd S", iid), ("random walk", sticky),
                    ("one chain", iid[:1])):
        assert_allclose(thmc.potential_scale_reduction(x),
                        np.asarray(jhmc.potential_scale_reduction(
                            jnp.asarray(x))), rtol=1e-12,
                        err_msg=f"potential_scale_reduction {case}")
        assert_allclose(thmc.effective_sample_size(x),
                        jhmc.effective_sample_size(x), rtol=1e-12,
                        err_msg=f"effective_sample_size {case}")


def _check_mcmc():
    _check_hmc("3-D Gaussian", _JQuad(v=JParam.create(np.zeros(3))),
               _TQuad(), _jquad_logp, _tquad_logp, None, None, 0.3, 5)
    jm, tm, jlogp, tlogp = _sgpmc_pair(np.random.RandomState(60))
    _check_hmc("2-layer SGPMC DGP", jm, tm, jlogp, tlogp,
               lambda path, p: "q_mu" not in path,
               lambda name, p: "q_mu" not in name, 0.05, 4)
    _check_nuts()
    _check_diagnostics()


# ---------------------------------------------------------------------------
# data and sample parallelism: the port's ranks (gloo, spawned CPU
# processes running tests/test_torch_ranks.py) against the JAX package's
# shard_map programs on the CPU devices of tests/conftest.py
# ---------------------------------------------------------------------------

DP_S, DP_N, DP_DX = 2, 12, 2
RANKS_TIMEOUT_S = 240.0


def _dp_pair(rng):
    """A 2-layer DGP (RBF, M=4, S=2, the solve branch) in both packages,
    its posterior moved off the prior; the port's pickled for the
    ranks."""
    X = rng.randn(DP_N, DP_DX)
    Y = np.sin(X[:, :1]) + 0.1 * rng.randn(DP_N, 1)
    Z = X[:4]
    with temp_config(jitter=1e-6, solve_mode="solve", use_pallas=False):
        jm = dsd.DGP.build(X, Y, Z, [dsd.RBF.make(DP_DX),
                                     dsd.RBF.make(DP_DX, lengthscales=1.2)],
                           dsd.Gaussian.make(0.1), num_samples=DP_S)
    layers = []
    for layer in jm.layers:
        Mi, Do = layer.q_mu.value.shape
        q_sqrt = np.tril(rng.randn(Do, Mi, Mi) * 0.2) + 0.4 * np.eye(Mi)
        layers.append(layer.replace(
            q_mu=layer.q_mu.with_value(rng.randn(Mi, Do) * 0.5),
            q_sqrt=layer.q_sqrt.with_value(q_sqrt)))
    jm = jm.replace(layers=layers)
    tm = port.DGP.build(X, Y, Z, [port.RBF(DP_DX), port.RBF(DP_DX)],
                        port.Gaussian(0.1), num_samples=DP_S,
                        config=port.Config(), device="cpu")
    port.load_reference_state(tm, _jax_state(jm))
    return jm, tm


def _jax_state(jm):
    return {_torch_key(jax.tree_util.keystr(p)): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jm)[0]}


def _jax_elbo(m, X, Y, zs):
    """The single-device ELBO of the batch at fixed draws (zs' S)."""
    _, Fm, Fv = m.propagate(X, zs=zs, S=zs[0].shape[0])
    ve = m.likelihood.variational_expectations(Fm[-1], Fv[-1], Y)
    KL = sum(layer.KL() for layer in m.layers)
    return jnp.sum(jnp.mean(ve, axis=0)) * (m.num_data / X.shape[0]) - KL


_jax_elbo_grad = jax.jit(jax.grad(_jax_elbo))
_jax_kl_grad = jax.jit(jax.grad(
    lambda m: sum(layer.KL() for layer in m.layers)))


def _close_grads(case, got, want, rtol=1e-8, atol=1e-10):
    """The port's {name: gradient} against a JAX gradient tree."""
    want = _jax_state(want)
    assert got, f"{case}: no gradients"
    for name, g in got.items():
        assert_allclose(g, want[name], rtol=rtol, atol=atol,
                        err_msg=f"{case}: gradient of {name}")


def _counted_once(case, got, want, replicated, n):
    """The 'replicated term counted once' case: the gradients match the
    single-device ones, and counting the replicated term's gradient n
    times instead would move them by far more than the tolerance."""
    _close_grads(case, got, want)
    want, rep = _jax_state(want), _jax_state(replicated)
    margin = max(float(np.max(np.abs((n - 1) * rep[k]) / (
        1e-10 + 1e-8 * np.abs(want[k])))) for k in got)
    assert margin > 1e3, (
        f"{case}: counting the replicated term {n} times would move the "
        f"gradient by only {margin:.3g} tolerances")


def _rows_seed_draws(seed, n, rows, widths, S):
    """The normals the ranks of ``dp_elbo(seed)`` draw (rank r from
    ``rank_generator(seed, r)``, S x its rows a layer), joined by rows."""
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import rank_generator
    per_rank = []
    for r in range(n):
        g = rank_generator(seed, r, "cpu")
        per_rank.append([torch.randn((S, rows // n, d), generator=g,
                                     dtype=torch.float64) for d in widths])
    return [torch.cat([d[l] for d in per_rank], dim=1)
            for l in range(len(widths))]


def _dp_oracles(jm, X, Y, zs_rows1, zs_full):
    """The JAX package's dp_elbo (2 devices, even and odd batches; the
    2 x 2 mesh, odd) and sp_elbo (2 devices; 2 x 2) values, and the
    single-device ELBO and gradients at the same draws."""
    from jax.sharding import Mesh
    from doubly_stochastic_dgp_tpu.parallel import dp as jdp
    from doubly_stochastic_dgp_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh)

    jzs1 = [jnp.asarray(z) for z in zs_rows1]
    jzsf = [jnp.asarray(z) for z in zs_full]
    mesh22 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                  ("data", "sample"))

    def jit(fn, mesh, **kw):
        # a shard_map outside jit runs op by op (20 s here); one program
        return jax.jit(lambda m, X, Y, zs: fn(m, X, Y, None, mesh, zs=zs,
                                              **kw))

    out = {"kl_grad": _jax_kl_grad(jm)}
    jax_dp2 = jit(jdp.dp_elbo, jax_make_mesh(num_devices=2))
    for case, rows in (("even", DP_N), ("odd", DP_N - 1)):
        Xb, Yb = jnp.asarray(X[:rows]), jnp.asarray(Y[:rows])
        out[f"dp_elbo {case}"] = (float(jax_dp2(jm, Xb, Yb, jzs1)),
                                  _jax_elbo_grad(jm, Xb, Yb, jzs1))
    Xo, Yo = jnp.asarray(X[:-1]), jnp.asarray(Y[:-1])
    out["dp_elbo 2 x 2"] = (
        float(jit(jdp.dp_elbo, mesh22, axis="data")(jm, Xo, Yo, jzs1)),
        out["dp_elbo odd"][1])
    Xf, Yf = jnp.asarray(X), jnp.asarray(Y)
    out["elbo grad"] = _jax_elbo_grad(jm, Xf, Yf, jzsf)
    out["elbo"] = float(_jax_elbo(jm, Xf, Yf, jzsf))
    for case, mesh in (("sp_elbo on 2", jax_make_mesh(num_devices=2,
                                                       axis="sample")),
                       ("sp_elbo on 2 x 2", mesh22)):
        out[case] = float(jit(jdp.sp_elbo, mesh, axis="sample")(
            jm, Xf, Yf, jzsf))
    return out


def _check_parallel():
    """dp_elbo (an even and an odd, padded, batch) and sp_elbo on 2 gloo
    ranks and on a 2 x 2 (data x sample) mesh of 4, values against the
    JAX package's shard_map functions (rtol 1e-10) and gradients against
    its single-device gradient (rtol 1e-8) at the same draws; the
    replicated KL counted once; dp_elbo's seeded draws; HMC and NUTS
    chains split over the ranks, draw for draw the chains of one process
    given the same generator (mesh= changes no draw); shard_chains's
    refusal."""
    from concurrent.futures import ThreadPoolExecutor
    from doubly_stochastic_dgp_tpu.parallel.mesh import (
        make_mesh as jax_make_mesh, shard_chains as jax_shard_chains)
    import pickle
    import test_torch_ranks as ranks
    from doubly_stochastic_dgp_tpu_torch.parallel.mesh import run_ranks

    rng = np.random.RandomState(70)
    jm, tm = _dp_pair(rng)
    X, Y = np.asarray(jm.X_data), np.asarray(jm.Y_data)
    zs_rows1 = [rng.randn(DP_S, 1, d) for d in (DP_DX, 1)]
    zs_full = [rng.randn(2 * DP_S, DP_N, d) for d in (DP_DX, 1)]
    payload = {"model": pickle.dumps(tm), "X_even": X, "Y_even": Y,
               "X_odd": X[:DP_N - 1], "Y_odd": Y[:DP_N - 1],
               "zs_rows1": zs_rows1, "zs_full": zs_full}
    # the ranks run while this process computes the JAX oracles
    pool = ThreadPoolExecutor(2)
    runs = [pool.submit(run_ranks, fn, n, (payload,), device="cpu",
                        threads=1, timeout_s=RANKS_TIMEOUT_S)
            for fn, n in ((ranks.conditional_ranks, 2),
                          (ranks.mesh2x2_ranks, 4))]
    pool.shutdown(wait=False)
    oracles = _dp_oracles(jm, X, Y, zs_rows1, zs_full)
    two, four = (r.result() for r in runs)
    for r in two:     # NUTS counts its own rank's host reads
        for name in ("hmc", "nuts"):
            r["chains"][name][2].pop("host_reads", None)
    for res in (two, four):
        for key in res[0]:
            if key != "coords":
                assert pickle.dumps(res[0][key]) == pickle.dumps(
                    res[-1][key]), f"parallel {key}: the ranks disagree"
    assert [r["coords"] for r in four] == [(0, 0), (0, 1), (1, 0), (1, 1)], (
        "parallel 2 x 2: rank = data index x 2 + sample index")
    out, out4 = two[0], four[0]

    kl_grad = oracles["kl_grad"]
    for case in ("even", "odd"):
        value, grads = out[f"dp_elbo {case}"]
        want, want_grad = oracles[f"dp_elbo {case}"]
        assert_allclose(value, want, rtol=1e-10,
                        err_msg=f"dp_elbo {case} batch: value vs JAX")
        _counted_once(f"dp_elbo {case} batch (a replicated term counted "
                      f"once)", grads, want_grad, kl_grad, 2)
    value, grads = out4["dp_elbo"]
    want, want_grad = oracles["dp_elbo 2 x 2"]
    assert_allclose(value, want, rtol=1e-10,
                    err_msg="dp_elbo on 2 x 2: value vs JAX")
    _counted_once("dp_elbo on 2 x 2 (a replicated term counted once)",
                  grads, want_grad, kl_grad, 4)
    for case, res in (("sp_elbo on 2", out["sp_elbo"]),
                      ("sp_elbo on 2 x 2", out4["sp_elbo"])):
        value, grads = res
        assert_allclose(value, oracles[case], rtol=1e-10,
                        err_msg=f"{case}: value vs JAX sp_elbo")
        assert_allclose(value, oracles["elbo"], rtol=1e-10,
                        err_msg=f"{case}: value vs the JAX elbo")
        _close_grads(f"{case}: gradient", grads, oracles["elbo grad"])
    # the seeded path: rank r draws from rank_generator(3, r)
    zs = _rows_seed_draws(3, 2, DP_N, (DP_DX, 1), DP_S)
    with torch.no_grad():
        want = float(tm.elbo(tm.X_data, tm.Y_data, zs=zs))
    assert_allclose(out["dp_elbo seed"], want, rtol=1e-10,
                    err_msg="dp_elbo seed: the ranks' generators")
    # the chains: one process, no mesh, the same generator
    single = ranks.chains(None)
    for name in ("hmc", "nuts"):
        s, acc, info = out["chains"][name]
        s1, acc1, info1 = single[name]
        assert np.array_equal(s, s1), (
            f"{name} chains over 2 ranks: samples differ from one "
            f"process's without a mesh")
        assert np.array_equal(acc, acc1), f"{name} chains: accept stats"
        for k in info:
            assert np.array_equal(info[k], info1[k]), f"{name} chains: {k}"
        assert s.shape[0] == 2 and not np.array_equal(s[0], s[1]), (
            f"{name} chains: the two chains must differ")
    try:
        jax_shard_chains(jax_make_mesh(num_devices=2), None, 3,
                         jnp.zeros((3, 1)))
    except ValueError as e:
        jax_error = ("ValueError", str(e))
    assert out["shard_chains 3"] == jax_error, (
        f"shard_chains: {out['shard_chains 3']} vs JAX {jax_error}")


# summary and with_config (utils/modules.py) against the JAX functions

def _printed_unit(s):
    """The unit of the last printed digit of a number as the table prints
    it ('0.2671' -> 1e-4, '2e-06' -> 1e-6)."""
    mant, _, exp = s.lower().partition("e")
    places = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (int(exp or 0) - places)


def _same_table(case, got, want):
    """``summary`` tables letter for letter, except that a number in the
    value column may differ by one unit in its last printed digit (the
    port applies each bijector in torch, the JAX package in XLA: the
    constrained values can differ in their last bit, and a digest that
    rounds there can print one unit apart)."""
    import re
    if got == want:
        return
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines), f"summary {case}: rows\n{got}"
    number = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")
    for g, w in zip(g_lines[2:], w_lines[2:]):
        gf, wf = re.split(r"  +", g.strip()), re.split(r"  +", w.strip())
        assert gf[:-1] == wf[:-1], f"summary {case}:\n{g}\nvs JAX\n{w}"
        gn, wn = number.findall(gf[-1]), number.findall(wf[-1])
        assert number.sub("#", gf[-1]) == number.sub("#", wf[-1]) and len(
            gn) == len(wn), f"summary {case}:\n{g}\nvs JAX\n{w}"
        for a, b in zip(gn, wn):
            unit = max(_printed_unit(a), _printed_unit(b))
            assert abs(float(a) - float(b)) <= 1.0001 * unit, (
                f"summary {case}: {a} vs JAX {b} (more than one unit of "
                f"the last printed digit)\n{g}\nvs JAX\n{w}")
    assert re.split(r"  +", g_lines[0].strip()) == re.split(
        r"  +", w_lines[0].strip()), f"summary {case}: header"


def _summary_models(rng):
    """(name, JAX model, port model) for the summary cases, the port's
    carried over by ``load_reference_state``."""
    from doubly_stochastic_dgp_tpu.models.layers import SGPRLayer as JSGPR
    N, D, M = 24, 3, 6
    X = rng.randn(N, D)
    Y = np.sin(X[:, :1]) + 0.1 * rng.randn(N, 1)
    Z = X[:M]
    cfg = port.Config(jitter=1e-6)

    def carried(jm, tm):
        return port.load_reference_state(tm, _jax_state(jm))

    def moved(jm):
        layers = []
        for layer in jm.layers:
            Mi, Do = layer.q_mu.value.shape
            q_sqrt = np.tril(rng.randn(Do, Mi, Mi) * 0.2) + 0.4 * np.eye(Mi)
            layers.append(layer.replace(
                q_mu=layer.q_mu.with_value(rng.randn(Mi, Do) * 0.5),
                q_sqrt=layer.q_sqrt.with_value(q_sqrt)))
        return jm.replace(layers=layers)

    out = []
    with temp_config(jitter=1e-6, solve_mode="solve", use_pallas=False):
        jm = moved(dsd.DGP.build(
            X, Y, Z, [dsd.RBF.make(D) + dsd.White.make(D, variance=2e-6,
                                                     trainable=False),
                      dsd.RBF.make(D, lengthscales=1.3)],
            dsd.Gaussian.make(0.05), num_samples=2))
        tm = carried(jm, port.DGP.build(
            X, Y, Z, [port.RBF(D) + port.White(D, variance=2e-6,
                                               trainable=False),
                      port.RBF(D)], port.Gaussian(1.0), num_samples=2,
            config=cfg, device="cpu"))
        out += [("headline DGP", jm, tm),
                ("precompute'd DGP", dsd.precompute(jm),
                 port.precompute(tm))]
        layers = dsd.init_layers_linear(X, Y, Z, [dsd.RBF.make(D),
                                                  dsd.RBF.make(D)])
        top = layers[-1]
        jc = dsd.DGPCollapsed.make(X, Y, dsd.Gaussian.make(0.05), [
            layers[0].replace(q_mu=layers[0].q_mu.with_value(
                rng.randn(M, D) * 0.3)),
            JSGPR.make(top.kern, np.asarray(top.Z.value), 1,
                       top.mean_function)])
        out.append(("DGPCollapsed", jc, carried(jc, port.DGPCollapsed.build(
            X, Y, Z, [port.RBF(D), port.RBF(D)], port.Gaussian(1.0),
            config=cfg, device="cpu"))))
        jd = dsd.DGPDamianou.build(X, Y, Z, [dsd.RBF.make(D),
                                             dsd.RBF.make(2)],
                                   dsd.Gaussian.make(0.05))
        jd = jd.replace(h_var=[p.with_value(np.exp(rng.randn(N, 2)) * 0.05)
                               for p in jd.h_var])
        out.append(("DGPDamianou", jd, carried(jd, port.DGPDamianou.build(
            X, Y, Z, [port.RBF(D), port.RBF(2)], port.Gaussian(1.0),
            config=cfg, device="cpu"))))
        js = dsd.SGPR.build(X, Y, dsd.RBF.make(D, lengthscales=0.7), Z,
                            noise_variance=0.1)
        out.append(("SGPR", js, carried(js, port.SGPR.build(
            X, Y, port.RBF(D), Z, config=cfg, device="cpu"))))
    jm, tm, _, _ = _sgpmc_pair(rng)
    out.append(("SGPMCLayer stack (Gaussian prior)", jm, tm))
    return out


def _check_summary():
    """``summary`` of six models letter for letter against the JAX
    ``summary`` (:func:`_same_table`); buffers left out."""
    rng = np.random.RandomState(81)
    for name, jm, tm in _summary_models(rng):
        _same_table(name, port.summary(tm), dsd.summary(jm))
        if name.startswith("SGPMC"):
            assert "gaussian(0.0, 1.0)" in port.summary(tm), (
                f"summary {name}: no prior column")


def _fused_layer_model():
    """tests/test_fused_layer.py's model (N=48, D=3, M=10, RBF + White,
    RBF, S=3) in both packages, with its loss at zero draws."""
    rng = np.random.RandomState(0)
    N, D, M = 48, 3, 10
    X = rng.rand(N, D)
    Y = np.sin(X.sum(1, keepdims=True))
    Z = X[:M].copy()
    jm = dsd.DGP.build(X, Y, Z, [
        dsd.RBF.make(D, lengthscales=0.6) + dsd.White.make(D,
                                                           variance=2e-6),
        dsd.RBF.make(D, lengthscales=0.6)], dsd.Gaussian.make(0.05),
        num_samples=3)
    tm = port.DGP.build(X, Y, Z, [port.RBF(D) + port.White(D),
                                  port.RBF(D)], port.Gaussian(1.0),
                        num_samples=3, config=port.Config(), device="cpu")
    return jm, port.load_reference_state(tm, _jax_state(jm))


def _jax_det_loss(m):
    zs = [jnp.zeros((3, 1, l.num_outputs)) for l in m.layers]
    _, Fm, Fv = m.propagate(m.X_data, zs=zs, S=3)
    ve = m.likelihood.variational_expectations(Fm[-1], Fv[-1], m.Y_data)
    KL = sum((l.KL() for l in m.layers), jnp.zeros((), ve.dtype))
    return -(jnp.sum(jnp.mean(ve, 0)) - KL)


def _port_det_loss(m):
    zs = [torch.zeros((3, 1, l.num_outputs), dtype=torch.float64)
          for l in m.layers]
    _, Fm, Fv = m.propagate(m.X_data, zs=zs, S=3)
    ve = m.likelihood.variational_expectations(Fm[-1], Fv[-1], m.Y_data)
    KL = sum(l.KL() for l in m.layers)
    return -(torch.sum(torch.mean(ve, 0)) - KL)


def _port_value_and_grads(m, loss):
    params = dict(m.named_parameters())
    value = loss(m)
    grads = torch.autograd.grad(value, list(params.values()),
                                allow_unused=True)
    return value.item(), {n: (torch.zeros_like(p) if g is None else g)
                          for (n, p), g in zip(params.items(), grads)}


def _check_with_config():
    """``with_config``: the fused routes (``use_pallas`` True and 'saved'
    with ``solve_mode='inverse'``) give the loss and gradients of JAX's
    with-configured model at zero draws (tests/test_fused_layer.py:32-46's
    tolerances); ``remat=True`` on a DGP and on a ``pp_stack``ed model gives
    the same value and gradients (rtol 1e-12, as tests/test_pp.py:285-306);
    'auto' raises naming fused_conditional; an unknown name is ignored;
    a ``fit`` step on the copy leaves the original bit for bit; the
    original keeps its own route."""
    import tempfile

    import torch.distributed as dist
    from doubly_stochastic_dgp_tpu import with_config as jax_with_config
    from doubly_stochastic_dgp_tpu_torch.parallel import mesh as pm
    from doubly_stochastic_dgp_tpu_torch.parallel import pp as ppp

    jm, tm = _fused_layer_model()
    oracle = jax.jit(jax.value_and_grad(_jax_det_loss))
    for route in (True, "saved"):
        case = f"with_config solve_mode='inverse', use_pallas={route!r}"
        jc = jax_with_config(jm, solve_mode="inverse", use_pallas=route)
        tc_ = port.with_config(tm, solve_mode="inverse", use_pallas=route)
        assert all(l.use_pallas == route and l.solve_mode == "inverse"
                   for l in tc_.layers), f"{case}: fields not replaced"
        assert all(l.use_pallas is False and l.solve_mode == "solve"
                   for l in tm.layers), f"{case}: the original changed"
        want, jgrads = oracle(jc)
        n = fused_conditional_saved.launches if route == "saved" else 0
        got, grads = _port_value_and_grads(tc_, _port_det_loss)
        assert_allclose(got, float(want), rtol=1e-9, err_msg=case)
        _close_grads(case, grads, jgrads, rtol=1e-6, atol=1e-10)
        assert fused_conditional_saved.launches == n, case
    base = _port_value_and_grads(tm, _port_det_loss)
    for bad in ("auto", "auto_saved"):
        try:
            _port_det_loss(port.with_config(tm, use_pallas=bad))
        except ValueError as e:
            assert "fused_conditional" in str(e), (
                f"with_config use_pallas={bad!r}: message {e}")
        else:
            raise AssertionError(f"with_config use_pallas={bad!r} did not "
                                 f"raise at evaluation")
    same = port.with_config(tm, no_such_field=1.0)
    assert not any(hasattr(m, "no_such_field") for m in same.modules()), (
        "with_config: an unknown name was set")
    assert port.summary(same) == port.summary(tm), (
        "with_config: an unknown name changed the model")

    # remat: a DGP, and a pp_stack'ed one on a one-rank gloo stage mesh
    remat = port.with_config(tm, remat=True)
    assert remat.remat and not tm.remat, "with_config remat: flags"
    got = _port_value_and_grads(remat, lambda m: -m.elbo(zs=[
        torch.as_tensor(np.random.RandomState(3).randn(3, 48, d))
        for d in (3, 1)]))
    want = _port_value_and_grads(tm, lambda m: -m.elbo(zs=[
        torch.as_tensor(np.random.RandomState(3).randn(3, 48, d))
        for d in (3, 1)]))
    _close_remat("with_config remat=True DGP", got, want)
    with tempfile.TemporaryDirectory() as tmp:
        pm.initialize_distributed(f"file://{tmp}/store", 1, 0,
                                  backend="gloo", device="cpu")
        try:
            mesh = pm.make_mesh(axis="stage")
            r = np.random.RandomState(4)
            X1 = r.rand(16, 1)
            m1 = port.DGP.build(X1, np.sin(3 * X1), X1[:4],
                                [port.RBF(1), port.RBF(1), port.RBF(1)],
                                port.Gaussian(0.1), num_samples=2,
                                config=port.Config(), device="cpu")
            zs = torch.as_tensor(r.randn(2, 2, 16, 1))    # the trunk's
            ms = ppp.pp_stack(m1, split_final=True)
            ms_r = port.with_config(ms, remat=True)
            assert ms_r.remat and not ms.remat, "with_config pp remat: flags"

            def pp_loss(m):
                return -ppp.pp_elbo(m, m1.X_data, m1.Y_data, None, mesh,
                                    n_micro=2, zs=zs)
            _close_remat("with_config remat=True pp_stack",
                         _port_value_and_grads(ms_r, pp_loss),
                         _port_value_and_grads(ms, pp_loss))
        finally:
            dist.destroy_process_group()

    # training the copy leaves the original as it was
    before = {n: t.clone() for n, t in tm.state_dict().items()}
    copy_ = port.with_config(tm, solve_mode="inverse", use_pallas=True)
    port.fit(copy_, 2, learning_rate=0.05, log_every=1)
    for n, t in tm.state_dict().items():
        assert torch.equal(t, before[n]), (
            f"with_config: training the copy changed the original's {n}")
    assert not torch.equal(copy_.layers[0].Z.unconstrained,
                           tm.layers[0].Z.unconstrained), (
        "with_config: the copy did not train")
    assert _port_value_and_grads(tm, _port_det_loss)[0] == base[0], (
        "with_config: the original's route changed")


def _close_remat(case, got, want):
    assert_allclose(got[0], want[0], rtol=1e-12, err_msg=f"{case}: value")
    assert got[1].keys() == want[1].keys(), f"{case}: parameter names"
    for n in want[1]:
        assert_allclose(got[1][n].numpy(), want[1][n].numpy(), rtol=1e-12,
                        atol=1e-15, err_msg=f"{case}: gradient {n}")


def _check_forward_cases():
    """The plain forward and the wrapper on the CPU against the JAX
    reference and the interpret-mode Pallas kernel, case by case."""
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


@contextlib.contextmanager
def _fresh_jax_programs():
    """JAX's persistent compile cache off (``tests/conftest.py`` points it
    at ``~/.cache/jax_comp_cache``, which keeps programs compiled in
    earlier runs, possibly for another CPU) and the in-memory caches
    cleared, so that the oracles inside are compiled here, for this
    machine; the setting is restored after, for the other files on the
    same worker."""
    from jax.experimental.compilation_cache import compilation_cache as cc
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        cc.reset_cache()


def test_fused_conditional_plain_matches_jax():
    for f in (fused_conditional, fused_conditional_saved):
        f.launches = f.backward_launches = 0
    tpsi2.psi2_core.launches = tpsi2.psi2_core.backward_launches = 0
    tgram.rbf_gram.launches = 0
    with _fresh_jax_programs():
        _check_forward_cases()
    _check_gradients()
    _check_plans()
    _check_psi2_limits()
    _check_psi2()
    _check_psi2_symmetric()
    _check_psi2_forward_plan()
    _check_psi2_backward()
    _check_psi2_backward_plan()
    _check_psi2_onepass()
    _check_rbf_gram()
    _check_gram_args()
    _check_timing()
    _check_mcmc()
    _check_parallel()
    _check_summary()
    _check_with_config()
    assert _counts() == (0, 0, 0, 0, 0, 0, 0), (
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
