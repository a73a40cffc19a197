#!/usr/bin/env python3
"""The fused conditional's row kernels built four ways, side by side, on
one NVIDIA GPU: as committed (the forward at two blocks an SM, the
products' k sums in blocks of 16), the forward at three blocks an SM
(``__launch_bounds__(256, 3)``, 80 registers), the k sums as one FFMA
chain in both row kernels, and both; and as the sources of each other
checkout named by ``--against`` build them (a parent unpacked by ``git
archive``, say; its C entry points must take this tree's arguments:
tools/backward_bitwise.py holds an older one against this tree).

    python3 tools/gram_stage_variants.py [--against CHECKOUT ...]

Prints each variant's registers and spills (ptxas), its resident blocks an SM
at M=100, the forward's and backward's float32 error against float64 beside
the plain float32 version's at one-row wide cases (phase 1's gate is 2x the
plain version's), and their device times in turns (ms a call by CUDA-graph
replays, chip_smoke.graph_calls_ms; each variant twice, in the order a b c d d
c b a) at the headline and MNIST shapes (the backward at B <= 10,000); then
``rbf_gram`` at the wide shapes against its plain version, beside the fp32
issue floor of its distance sums in the Kahan and the blocked order.  The
variants are compiled into ``build/gram_stage_variants/`` (ignored by git).
Not used by the package; the record of why the kernels are built as they are
(PERF.md §6).
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BOUNDS = ("__launch_bounds__(kThreads, 2)\nfused_conditional_fwd_kernel",
          "__launch_bounds__(kThreads, 3)\nfused_conditional_fwd_kernel")
CHAIN = ("ffma_slice_blocked(", "ffma_slice(")
VARIANTS = {"as built": [], "3 blocks an SM": [BOUNDS],
            "one k chain": [CHAIN], "one k chain, 3 blocks an SM":
            [CHAIN, BOUNDS]}
SOURCES = ("fused_conditional", "fused_conditional_bwd")


def issue_floor_ms(terms, per_term):
    """The least time of ``terms`` distance terms at ``per_term`` fp32
    instructions each, at the card's fp32 issue rate (FP32_PEAK / 2: an
    FFMA counts two flops).  Kahan on every term takes 5 (the difference,
    the FMA of the square with the compensation, three adds); the blocked
    order 2 (the difference and an FFMA), its chunk totals aside."""
    import chip_smoke as cs
    return 1e3 * terms * per_term / (cs.FP32_PEAK / 2)


def build_variants(cs, build, conditional, against):
    """Compile every variant, and the row kernels of each checkout in
    ``against`` (all nvcc processes at once); returns {variant: (forward
    entry point, backward entry point, resident forward blocks an SM at
    M=100)}."""
    out_dir = os.path.join(ROOT, "build", "gram_stage_variants")
    variants = {n: (build.CSRC, e) for n, e in VARIANTS.items()}
    for a in against:
        variants[f"sources of {a}"] = (os.path.join(
            a, "doubly_stochastic_dgp_tpu_torch", "csrc"), [])
    procs = {}
    for i, (name, (src, edits)) in enumerate(variants.items()):
        d = os.path.join(out_dir, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        for f in SOURCES:
            path = os.path.join(d, f + ".cu")
            text = open(path).read()
            for a, b in edits:
                if f == "fused_conditional" or a == CHAIN[0]:
                    assert a in text, (name, f, a)
                    text = text.replace(a, b)
            open(path, "w").write(text)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
                   os.path.join(d, f + ".so"), path]
            procs[(name, f)] = (d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (name, f), (d, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {f}:\n{out}")
        cs.print_kernel_resources(f"{name}: {f}", out)
    for i, name in enumerate(variants):
        d = os.path.join(out_dir, str(i))
        fl = ctypes.CDLL(os.path.join(d, "fused_conditional.so"))
        fw = conditional._bind_fwd(fl)
        bw = conditional._bind_bwd(ctypes.CDLL(
            os.path.join(d, "fused_conditional_bwd.so")))
        occ = fl.fused_conditional_fwd_occupancy
        occ.argtypes = [ctypes.c_int] * 3
        libs[name] = (fw, bw, occ(100, 0, 1))
    return libs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", nargs="*", default=[],
                        help="checkouts whose row kernels to time too")
    args_ = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gram_stage_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from doubly_stochastic_dgp_tpu_torch.ops.cuda import (build,
                                                          conditional, gram)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    libs = build_variants(cs, build, conditional, args_.against)
    print(f"variants built in {time.perf_counter() - t0:.1f} s; resident "
          "forward blocks an SM at M=100: " + ", ".join(
              f"{v} {libs[v][2]}" for v in libs), flush=True)
    fwd_fn, bwd_fn = conditional._fwd_fn, conditional._bwd_fn

    def use(v):
        conditional._fwd_fn = lambda: libs[v][0]
        conditional._bwd_fn = lambda: libs[v][1]

    try:
        for case, B, Dx in (("Dx9_B1", 1, 9), ("Dx30_B1", 1, 30),
                            ("Dx784_B1", 1, 784), ("Dx30_B41", 41, 30),
                            ("Dx784_B1000", 1000, 784)):
            args = cs.conditional_inputs(B, cs.M, Dx, 8, 0, False,
                                         cs.wide_spread(Dx))
            a64 = [a.double() for a in args]
            gm, gv = cs.cotangents(B, 8, 0)
            with torch.no_grad():
                pm, pv, _ = cs.fused_conditional_saved_plain(*args)
                rm, rv, _ = cs.fused_conditional_saved_plain(*a64)
                for v in libs:
                    use(v)
                    km, kv = cs.fused_conditional_forward(*args)[:2]
                    e = cs.compare((km, kv), (pm, pv), (rm, rv), True)
                    kg = cs.fused_conditional_backward(*args, km, kv, gm, gv)
                    pg = cs.fused_conditional_backward_plain(*args, km, kv,
                                                             gm, gv)
                    rg = cs.fused_conditional_backward_plain(
                        *a64, km.double(), kv.double(), gm.double(),
                        gv.double())
                    eb = cs.compare(kg, pg, rg, False)
                    print(f"precision {case} {v}: forward {e[2]:.3e} "
                          f"(plain {e[3]:.3e}, ratio {e[2] / e[3]:.2f}); "
                          f"backward {eb[2]:.3e} (plain {eb[3]:.3e}, ratio "
                          f"{eb[2] / eb[3]:.2f})", flush=True)
        order = list(libs) + list(libs)[::-1]
        for B, M_, Dx, Do in ((10000, 100, 8, 8), (100000, 100, 8, 8),
                              (1000, 100, 784, 30), (1000, 100, 30, 30),
                              (100000, 100, 784, 30)):
            args = cs.conditional_inputs(B, M_, Dx, Do, 0, False,
                                         cs.wide_spread(Dx))
            gm, gv = cs.cotangents(B, Do, 0)
            fwd = {v: [] for v in libs}
            bwd = {v: [] for v in libs}
            big = B * Dx > 10 ** 7   # tens of ms a call: fewer replays
            with torch.no_grad():
                km, kv = cs.fused_conditional_forward(*args)[:2]
                for v in order:
                    use(v)
                    fwd[v].append(cs.graph_calls_ms(
                        lambda: cs.fused_conditional_forward(*args),
                        *((2, 2, 3) if big else ())))
                    if B <= 10000:
                        bwd[v].append(cs.graph_calls_ms(
                            lambda: cs.fused_conditional_backward(
                                *args, km, kv, gm, gv)))
            print(f"timing B={B} M={M_} Dx={Dx} Do={Do} forward ms: "
                  + "; ".join(f"{v} {' / '.join(f'{t:.4f}' for t in ts)}"
                              for v, ts in fwd.items())
                  + ("" if B > 10000 else " | backward ms: " + "; ".join(
                      f"{v} {' / '.join(f'{t:.4f}' for t in ts)}"
                      for v, ts in bwd.items())) + f" [{card}]", flush=True)
    finally:
        conditional._fwd_fn, conditional._bwd_fn = fwd_fn, bwd_fn
    for N, D in ((None, 784), (1000, 784), (None, 30), (1000, 30),
                 (100000, 784)):
        Z = torch.randn(100, D, device="cuda") / D ** 0.5
        X = Z if N is None else torch.randn(N, D, device="cuda") / D ** 0.5
        ls = torch.rand(D, device="cuda") + 1.0
        var = torch.tensor(1.3, device="cuda")
        plan = gram.launch_plan(X.shape[0], 100, D)
        with torch.no_grad():
            k = cs.event_ms(lambda: gram.rbf_gram_kernel(X, Z, ls, var))
            p = cs.event_ms(lambda: gram.rbf_gram_plain(X, Z, ls, var))
            g = cs.graph_calls_ms(lambda: gram.rbf_gram_kernel(X, Z, ls,
                                                               var))
        kahan, blocked = (issue_floor_ms(X.shape[0] * 100 * D, n)
                          for n in (5, 2))
        print(f"timing rbf_gram N={X.shape[0]} M=100 D={D} ({plan['grid']} "
              f"blocks, {plan['splits']} splits): kernel {k:.4f} ms by "
              f"events, {g:.4f} ms by graph replays; plain {p:.4f} ms; "
              f"fp32 issue floor of the distance sums: Kahan {kahan:.4f} ms, "
              f"blocked {blocked:.4f} ms [{card}]", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
