#!/usr/bin/env python3
"""The fused conditional's backward against another checkout's, on one
NVIDIA GPU: bit for bit, and in turns by CUDA-graph replays.

    python3 tools/backward_bitwise.py --against CHECKOUT

Builds the checkout's backward (its ``csrc/fused_conditional_bwd.cu`` and
headers) into ``build/backward_bitwise/`` (ignored by git) and loads its
``ops/cuda/conditional.py`` under another module name, with its own C
binding and launch plan; this tree's backward runs through the package.
On chip_smoke.py's operands (seed 0) at phase 1's wide cases (Dx = 9, 30
and 784 at B = 1, 41 and 1000; Dx = 785; Dx = 784 at M = 37, B = 41) and
at the MNIST layers' shapes ((1000, 100, Dx, Do) at (784, 30), (30, 30),
(30, 10) and (784, 15)), in both forms (the gram recomputed, and read from
the saved forward's), it compares the seven gradients of the two trees by
their 32-bit patterns (so -0 and +0 differ), and this tree's with dX formed
in the row pass against dX on the reduction's tiles.  Then it times both
trees' backward in turns (ms a call by CUDA-graph replays,
chip_smoke.graph_calls_ms, in the order a b b a) at the MNIST shapes and
the headline training layer (10000, 100, 8, 8), and this tree's two dX
forms at Dx = 1, 2, 4, 8, 16, 30 and 784.  Exits 1 if a bit differs.  Not used by
the package; the record that the backward's redesigns keep its bits
(PERF.md §6).
"""

import argparse
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys
import time
import types
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NAMES = ("dXs", "dZs", "dLiT", "dalpha", "dW", "dkvar", "dkdiag")
# (case, B, M, Dx, Do): phase 1's wide cases, then the MNIST layers'
WIDE_CASES = [("Dx9_B1", 1, 100, 9, 8), ("Dx9_B41", 41, 100, 9, 8),
              ("Dx9_B1000", 1000, 100, 9, 8), ("Dx30_B1", 1, 100, 30, 8),
              ("Dx30_B41", 41, 100, 30, 8), ("Dx30_B1000", 1000, 100, 30, 8),
              ("Dx784_B1", 1, 100, 784, 8), ("Dx784_B41", 41, 100, 784, 8),
              ("Dx784_B1000", 1000, 100, 784, 8),
              ("Dx785_B1000", 1000, 100, 785, 8),
              ("Dx784_M37_B41", 41, 37, 784, 8)]
MNIST_CASES = [("mnist layer0_Dx784_Do30", 1000, 100, 784, 30),
               ("mnist hidden_Dx30_Do30", 1000, 100, 30, 30),
               ("mnist last_Dx30_Do10", 1000, 100, 30, 10),
               ("mnist outdim_Dx784_Do15", 1000, 100, 784, 15)]
TIMED = MNIST_CASES + [("headline", 10000, 100, 8, 8)]
# (B, M, Dx, Do) at which dX's two forms are timed: DGPQuad's layer 1
# (B = 100,000, Dx = 1), narrow inputs at the headline's B, the MNIST layers
DX_FORMS_TIMED = [(100000, 100, 1, 1), (10000, 100, 2, 8),
                  (10000, 100, 4, 8), (10000, 100, 8, 8),
                  (10000, 100, 16, 8), (1000, 100, 30, 30),
                  (1000, 100, 30, 10), (1000, 100, 784, 30)]


class _NoOp:
    """Stands for torch.library.custom_op's result while the other
    checkout's module is loaded (its forward op has this tree's name)."""

    def __init__(self, fn):
        self.fn = fn

    def register_fake(self, fn):
        return fn


def load_against(path, build):
    """(the checkout's conditional module, its ptxas output): its backward
    compiled with this tree's flags, its module bound to that library."""
    csrc = os.path.join(path, "doubly_stochastic_dgp_tpu_torch", "csrc")
    d = os.path.join(ROOT, "build", "backward_bitwise", "against")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    so = os.path.join(d, "fused_conditional_bwd.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                           os.path.join(d, "fused_conditional_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(so)
    pkg = types.ModuleType("against_cuda")
    pkg.__path__ = []
    shim = types.ModuleType("against_cuda.build")

    def load_library(name):
        if name != "fused_conditional_bwd":
            raise RuntimeError(f"backward_bitwise: {path} runs only its "
                               f"backward, not {name}")
        return lib

    shim.load_library = load_library
    sys.modules["against_cuda"] = pkg
    sys.modules["against_cuda.build"] = shim
    spec = importlib.util.spec_from_file_location(
        "against_cuda.conditional", os.path.join(
            path, "doubly_stochastic_dgp_tpu_torch", "ops", "cuda",
            "conditional.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["against_cuda.conditional"] = mod
    import torch
    with mock.patch.object(torch.library, "custom_op",
                           lambda *a, **k: _NoOp):
        spec.loader.exec_module(mod)
    return mod, proc.stdout + proc.stderr


def dx_form(conditional, in_rows):
    """This tree's backward with dX in the row pass or on the tiles."""
    return mock.patch.object(conditional, "DX_IN_ROWS_MAX",
                             10 ** 9 if in_rows else 0)


def same_bits(got, want):
    """Per gradient, whether the two agree in every 32-bit pattern."""
    import torch
    return [g.shape == w.shape and torch.equal(
        g.contiguous().view(torch.int32), w.contiguous().view(torch.int32))
        for g, w in zip(got, want)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True,
                        help="a checkout (git archive of a commit, say)")
    args_ = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("backward_bitwise: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from doubly_stochastic_dgp_tpu_torch.ops.cuda import build, conditional
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    for name, out in build.build_all().items():
        cs.print_kernel_resources(f"this tree: {name}", out)
    other, out = load_against(args_.against, build)
    cs.print_kernel_resources(f"{args_.against}: fused_conditional_bwd",
                              out)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    def call(mod, a, km, kv, gm, gv, K):
        return mod.fused_conditional_backward(*a, km, kv, gm, gv, K)

    failed = []
    operands = {}
    for case, B, M, Dx, Do in WIDE_CASES + MNIST_CASES:
        a = cs.conditional_inputs(B, M, Dx, Do, 0, False, cs.wide_spread(Dx))
        gm, gv = cs.cotangents(B, Do, 0)
        with torch.no_grad():
            km, kv, K = conditional.fused_conditional_forward(
                *a, save_gram=True)
            for form, Kin in (("recompute", None), ("saved", K)):
                mine = call(conditional, a, km, kv, gm, gv, Kin)
                theirs = call(other, a, km, kv, gm, gv, Kin)
                with dx_form(conditional, not conditional.backward_plan(
                        B, M, Dx, Do)["dx_in_rows"]):
                    flipped = call(conditional, a, km, kv, gm, gv, Kin)
                torch.cuda.synchronize()
                vs_other, vs_form = (same_bits(mine, theirs),
                                     same_bits(flipped, mine))
                print(f"bitwise {case} (B={B} M={M} Dx={Dx} Do={Do}) {form}:"
                      f" against {args_.against} "
                      + ", ".join(f"{n} {s}" for n, s in zip(NAMES, vs_other))
                      + "; dX in the row pass against its tiles "
                      + ", ".join(f"{n} {s}" for n, s in zip(NAMES, vs_form)),
                      flush=True)
                if not (all(vs_other) and all(vs_form)):
                    failed.append(f"{case} {form}")
        operands[case] = (a, km, kv, gm, gv, K)

    for case, B, M, Dx, Do in TIMED:
        if case not in operands:
            a = cs.conditional_inputs(B, M, Dx, Do, 0, False,
                                      cs.wide_spread(Dx))
            gm, gv = cs.cotangents(B, Do, 0)
            with torch.no_grad():
                km, kv, K = conditional.fused_conditional_forward(
                    *a, save_gram=True)
            operands[case] = (a, km, kv, gm, gv, K)
        a, km, kv, gm, gv, K = operands[case]
        for form, Kin in (("recompute", None), ("saved", K)):
            times = {"against": [], "this tree": []}
            with torch.no_grad():
                for who in ("against", "this tree", "this tree", "against"):
                    mod = other if who == "against" else conditional
                    times[who].append(cs.graph_calls_ms(
                        lambda: call(mod, a, km, kv, gm, gv, Kin)))
            print(f"timing backward {case} (B={B} M={M} Dx={Dx} Do={Do}) "
                  f"{form}: ms a call by CUDA-graph replays, "
                  + "; ".join(f"{w} {' / '.join(f'{t:.4f}' for t in ts)}"
                              for w, ts in times.items())
                  + f" [{card}]", flush=True)
        del operands[case]
    for B, M, Dx, Do in DX_FORMS_TIMED:
        a = cs.conditional_inputs(B, M, Dx, Do, 0, False, cs.wide_spread(Dx))
        gm, gv = cs.cotangents(B, Do, 0)
        times = {True: [], False: []}
        with torch.no_grad():
            km, kv = conditional.fused_conditional_forward(*a)[:2]
            for in_rows in (True, False, False, True):
                with dx_form(conditional, in_rows):
                    times[in_rows].append(cs.graph_calls_ms(
                        lambda: call(conditional, a, km, kv, gm, gv, None)))
        rows, tiles = (" / ".join(f"{t:.4f}" for t in times[f])
                       for f in (True, False))
        plan = conditional.backward_plan(B, M, Dx, Do)
        print(f"timing dX forms B={B} M={M} Dx={Dx} Do={Do}: ms a call by "
              f"CUDA-graph replays, in the row pass {rows}; on the "
              f"reduction's tiles {tiles} (the plan's: "
              f"{'row pass' if plan['dx_in_rows'] else 'tiles'}) [{card}]",
              flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s; "
          + (f"bits differ at {failed}" if failed else
             "every gradient bit for bit"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
