#!/usr/bin/env python3
"""The fused conditional's forward and backward against another checkout's,
on one NVIDIA GPU: bit for bit, and in turns by CUDA-graph replays.

    python3 tools/backward_bitwise.py --against CHECKOUT

Builds the checkout's forward and backward (its ``csrc/fused_conditional.cu``,
``csrc/fused_conditional_bwd.cu`` and headers) into
``build/backward_bitwise/`` (ignored by git) and loads its
``ops/cuda/conditional.py`` under another module name, with its own C
bindings and launch plans; this tree's kernels run through the package.
On chip_smoke.py's operands (seed 0) at phase 1's cases (``KERNEL_CASES``)
and at the MNIST layers' shapes ((1000, 100, Dx, Do) at (784, 30), (30,
30), (30, 10) and (784, 15)) it compares, by their 32-bit patterns (so -0
and +0 differ), the forward's mean and var and, in its save-gram form,
mean, var and K; and the backward's seven gradients in both forms (the
gram recomputed, and read from the saved forward's), and this tree's with
dX formed in the row pass against dX on the reduction's tiles.  Then it
times both trees' forward and backward in turns (ms a call by CUDA-graph
replays, chip_smoke.graph_calls_ms, in the order a b b a) at the MNIST
shapes, the headline training layer (10000, 100, 8, 8) and the serving
shape (100000, 100, 8, 8), and splits each tree's call by kernel (the
profiler's records of replayed graphs, each kernel's device ms over its
own records: the forward, the backward's row pass, its reduction and the
slice sum); and this tree's two dX forms at Dx = 1, 2, 4, 8, 16, 30 and
784.  ``--no-dx-forms`` skips the last.  ``--plans`` also runs this
tree's kernels at the MNIST shapes and two B where the plan's cluster
changes (``PLAN_EDGES``) under other launch plans of the row kernels
(``PLAN_SWEEP``: clusters of 1 to 8 blocks a row block), each against the rule's plan's outputs bit for
bit, and times them in turns (forward and backward, each plan twice, in
the order a b ... b a).  Exits 1 if a bit differs.  Not
used by the package; the record that the row kernels' redesigns keep
their bits (PERF.md §6).
"""

import argparse
import contextlib
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
FWD_NAMES = ("mean", "var", "K")
SOURCES = ("fused_conditional", "fused_conditional_bwd")
# (case, B, M, Dx, Do): the MNIST layers'
MNIST_CASES = [("mnist layer0_Dx784_Do30", 1000, 100, 784, 30),
               ("mnist hidden_Dx30_Do30", 1000, 100, 30, 30),
               ("mnist last_Dx30_Do10", 1000, 100, 30, 10),
               ("mnist outdim_Dx784_Do15", 1000, 100, 784, 15)]
TIMED = MNIST_CASES + [("headline", 10000, 100, 8, 8),
                       ("serving", 100000, 100, 8, 8)]
# the device kernels of a call, as torch.profiler names them
KERNELS = {"forward": ("fused_conditional_fwd_kernel",),
           "backward": ("fused_conditional_bwd_rows_kernel",
                        "fused_conditional_bwd_reduce_kernel",
                        "sum_slices_kernel")}
# launch plans of the row kernels timed with --plans: (name, blocks of a
# cluster in place of forward_plan's and backward_plan's rule)
PLAN_SWEEP = [("one block a row block", 1), ("clusters of 2", 2),
              ("clusters of 3", 3), ("clusters of 4", 4),
              ("clusters of 5", 5), ("clusters of 6", 6),
              ("clusters of 8", 8)]
# shapes beside the MNIST ones where --plans times PLAN_SWEEP: the last B of
# clusters of 4 at M=100 and the last with clusters (of 2)
PLAN_EDGES = [("cluster 4 B2640", 2640, 100, 8, 8),
              ("cluster 2 B5280", 5280, 100, 8, 8)]
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
    """(the checkout's conditional module, its ptxas output): its forward
    and backward compiled with this tree's flags, its module bound to
    those libraries."""
    csrc = os.path.join(path, "doubly_stochastic_dgp_tpu_torch", "csrc")
    d = os.path.join(ROOT, "build", "backward_bitwise", "against")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    procs = {n: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(d, n + ".so"),
         os.path.join(d, n + ".cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in SOURCES}
    libs, out = {}, ""
    for n, p in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path} {n}:\n{text}")
        out += text
        libs[n] = ctypes.CDLL(os.path.join(d, n + ".so"))
    pkg = types.ModuleType("against_cuda")
    pkg.__path__ = []
    shim = types.ModuleType("against_cuda.build")

    def load_library(name):
        if name not in libs:
            raise RuntimeError(f"backward_bitwise: {path} runs only its "
                               f"fused conditional, not {name}")
        return libs[name]

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
    return mod, out


def dx_form(conditional, in_rows):
    """This tree's backward with dX in the row pass or on the tiles."""
    return mock.patch.object(conditional, "DX_IN_ROWS_MAX",
                             10 ** 9 if in_rows else 0)


def same_bits(got, want):
    """Per output, whether the two agree in every 32-bit pattern."""
    import torch
    return [g.shape == w.shape and torch.equal(
        g.contiguous().view(torch.int32), w.contiguous().view(torch.int32))
        for g, w in zip(got, want)]


def forward(mod, a, save_gram):
    """A tree's forward kernel: (mean, var), or (mean, var, K)."""
    kvar, kdiag = mod._scalars(a[5], a[6], a[0])
    out = mod._forward_kernel(*a[:5], kvar, kdiag, save_gram)
    return out if save_gram else out[:2]


def backward(mod, a, km, kv, gm, gv, K):
    return mod.fused_conditional_backward(*a, km, kv, gm, gv, K)


@contextlib.contextmanager
def with_plan(conditional, cluster):
    """This tree's kernels with clusters of ``cluster`` blocks a row block
    in place of the plans' rule."""
    with mock.patch.object(conditional, "_cluster_size",
                           lambda *args: cluster):
        yield


def plan_sweep(cs, conditional, card):
    """PLAN_SWEEP at the MNIST shapes and PLAN_EDGES: each plan's outputs
    against the rule's bit for bit, then times in turns.  Returns the
    cases whose bits differ."""
    import torch
    failed = []
    for case, B, M, Dx, Do in MNIST_CASES + PLAN_EDGES:
        a = cs.conditional_inputs(B, M, Dx, Do, 0, False, cs.wide_spread(Dx))
        gm, gv = cs.cotangents(B, Do, 0)
        shape = f"{case} (B={B} M={M} Dx={Dx} Do={Do})"
        plans = [(n, c) for n, c in PLAN_SWEEP if c <= Do]
        with torch.no_grad():
            km, kv, K = forward(conditional, a, True)

            def outputs():
                return (*forward(conditional, a, True),
                        *backward(conditional, a, km, kv, gm, gv, None),
                        *backward(conditional, a, km, kv, gm, gv, K))

            want = outputs()
            calls = {"forward": lambda: forward(conditional, a, False),
                     "backward": lambda: backward(conditional, a, km, kv, gm,
                                                  gv, None)}
            times = {n: {w: [] for w in calls} for n, _ in plans}
            for name, over in plans:
                with with_plan(conditional, over):
                    same = same_bits(outputs(), want)
                torch.cuda.synchronize()
                print(f"plan {shape} {name}: every output bit for "
                      f"bit with the rule's plan {all(same)}", flush=True)
                if not all(same):
                    failed.append(f"plan {case} {name}")
            for name, over in plans + plans[::-1]:
                with with_plan(conditional, over):
                    for what, call in calls.items():
                        times[name][what].append(cs.graph_calls_ms(call))
            rule = conditional.forward_plan(B, M, Dx, Do)
            for name, over in plans:
                print(f"timing plans {shape} {name}: ms a call by CUDA-graph "
                      "replays, "
                      + "; ".join(f"{w} " + " / ".join(f"{t:.4f}" for t in ts)
                                  for w, ts in times[name].items())
                      + f" (the rule's plan: clusters of {rule['cluster']}, "
                      f"{rule['tb']} rows) [{card}]", flush=True)
        del a, gm, gv, km, kv, K
    return failed


def kernel_split_ms(cs, fn, names, calls=10, reps=5):
    """{kernel: device ms a launch} of ``fn`` (each kernel launched once a
    call): ``calls`` calls in one CUDA graph, replayed ``reps`` times under
    torch.profiler, each kernel's device time over its own records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    g = cs.capture_calls(fn, calls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            g.replay()
        torch.cuda.synchronize()
    del g
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    out = {}
    for n in names:
        found = [e for e in events if n in e.key]
        count = sum(e.count for e in found)
        out[n] = (sum(e.self_device_time_total for e in found) / count / 1e3
                  if count else None)
    return out


def fmt_split(split):
    return ", ".join(f"{k} " + ("not measured" if v is None else f"{v:.4f}")
                     for k, v in split.items())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True,
                        help="a checkout (git archive of a commit, say)")
    parser.add_argument("--no-dx-forms", action="store_true",
                        help="skip the timing of dX's two forms")
    parser.add_argument("--plans", action="store_true",
                        help="time the row kernels under PLAN_SWEEP")
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
    cs.print_kernel_resources(f"{args_.against}: fused_conditional", out)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    failed = []
    cases = [(c, B, M, Dx, Do, clamp)
             for c, B, M, Dx, Do, clamp in cs.KERNEL_CASES] + [
        (c, B, M, Dx, Do, False) for c, B, M, Dx, Do in MNIST_CASES]
    for case, B, M, Dx, Do, clamp in cases:
        a = cs.conditional_inputs(B, M, Dx, Do, 0, clamp, cs.wide_spread(Dx))
        gm, gv = cs.cotangents(B, Do, 0)
        shape = f"{case} (B={B} M={M} Dx={Dx} Do={Do})"
        with torch.no_grad():
            for save_gram in (False, True):
                mine = forward(conditional, a, save_gram)
                theirs = forward(other, a, save_gram)
                torch.cuda.synchronize()
                same = same_bits(mine, theirs)
                print(f"bitwise forward {shape} "
                      f"{'saved' if save_gram else 'plain'}: against "
                      f"{args_.against} "
                      + ", ".join(f"{n} {s}" for n, s in zip(FWD_NAMES,
                                                             same)),
                      flush=True)
                if not all(same):
                    failed.append(f"forward {case} {save_gram}")
            km, kv, K = forward(conditional, a, True)
            for form, Kin in (("recompute", None), ("saved", K)):
                mine = backward(conditional, a, km, kv, gm, gv, Kin)
                theirs = backward(other, a, km, kv, gm, gv, Kin)
                with dx_form(conditional, not conditional.backward_plan(
                        B, M, Dx, Do)["dx_in_rows"]):
                    flipped = backward(conditional, a, km, kv, gm, gv, Kin)
                torch.cuda.synchronize()
                vs_other, vs_form = (same_bits(mine, theirs),
                                     same_bits(flipped, mine))
                print(f"bitwise backward {shape} {form}: against "
                      f"{args_.against} "
                      + ", ".join(f"{n} {s}" for n, s in zip(NAMES, vs_other))
                      + "; dX in the row pass against its tiles "
                      + ", ".join(f"{n} {s}" for n, s in zip(NAMES, vs_form)),
                      flush=True)
                if not (all(vs_other) and all(vs_form)):
                    failed.append(f"backward {case} {form}")
        del a, gm, gv, km, kv, K

    if args_.plans:
        failed += plan_sweep(cs, conditional, card)
    for case, B, M, Dx, Do in TIMED:
        a = cs.conditional_inputs(B, M, Dx, Do, 0, False, cs.wide_spread(Dx))
        gm, gv = cs.cotangents(B, Do, 0)
        shape = f"{case} (B={B} M={M} Dx={Dx} Do={Do})"
        with torch.no_grad():
            km, kv, K = forward(conditional, a, True)
            calls = {"forward plain": lambda mod: forward(mod, a, False),
                     "forward saved": lambda mod: forward(mod, a, True),
                     "backward recompute": lambda mod: backward(
                         mod, a, km, kv, gm, gv, None),
                     "backward saved": lambda mod: backward(
                         mod, a, km, kv, gm, gv, K)}
            for what, call in calls.items():
                times = {"against": [], "this tree": []}
                for who in ("against", "this tree", "this tree", "against"):
                    mod = other if who == "against" else conditional
                    times[who].append(cs.graph_calls_ms(
                        lambda: call(mod)))  # noqa: B023
                names = KERNELS[what.split()[0]]
                split = {who: kernel_split_ms(
                    cs, lambda: call(other if who == "against"  # noqa: B023
                                     else conditional), names)
                    for who in times}
                print(f"timing {what} {shape}: ms a call by CUDA-graph "
                      "replays, "
                      + "; ".join(f"{w} {' / '.join(f'{t:.4f}' for t in ts)}"
                                  for w, ts in times.items())
                      + "; by kernel (profiled replays, ms a launch) "
                      + "; ".join(f"{w}: {fmt_split(s)}"
                                  for w, s in split.items())
                      + f" [{card}]", flush=True)
        del a, gm, gv, km, kv, K
    if not args_.no_dx_forms:
        for B, M, Dx, Do in DX_FORMS_TIMED:
            a = cs.conditional_inputs(B, M, Dx, Do, 0, False,
                                      cs.wide_spread(Dx))
            gm, gv = cs.cotangents(B, Do, 0)
            times = {True: [], False: []}
            with torch.no_grad():
                km, kv = forward(conditional, a, False)
                for in_rows in (True, False, False, True):
                    with dx_form(conditional, in_rows):
                        times[in_rows].append(cs.graph_calls_ms(
                            lambda: backward(conditional, a, km, kv, gm, gv,
                                             None)))
            rows, tiles = (" / ".join(f"{t:.4f}" for t in times[f])
                           for f in (True, False))
            plan = conditional.backward_plan(B, M, Dx, Do)
            print(f"timing dX forms B={B} M={M} Dx={Dx} Do={Do}: ms a call "
                  f"by CUDA-graph replays, in the row pass {rows}; on the "
                  f"reduction's tiles {tiles} (the plan's: "
                  f"{'row pass' if plan['dx_in_rows'] else 'tiles'}) "
                  f"[{card}]", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s; "
          + (f"bits differ at {failed}" if failed else
             "every output bit for bit"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
