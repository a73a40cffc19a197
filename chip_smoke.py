#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (doubly_stochastic_dgp_tpu_torch)
on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check:

0. the card's name and power limit (nvidia-smi), TF32 off, and a build of
   every CUDA kernel from the sources in this checkout;
1. every kernel against its plain PyTorch version at the serving path's
   per-layer shapes (and a ragged multi-tile, a clamp-active and an M=512
   shape), in float32, both also held against the plain version in
   float64 on the same inputs;
2. the serving path, live: a 5-layer DGP at the headline width
   (kin8nm-shaped synthetic data, N=8192 and D=8, M=100, RBF+White
   inner kernels, Gaussian likelihood 0.05, S=100) built with
   ``DGP.build`` on the card and served by ``make_server(precompute=
   False, batch_buckets=(128, 512, 1000))``: three requests (the 820-row
   test split, 1000 rows, 1300 rows in two chunks), with launch counts,
   shapes, finiteness, pinned-seed reproducibility, and agreement of the
   live and cached float32 paths with the port's float64 CPU path on a
   small input at fixed draws;
3. the cached server (``precompute=True``) on the same requests, and its
   distance from the live server at the same seeds;
4. timings with CUDA events (median of 30 launches): each kernel at the
   serving shapes, its plain version, its bound; per-request latency of
   the live and the cached servers;
5. a torch.profiler breakdown of a request's device time by kernel.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, it exits non-zero and prints no result.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from doubly_stochastic_dgp_tpu_torch import (  # noqa: E402
    DGP, RBF, Config, Gaussian, SyntheticRegression, White, make_server,
    precompute)
from doubly_stochastic_dgp_tpu_torch.ops.cuda import build  # noqa: E402
from doubly_stochastic_dgp_tpu_torch.ops.cuda.conditional import (  # noqa: E402
    flops, fused_conditional, fused_conditional_plain)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
FP32_PEAK = 67e12          # FLOP/s, fp32 outside the tensor cores
HBM_RATE = 3.35e12         # bytes/s
LAYERS, M, S = 5, 100, 100
BUCKETS = (128, 512, 1000)
# kernel vs plain float32 on the same inputs: both are float32 with
# different summation orders, so they may differ by float32 roundoff
# amplified by the staged products; relative to the output scale
KERNEL_VS_PLAIN_RTOL = 1e-4
# the live float32 path on the card vs the port's float64 CPU path on a
# small request (5 layers of float32 staging and cancellation)
F32_PATH_ATOL = 5e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps=30):
    """Median over ``reps`` warm runs, each timed with CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def conditional_inputs(B, M_, Dx, Do, seed, clamp=False):
    """float32 inputs on the card in the kernel's contract (staged LiT,
    symmetric W), drawn from a seeded numpy stream."""
    rng = np.random.RandomState(seed)
    LiT = np.eye(M_) + 0.1 * rng.randn(M_, M_)
    Wh = rng.randn(Do, M_, M_) * 0.1
    W = (Wh + np.swapaxes(Wh, 1, 2)) / 2
    if clamp:
        W = -np.einsum("dij,dkj->dik", Wh, Wh) * 20.0
    arrays = (rng.randn(B, Dx), rng.randn(M_, Dx), LiT,
              rng.randn(M_, Do) * 0.3, W, np.float64(1.4),
              np.float64(1.4 + 2e-6))
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def phase_kernels(seed):
    cases = [("serving_Do8", 100000, M, 8, 8, False),
             ("serving_Do1", 100000, M, 8, 1, False),
             ("ragged_multi_tile", 1300, 37, 8, 3, False),
             ("clamp_active", 4000, 50, 5, 3, True),
             ("M512", 513, 512, 3, 2, False)]
    worst = {"max_abs_err": 0.0, "err_vs_f64": 0.0, "plain_err_vs_f64": 0.0}
    for name, B, M_, Dx, Do, clamp in cases:
        args = conditional_inputs(B, M_, Dx, Do, seed, clamp)
        with torch.no_grad():
            km, kv = fused_conditional(*args)
            torch.cuda.synchronize()
            pm, pv = fused_conditional_plain(*args)
            rm, rv = fused_conditional_plain(*[a.double() for a in args])
        scale = max(rm.abs().max().item(), rv.abs().max().item(), 1.0)
        err = max((km - pm).abs().max().item(), (kv - pv).abs().max().item())
        e_k = max((km.double() - rm).abs().max().item(),
                  (kv.double() - rv).abs().max().item())
        e_p = max((pm.double() - rm).abs().max().item(),
                  (pv.double() - rv).abs().max().item())
        print(f"kernel fused_conditional {name} B={B} M={M_} Dx={Dx} "
              f"Do={Do}: |kernel-plain| {err:.3e}, kernel vs f64 "
              f"{e_k:.3e}, plain f32 vs f64 {e_p:.3e}, scale {scale:.3g}",
              flush=True)
        check(torch.isfinite(km).all() and torch.isfinite(kv).all(),
              f"{name}: kernel output not finite")
        check(err <= KERNEL_VS_PLAIN_RTOL * scale,
              f"{name}: kernel vs plain {err} > {KERNEL_VS_PLAIN_RTOL}*"
              f"{scale}")
        check(e_k <= 2.0 * e_p,
              f"{name}: kernel error vs f64 {e_k} > 2x the plain f32 "
              f"error {e_p}")
        if clamp:
            check(bool((kv == 0).any() and (kv > 0).any()
                       and (pv == 0).any()),
                  f"{name}: the variance clamp is not active")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["err_vs_f64"] = max(worst["err_vs_f64"], e_k)
        worst["plain_err_vs_f64"] = max(worst["plain_err_vs_f64"], e_p)
    return worst


# ---------------------------------------------------------------------------
# phase 2/3: the serving path
# ---------------------------------------------------------------------------

def build_model(seed, device="cuda", dtype=torch.float32):
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    X, Y = data["X"], data["Y"]
    rng = np.random.RandomState(seed)
    Z = X[rng.choice(X.shape[0], M, replace=False)]
    kernels = [RBF(8) + White(8, variance=2e-6, trainable=False)
               for _ in range(LAYERS - 1)] + [RBF(8)]
    cfg = Config(dtype=dtype, jitter=1e-5, solve_mode="inverse",
                 use_pallas=True)
    model = DGP.build(X, Y, Z, kernels, Gaussian(0.05), config=cfg,
                      device=device)
    # near-deterministic inner layers (reference run_regression.py), and a
    # random posterior mean so the posterior is not the prior
    for layer in model.layers[:-1]:
        layer.q_sqrt.set_value(layer.q_sqrt.value * 1e-5)
    for layer in model.layers:
        layer.q_mu.set_value(rng.randn(*layer.q_mu.value.shape) * 0.5)
    return model, data


def serve_all(serve, requests):
    out = [serve(x, seed=s) for s, x in requests]
    torch.cuda.synchronize()
    return out


def phase_serving(seed):
    model, data = build_model(seed)
    check(model.X_data.device.type == "cuda", "model not on the card")
    X = data["X"]
    requests = [(101, data["Xs"]), (102, X[:1000]), (103, X[1000:2300])]
    chunks = sum(-(-len(x) // BUCKETS[-1]) for _, x in requests)
    live = make_server(model, S=S, precompute=False, batch_buckets=BUCKETS)

    fused_conditional.launches = 0
    t0 = time.perf_counter()
    outs = serve_all(live, requests)
    first_s = time.perf_counter() - t0
    launches = fused_conditional.launches
    print(f"serving live: 3 requests ({[len(x) for _, x in requests]} rows,"
          f" {chunks} chunks) in {first_s:.3f} s; fused_conditional "
          f"launches {launches} (expected {LAYERS} layers x {chunks} "
          f"chunks)", flush=True)
    check(launches == LAYERS * chunks,
          f"launches {launches} != {LAYERS} x {chunks}")
    for (_, x), (mean, var) in zip(requests, outs):
        for name, t in (("mean", mean), ("var", var)):
            check(tuple(t.shape) == (S, len(x), 1),
                  f"{name} shape {tuple(t.shape)}")
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
        check(bool((var > 0).all()), "predictive variance not positive")
    again = serve_all(live, requests)
    check(all(torch.equal(a, b) for o1, o2 in zip(outs, again)
              for a, b in zip(o1, o2)),
          "pinned seeds did not reproduce bit for bit")
    print("serving live: pinned-seed repeats bit-identical", flush=True)

    # the float32 paths on the card against the port's float64 CPU path
    # (the path the CPU tests pin to the JAX package), at fixed draws, on
    # test rows and on inducing inputs (where the variance cancels to
    # about the jitter: the worst case for float32)
    ref, _ = build_model(seed, device="cpu", dtype=torch.float64)
    ref.load_state_dict(model.state_dict())
    rng = np.random.RandomState(seed + 1)
    n, s_ref = 200, 20
    Z = model.layers[0].Z.value.detach().cpu().double().numpy()
    xs = np.concatenate([data["Xs"][:n - 50], Z[:50]])
    zs = [rng.randn(s_ref, n, 8) for _ in range(LAYERS - 1)] + [
        rng.randn(s_ref, n, 1)]
    cm, cv = ref.predict_y(xs, S=s_ref, zs=zs)
    for name, m in (("live", model), ("cached", precompute(model))):
        gm, gv = m.predict_y(xs, S=s_ref, zs=zs)
        dm = (gm.cpu().double() - cm).abs().max().item()
        dv = (gv.cpu().double() - cv).abs().max().item()
        print(f"serving {name} f32 on the card vs the f64 CPU path ({n} "
              f"rows incl. 50 inducing inputs, S={s_ref}, fixed draws): "
              f"max |dmean| {dm:.3e}, max |dvar| {dv:.3e}", flush=True)
        check(dm <= F32_PATH_ATOL and dv <= F32_PATH_ATOL,
              f"{name} f32 card path vs f64 CPU path: {dm}, {dv} > "
              f"{F32_PATH_ATOL}")

    cached = make_server(model, S=S, precompute=True, batch_buckets=BUCKETS)
    couts = serve_all(cached, requests)
    dmc = max((a[0] - b[0]).abs().max().item()
              for a, b in zip(outs, couts))
    dvc = max((a[1] - b[1]).abs().max().item()
              for a, b in zip(outs, couts))
    for mean, var in couts:
        check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
              "cached server output not finite")
    print(f"serving cached vs live at the same seeds: max |dmean| "
          f"{dmc:.3e}, max |dvar| {dvc:.3e}", flush=True)
    return live, cached, requests, launches


# ---------------------------------------------------------------------------
# phase 4: timings
# ---------------------------------------------------------------------------

def bound_ms(B, M_, Dx, Do):
    nbytes = 4 * (B * Dx + M_ * Dx + M_ * M_ + M_ * Do + Do * M_ * M_ + 2
                  + 2 * B * Do)
    t_ops = flops(B, M_, Dx, Do) / FP32_PEAK
    t_bytes = nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                      else "bytes")


def phase_timings(seed, live, cached, requests):
    shapes = []
    for Do in (8, 1):
        B, Dx = S * BUCKETS[-1], 8
        args = conditional_inputs(B, M, Dx, Do, seed)
        launches = fused_conditional.launches
        with torch.no_grad():
            k_ms = event_ms(lambda: fused_conditional(*args))
            p_ms = event_ms(lambda: fused_conditional_plain(*args))
        fused_conditional.launches = launches
        b_ms, b_by = bound_ms(B, M, Dx, Do)
        shapes.append({"B": B, "M": M, "Dx": Dx, "Do": Do, "ms": k_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "gflop": flops(B, M, Dx, Do) / 1e9})
        print(f"timing fused_conditional B={B} M={M} Dx={Dx} Do={Do}: "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {flops(B, M, Dx, Do) / 1e9:.2f} "
              f"GFLOP at {FP32_PEAK / 1e12:.0f} TFLOP/s fp32), library "
              f"call: none", flush=True)
    latency = {}
    _, x1000 = requests[1]
    for name, serve in (("live", live), ("cached", cached)):
        times = []
        for i in range(7):
            t0 = time.perf_counter()
            serve(x1000, seed=1000 + i)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        latency[name] = statistics.median(times)
        print(f"timing {name} server, 1000-row request, S={S}: median "
              f"{latency[name]:.3f} ms over 7 (all: "
              f"{', '.join(f'{t:.3f}' for t in times)})", flush=True)
    return shapes, latency


def phase_profile(live, cached, requests):
    """Where a request's time goes: device time by kernel over three
    1000-row requests under torch.profiler (whose own overhead inflates
    the wall time, so the idle share here is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile
    _, x1000 = requests[1]
    for name, serve in (("live", live), ("cached", cached)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                serve(x1000, seed=2000 + i)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 3
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"]
        if not kernels:
            print(f"profile {name}: device time not measured", flush=True)
            continue
        busy = sum(e.self_device_time_total for e in kernels) / 3e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        print(f"profile {name} server, 1000-row request: device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall under the profiler "
              f"(idle share {1 - busy / wall:.2f}); top kernels: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 3e3:.3f}"
                          f" ms x{e.count // 3}" for e in top), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"torch.backends.cuda.matmul.allow_tf32 = {tf32}", flush=True)
    check(tf32 is False, "TF32 matmuls are enabled")
    t0 = time.perf_counter()
    for name, out in build.build_all().items():
        print(f"built {name}.cu:\n{out.strip()[-1500:]}", flush=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

    errs = phase_kernels(args.seed)
    live, cached, requests, launches = phase_serving(args.seed)
    shapes, latency = phase_timings(args.seed, live, cached, requests)
    phase_profile(live, cached, requests)

    main_shape = shapes[0]
    record = {
        "name": "fused_conditional", "route": "cuda",
        "source": "doubly_stochastic_dgp_tpu_torch/csrc/fused_conditional.cu",
        "replaces": "doubly_stochastic_dgp_tpu/ops/pallas/conditional.py:206",
        "launches": launches, "max_abs_err": errs["max_abs_err"],
        "max_abs_err_vs_f64": errs["err_vs_f64"],
        "plain_max_abs_err_vs_f64": errs["plain_err_vs_f64"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "shapes": shapes,
    }
    print(json.dumps({"serving_request_ms": latency, "card": card}))
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
