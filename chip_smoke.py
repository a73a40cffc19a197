#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (doubly_stochastic_dgp_tpu_torch)
on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check:

0. the card's name and power limit (nvidia-smi), TF32 off, and a build of
   every CUDA kernel from the sources in this checkout (one nvcc per
   source, all started together); raises if a build fails;
1. every kernel (the fused conditional's forward, backward, save-gram
   forward and save-gram backward) against its plain PyTorch version at
   the serving path's per-layer shapes (B=100,000), the training path's
   (B=10,000, M=100, Dx=8, Do=8 and 1), a ragged multi-tile, a
   clamp-active and an M=512 shape, in float32, both also held against
   the plain version in float64 on the same inputs.  Raises if a kernel
   fails to launch, gives a non-finite value, differs from the plain
   float32 version by more than 1e-4 of the output scale (per gradient
   tensor for the backward), is more than 2x as far from float64 as the
   plain float32 version, gives different bits on a repeat launch, or
   (save-gram forward) differs from the forward's mean and var;
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
4. timings with CUDA events (median of 30 launches): the forward kernel
   at the serving shapes, its plain version, its bound; per-request
   latency of the live and the cached servers;
5. a torch.profiler breakdown of a request's device time by kernel;
6. the training path, live: the headline model with S=10 samples
   (``DGP.build`` on the card, ``use_pallas=True``) trained by ``fit`` for
   300 Adam steps at minibatch 1000 (10,000 rows per layer a step).
   Raises unless every step launched exactly 5 forward and 5 backward
   kernels, and the loss is finite and lower at the end than at the
   start.  Then the ELBO gradient at a fixed minibatch and fixed draws on
   the card, in float32 through the kernels and through the plain
   (``use_pallas=False``) path, against the port's float64 CPU path;
   raises if a gradient is not finite or the kernel path's worst
   relative error per parameter tensor is above 2x the plain path's.
   ``evaluate_regression`` on the test split (raises unless RMSE and
   loglik are finite); 60 ``fit`` steps under ``use_pallas='saved'``
   (raises unless finite and 5 save-gram launches of each kind a step)
   and under ``False`` (raises if any kernel launched); and whether two
   20-step fits from one seed agree bit for bit (printed);
7. timings with CUDA events (median of 30): each kernel and its plain
   version at the training shapes, with its bound; training steps/s of
   ``fit`` for ``use_pallas=True``, ``'saved'`` and ``False``, measured in
   turns;
8. a training step's wall time, its host syncs (counted in torch's sync
   debug mode) and a torch.profiler breakdown of its device time: busy,
   idle share, device ops, top device ops.

It prints a ``{"kernels": [...]}`` line (four records: forward, backward,
save-gram forward, save-gram backward), the card's name and power limit,
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
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from doubly_stochastic_dgp_tpu_torch import (  # noqa: E402
    DGP, RBF, Config, Gaussian, SyntheticRegression, White,
    evaluate_regression, fit, make_server, precompute)
from doubly_stochastic_dgp_tpu_torch.ops.cuda import build  # noqa: E402
from doubly_stochastic_dgp_tpu_torch.ops.cuda.conditional import (  # noqa: E402
    flops, flops_bwd, fused_conditional, fused_conditional_backward,
    fused_conditional_backward_plain, fused_conditional_forward,
    fused_conditional_plain, fused_conditional_saved,
    fused_conditional_saved_plain)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
FP32_PEAK = 67e12          # FLOP/s, fp32 outside the tensor cores
HBM_RATE = 3.35e12         # bytes/s
LAYERS, M, S = 5, 100, 100
BUCKETS = (128, 512, 1000)
# training: S=10 samples, minibatch 1000, so 10,000 rows per layer a step
TRAIN_S, BATCH, TRAIN_STEPS = 10, 1000, 300
# (name, source, the TPU kernel it replaces, the launch counter's owner and
# attribute)
KERNELS = (
    ("fused_conditional", "fused_conditional.cu", 206, fused_conditional,
     "launches"),
    ("fused_conditional_backward", "fused_conditional_bwd.cu", 390,
     fused_conditional, "backward_launches"),
    ("fused_conditional_saved", "fused_conditional.cu", 166,
     fused_conditional_saved, "launches"),
    ("fused_conditional_saved_backward", "fused_conditional_bwd.cu", 239,
     fused_conditional_saved, "backward_launches"),
)
KERNEL_NAMES = [k[0] for k in KERNELS]
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


def launch_counts():
    return {name: getattr(owner, attr)
            for name, _, _, owner, attr in KERNELS}


def set_launch_counts(counts):
    for name, _, _, owner, attr in KERNELS:
        setattr(owner, attr, counts[name])


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


def cotangents(B, Do, seed):
    rng = np.random.RandomState(seed + 7)
    return [torch.tensor(rng.randn(B, Do), dtype=torch.float32,
                         device="cuda") for _ in range(2)]


def compare(got, plain, ref, joint_scale):
    """(max |kernel - plain|, and the three errors relative to the output
    scale: kernel vs plain, kernel vs f64, plain f32 vs f64).  The scale
    is max(max |ref|, 1) over all outputs (joint_scale, the forward's rule)
    or per output tensor (the gradients, whose scales differ by orders)."""
    scales = [max(r.abs().max().item(), 1.0) for r in ref]
    if joint_scale:
        scales = [max(scales)] * len(scales)
    abs_err, err, e_k, e_p = 0.0, 0.0, 0.0, 0.0
    for g, p, r, sc in zip(got, plain, ref, scales):
        check(bool(torch.isfinite(g).all()), "kernel output not finite")
        a = (g - p).abs().max().item()
        abs_err = max(abs_err, a)
        err = max(err, a / sc)
        e_k = max(e_k, (g.double() - r).abs().max().item() / sc)
        e_p = max(e_p, (p.double() - r).abs().max().item() / sc)
    return abs_err, err, e_k, e_p


def hold(name, case, errs):
    abs_err, err, e_k, e_p = errs
    print(f"kernel {name} {case}: |kernel-plain| {abs_err:.3e} "
          f"({err:.3e} of scale), kernel vs f64 {e_k:.3e}, plain f32 vs "
          f"f64 {e_p:.3e} (of scale)", flush=True)
    check(err <= KERNEL_VS_PLAIN_RTOL,
          f"{name} {case}: kernel vs plain {err} > {KERNEL_VS_PLAIN_RTOL} "
          f"of the output scale")
    check(e_k <= 2.0 * e_p,
          f"{name} {case}: kernel error vs f64 {e_k} > 2x the plain f32 "
          f"error {e_p}")


def check_repeat(name, case, fn, first):
    again = fn()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"{name} {case}: two launches on the same inputs differ")


KERNEL_CASES = [("serving_Do8", 100000, M, 8, 8, False),
                ("serving_Do1", 100000, M, 8, 1, False),
                ("ragged_multi_tile", 1300, 37, 8, 3, False),
                ("clamp_active", 4000, 50, 5, 3, True),
                ("M512", 513, 512, 3, 2, False),
                ("training_Do8", TRAIN_S * BATCH, M, 8, 8, False),
                ("training_Do1", TRAIN_S * BATCH, M, 8, 1, False)]


def phase_kernels(seed):
    """Every kernel against its plain version in float32 and float64 on
    the same inputs; repeat launches must agree bit for bit and the saved
    forward must equal the forward.  Returns the worst errors per kernel
    (these launches are not the main path's and are not counted)."""
    worst = {n: [0.0] * 4 for n in KERNEL_NAMES}
    counts = launch_counts()
    for case, B, M_, Dx, Do, clamp in KERNEL_CASES:
        args = conditional_inputs(B, M_, Dx, Do, seed, clamp)
        a64 = [a.double() for a in args]
        gm, gv = cotangents(B, Do, seed)
        with torch.no_grad():
            fwd = lambda: fused_conditional_forward(*args)[:2]  # noqa: E731
            km, kv = fwd()
            torch.cuda.synchronize()
            pm, pv, pK = fused_conditional_saved_plain(*args)
            rm, rv, rK = fused_conditional_saved_plain(*a64)
            errs = compare((km, kv), (pm, pv), (rm, rv), joint_scale=True)
            hold("fused_conditional", case, errs)
            check_repeat("fused_conditional", case, fwd, (km, kv))
            if clamp:
                check(bool((kv == 0).any() and (kv > 0).any()
                           and (pv == 0).any()),
                      f"{case}: the variance clamp is not active")
            worst["fused_conditional"] = list(
                map(max, worst["fused_conditional"], errs))

            saved = lambda: fused_conditional_forward(  # noqa: E731
                *args, save_gram=True)
            sm, sv, sK = saved()
            check(torch.equal(sm, km) and torch.equal(sv, kv),
                  f"{case}: the saved forward's mean/var differ from the "
                  f"forward's")
            errs = compare((sm, sv, sK), (pm, pv, pK), (rm, rv, rK),
                           joint_scale=True)
            hold("fused_conditional_saved", case, errs)
            check_repeat("fused_conditional_saved", case, saved,
                         (sm, sv, sK))
            worst["fused_conditional_saved"] = list(
                map(max, worst["fused_conditional_saved"], errs))

            # the backward at the kernel forward's outputs (so all three
            # versions mask the same clamped entries)
            g64 = (gm.double(), gv.double())
            for name, K, K64 in (("fused_conditional_backward", None, None),
                                 ("fused_conditional_saved_backward", sK,
                                  rK)):
                bwd = lambda: fused_conditional_backward(  # noqa: E731
                    *args, km, kv, gm, gv, K)
                kg = bwd()
                torch.cuda.synchronize()
                pg = fused_conditional_backward_plain(*args, km, kv, gm, gv,
                                                      K)
                rg = fused_conditional_backward_plain(
                    *a64, km.double(), kv.double(), *g64, K64)
                errs = compare(kg, pg, rg, joint_scale=False)
                hold(name, case, errs)
                check_repeat(name, case, bwd, kg)
                worst[name] = list(map(max, worst[name], errs))
        del args, a64, gm, gv, pK, rK, sK
    set_launch_counts(counts)
    return worst


# ---------------------------------------------------------------------------
# phase 2/3: the serving path
# ---------------------------------------------------------------------------

def build_model(seed, device="cuda", dtype=torch.float32, use_pallas=True,
                num_samples=1, random_posterior=True):
    """The headline model (bench.py's build_regression at BASELINE.json's
    width) on kin8nm-shaped synthetic data; Z is a seeded random subset
    of X."""
    data = SyntheticRegression(N=8192, D=8).get_data(split=0)
    X, Y = data["X"], data["Y"]
    rng = np.random.RandomState(seed)
    Z = X[rng.choice(X.shape[0], M, replace=False)]
    kernels = [RBF(8) + White(8, variance=2e-6, trainable=False)
               for _ in range(LAYERS - 1)] + [RBF(8)]
    cfg = Config(dtype=dtype, jitter=1e-5, solve_mode="inverse",
                 use_pallas=use_pallas)
    model = DGP.build(X, Y, Z, kernels, Gaussian(0.05), config=cfg,
                      num_samples=num_samples, device=device)
    # near-deterministic inner layers (reference run_regression.py)
    for layer in model.layers[:-1]:
        layer.q_sqrt.set_value(layer.q_sqrt.value * 1e-5)
    if random_posterior:   # so that the posterior is not the prior
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

def bound_ms(B, M_, Dx, Do, backward=False, saved=False):
    """The least time for the call: the larger of its bytes (each input
    read once, each output written once) over the HBM rate and its flops
    over the fp32 peak.  The backward reads the forward's inputs and the
    cotangents gm, gv and writes a gradient of the same size as each of
    the forward's tensor inputs; the saved pair also writes (forward) or
    reads (backward) the (B, M) gram."""
    params = M_ * Dx + M_ * M_ + M_ * Do + Do * M_ * M_
    if backward:
        floats = B * Dx + params + 2 + 2 * B * Do + B * Dx + params
        n_flops = flops_bwd(B, M_, Dx, Do, saved=saved)
    else:
        floats = B * Dx + params + 2 + 2 * B * Do
        n_flops = flops(B, M_, Dx, Do)
    floats += B * M_ if saved else 0
    t_ops = n_flops / FP32_PEAK
    t_bytes = 4 * floats / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                      else "bytes")


def phase_timings(seed, live, cached, requests):
    shapes = []
    for Do in (8, 1):
        B, Dx = S * BUCKETS[-1], 8
        args = conditional_inputs(B, M, Dx, Do, seed)
        counts = launch_counts()
        with torch.no_grad():
            k_ms = event_ms(lambda: fused_conditional(*args))
            p_ms = event_ms(lambda: fused_conditional_plain(*args))
        set_launch_counts(counts)
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


def device_breakdown(prof, n):
    """(device busy ms per unit, device ops per unit, top device ops) from
    a profile over n units of work; None when the profiler saw no device
    time."""
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    if not kernels:
        return None
    busy = sum(e.self_device_time_total for e in kernels) / (1e3 * n)
    ops = sum(e.count for e in kernels) / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    desc = "; ".join(f"{e.key[:60]} {e.self_device_time_total / (1e3 * n):.3f}"
                     f" ms x{e.count // n}" for e in top)
    return busy, ops, desc


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
        found = device_breakdown(prof, 3)
        if found is None:
            print(f"profile {name}: device time not measured", flush=True)
            continue
        busy, _, top = found
        print(f"profile {name} server, 1000-row request: device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall under the profiler "
              f"(idle share {1 - busy / wall:.2f}); top kernels: {top}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

def run_fit(model, steps, seed):
    """fit() with the launch counts set to 0 just before and read just
    after; logs (and syncs) every 10 steps."""
    set_launch_counts({n: 0 for n in KERNEL_NAMES})
    _, hist = fit(model, iterations=steps, learning_rate=0.01,
                  batch_size=BATCH, seed=seed, log_every=10)
    torch.cuda.synchronize()
    return hist, launch_counts()


def loss_grads(model, idx, zs):
    model.zero_grad(set_to_none=True)
    loss = model.loss(model.X_data[idx], model.Y_data[idx], zs=zs)
    loss.backward()
    return loss.item(), {n: p.grad.detach().double().cpu()
                         for n, p in model.named_parameters()
                         if p.requires_grad}


def check_gradient(model, seed):
    """The ELBO gradient of the float32 card paths at a fixed minibatch
    and fixed draws against the port's float64 CPU path: per parameter
    tensor, max |g - g64| / max |g64|; the kernel path's worst must be
    within 2x the plain (use_pallas=False) float32 path's worst."""
    state = model.state_dict()
    models = {"kernel f32": model}
    for name, kw in (("plain f32", dict(use_pallas=False)),
                     ("f64 cpu", dict(device="cpu", dtype=torch.float64))):
        m, _ = build_model(seed, num_samples=TRAIN_S, random_posterior=False,
                           **kw)
        m.load_state_dict(state)
        models[name] = m
    rng = np.random.RandomState(seed + 3)
    idx = rng.randint(0, model.X_data.shape[0], BATCH)
    zs = [rng.randn(TRAIN_S, BATCH, d) for d in (8,) * (LAYERS - 1) + (1,)]
    out = {name: loss_grads(m, torch.as_tensor(idx, device=m.X_data.device),
                            zs) for name, m in models.items()}
    l64, g64 = out.pop("f64 cpu")
    worst = {}
    for name, (loss, grads) in out.items():
        check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
              f"ELBO gradient ({name}) not finite")
        errs = {p: ((g - g64[p]).abs().max()
                    / g64[p].abs().max().clamp_min(1e-30)).item()
                for p, g in grads.items()}
        worst[name] = max(errs.values())
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        print(f"training gradient {name} vs f64 (batch {BATCH}, S="
              f"{TRAIN_S}, fixed draws): loss {loss:.6f} vs {l64:.6f}; "
              f"worst relative error over {len(errs)} tensors "
              f"{worst[name]:.3e} ("
              + ", ".join(f"{p} {e:.2e}" for p, e in top) + ")",
              flush=True)
    check(worst["kernel f32"] <= 2.0 * worst["plain f32"],
          f"ELBO gradient through the kernels {worst['kernel f32']} > 2x "
          f"the plain float32 path's {worst['plain f32']}")
    return worst


def phase_training(seed):
    model, data = build_model(seed, num_samples=TRAIN_S,
                              random_posterior=False)
    hist, counts = run_fit(model, TRAIN_STEPS, seed)
    losses = [h["loss"] for h in hist]
    print(f"training use_pallas=True: {TRAIN_STEPS} Adam steps, 5 layers, "
          f"M={M}, S={TRAIN_S}, batch {BATCH}: loss {losses[0]:.3f} "
          f"(steps 1-10) -> {losses[-1]:.3f} (last 10); launches "
          + ", ".join(f"{n} {c}" for n, c in counts.items()), flush=True)
    per_run = LAYERS * TRAIN_STEPS
    check(counts["fused_conditional"] == per_run
          and counts["fused_conditional_backward"] == per_run,
          f"launches {counts} != {LAYERS} forward and {LAYERS} backward a "
          f"step over {TRAIN_STEPS} steps")
    check(all(np.isfinite(losses)), "training loss not finite")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")

    grad_worst = check_gradient(model, seed)

    metrics = evaluate_regression(model, data["Xs"], data["Ys"],
                                  data["Y_std"], S=100, seed=seed)
    print(f"training evaluate_regression on the {len(data['Xs'])}-row test "
          f"split, S=100: rmse {metrics['rmse']:.6f}, loglik "
          f"{metrics['loglik']:.6f}", flush=True)
    check(np.isfinite(metrics["rmse"]) and np.isfinite(metrics["loglik"]),
          "test metrics not finite")

    saved_counts = None
    for route in ("saved", False):
        m, _ = build_model(seed, num_samples=TRAIN_S, random_posterior=False,
                           use_pallas=route)
        h, c = run_fit(m, 60, seed)
        print(f"training use_pallas={route!r}: 60 steps, loss "
              f"{h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}; launches "
              + ", ".join(f"{n} {k}" for n, k in c.items()), flush=True)
        check(all(np.isfinite([x["loss"] for x in h])),
              f"use_pallas={route!r}: loss not finite")
        if route == "saved":
            saved_counts = c
            check(c["fused_conditional_saved"] == LAYERS * 60
                  and c["fused_conditional_saved_backward"] == LAYERS * 60,
                  f"saved launches {c} != {LAYERS} a step")
        else:
            check(not any(c.values()), f"use_pallas=False launched {c}")

    runs = []
    for _ in range(2):
        m, _ = build_model(seed, num_samples=TRAIN_S, random_posterior=False)
        run_fit(m, 20, seed)
        runs.append(m.state_dict())
    same = all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    print(f"training: two 20-step fits from one seed agree bit for bit: "
          f"{same}", flush=True)

    launches = {**counts, **{n: saved_counts[n] for n in
                             ("fused_conditional_saved",
                              "fused_conditional_saved_backward")}}
    return model, launches, grad_worst, metrics, same


def phase_steps_per_s(seed, card):
    """Training steps/s of ``fit`` for each route, measured in turns (3
    rounds of a 30-step fit per route) so that the shared host's load
    falls alike on all three: the median of the 10-step chunk rates,
    leaving out each fit's first chunk (optimizer set-up)."""
    routes = (True, "saved", False)
    models = {r: build_model(seed, num_samples=TRAIN_S,
                             random_posterior=False, use_pallas=r)[0]
              for r in routes}
    samples = {r: [] for r in routes}
    for i in range(3):
        for r in routes:
            hist, _ = run_fit(models[r], 30, seed + i)
            samples[r] += [h["iters_per_sec"] for h in hist[1:]]
    rates = {str(r): statistics.median(v) for r, v in samples.items()}
    print("training steps/s of fit (median of 6 ten-step chunks, in turns; "
          "range): " + ", ".join(
              f"use_pallas={r!r} {rates[str(r)]:.2f} ({min(v):.2f}-"
              f"{max(v):.2f})" for r, v in samples.items())
          + f" [{card}]", flush=True)
    return rates


def phase_training_timings(seed, card):
    """Each kernel and its plain version at the training shapes (B = S x
    batch = 10,000 rows, M=100, Dx=8), CUDA-event medians of 30."""
    shapes = {n: [] for n in KERNEL_NAMES}
    counts = launch_counts()
    for Do in (8, 1):
        B, Dx = TRAIN_S * BATCH, 8
        args = conditional_inputs(B, M, Dx, Do, seed)
        gm, gv = cotangents(B, Do, seed)
        with torch.no_grad():
            km, kv, kK = fused_conditional_forward(*args, save_gram=True)
            calls = {
                "fused_conditional": (
                    lambda: fused_conditional_forward(*args),
                    lambda: fused_conditional_plain(*args), False, False),
                "fused_conditional_backward": (
                    lambda: fused_conditional_backward(*args, km, kv, gm, gv),
                    lambda: fused_conditional_backward_plain(
                        *args, km, kv, gm, gv), True, False),
                "fused_conditional_saved": (
                    lambda: fused_conditional_forward(*args, save_gram=True),
                    lambda: fused_conditional_saved_plain(*args), False,
                    True),
                "fused_conditional_saved_backward": (
                    lambda: fused_conditional_backward(*args, km, kv, gm, gv,
                                                       kK),
                    lambda: fused_conditional_backward_plain(
                        *args, km, kv, gm, gv, kK), True, True),
            }
            for name, (kern, plain, backward, saved) in calls.items():
                k_ms = event_ms(kern)
                p_ms = event_ms(plain)
                b_ms, b_by = bound_ms(B, M, Dx, Do, backward, saved)
                gflop = (flops_bwd(B, M, Dx, Do, saved) if backward
                         else flops(B, M, Dx, Do)) / 1e9
                shapes[name].append({
                    "B": B, "M": M, "Dx": Dx, "Do": Do, "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "gflop": gflop})
                print(f"timing {name} B={B} M={M} Dx={Dx} Do={Do}: kernel "
                      f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                      f"{b_ms:.4f} ms ({b_by}; {gflop:.3f} GFLOP), library "
                      f"call: none [{card}]", flush=True)
    set_launch_counts(counts)
    return shapes


def phase_training_profile(model, seed, card):
    """One training step's device time by kernel (mean of 5 profiled
    steps) against the unprofiled step wall time (median of 20)."""
    from torch.profiler import ProfilerActivity, profile

    from doubly_stochastic_dgp_tpu_torch.training.loop import (
        make_sgd_train_step)
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        masked_optimizer)
    step = make_sgd_train_step(masked_optimizer(model, 0.01), BATCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    times = []
    for i in range(23):
        t0 = time.perf_counter()
        step(model, generator=gen)
        torch.cuda.synchronize()
        if i >= 3:
            times.append(1e3 * (time.perf_counter() - t0))
    wall = statistics.median(times)
    # host syncs a step: torch's sync debug mode warns on each
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step(model, generator=gen)
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    print(f"training step: {syncs} host syncs (torch.cuda sync debug mode; "
          f"{LAYERS} conditionals and {LAYERS} KL terms each read "
          f"safe_cholesky's info once)", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step(model, generator=gen)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0) / 5
    found = device_breakdown(prof, 5)
    print(f"timing training step (use_pallas=True, batch {BATCH}, S="
          f"{TRAIN_S}), synchronized each step: median {wall:.3f} ms over "
          f"20 (all: {', '.join(f'{t:.3f}' for t in times)}) [{card}]",
          flush=True)
    if found is None:
        print("profile training step: device time not measured", flush=True)
        return {"step_ms": wall, "busy_ms": None, "host_syncs": syncs}
    busy, ops, top = found
    print(f"profile training step: device busy {busy:.3f} ms in {ops:.0f} "
          f"device ops; wall {prof_wall:.3f} ms under the profiler, "
          f"{wall:.3f} ms without (idle share {1 - busy / wall:.2f} of the "
          f"unprofiled wall); top device ops: {top}", flush=True)
    return {"step_ms": wall, "busy_ms": busy, "device_ops": ops,
            "idle_share": 1 - busy / wall, "host_syncs": syncs}


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
    live, cached, requests, serving_launches = phase_serving(args.seed)
    serving_shapes, latency = phase_timings(args.seed, live, cached,
                                            requests)
    phase_profile(live, cached, requests)
    del live, cached
    model, launches, grad_worst, metrics, same = phase_training(args.seed)
    train_shapes = phase_training_timings(args.seed, card)
    rates = phase_steps_per_s(args.seed, card)
    step = phase_training_profile(model, args.seed, card)

    records = []
    for name, src, line, _, _ in KERNELS:
        main_shape = train_shapes[name][0]
        abs_err, rel, rel_k, rel_p = errs[name]
        rec = {
            "name": name, "route": "cuda",
            "source": f"doubly_stochastic_dgp_tpu_torch/csrc/{src}",
            "replaces":
                f"doubly_stochastic_dgp_tpu/ops/pallas/conditional.py:{line}",
            "launches": launches[name], "max_abs_err": abs_err,
            "max_rel_err": rel, "max_rel_err_vs_f64": rel_k,
            "plain_max_rel_err_vs_f64": rel_p,
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": None,
            "shapes": train_shapes[name],
        }
        if name == "fused_conditional":
            rec["serving_launches"] = serving_launches
            rec["serving_shapes"] = serving_shapes
        records.append(rec)
    print(json.dumps({"serving_request_ms": latency,
                      "training_steps_per_s": rates,
                      "training_step": step,
                      "training_grad_rel_err": grad_worst,
                      "test_metrics": metrics,
                      "fit_bit_identical": same, "card": card}))
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
