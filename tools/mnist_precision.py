#!/usr/bin/env python3
"""Float32 precision at the MNIST DGP's shapes (Dx=784).

    python3 tools/mnist_precision.py --cpu   # the distance sum, emulated
    python3 tools/mnist_precision.py         # on one NVIDIA GPU

``--cpu``: the squared distance over 784 pixel-like dimensions summed in
float32 in each order of :func:`orders` (the kernels' order, Kahan's
compensation on every term, unsplit as the fused gram stage sums it and
split over 8 blocks as ``rbf_gram`` sums it at the MNIST Kuu and Kuf; a
running sum; the blocked order also tried) and as torch sums it, each
against float64: the largest relative error of d2 over 300 x 60 pairs,
and each one's largest relative distance from the unsplit Kahan order.

On the card (imports ``chip_smoke.py``'s phase 25 helpers): the same orders on
the card, against the gram the kernels return (``rbf_gram``'s and the fused
forward's saved gram at pixel-like rows, 1000 x 100): each one's largest
relative error against the float64 gram and its distance from the Kahan
order's gram; then trains the MNIST DGP2 and DGP3 as phase 25 does, and for
four draw seeds (``--seeds``) prints the ELBO gradient's relative error per
parameter tensor against the float64 CPU path, through the fused kernels,
through ``use_pallas=False`` (phase 25's gate: the first within 2x the second
at draw seed 0), and through the fused route with its fused pair exact
(float64, rounded: the route's error with exact kernels), and each layer's
fused forward and backward errors against float64 on the trained model's
operands, beside the plain float32 version's.
"""

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

D, CHUNK = 784, 16


def pixels(n, rng):
    """n pixel-like rows in [0, 1] (mean 0.5, std 0.15), float32."""
    return np.clip(0.5 + rng.randn(n, D) * 0.15, 0, 1).astype(np.float32)


def kahan(total, comp, x):
    """total += x with Kahan's compensation comp (tensors of one dtype)."""
    y = x - comp
    t = total + y
    return t, (t - total) - y


def orders(x, z):
    """{order: d2 (N, M) float32} of the rows x (N, D) and z (M, D), float32
    tensors on one device, summed in each order (fmaf emulated as the
    float64 sum of the exact product, rounded to float32): a running fmaf
    sum (the earliest design's); Kahan's compensation on every term, the
    square folded into fmaf(u, u, -c) (the kernels' order), also with
    the 16-wide chunks of d split over 8 blocks whose totals less their
    compensations are added compensated (rbf_gram at the MNIST Kuu and
    Kuf); and fmaf chains over 16 terms, each chunk's partial added
    compensated (a blocked order also tried), unsplit."""
    sq = (x[:, None, :] - z[None, :, :]).double() ** 2
    zero = torch.zeros(sq.shape[:2], dtype=torch.float32, device=x.device)
    chunks = -(-D // CHUNK)

    def kahan_terms(d0, d1):
        tot = comp = zero
        for d in range(d0, d1):
            y = (sq[..., d] - comp.double()).float()     # fmaf(u, u, -comp)
            t = tot + y
            tot, comp = t, (t - tot) - y
        return tot - comp

    def combine(parts):
        S = C = zero
        for v in parts:
            S, C = kahan(S, C, v)
        return S - C

    run = zero
    for d in range(D):
        run = (run.double() + sq[..., d]).float()
    blocked = []
    for c in range(chunks):
        p = zero
        for d in range(CHUNK * c, min(D, CHUNK * c + CHUNK)):
            p = (p.double() + sq[..., d]).float()
        blocked.append(p)
    return {"running fmaf sum (earliest design)": run,
            "Kahan on every term (the kernels)": kahan_terms(0, D),
            "Kahan on every term, 8 splits (rbf_gram)": combine(
                [kahan_terms(CHUNK * (r * chunks // 8),
                             min(D, CHUNK * ((r + 1) * chunks // 8)))
                 for r in range(8)]),
            "blocked (also tried)": combine(blocked)}


def distance_sums(seed=0):
    rng = np.random.RandomState(seed)
    X = torch.from_numpy(pixels(300, rng) / 2)
    Z = torch.from_numpy(pixels(60, rng) / 2)
    ref = ((X.double()[:, None] - Z.double()[None]) ** 2).sum(-1)
    got = orders(X, Z)
    got["torch.sum"] = torch.sum((X[:, None] - Z[None]) ** 2, -1)
    kahan_d2 = got["Kahan on every term (the kernels)"].double()
    for name, d2 in got.items():
        err = ((d2.double() - ref).abs() / ref).max().item()
        gap = ((d2.double() - kahan_d2).abs() / ref).max().item()
        print(f"d2 over {D} dims (mean d2 {ref.mean().item():.3f}), {name}: "
              f"max relative error {err:.3e}; from the Kahan order "
              f"{gap:.3e}", flush=True)


def gram_orders_on_card(cs):
    """The orders on the card beside the kernels' grams: K = 2 exp(-d2 / 2)
    at lengthscale 2 over 1000 x 100 pixel-like rows, float32."""
    rng = np.random.RandomState(1)
    X = torch.from_numpy(pixels(1000, rng)).cuda()
    Z = torch.from_numpy(pixels(100, rng)).cuda()
    two = torch.tensor(2.0, device="cuda")
    x, z = X / two, Z / two
    ref = 2.0 * torch.exp(-0.5 * ((x.double()[:, None] - z.double()[None])
                                  ** 2).sum(-1))
    with torch.no_grad():
        grams = {k: 2.0 * torch.exp(-0.5 * d2)
                 for k, d2 in orders(x, z).items()}
        grams["rbf_gram kernel"] = cs.gram.rbf_gram_kernel(X, Z, two, two)
        M_, Do = Z.shape[0], 30
        args = cs.conditional_inputs(X.shape[0], M_, D, Do, 0)
        grams["fused forward, saved gram"] = cs.fused_conditional_forward(
            x, z, *args[2:5], two, two + 2e-6, save_gram=True)[2]
    old = grams["Kahan on every term (the kernels)"].double()
    for name, K in grams.items():
        err = ((K.double() - ref).abs() / ref).max().item()
        gap = ((K.double() - old).abs() / ref).max().item()
        print(f"gram on the card over {D} dims, {name}: max relative error "
              f"{err:.3e}; from the Kahan order {gap:.3e} "
              f"[{cs.card_line()}]", flush=True)


@contextlib.contextmanager
def exact_fused_pair():
    """The kernel route with its fused forward and backward replaced by
    their plain versions in float64, rounded to float32: what the route's
    gradient error would be with exact fused kernels."""
    from doubly_stochastic_dgp_tpu_torch.ops.cuda import conditional as C
    fwd, bwd = C.fused_conditional_forward, C.fused_conditional_backward

    def exact_fwd(Xs, Zs, LiT, alpha, W, kvar, kdiag, save_gram=False):
        kv, kd = C._scalars(kvar, kdiag, Xs)
        m, v, K = C.fused_conditional_saved_plain(
            *(t.double() for t in (Xs, Zs, LiT, alpha, W, kv, kd)))
        return m.float(), v.float(), K.float() if save_gram else None

    def exact_bwd(Xs, Zs, LiT, alpha, W, kvar, kdiag, mean, var, gm, gv,
                  K=None):
        kv, kd = C._scalars(kvar, kdiag, Xs)
        g = C.fused_conditional_backward_plain(
            *(t.double() for t in (Xs, Zs, LiT, alpha, W, kv, kd, mean, var,
                                   gm, gv)), None if K is None else K.double())
        return tuple(t.float() for t in g)

    C.fused_conditional_forward = exact_fwd
    C.fused_conditional_backward = exact_bwd
    try:
        yield
    finally:
        C.fused_conditional_forward, C.fused_conditional_backward = fwd, bwd


def on_card(seeds=4):
    import chip_smoke as cs
    print(f"card: {cs.card_line()}", flush=True)
    cs.build.build_all()
    gram_orders_on_card(cs)
    data = cs.mnist_data(0)
    names = ["dXs", "dZs", "dLiT", "dalpha", "dW", "dkvar", "dkdiag"]
    for label, hidden in cs.MNIST_MODELS.items():
        model = cs.mnist_model(data, hidden, 0)
        cs.run_fit(model, cs.MNIST_STEPS, 0, profiled=False)
        state = model.state_dict()
        plain = cs.mnist_model(data, hidden, 0, use_pallas=False)
        plain.load_state_dict(state)
        ref = cs.mnist_model(data, hidden, 0, device="cpu",
                             dtype=torch.float64)
        ref.load_state_dict(state)
        for seed in range(seeds):
            rng = np.random.RandomState(seed + 3)
            idx = rng.randint(0, ref.X_data.shape[0], cs.BATCH)
            zs = [rng.randn(1, cs.BATCH, d) for d in hidden + (cs.MNIST_K,)]
            _, g64 = cs.loss_grads(ref, torch.as_tensor(idx), zs)
            worst, top = {}, {}
            for name, m, ctx in (("kernel", model, contextlib.nullcontext()),
                                 ("plain", plain, contextlib.nullcontext()),
                                 ("exact", model, exact_fused_pair())):
                with ctx:
                    _, g = cs.loss_grads(
                        m, torch.as_tensor(idx, device="cuda"), zs)
                errs = {p: ((g[p] - g64[p]).abs().max()
                            / g64[p].abs().max().clamp_min(1e-30)).item()
                        for p in g}
                worst[name] = max(errs.values())
                top[name] = ", ".join(
                    f"{p.replace('.unconstrained', '')} {e:.2e}" for p, e in
                    sorted(errs.items(), key=lambda kv: -kv[1])[:2])
            print(f"{label} draw seed {seed}: worst relative gradient error "
                  f"kernel {worst['kernel']:.3e} ({top['kernel']}), plain "
                  f"{worst['plain']:.3e} ({top['plain']}) (ratio "
                  f"{worst['kernel'] / worst['plain']:.2f}); the kernel "
                  f"route with the fused pair exact {worst['exact']:.3e} "
                  f"({top['exact']}) (ratio "
                  f"{worst['exact'] / worst['plain']:.2f})", flush=True)
        rng = np.random.RandomState(6)
        Xb = torch.as_tensor(data["X"][rng.randint(0, cs.MNIST_N, cs.BATCH)],
                             device="cuda")
        for layer, args in enumerate(cs.capture_fused_operands(model, Xb)):
            args = [a.contiguous() for a in args]
            a64 = [a.double() for a in args]
            B, Do = args[0].shape[0], args[3].shape[1]
            with torch.no_grad():
                km, kv, _ = cs.fused_conditional_forward(*args)
                gm, gv = cs.cotangents(B, Do, 0)
                kg = cs.fused_conditional_backward(*args, km, kv, gm, gv)
                pg = cs.fused_conditional_backward_plain(*args, km, kv, gm,
                                                         gv)
                rg = cs.fused_conditional_backward_plain(
                    *a64, km.double(), kv.double(), gm.double(), gv.double())
            errs = []
            for n, k, p, r in zip(names, kg, pg, rg):
                sc = max(r.abs().max().item(), 1.0)
                errs.append(f"{n} {(k.double() - r).abs().max().item() / sc:.2e}"
                            f"/{(p.double() - r).abs().max().item() / sc:.2e}")
            print(f"{label} layer {layer} (B={B}, Dx={args[0].shape[1]}, "
                  f"Do={Do}) backward vs f64 of scale, kernel/plain: "
                  + "; ".join(errs), flush=True)
        del model, plain, ref


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=4,
                        help="draw seeds of the gradient comparison")
    parser.add_argument("--cpu", action="store_true",
                        help="only the distance-sum emulation")
    args = parser.parse_args()
    distance_sums()
    if args.cpu:
        return 0
    if not torch.cuda.is_available():
        print("mnist_precision: CUDA is not available", file=sys.stderr)
        return 1
    on_card(args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
