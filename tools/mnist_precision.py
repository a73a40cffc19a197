#!/usr/bin/env python3
"""Float32 precision at the MNIST DGP's shapes (Dx=784).

    python3 tools/mnist_precision.py --cpu   # the distance sum, emulated
    python3 tools/mnist_precision.py         # on one NVIDIA GPU

``--cpu``: the squared distance over 784 pixel-like dimensions summed in
float32 as the kernels' gram loops sum it (one running fmaf sum, and with
Kahan's compensation) and as torch sums it, each against float64: the
largest relative error of d2 over 300 x 60 pairs.

On the card (imports ``chip_smoke.py``'s phase 25 helpers): trains the
MNIST DGP2 and DGP3 as phase 25 does, then for four draw seeds prints the
ELBO gradient's relative error per parameter tensor against the float64
CPU path, through the fused kernels and through ``use_pallas=False``, and
each layer's fused forward and backward errors against float64 on the
trained model's operands, beside the plain float32 version's.
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

D = 784


def distance_sums(seed=0):
    rng = np.random.RandomState(seed)
    X = (np.clip(0.5 + rng.randn(300, D) * 0.15, 0, 1) / 2).astype(
        np.float32)
    Z = (np.clip(0.5 + rng.randn(60, D) * 0.15, 0, 1) / 2).astype(np.float32)
    ref = ((X.astype(np.float64)[:, None] - Z.astype(np.float64)[None])
           ** 2).sum(-1)
    U = (X[:, None] - Z[None]).astype(np.float32)
    sq = U.astype(np.float64) ** 2          # fmaf: the product is exact
    run = np.zeros(ref.shape, np.float32)
    tot = np.zeros(ref.shape, np.float32)
    comp = np.zeros(ref.shape, np.float32)
    for d in range(D):
        run = (run.astype(np.float64) + sq[..., d]).astype(np.float32)
        y = (sq[..., d] - comp).astype(np.float32)
        t = (tot + y).astype(np.float32)
        comp = ((t - tot).astype(np.float32) - y).astype(np.float32)
        tot = t
    pairwise = torch.sum(torch.from_numpy(U) ** 2, -1).numpy()
    for name, got in (("running fmaf sum", run), ("Kahan", tot),
                      ("torch.sum", pairwise)):
        err = np.abs(got.astype(np.float64) - ref) / ref
        print(f"d2 over {D} dims (mean d2 {ref.mean():.3f}), {name}: max "
              f"relative error {err.max():.3e}", flush=True)


def on_card():
    import chip_smoke as cs
    print(f"card: {cs.card_line()}", flush=True)
    cs.build.build_all()
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
        for seed in range(4):
            rng = np.random.RandomState(seed + 3)
            idx = rng.randint(0, ref.X_data.shape[0], cs.BATCH)
            zs = [rng.randn(1, cs.BATCH, d) for d in hidden + (cs.MNIST_K,)]
            _, g64 = cs.loss_grads(ref, torch.as_tensor(idx), zs)
            worst = {}
            for name, m in (("kernel", model), ("plain", plain)):
                _, g = cs.loss_grads(m, torch.as_tensor(idx, device="cuda"),
                                     zs)
                worst[name] = max(
                    ((g[p] - g64[p]).abs().max()
                     / g64[p].abs().max().clamp_min(1e-30)).item()
                    for p in g)
            print(f"{label} draw seed {seed}: worst relative gradient error "
                  f"kernel {worst['kernel']:.3e}, plain {worst['plain']:.3e}"
                  f" (ratio {worst['kernel'] / worst['plain']:.2f})",
                  flush=True)
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
    parser.add_argument("--cpu", action="store_true",
                        help="only the distance-sum emulation")
    args = parser.parse_args()
    distance_sums()
    if args.cpu:
        return 0
    if not torch.cuda.is_available():
        print("mnist_precision: CUDA is not available", file=sys.stderr)
        return 1
    on_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
