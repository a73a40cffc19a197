#!/usr/bin/env python
"""UCI benchmark harness on the PyTorch port (demos/uci_benchmark.py):
the single-layer baselines (SGPR, SVGP, FITC: reference notebook cell 8)
and 1-3 layer DGPs (cell 15), optionally with the alternating NatGrad+Adam
loop (cell 17); reports test log-likelihood and RMSE per model.

Without the real CSV under --data-path it runs on the shape-matched
synthetic dataset.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

from doubly_stochastic_dgp_tpu_torch import resolve_device
from demos_torch._common import ACCELERATOR, add_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="kin8nm")
    p.add_argument("--split", type=int, default=0)
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--max-layers", type=int, default=3)
    p.add_argument("--natgrad-gamma", type=float, default=None)
    p.add_argument("--data-path", default="data/")
    p.add_argument("--num-inducing", type=int, default=100)
    p.add_argument("--eval-samples", type=int, default=50)
    add_device(p)
    return p.parse_args(argv)


def make_data(args):
    from scipy.cluster.vq import kmeans2

    from doubly_stochastic_dgp_tpu_torch.data.datasets import (
        Datasets, SyntheticRegression)

    try:
        data = Datasets(args.data_path).all_datasets[args.dataset] \
            .get_data(split=args.split)
        real = True
    except Exception:
        data = SyntheticRegression(
            name=f"{args.dataset}_synth",
            data_path=args.data_path).get_data(split=args.split)
        real = False
    X, Y, Xs, Ys, Y_std = (data[k].astype("float32")
                           if k[0] in "XY" else data[k]
                           for k in ["X", "Y", "Xs", "Ys", "Y_std"])
    M = min(args.num_inducing, X.shape[0])
    Z = kmeans2(X, M, minit="points", seed=0)[0]
    return {"X": X, "Y": Y, "Xs": Xs, "Ys": Ys, "Y_std": Y_std, "Z": Z,
            "real": real}


def build_baselines(args, data, config, device):
    """[(name, model)] of the single-layer baselines before training."""
    import doubly_stochastic_dgp_tpu_torch as port

    X, Y, Z = data["X"], data["Y"], data["Z"]
    D = X.shape[1]
    return [
        ("SGPR", port.SGPR.build(X, Y, port.RBF(D), Z.copy(),
                                 noise_variance=0.01, config=config,
                                 device=device)),
        ("FITC", port.GPRFITC.build(X, Y, port.RBF(D), Z.copy(),
                                    noise_variance=0.01, config=config,
                                    device=device)),
        ("SVGP", port.SVGP.build(X, Y, port.RBF(D), port.Gaussian(0.01),
                                 Z.copy(), config=config, device=device)),
    ]


def build_dgp(L, data, config, device):
    import doubly_stochastic_dgp_tpu_torch as port

    X, Y, Z = data["X"], data["Y"], data["Z"]
    D = X.shape[1]
    kernels = []
    for l in range(L):
        k = port.RBF(D)
        if l < L - 1:
            k = k + port.White(D, variance=2e-6, trainable=False)
        kernels.append(k)
    m = port.DGP.build(X, Y, Z.copy(), kernels, port.Gaussian(0.05),
                       num_samples=1, config=config, device=device)
    for layer in m.layers[:-1]:
        layer.q_sqrt.set_value(layer.q_sqrt.value * 1e-5)
    return m


def build(args, data, config, device):
    """Every model of the run before training: the baselines, then
    DGP1..DGP<max-layers>."""
    return build_baselines(args, data, config, device) + [
        (f"DGP{L}", build_dgp(L, data, config, device))
        for L in range(1, args.max_layers + 1)]


def run(args):
    from scipy.stats import norm

    from doubly_stochastic_dgp_tpu_torch import (evaluate_regression, fit,
                                                 lbfgs_minimize)

    device = resolve_device(args.device)
    data = make_data(args)
    X, Xs, Ys, Y_std = data["X"], data["Xs"], data["Ys"], data["Y_std"]
    results, losses = {}, {}

    def eval_deterministic(m, name):
        """Single-layer models: deterministic predictive moments."""
        means, vars_ = [], []
        with torch.no_grad():
            for mb in range(-(-len(Xs) // 1000)):
                mean, var = m.predict_y(Xs[mb * 1000:(mb + 1) * 1000])
                means.append(mean.double().cpu().numpy())
                vars_.append(var.double().cpu().numpy())
        mean = np.concatenate(means, 0)
        var = np.concatenate(vars_, 0)
        rmse = float(np.average(Y_std * np.mean((Ys - mean) ** 2) ** 0.5))
        ll = float(np.average(
            norm.logpdf(Ys * Y_std, mean * Y_std, var ** 0.5 * Y_std)))
        results[name] = {"loglik": ll, "rmse": rmse}
        print(f"{name:12s} loglik {ll:+.4f}  rmse {rmse:.4f}", flush=True)

    # single-layer baselines (notebook cell 8): L-BFGS like the notebook's
    # ScipyOptimizer, and SVGP by Adam
    for name, m in build_baselines(args, data, ACCELERATOR, device):
        if name == "SVGP":
            m, hist = fit(m, args.iterations, learning_rate=0.01,
                          batch_size=min(1000, X.shape[0]), log_every=200)
            losses[name] = [h["loss"] for h in hist]
        else:
            with torch.no_grad():
                l0 = float(-m.log_likelihood())
            m, l1 = lbfgs_minimize(lambda mm: -mm.log_likelihood(), m,
                                   max_iters=min(300, args.iterations))
            losses[name] = [l0, l1]
        eval_deterministic(m, name)

    # DGPs, 1..max_layers (notebook cells 15 and 17)
    for L in range(1, args.max_layers + 1):
        m = build_dgp(L, data, ACCELERATOR, device)
        m, hist = fit(m, args.iterations, learning_rate=0.01,
                      batch_size=min(1000, X.shape[0]),
                      natgrad_gamma=args.natgrad_gamma, log_every=200)
        losses[f"DGP{L}"] = [h["loss"] for h in hist]
        res = evaluate_regression(m, Xs, Ys, Y_std, S=args.eval_samples,
                                  batch_size=1000)
        results[f"DGP{L}"] = {"loglik": res["loglik"], "rmse": res["rmse"]}
        print(f"{'DGP' + str(L):12s} loglik {res['loglik']:+.4f}  "
              f"rmse {res['rmse']:.4f}", flush=True)

    summary = {"dataset": args.dataset, "real_data": data["real"],
               "results": results}
    return summary, {"losses": losses}


def main(argv=None):
    summary, _ = run(parse_args(argv))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
