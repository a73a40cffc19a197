#!/usr/bin/env python
"""UCI regression experiment runner on the PyTorch port: the reference
paper's harness (demos/run_regression.py) with the same model config
(per-layer RBF(D) + White(D, 2e-6) inter-layer noise, M=100 kmeans
inducing points, num_samples=1, near-deterministic inner q_sqrt init,
Adam(0.01), minibatch 10000, 10k iters), JSONL monitoring, checkpoints,
and test RMSE/NLL (S=100 in 1000-row batches) at every log event.

Usage: python demos_torch/run_regression.py <dataset> <L> <split>
       [--iterations N] [--data-path P] [--results P] [--synthetic]
       [--device cpu]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from doubly_stochastic_dgp_tpu_torch import resolve_device
from demos_torch._common import ACCELERATOR, add_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset")
    p.add_argument("L", type=int)
    p.add_argument("split", type=int)
    p.add_argument("--iterations", type=int, default=10000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--minibatch", type=int, default=10000)
    p.add_argument("--data-path", default="data/")
    p.add_argument("--results", default="results/")
    p.add_argument("--synthetic", action="store_true",
                   help="use shape-matched synthetic data (offline)")
    p.add_argument("--float64", action="store_true")
    p.add_argument("--natgrad-gamma", type=float, default=None)
    add_device(p)
    return p.parse_args(argv)


def config_of(args):
    """--float64: the JAX defaults (float64, jitter 1e-6, solves);
    otherwise the accelerator numerics (demos/run_regression.py:51-57)."""
    from doubly_stochastic_dgp_tpu_torch import Config
    return Config() if args.float64 else ACCELERATOR


def make_data(args):
    """The split's arrays and the kmeans inducing inputs Z."""
    from scipy.cluster.vq import kmeans2

    from doubly_stochastic_dgp_tpu_torch.data.datasets import (
        Datasets, SyntheticRegression)

    if args.synthetic:
        ds = SyntheticRegression(name=f"{args.dataset}_synth",
                                 data_path=args.data_path)
        data = ds.get_data(split=args.split)
    else:
        data = Datasets(args.data_path).all_datasets[args.dataset] \
            .get_data(split=args.split)
    X, Y, Xs, Ys, Y_std = (data[k] for k in ["X", "Y", "Xs", "Ys", "Y_std"])
    dtype = "float64" if args.float64 else "float32"
    X, Y, Xs, Ys = (a.astype(dtype) for a in (X, Y, Xs, Ys))
    Z = kmeans2(X, min(100, X.shape[0]), minit="points", seed=0)[0]
    return {"X": X, "Y": Y, "Xs": Xs, "Ys": Ys, "Y_std": Y_std, "Z": Z}


def build(args, data, config, device):
    import doubly_stochastic_dgp_tpu_torch as port

    X, Y, Z = data["X"], data["Y"], data["Z"]
    D = X.shape[1]
    kernels = []
    for l in range(args.L):
        k = port.RBF(D)
        if l < args.L - 1:
            k = k + port.White(D, variance=2e-6, trainable=False)
        kernels.append(k)
    model = port.DGP.build(X, Y, Z, kernels, port.Gaussian(0.05),
                           num_samples=1, config=config, device=device)
    # near-deterministic inner layers (reference run_regression.py:71-74)
    for layer in model.layers[:-1]:
        layer.q_sqrt.set_value(layer.q_sqrt.value * 1e-5)
    return model


def run(args):
    """(the printed summary, {"model", "history"})."""
    from doubly_stochastic_dgp_tpu_torch import evaluate_regression, fit
    from doubly_stochastic_dgp_tpu_torch.training.checkpoint import (
        save_checkpoint)
    from doubly_stochastic_dgp_tpu_torch.training.monitor import (
        JsonlLogger, PrintTimings)

    device = resolve_device(args.device)
    data = make_data(args)
    X, Xs, Ys, Y_std = data["X"], data["Xs"], data["Ys"], data["Y_std"]
    print(f"##### {args.dataset} L={args.L} split={args.split}  "
          f"N={X.shape[0]} D={X.shape[1]} Ns={Xs.shape[0]}")
    model = build(args, data, config_of(args), device)
    mb = args.minibatch if X.shape[0] > args.minibatch else None

    outdir = os.path.join(args.results,
                          f"{args.dataset}_L{args.L}_split{args.split}")
    os.makedirs(outdir, exist_ok=True)
    logger = JsonlLogger(os.path.join(outdir, "train.jsonl"))

    def test_metrics_cb(step, m, loss, stats):
        res = evaluate_regression(m, Xs, Ys, Y_std, S=100, batch_size=1000)
        stats.update({"test_rmse": res["rmse"], "test_nll": res["nll"]})
        save_checkpoint(os.path.join(outdir, "checkpoints"), (m,), step)

    try:
        model, hist = fit(model, args.iterations, learning_rate=0.01,
                          batch_size=mb, natgrad_gamma=args.natgrad_gamma,
                          callbacks=[PrintTimings(), test_metrics_cb, logger],
                          log_every=args.log_every)
    finally:
        logger.close()

    final = evaluate_regression(model, Xs, Ys, Y_std, S=100, batch_size=1000)
    summary = {"dataset": args.dataset, "L": args.L, "split": args.split,
               **final}
    return summary, {"model": model, "history": hist}


def main(argv=None):
    summary, _ = run(parse_args(argv))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
