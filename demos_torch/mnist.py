#!/usr/bin/env python
"""MNIST multiclass demo on the PyTorch port (demos/mnist.py): a DGP with
a robust-max MultiClass(10) likelihood, M=100 inducing points, minibatch
1000: DGP2 = 784->30->10, DGP3 = 784->30->30->10.

MNIST is read from a local npz at --data (keys X, Y, Xs, Ys; X in [0, 1],
Y integer labels); without one, or with --synthetic, a synthetic
10-class problem of MNIST's width (6000 training rows).

``--data-parallel`` trains with ``fit_dp`` (``parallel/dp.py``'s scanned
step) and evaluates with the test rows split over the ranks: ``run``
called inside a process group that is already up runs on its ranks (one
rank a card, as ``parallel/mesh.py``'s ``run_ranks`` starts them);
otherwise the device (the card, or ``--device cpu``) is a one-rank group
made here (NCCL on the card, gloo on the CPU)."""

import argparse
import json
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

from doubly_stochastic_dgp_tpu_torch import resolve_device
from demos_torch._common import ACCELERATOR, add_device


def synthetic_multiclass(N=6000, D=784, K=10, Ns=1000, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(D, K) * 0.5
    X = rng.rand(N + Ns, D)
    logits = X @ W + rng.randn(N + Ns, K) * 0.1
    Y = np.argmax(logits, 1)[:, None].astype(float)
    return X[:N], Y[:N], X[N:], Y[N:]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--iterations", type=int, default=2000)
    p.add_argument("--minibatch", type=int, default=1000)
    p.add_argument("--data", default="data/mnist.npz")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data-parallel", action="store_true",
                   help="train with fit_dp over one rank per visible card")
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate test accuracy every N iterations "
                        "(0 = final only)")
    add_device(p)
    return p.parse_args(argv)


def make_data(args):
    """The images as float32 and the kmeans inducing inputs (100 of them,
    on the host: seconds at 6000 x 784, timed in ``kmeans_s``)."""
    import time

    from scipy.cluster.vq import kmeans2

    if not args.synthetic and os.path.isfile(args.data):
        from doubly_stochastic_dgp_tpu_torch import load_mnist_npz
        d = load_mnist_npz(args.data)
        X, Y, Xs, Ys = d["X"], d["Y"], d["Xs"], d["Ys"]
    else:
        X, Y, Xs, Ys = synthetic_multiclass()
    X = X.astype("float32")
    Xs = Xs.astype("float32")
    t0 = time.perf_counter()
    Z = kmeans2(X, 100, minit="points", seed=0)[0]
    return {"X": X, "Y": Y, "Xs": Xs, "Ys": Ys, "Z": Z,
            "kmeans_s": time.perf_counter() - t0}


def build(args, data, config, device):
    import doubly_stochastic_dgp_tpu_torch as port

    K = 10
    D = data["X"].shape[1]
    dims = [D] + [30] * (args.layers - 1)
    kernels = [port.RBF(d, lengthscales=2.0, variance=2.0) for d in dims]
    return port.DGP.build(data["X"], data["Y"], data["Z"], kernels,
                          port.MultiClass(K), num_outputs=K, num_samples=1,
                          config=config, device=device)


def _evaluate(model, Xs, Ys, S=25):
    """Predictive class probabilities in 1000-row batches (reference
    demo_mnist.ipynb cell 11): S=100 for the final evaluation, a cheaper
    S=25 in the callbacks."""
    from doubly_stochastic_dgp_tpu_torch import evaluate_classification

    r = evaluate_classification(model, Xs, Ys, S=S, batch_size=1000)
    return r["accuracy"], r["loglik"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data_parallel(args, model, device, Xs, Ys):
    """fit_dp over the ranks of the process group (one made here when none
    is up), then the final evaluation with the test rows split over the
    ranks (``dp_evaluate_classification``); returns (history, accuracy,
    loglik)."""
    import torch.distributed as dist

    from doubly_stochastic_dgp_tpu_torch import fit_dp
    from doubly_stochastic_dgp_tpu_torch.parallel import mesh as pm
    from doubly_stochastic_dgp_tpu_torch.parallel.dp import (
        dp_evaluate_classification)

    own = not dist.is_initialized()
    if own:
        pm.initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                  device=device)
    try:
        mesh = pm.make_mesh()
        n_dev = mesh.size()
        B = args.minibatch - args.minibatch % n_dev

        def log(step, m, loss, stats):
            print(f"[dp x{n_dev}] iter {step}: loss {loss:.2f}", flush=True)

        _, hist = fit_dp(model, mesh, args.iterations, learning_rate=0.01,
                         batch_size=B, callbacks=[log], log_every=100)
        r = dp_evaluate_classification(model, Xs, Ys, 100, 0, mesh)
    finally:
        if own:
            dist.destroy_process_group()
    return hist, r["accuracy"], r["loglik"]


def run(args, data=None):
    """(the printed summary, {"model", "history", "data"}); ``data``
    (``make_data``'s) may be handed in to skip the kmeans."""
    from doubly_stochastic_dgp_tpu_torch import fit
    from doubly_stochastic_dgp_tpu_torch.training.monitor import PrintTimings

    device = resolve_device(args.device)
    data = make_data(args) if data is None else data
    Xs, Ys = data["Xs"], data["Ys"]
    model = build(args, data, ACCELERATOR, device)

    if args.data_parallel:
        hist, acc, ll = _data_parallel(args, model, device, Xs, Ys)
    else:
        next_eval = {"at": args.eval_every or float("inf")}

        def acc_cb(step_i, m, loss, stats):
            if step_i >= next_eval["at"]:
                next_eval["at"] = step_i + args.eval_every
                a, l = _evaluate(m, Xs, Ys)
                stats["test_acc"] = a
                print(f"  iter {step_i}: test acc {a:.4f} loglik {l:.4f}",
                      flush=True)

        model, hist = fit(model, args.iterations, learning_rate=0.01,
                          batch_size=args.minibatch,
                          callbacks=[PrintTimings(), acc_cb], log_every=100)
        acc, ll = _evaluate(model, Xs, Ys, S=100)

    summary = {"accuracy": acc, "test_loglik": ll, "layers": args.layers,
               "final_loss": hist[-1]["loss"]}
    return summary, {"model": model, "history": hist, "data": data}


def main(argv=None, data=None):
    """Run the demo and print its summary; ``data`` as in ``run``."""
    summary, _ = run(parse_args(argv), data)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
