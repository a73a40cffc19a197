#!/usr/bin/env python
"""DGPDamianou demo on the PyTorch port (demos/damianou.py): the Damianou
& Lawrence (2013) fully-collapsed deep GP trained on a held-out
regression problem, against the collapsed single-layer SGPR baseline and
the doubly-stochastic MC DGP of the same depth.

The Damianou bound is deterministic (the psi statistics integrate the
hidden uncertainty analytically) but full-batch and O(N) in variational
parameters; the Salimbeni MC bound is stochastic but minibatchable.

Numerics: on the card the accelerator branch of the JAX demo (float32,
jitter 1e-5, the staged inverse), on which the psi2 data sum runs in its
CUDA kernel; float32 tracks the float64 trajectory through the early and
middle phase (~1000 iterations at these shapes).  On the CPU, or with
--float64, float64 with jitter 1e-8.

Usage:
  python demos_torch/damianou.py --n 1500 --iterations 1500
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch

from doubly_stochastic_dgp_tpu_torch import resolve_device
from demos_torch._common import ACCELERATOR, add_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1500, help="training rows")
    p.add_argument("--dims", type=int, default=4)
    p.add_argument("--inducing", type=int, default=50)
    p.add_argument("--iterations", type=int, default=1500)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--float64", action="store_true",
                   help="force float64 (the CPU's numerics)")
    add_device(p)
    return p.parse_args(argv)


def config_of(args, device):
    """The accelerator branch on the card (demos/damianou.py:62-70), else
    float64 with jitter 1e-8."""
    from doubly_stochastic_dgp_tpu_torch import Config
    if device.type == "cuda" and not args.float64:
        return ACCELERATOR
    return Config(dtype=torch.float64, jitter=1e-8)


def make_data(args, config):
    from scipy.cluster.vq import kmeans2

    from doubly_stochastic_dgp_tpu_torch.data.datasets import (
        CompositionalRegression)

    data = CompositionalRegression(N=args.n + args.n // 9,
                                   D=args.dims).get_data(split=0)
    dtype = "float64" if config.dtype == torch.float64 else "float32"
    X, Y, Xs, Ys = (data[k].astype(dtype) for k in ("X", "Y", "Xs", "Ys"))
    Z = kmeans2(X, min(args.inducing, len(X) // 2), minit="points",
                seed=0)[0]
    return {"X": X, "Y": Y, "Xs": Xs, "Ys": Ys, "Y_std": data["Y_std"],
            "Z": Z}


def build(args, data, config, device):
    """[(label, model)]: the collapsed 1-layer SGPR, the 2-layer
    Damianou-Lawrence DGP and the 2-layer doubly-stochastic MC DGP."""
    import doubly_stochastic_dgp_tpu_torch as port

    X, Y, Z = data["X"], data["Y"], data["Z"]
    D = X.shape[1]
    lay = port.SGPRLayer(port.RBF(D), Z, Y.shape[1], port.Zero(Y.shape[1]),
                         config=config)
    m_sgpr = port.DGPCollapsed.make(X, Y, port.Gaussian(0.05), [lay],
                                    config=config, device=device)
    m_dam = port.DGPDamianou.build(X, Y, Z, [port.RBF(D), port.RBF(D)],
                                   port.Gaussian(0.05), config=config,
                                   device=device)
    kerns = []
    for l in range(2):
        k = port.RBF(D)
        if l < 1:
            k = k + port.White(D, variance=2e-6, trainable=False)
        kerns.append(k)
    m_dgp = port.DGP.build(X, Y, Z, kerns, port.Gaussian(0.05),
                           num_samples=5, config=config, device=device)
    m_dgp.layers[0].q_sqrt.set_value(m_dgp.layers[0].q_sqrt.value * 1e-5)
    return [("SGPR (collapsed, 1 layer)", m_sgpr),
            ("DGPDamianou (2 layers)", m_dam),
            ("DGP2 (doubly stochastic MC)", m_dgp)]


def train(args, model, label, data, device):
    """Adam on every trainable parameter (``masked_optimizer``), one full
    batch a step, then ``evaluate_regression`` at S=100; returns the
    result and the losses printed."""
    from doubly_stochastic_dgp_tpu_torch import evaluate_regression
    from doubly_stochastic_dgp_tpu_torch.training.optim import (
        make_train_step, masked_optimizer)

    step = make_train_step(lambda m, g: -m.elbo(generator=g),
                           masked_optimizer(model, args.lr))
    g = torch.Generator(device=device).manual_seed(0)
    losses = []
    t0 = time.time()
    for i in range(args.iterations):
        loss = step(model, g)
        if i % max(1, args.iterations // 10) == 0:
            losses.append(float(loss))
            print(f"[{label}] iter {i}: loss {losses[-1]:.2f}")
    losses.append(float(loss))
    dt = time.time() - t0
    res = evaluate_regression(model, data["Xs"], data["Ys"], data["Y_std"],
                              S=100)
    res.update(label=label, seconds=round(dt, 1),
               final_loss=round(float(loss), 2))
    # each model's result as it completes (a long float64 CPU run can be
    # stopped midway; the finished models' numbers are kept)
    print(json.dumps(res, default=float), flush=True)
    return res, losses


def run(args):
    device = resolve_device(args.device)
    config = config_of(args, device)
    data = make_data(args, config)
    results, losses = [], {}
    for label, model in build(args, data, config, device):
        res, losses[label] = train(args, model, label, data, device)
        results.append(res)
    return results, {"losses": losses}


def main(argv=None):
    results, _ = run(parse_args(argv))
    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
