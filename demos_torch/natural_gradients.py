#!/usr/bin/env python
"""Natural-gradients demo on the PyTorch port
(demos/natural_gradients.py): on a 1D toy problem, Adam alone against
the alternating NatGrad(final layer) + Adam loop, which converges the
variational distribution much faster."""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

from doubly_stochastic_dgp_tpu_torch import resolve_device
from demos_torch._common import add_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=300)
    p.add_argument("--gamma", type=float, default=1.0)
    add_device(p)
    return p.parse_args(argv)


def make_data(args):
    rng = np.random.RandomState(0)
    N = 60
    X = rng.rand(N, 1) * 2 - 1
    Y = np.sin(3 * X) + rng.randn(N, 1) * 0.1
    return {"X": X, "Y": Y, "Z": np.linspace(-1, 1, 20)[:, None]}


def build(args, data, config, device):
    import doubly_stochastic_dgp_tpu_torch as port

    kernels = [port.RBF(1, lengthscales=0.3), port.RBF(1, lengthscales=0.3)]
    return port.DGP.build(data["X"], data["Y"], data["Z"], kernels,
                          port.Gaussian(0.05), num_samples=5, config=config,
                          device=device)


def run(args):
    from doubly_stochastic_dgp_tpu_torch import Config, fit

    device = resolve_device(args.device)
    data = make_data(args)
    m_adam, h_adam = fit(build(args, data, Config(), device),
                         args.iterations, learning_rate=0.01, log_every=50)
    m_ng, h_ng = fit(build(args, data, Config(), device), args.iterations,
                     learning_rate=0.01, natgrad_gamma=args.gamma,
                     log_every=50)
    summary = {
        "adam_only_loss": h_adam[-1]["loss"],
        "natgrad_adam_loss": h_ng[-1]["loss"],
        "natgrad_better_by": h_adam[-1]["loss"] - h_ng[-1]["loss"],
    }
    return summary, {"model": m_ng, "history": h_ng,
                     "histories": [h_adam, h_ng]}


def main(argv=None):
    summary, _ = run(parse_args(argv))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
