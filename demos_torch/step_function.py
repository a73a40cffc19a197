#!/usr/bin/env python
"""Step-function demo on the PyTorch port (demos/step_function.py): 2- and
3-layer DGPs on 1D step data with num_samples=100, Adam(0.01): the
non-Gaussian multi-modal predictive a deep GP produces at the
discontinuity.  Prints per-layer sample statistics as a JSON summary."""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

from doubly_stochastic_dgp_tpu_torch import resolve_device
from demos_torch._common import add_device


def make_step_data(N=50, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(N, 1) * 2 - 1
    Y = (X > 0).astype(float) + rng.randn(N, 1) * 0.02
    return X, Y


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--num-samples", type=int, default=100)
    add_device(p)
    return p.parse_args(argv)


def make_data(args):
    X, Y = make_step_data()
    return {"X": X, "Y": Y, "Z": np.linspace(-1, 1, 25)[:, None]}


def build(args, data, config, device):
    import doubly_stochastic_dgp_tpu_torch as port

    kernels = [port.RBF(1, lengthscales=0.2) for _ in range(args.layers)]
    return port.DGP.build(data["X"], data["Y"], data["Z"], kernels,
                          port.Gaussian(0.01), num_samples=args.num_samples,
                          config=config, device=device)


def run(args):
    from doubly_stochastic_dgp_tpu_torch import Config, fit
    from doubly_stochastic_dgp_tpu_torch.training.monitor import PrintTimings

    device = resolve_device(args.device)
    model = build(args, make_data(args), Config(), device)
    model, hist = fit(model, args.iterations, learning_rate=0.01,
                      callbacks=[PrintTimings()], log_every=100)

    Xs = np.linspace(-1.5, 1.5, 101)[:, None]
    g = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        Fs, _, _ = model.predict_all_layers(Xs, S=50, generator=g)
    Fs = [F.double().cpu().numpy() for F in Fs]
    summary = {
        "final_loss": hist[-1]["loss"],
        "layers": [
            {"layer": i,
             "sample_mean_range": [float(F.mean(0).min()),
                                   float(F.mean(0).max())],
             "sample_std_max": float(F.std(0).max())}
            for i, F in enumerate(Fs)
        ],
    }
    return summary, {"model": model, "history": hist}


def main(argv=None):
    summary, _ = run(parse_args(argv))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
