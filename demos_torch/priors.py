#!/usr/bin/env python
"""DGP prior-sample demo on the PyTorch port (demos/priors.py): correlated
full-covariance samples from an untrained deep GP, by passing fixed
whitened draws ``zs`` through ``propagate``, along a great circle between
two draws for smooth animations."""

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


def great_circle(z0, z1, t):
    """Spherically interpolate two standard-normal draws: every point on
    the path is marginally N(0,1)."""
    return z0 * np.cos(t) + z1 * np.sin(t)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--frames", type=int, default=8)
    add_device(p)
    return p.parse_args(argv)


def config_of(args):
    """Full-covariance sampling over a dense grid needs a healthier jitter
    (demos/priors.py:36): jitter 1e-4 on the JAX defaults."""
    from doubly_stochastic_dgp_tpu_torch import Config
    return Config(jitter=1e-4)


def make_data(args):
    X = np.linspace(-1, 1, 101)[:, None]
    return {"X": X, "Y": X, "Z": np.linspace(-1, 1, 20)[:, None]}


def build(args, data, config, device):
    import doubly_stochastic_dgp_tpu_torch as port

    kernels = [port.RBF(1, lengthscales=0.3) for _ in range(args.layers)]
    return port.DGP.build(data["X"], data["Y"], data["Z"], kernels,
                          port.Gaussian(0.01), num_samples=1, config=config,
                          device=device)


def run(args):
    device = resolve_device(args.device)
    data = make_data(args)
    X = data["X"]
    N = X.shape[0]
    model = build(args, data, config_of(args), device)

    rng = np.random.RandomState(0)
    S = 1
    z0 = [rng.randn(S, N, l.num_outputs) for l in model.layers]
    z1 = [rng.randn(S, N, l.num_outputs) for l in model.layers]

    frames = []
    with torch.no_grad():
        for i in range(args.frames):
            t = 2 * np.pi * i / args.frames
            zs = [model._as_input(great_circle(a, b, t))
                  for a, b in zip(z0, z1)]
            Fs, _, _ = model.propagate(model._as_input(X), zs=zs, S=S,
                                       full_cov=True)
            frames.append(Fs[-1][0, :, 0].double().cpu().numpy())

    frames = np.stack(frames)
    summary = {
        "frames": args.frames,
        "sample_range": [float(frames.min()), float(frames.max())],
        "frame_to_frame_rms": float(
            np.sqrt(np.mean(np.diff(frames, axis=0) ** 2))),
    }
    return summary, {"model": model, "frames": frames}


def main(argv=None):
    summary, _ = run(parse_args(argv))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
