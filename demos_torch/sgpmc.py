#!/usr/bin/env python
"""Sparse GP MCMC demo on the PyTorch port (demos/sgpmc.py): HMC over the
inducing values of an SGPMC layer (reference layers.py:249-260) on a 1-D
regression with M << N inducing points.

The chain targets the ELBO at fixed draws plus the N(0, 1) prior on the
whitened q_mu, with a dual-averaged step size; on the card a chunk of
iterations is one captured CUDA graph.  The posterior predictive is the
mixture over thinned draws.  ``--sampler nuts`` swaps in the No-U-Turn
sampler (same target, same diagnostics).  Prints a JSON summary.
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
from demos_torch._common import add_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-data", type=int, default=80)
    p.add_argument("--num-inducing", type=int, default=12)
    p.add_argument("--num-samples", type=int, default=500)
    p.add_argument("--num-burn", type=int, default=300)
    p.add_argument("--num-leapfrog", type=int, default=10)
    p.add_argument("--sampler", choices=["hmc", "nuts"], default="hmc")
    p.add_argument("--max-depth", type=int, default=7,
                   help="NUTS doubling cap (ignored for hmc)")
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    return p.parse_args(argv)


def make_data(args):
    rng = np.random.default_rng(args.seed)
    N, M = args.num_data, args.num_inducing
    X = np.sort(rng.uniform(-1, 1, (N, 1)), axis=0)
    f_true = np.sin(6 * X) * np.exp(-X)
    Y = f_true + rng.normal(size=(N, 1)) * 0.1
    return {"X": X, "Y": Y, "Z": np.linspace(-1, 1, M)[:, None],
            "Xs": np.linspace(-1.1, 1.1, 60)[:, None]}


def build(args, data, config, device):
    import doubly_stochastic_dgp_tpu_torch as port

    kern = port.RBF(1, lengthscales=0.4)
    layer = port.SGPMCLayer(kern, data["Z"], 1, white=True, config=config)
    return port.DGPBase.make(data["X"], data["Y"], port.Gaussian(0.05),
                             [layer], num_samples=1, config=config,
                             device=device)


def run(args):
    import doubly_stochastic_dgp_tpu_torch as port

    device = resolve_device(args.device)
    data = make_data(args)
    model = build(args, data, port.Config(), device)

    # the ELBO's draws fixed once (the JAX demo's fixed key)
    g = torch.Generator(device=device).manual_seed(7)
    zs = [torch.randn((1, data["X"].shape[0], layer.num_outputs),
                      generator=g, dtype=model.X_data.dtype, device=device)
          for layer in model.layers]

    def log_post(m):
        return m.elbo(zs=zs) + port.log_prior(m)

    def freeze(name, param):          # sample only the inducing values
        return "q_mu" not in name

    key = torch.Generator(device=device).manual_seed(args.seed)
    if args.sampler == "nuts":
        samples, acc, rebuild, info = port.nuts_sample(
            model, log_post, key, num_samples=args.num_samples,
            num_burn=args.num_burn, step_size=0.1, max_depth=args.max_depth,
            freeze=freeze)
        step_size, extra = info["step_size"], {
            "mean_tree_depth": round(info["mean_tree_depth"], 2),
            "divergences": info["divergences"]}
    else:
        samples, acc, rebuild, info = port.hmc_sample(
            model, log_post, key, num_samples=args.num_samples,
            num_burn=args.num_burn, step_size=0.1,
            num_leapfrog=args.num_leapfrog, freeze=freeze,
            adapt_step_size=True)
        step_size, extra = info.step_size, {}

    samples = samples.double().cpu().numpy()
    thin = samples[:: max(1, args.num_samples // 40)]
    Xs = data["Xs"]
    mus, vars_ = [], []
    with torch.no_grad():
        for v in thin:
            m = rebuild(torch.as_tensor(v, dtype=model.X_data.dtype,
                                        device=device))
            mu, var = m.predict_y(Xs, S=1)
            mus.append(mu[0].double().cpu().numpy())
            vars_.append(var[0].double().cpu().numpy())
    mu_mix = np.mean(mus, 0)
    var_mix = np.mean(np.asarray(vars_) + np.asarray(mus) ** 2, 0) \
        - mu_mix ** 2

    f_ref = np.sin(6 * Xs) * np.exp(-Xs)
    inside = np.mean((f_ref >= mu_mix - 1.96 * np.sqrt(var_mix))
                     & (f_ref <= mu_mix + 1.96 * np.sqrt(var_mix)))
    ess = port.effective_sample_size(samples[None])
    summary = {
        "sampler": args.sampler,
        "accept_rate": round(float(acc), 3),
        "adapted_step_size": round(float(step_size), 4),
        "ess_min": int(ess.min()), "ess_median": int(np.median(ess)),
        "posterior_mean_rmse_vs_truth": round(float(
            np.sqrt(np.mean((mu_mix - f_ref) ** 2))), 4),
        "truth_coverage_95": round(float(inside), 3),
        **extra,
    }
    return summary, {"model": model, "samples": samples}


def main(argv=None):
    summary, _ = run(parse_args(argv))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
