#!/usr/bin/env python3
"""Fixed-length HMC resonance on ``chip_smoke.py``'s phase-28b target.

    python3 tools/hmc_resonance.py [--seed 0] [--threads 4] [RUN ...]

Phase 28b samples the exactly Gaussian posterior over the inducing values
of one white SGPMC layer (M=100, the 7372 headline rows, Gaussian 0.05)
in float32 on the card and holds the samples against the closed form.
This script runs the same target in float64 on the CPU through the
port's ``hmc_sample`` (no card, no kernel: on a CPU tensor the wrappers
run their plain versions) with 28b's burn-in, samples, initial step and
dual averaging, at 10 and at 5 leapfrog steps, and at 10 steps with the
step fixed at ``FIXED_STEP``, the step 28b adapted to on an H100 with
10 steps.  For each run it prints what 28b prints: the
adapted step, the closest approach of a trajectory's rotation to a whole
turn over the target's eigen-directions (``closed_form_resonance``), ESS
min and median, the largest mean error against 4.5 max sd / sqrt(ESS
min), and the largest marginal-sd error against 28b's 0.25.  RUN picks
some of the three runs (``10``, ``5``, ``10-fixed``; default all), so
that they can go in parallel processes.  A chain whose rotation comes
near a whole turn in some direction barely moves along it, so it mixes
there slowly and its marginal sds come out wrong, too large or too
small.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# leapfrog steps and whether the step adapts, by run
RUNS = {"10": (10, True), "5": (5, True), "10-fixed": (10, False)}
FIXED_STEP = 0.0319


def run(model, logp, mu, sd, Sig, seed, L, adapt, step):
    g = torch.Generator().manual_seed(seed + 281)
    burn, n = cs.CLOSED_HMC
    t0 = time.perf_counter()
    s, acc, _, info = cs.hmc_sample(
        model, logp, g, num_samples=n, num_burn=burn, step_size=step,
        num_leapfrog=L, freeze=cs.q_mu_only, adapt_step_size=adapt)
    wall = time.perf_counter() - t0
    s = s.numpy()
    ess = cs.effective_sample_size(s[None])
    bound = 4.5 * sd.max() / np.sqrt(ess.min())
    mean_err = np.abs(s.mean(0) - mu).max()
    sd_rel = s.std(0) / sd - 1.0
    turn, sd_there = cs.closed_form_resonance(Sig, info.step_size, L)
    print(f"L={L} {'adapted from' if adapt else 'fixed'} step {step}: "
          f"{burn} + {n} iterations in {wall:.1f} s; accept {acc:.3f}; "
          f"step {info.step_size:.6g}; closest to a turn {turn:.4f} rad "
          f"(eigen-sd there {sd_there:.4f}); ESS min {ess.min():.1f} median "
          f"{np.median(ess):.1f}; max |mean - mu| {mean_err:.4e} (bound "
          f"{bound:.4e}); max |sd / sd_true - 1| {np.abs(sd_rel).max():.4f} "
          f"(gate 0.25), most shrunk {sd_rel.min():.4f}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("runs", nargs="*", choices=sorted(RUNS),
                        default=list(RUNS))
    args = parser.parse_args()
    torch.set_num_threads(args.threads)
    model, _ = cs.sgpmc_model(args.seed, layers=1, device="cpu",
                              dtype=torch.float64)
    g = torch.Generator().manual_seed(args.seed + 28)
    zs = [torch.randn(1, model.X_data.shape[0], 1, generator=g,
                      dtype=torch.float64)]

    def logp(m):
        return m.elbo(zs=zs) + cs.log_prior(m)

    mu, sd, Sig = cs.closed_form_posterior(model)
    print(f"28b target in float64 on the CPU: posterior sds "
          f"{sd.min():.4f}-{sd.max():.4f}", flush=True)
    for name in args.runs:
        L, adapt = RUNS[name]
        step = FIXED_STEP if name == "10-fixed" else cs.MC_STEP
        run(model, logp, mu, sd, Sig, args.seed, L, adapt, step)


if __name__ == "__main__":
    main()
