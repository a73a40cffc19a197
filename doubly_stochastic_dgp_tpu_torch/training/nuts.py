"""The No-U-Turn Sampler over a model's trainable parameters.

Counterpart of ``doubly_stochastic_dgp_tpu/training/nuts.py``
(``nuts_sample``, ``nuts_sample_chains``): the multinomial NUTS of
Betancourt (2017) with the JAX package's choices, which the tests pin draw
for draw: leapfrog with a signed step (backward expansion integrates with
-eps, momenta stay in forward time), multinomial sampling inside a
subtree and biased progressive sampling across doublings, the U-turn
checks of every complete power-of-two span inside a subtree from momenta
and momentum sums checkpointed at the span starts ((max_depth + 1, P)
buffers, the iterative scheme of Phan & Pradhan), a leaf whose energy
error is above ``DIVERGENCE_THRESHOLD`` (or NaN) marking the trajectory
divergent and its subtree discarded, the position's log density and
gradient carried with it, dual averaging of the step size from the mean
acceptance statistic of the evaluated leaves (``hmc.DualAveraging``), and
divergences and tree depths counted after burn-in only.

The JAX chain is one ``lax.scan`` whose trees grow in a ``while_loop``.
A CUDA graph has no data-dependent loop, so here a transition is three
kinds of program over device state: ``start`` (draw the momenta, set up
the trajectory), ``doubling(d)`` (choose a direction and integrate a
subtree of 2^d leaves, each leaf's update masked off once the subtree has
turned or diverged, as ``build_subtree`` freezes them, then merge it) and
``finish`` (take the proposal, count, adapt).  On a CUDA tensor each is a
CUDA graph captured at its first use (one a subtree depth) and replayed;
the host reads one flag, turning or diverging, after each doubling: that
read is the only one inside a transition (``info['host_reads']`` counts
them).  A subtree's leaves after a turn cost device time but no draws.
The draws of each program (per transition: the momenta (P,); per
doubling: the direction uniform, the 2^d leaf uniforms, the merge
uniform) are made from the chain's generator before its replay in the
eager order, so a graphed chain takes the eager chain's steps.  On the
CPU, and on the card inside ``graphs.eager_on_card()``, the same code runs
eagerly, also from any draw source (``graphs.randn``).

Chains run one after another, each transition on the same device buffers
(a chain's state is copied in before its transition and out after), in
the order iteration, then chain.  Each chain draws from its own source
(``hmc.chain_generators``, the JAX per-chain keys), so a chain's draws do
not depend on where it runs: ``mesh=`` splits the chains over ranks.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..graphs import rand, randn
from .hmc import (DualAveraging, Program, Target, chain_sources,
                  effective_sample_size, overdispersed_chains,
                  potential_scale_reduction)

__all__ = ["nuts_sample", "nuts_sample_chains", "NUTSChains",
           "DIVERGENCE_THRESHOLD"]

DIVERGENCE_THRESHOLD = 1000.0


def _uturn(span, r_a, r_b):
    """The generalized U-turn criterion of a span: its momentum sum no
    longer points along either end's momentum."""
    return (torch.dot(span, r_a) <= 0.0) | (torch.dot(span, r_b) <= 0.0)


def _where(c, new, old):
    return tuple(torch.where(c, n, o) for n, o in zip(new, old))


class NUTSChains:
    """C NUTS chains over ``log_prob_fn(model)``: :meth:`transition` runs
    one transition of one chain, :meth:`run` the remaining iterations of
    all of them.  ``q0`` (C, P): the starting positions, default the
    model's own; ``generators`` as ``hmc.HMCChains``'s.  ``host_reads`` counts the flags read on the host."""

    def __init__(self, model, log_prob_fn, generators=None, q0=None,
                 num_samples=100, num_burn=100, step_size=0.01, max_depth=8,
                 freeze=None, adapt_step_size=True, target_accept=0.8,
                 target=None):
        t = target or Target(model, log_prob_fn, freeze)
        self.target, self.max_depth = t, int(max_depth)
        q0 = t.flat0[None] if q0 is None else q0
        C, P = q0.shape
        self.generators = chain_sources(generators, C, t.device)
        self.num_burn, self.total = num_burn, num_burn + num_samples
        # the chains' state: position with its log density and gradient,
        # dual averaging, post-warmup counts, iteration
        starts = [t.value_and_grad(q) for q in q0]
        self.chains = {
            "q": q0.clone(), "lp": torch.stack([s[0] for s in starts]),
            "g": torch.stack([s[1] for s in starts]),
            "log_eps": None, "log_eps_bar": None, "Hbar": None,
            "n_div": torch.zeros(C, dtype=torch.int64, device=t.device),
            "sum_depth": torch.zeros(C, dtype=torch.int64, device=t.device),
            "it": torch.zeros(C, dtype=torch.int64, device=t.device)}
        da = DualAveraging(t, C, step_size, num_burn, adapt_step_size,
                           target_accept)
        self.chains.update(log_eps=da.log_eps, log_eps_bar=da.log_eps_bar,
                           Hbar=da.Hbar)
        self.da_final = da
        self.da_keys = ("log_eps", "log_eps_bar", "Hbar")
        # the working slot the programs read and write: one chain's state
        self.da = DualAveraging(t, 1, step_size, num_burn, adapt_step_size,
                                target_accept)
        zP = torch.zeros(P, dtype=t.dtype, device=t.device)
        z0 = torch.zeros((), dtype=t.dtype, device=t.device)
        b0 = torch.zeros((), dtype=torch.bool, device=t.device)
        i0 = torch.zeros((), dtype=torch.int64, device=t.device)
        self.w = {"q": zP.clone(), "lp": z0.clone(), "g": zP.clone(),
                  "log_eps": self.da.log_eps, "log_eps_bar":
                  self.da.log_eps_bar, "Hbar": self.da.Hbar,
                  "n_div": i0.clone(), "sum_depth": i0.clone(),
                  "it": i0.clone()}
        # one transition's trajectory
        self.tr = {"p_sum": zP.clone()}
        for side in ("left", "right"):
            self.tr.update({f"{side}_z": zP.clone(), f"{side}_r": zP.clone(),
                            f"{side}_g": zP.clone(),
                            f"{side}_lp": z0.clone()})
        self.tr.update(prop_z=zP.clone(), prop_lp=z0.clone(),
                       prop_g=zP.clone(), eps=z0.clone(), lw_ref=z0.clone(),
                       lw_tot=z0.clone(), sum_alpha=z0.clone(),
                       n_alpha=z0.clone(), in_burn=b0.clone(),
                       turning=b0.clone(), diverging=b0.clone(),
                       depth=i0.clone())
        # the U-turn checkpoints' static masks, per leaf index i < 2^(D-1):
        # rows k whose 2^k-aligned span starts at i, and (k >= 1) ends at i
        levels = np.arange(self.max_depth + 1)
        idx = np.arange(max(1, 2 ** (self.max_depth - 1)))[:, None]
        pow2 = 2 ** levels[None, :]
        self.set_mask = torch.as_tensor(idx % pow2 == 0, device=t.device)
        self.chk_mask = torch.as_tensor(((idx + 1) % pow2 == 0)
                                        & (levels[None, :] >= 1),
                                        device=t.device)
        self.program = Program(
            t, list(self.w.values()) + list(self.tr.values()),
            "NUTS program")
        self.host_reads = 0
        self.done = 0
        t.rebuild(t.flat0)

    # -- the three programs ---------------------------------------------------
    def _start(self, draws):
        t, w, tr = self.target, self.w, self.tr
        eps, in_burn = self.da.eps(w["it"])
        r0 = randn((w["q"].shape[0],), draws, t.dtype, t.device)
        tr["eps"].copy_(eps[0])
        tr["in_burn"].copy_(in_burn)
        tr["lw_ref"].copy_(w["lp"] - 0.5 * torch.dot(r0, r0))
        for side in ("left", "right"):
            for k in ("q", "g", "lp"):
                tr[f"{side}_{'z' if k == 'q' else k}"].copy_(w[k])
            tr[f"{side}_r"].copy_(r0)
        tr["prop_z"].copy_(w["q"])
        tr["prop_lp"].copy_(w["lp"])
        tr["prop_g"].copy_(w["g"])
        tr["p_sum"].copy_(r0)
        for k in ("lw_tot", "sum_alpha", "n_alpha", "turning", "diverging",
                  "depth"):
            tr[k].zero_()
        return tr["depth"]

    def _leapfrog(self, z, r, g, eps):
        r_half = r + 0.5 * eps * g
        z_new = z + eps * r_half
        lp_new, g_new = self.target.value_and_grad(z_new)
        return z_new, r_half + 0.5 * eps * g_new, g_new, lp_new

    def _subtree(self, edge, n_leaf, eps, u_leaves):
        """``n_leaf`` leaves from ``edge`` = (z, r, g, lp): the
        multinomial proposal, the momentum sum, the checkpointed U-turn
        checks and the divergence flag; a leaf after a turn or a divergence
        leaves every quantity as it was."""
        t, tr = self.target, self.tr
        z, r, g, lp = edge
        K = self.max_depth + 1
        prop = (z, lp, g)
        lw_sub = torch.full_like(lp, -float("inf"))
        cum = torch.zeros_like(z)
        r_ck = torch.zeros((K, z.shape[0]), dtype=t.dtype, device=t.device)
        ps_ck = torch.zeros_like(r_ck)
        turning = torch.zeros((), dtype=torch.bool, device=t.device)
        diverging = torch.zeros_like(turning)
        sum_a, n_eval = torch.zeros_like(lp), torch.zeros_like(lp)
        for i in range(n_leaf):
            live = ~(turning | diverging)
            zn, rn, gn, lpn = self._leapfrog(z, r, g, eps)
            lw_leaf = (lpn - 0.5 * torch.dot(rn, rn)) - tr["lw_ref"]
            bad = torch.isnan(lw_leaf) | (lw_leaf < -DIVERGENCE_THRESHOLD)
            lw_leaf = torch.where(bad, -float("inf"), lw_leaf)
            alpha = torch.clamp(torch.exp(lw_leaf), max=1.0)
            set_mask = self.set_mask[i][:, None]
            r_ck_n = torch.where(set_mask, rn[None], r_ck)
            ps_ck_n = torch.where(set_mask, cum[None], ps_ck)
            cum_n = cum + rn
            span = cum_n[None] - ps_ck_n                          # (K, P)
            turn_k = ((torch.sum(span * r_ck_n, dim=1) <= 0.0)
                      | (span @ rn <= 0.0))
            turning_n = torch.any(self.chk_mask[i] & turn_k)
            lw_n = torch.logaddexp(lw_sub, lw_leaf)
            take = torch.log(u_leaves[i]) < lw_leaf - lw_n
            prop_n = _where(take, (zn, lpn, gn), prop)
            z, r, g, lp = _where(live, (zn, rn, gn, lpn), (z, r, g, lp))
            prop = _where(live, prop_n, prop)
            lw_sub, cum, r_ck, ps_ck, turning, diverging, sum_a, n_eval = \
                _where(live, (lw_n, cum_n, r_ck_n, ps_ck_n, turning_n,
                              diverging | bad, sum_a + alpha, n_eval + 1.0),
                       (lw_sub, cum, r_ck, ps_ck, turning, diverging, sum_a,
                        n_eval))
        return ((z, r, g, lp), prop, lw_sub, cum, turning, diverging, sum_a,
                n_eval)

    def _doubling(self, d, draws):
        t, tr = self.target, self.tr
        go_right = rand((), draws, t.dtype, t.device) < 0.5
        sides = {s: tuple(tr[f"{s}_{k}"] for k in ("z", "r", "g", "lp"))
                 for s in ("left", "right")}
        edge = _where(go_right, sides["right"], sides["left"])
        eps = torch.where(go_right, tr["eps"], -tr["eps"])
        u_leaves = rand((2 ** d,), draws, t.dtype, t.device)
        (edge_n, sub_prop, lw_sub, p_sub, turn_sub, div_sub, sum_a,
         n_eval) = self._subtree(edge, 2 ** d, eps, u_leaves)
        ok = ~turn_sub & ~div_sub
        # biased progressive sampling across the doubling
        u_take = rand((), draws, t.dtype, t.device)
        take = (torch.log(u_take) < lw_sub - tr["lw_tot"]) & ok
        prop = (tr["prop_z"], tr["prop_lp"], tr["prop_g"])
        torch._foreach_copy_(list(prop), list(_where(take, sub_prop, prop)))
        tr["lw_tot"].copy_(torch.where(
            ok, torch.logaddexp(tr["lw_tot"], lw_sub), tr["lw_tot"]))
        tr["p_sum"].copy_(torch.where(ok, tr["p_sum"] + p_sub, tr["p_sum"]))
        for side, pick in (("right", ok & go_right), ("left", ok & ~go_right)):
            torch._foreach_copy_(list(sides[side]),
                                 list(_where(pick, edge_n, sides[side])))
        tr["turning"].copy_(turn_sub | _uturn(tr["p_sum"], tr["left_r"],
                                              tr["right_r"]))
        tr["diverging"].copy_(tr["diverging"] | div_sub)
        tr["depth"].add_(1)
        tr["sum_alpha"].add_(sum_a)
        tr["n_alpha"].add_(n_eval)
        return tr["turning"] | tr["diverging"]

    def _finish(self, draws):
        w, tr = self.w, self.tr
        mean_alpha = tr["sum_alpha"] / torch.clamp(tr["n_alpha"], min=1.0)
        w["q"].copy_(tr["prop_z"])
        w["lp"].copy_(tr["prop_lp"])
        w["g"].copy_(tr["prop_g"])
        # post-warmup divergences and tree depths only (Stan's convention)
        w["n_div"].add_((tr["diverging"] & ~tr["in_burn"]).long())
        w["sum_depth"].add_(torch.where(tr["in_burn"], 0, tr["depth"]))
        self.da.update_(w["it"], tr["in_burn"], mean_alpha[None])
        w["it"].add_(1)
        return w["q"].clone(), mean_alpha.clone()

    # -- driving --------------------------------------------------------------
    @torch.no_grad()
    def transition(self, c=0):
        """One transition of chain ``c``: (position (P,), mean acceptance
        statistic ()), on the device."""
        slot = [v[c:c + 1] if v.ndim == 1 and k in self.da_keys else v[c]
                for k, v in self.chains.items()]
        torch._foreach_copy_(list(self.w.values()), slot)
        def run(key, body):
            return self.program.run(key, lambda dr: body(dr[0]),
                                    self.generators[c:c + 1])

        run("start", self._start)
        for d in range(self.max_depth):
            stop = run(("doubling", d), lambda dr, d=d: self._doubling(d, dr))
            self.host_reads += 1
            if bool(stop):
                break
        out = run("finish", self._finish)
        torch._foreach_copy_(slot, list(self.w.values()))
        return out

    def run(self):
        """The remaining iterations: positions (T, C, P) and mean
        acceptance statistics (T, C)."""
        qs, alphas = [], []
        C = self.chains["q"].shape[0]
        while self.done < self.total:
            outs = [self.transition(c) for c in range(C)]
            qs.append(torch.stack([o[0] for o in outs]))
            alphas.append(torch.stack([o[1] for o in outs]))
            self.done += 1
        self.target.rebuild(self.target.flat0)
        return torch.stack(qs), torch.stack(alphas)

    def step_sizes(self):
        return self.da_final.final_step_sizes()


def nuts_sample(model, log_prob_fn: Callable, generator=None,
                num_samples: int = 100, num_burn: int = 100,
                step_size: float = 0.01, max_depth: int = 8,
                freeze=None, adapt_step_size: bool = True,
                target_accept: float = 0.8, compute_ess: bool = False):
    """Run NUTS; returns (samples, accept_stat, rebuild, info).

    As :func:`.hmc.hmc_sample`: ``samples`` (num_samples, P) on the
    model's device, ``rebuild(vec)``, ``log_prob_fn(model)``, and
    ``generator`` a ``torch.Generator`` (default: seeded with 0) or,
    eagerly, a draw source.  ``max_depth`` caps the doublings;
    ``step_size`` is the initial guess under ``adapt_step_size``.  ``info``:
    accept_stat, step_size, divergences and mean_tree_depth (after
    burn-in), host_reads (flags read on the host, one a doubling) and
    host_reads_per_transition, and ess with ``compute_ess``."""
    chains = NUTSChains(model, log_prob_fn, generator, None, num_samples,
                        num_burn, step_size, max_depth, freeze,
                        adapt_step_size, target_accept)
    qs, alphas = chains.run()
    samples = qs[num_burn:, 0]
    accept_stat = float(torch.mean(alphas[num_burn:, 0]))
    info = {
        "accept_stat": accept_stat,
        "step_size": float(chains.step_sizes()[0]),
        "divergences": int(chains.chains["n_div"][0]),
        "mean_tree_depth": float(chains.chains["sum_depth"][0])
        / max(num_samples, 1),
        "host_reads": chains.host_reads,
        "host_reads_per_transition": chains.host_reads / chains.total,
    }
    if compute_ess and num_samples >= 2:
        info["ess"] = effective_sample_size(
            samples.double().cpu().numpy()[None])
    return samples, accept_stat, chains.target.rebuild, info


def nuts_sample_chains(model, log_prob_fn: Callable, generator=None,
                       num_chains: int = 4, num_samples: int = 100,
                       num_burn: int = 100, step_size: float = 0.01,
                       max_depth: int = 8, freeze=None,
                       adapt_step_size: bool = True,
                       target_accept: float = 0.8,
                       init_jitter: float = 0.1, mesh=None,
                       chain_axis: str = None):
    """C chains from overdispersed starts, each adapting its own step
    size and growing its own trees.  Returns (samples (C, S, P),
    accept_stats (C,), rebuild, info with per-chain step sizes, divergence
    counts and mean tree depths, split R-hat, ESS and the host reads,
    this rank's).

    ``generator`` and ``mesh`` as ``hmc.hmc_sample_chains``'s: the starts,
    then each chain's own generator; ``mesh`` splits the chains over the
    mesh axis ``chain_axis``, each rank running its block, and the draws
    and statistics are gathered on every rank."""
    target = Target(model, log_prob_fn, freeze)
    q0, sources, gather = overdispersed_chains(
        target, generator, num_chains, init_jitter, mesh, chain_axis)
    chains = NUTSChains(model, log_prob_fn, sources, q0, num_samples,
                        num_burn, step_size, max_depth, freeze,
                        adapt_step_size, target_accept, target=target)
    qs, alphas = chains.run()
    samples = gather(qs[num_burn:].transpose(0, 1).contiguous())
    stats = gather(torch.stack([torch.mean(alphas[num_burn:], dim=0),
                                chains.da_final.log_eps_bar], dim=1))
    counts = gather(torch.stack([chains.chains["n_div"],
                                 chains.chains["sum_depth"]], dim=1))
    host = samples.double().cpu().numpy()
    info = {
        "accept_stats": stats[:, 0].double().cpu().numpy(),
        "step_sizes": (np.exp(stats[:, 1].double().cpu().numpy())
                       if adapt_step_size
                       else np.full(num_chains, step_size)),
        "divergences": counts[:, 0].cpu().numpy(),
        "mean_tree_depths": counts[:, 1].cpu().numpy()
        / max(num_samples, 1),
        "rhat": potential_scale_reduction(host),
        "ess": effective_sample_size(host),
        "host_reads": chains.host_reads,
    }
    return samples, info["accept_stats"], target.rebuild, info
