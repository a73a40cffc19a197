"""Hamiltonian Monte Carlo over a model's trainable parameters.

Counterpart of ``doubly_stochastic_dgp_tpu/training/hmc.py``
(``hmc_sample``, ``hmc_sample_chains``, ``potential_scale_reduction``,
``effective_sample_size``, ``HMCInfo``).  The target is
``log_prob_fn(model)``, e.g. ``elbo + log_prior`` over the inducing values
of ``SGPMCLayer``s, or ``DGPHeinonen.log_posterior``; the position is the
flat vector of the trainable parameters (``optim.partition_trainable``,
whose ``rebuild`` writes a position into the model's parameters in place).
Each iteration draws momenta, integrates ``num_leapfrog`` leapfrog steps
(``num_leapfrog + 1`` gradient evaluations, as the JAX kernel), accepts by
Metropolis with a NaN energy counted as a rejection, and during burn-in
adapts the step size by dual averaging (Hoffman & Gelman 2014, Alg. 5:
t0 = 10, gamma = 0.05, kappa = 0.75), frozen at its averaged value after.

On a CUDA tensor a chunk of ``CHUNK`` iterations is one captured CUDA
graph (``graphs.CapturedCall``), replayed per chunk: the chain's state
(positions, log densities, acceptance counts, the dual-averaging state and
the iteration count) lives in device tensors the graph updates in place,
and nothing is read on the host inside a chunk.  The momenta and the
accept uniforms of a chunk are drawn from the caller's generator before
each replay, in the eager order (``graphs.DrawTape``), so a graphed chain
takes the eager chain's steps.  On the CPU, and on the card inside
``graphs.eager_on_card()``, the same code runs eagerly; there the draws
may also come from any draw source (``graphs.randn``), which is how the
tests replay the JAX package's keys.  Draw order: ``hmc_sample_chains``
draws the (C, P) normals of its overdispersed starts from the caller's
generator, then gives each chain a draw source of its own
(:func:`chain_generators`, as JAX splits its run key into one key a
chain); ``hmc_sample``'s one chain draws from the caller's generator
itself (JAX: its key).  Per iteration a chain draws its momenta (P,), then
its accept uniform, from its own source, so a chain's draws do not depend
on where it runs: ``mesh=`` splits the chains over ranks (the JAX
``shard_chains``) and the ranks draw what one process draws.

Chains: JAX ``vmap``s them into one batched program.  Here they run one
after another inside the captured chunk (the kernels' autograd Functions
have no vmap rule), so C chains cost C times one chain's device time.

The samplers leave the model's parameters as they found them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..graphs import CapturedCall, DrawTape, graphs_enabled, rand, randn
from .optim import partition_trainable, trainable_parameters, value_and_grads

__all__ = ["hmc_sample", "hmc_sample_chains", "HMCChains",
           "chain_generators", "potential_scale_reduction",
           "effective_sample_size", "HMCInfo"]

# dual-averaging constants (Hoffman & Gelman 2014)
DA_T0, DA_GAMMA, DA_KAPPA = 10.0, 0.05, 0.75
# iterations a captured graph runs on the card
CHUNK = 10


class HMCInfo(NamedTuple):
    accept_rate: float        # over the whole chain (burn + sampling)
    step_size: float          # final (adapted) step size
    final_log_prob: float


class Target:
    """The log density over flat positions and its gradient:
    ``value_and_grad(q)`` writes q into the model (``rebuild``) and
    returns (log p, d log p / dq) as detached tensors."""

    def __init__(self, model, log_prob_fn, freeze=None):
        self.flat0, self.rebuild = partition_trainable(model, freeze)
        self.params = trainable_parameters(model, freeze)
        self.model, self.log_prob_fn = model, log_prob_fn
        self.dtype, self.device = self.flat0.dtype, self.flat0.device

    def value_and_grad(self, q):
        self.rebuild(q)
        lp, grads = value_and_grads(lambda: self.log_prob_fn(self.model),
                                    self.params)
        return lp, torch.cat([g.reshape(-1) for g in grads])

    @torch.no_grad()
    def value(self, q):
        self.rebuild(q)
        return self.log_prob_fn(self.model).detach()

    def scalar(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)


class DualAveraging:
    """The step-size state of C chains, (C,) tensors advanced in place:
    log_eps, log_eps_bar, Hbar."""

    def __init__(self, target, num_chains, step_size, num_burn,
                 adapt, target_accept):
        log0 = math.log(step_size)
        self.log_eps = torch.full((num_chains,), log0, dtype=target.dtype,
                                  device=target.device)
        self.log_eps_bar = self.log_eps.clone()
        self.Hbar = torch.zeros_like(self.log_eps)
        self.mu = torch.log(target.scalar(10.0 * step_size))
        self.step_size = target.scalar(step_size)
        self.num_burn, self.adapt = num_burn, adapt
        self.target_accept = target_accept

    def tensors(self):
        return [self.log_eps, self.log_eps_bar, self.Hbar]

    def eps(self, it):
        """This iteration's step sizes (C,) and whether it is in burn-in."""
        in_burn = it < self.num_burn
        if not self.adapt:
            return self.step_size.expand_as(self.log_eps), in_burn
        return torch.exp(torch.where(in_burn, self.log_eps,
                                     self.log_eps_bar)), in_burn

    def update_(self, it, in_burn, alpha):
        """Dual averaging toward ``target_accept`` at iteration ``it`` from
        the acceptance statistics ``alpha`` (C,), during burn-in only."""
        if not self.adapt:
            return
        m = (it + 1).to(self.log_eps.dtype)
        Hbar_n = ((1.0 - 1.0 / (m + DA_T0)) * self.Hbar
                  + (self.target_accept - alpha) / (m + DA_T0))
        log_eps_n = self.mu - torch.sqrt(m) / DA_GAMMA * Hbar_n
        eta = m ** (-DA_KAPPA)
        log_eps_bar_n = eta * log_eps_n + (1.0 - eta) * self.log_eps_bar
        self.Hbar.copy_(torch.where(in_burn, Hbar_n, self.Hbar))
        self.log_eps.copy_(torch.where(in_burn, log_eps_n, self.log_eps))
        self.log_eps_bar.copy_(torch.where(in_burn, log_eps_bar_n,
                                           self.log_eps_bar))

    def final_step_sizes(self):
        if not self.adapt:
            return np.full(self.log_eps.shape[0], float(self.step_size))
        return np.exp(self.log_eps_bar.double().cpu().numpy())


class Program:
    """Bodies that advance a sampler's device state in place, each run
    eagerly or, on a CUDA tensor outside ``graphs.eager_on_card()``, as a
    CUDA graph captured at its first call under ``key`` and replayed after.

    ``state`` lists the persistent tensors the bodies write (with the
    model's parameters): a capture's eager warm-up runs the body from a
    snapshot of them and of the generators, and restores them, so it takes
    no step.  ``sources``: the body's draw sources, a list; a graphed body
    needs each to be a ``torch.Generator`` on the device, and before each
    replay its draws are made from them into the tapes' buffers in the
    eager order."""

    def __init__(self, target, state, what):
        self.target, self.state, self.what = target, state, what
        self.graphs = {}

    def run(self, key, body, sources):
        """``body(draws)``, ``draws`` a list of one draw source for each of
        ``sources``."""
        if not graphs_enabled(self.target.device):
            return body(sources)
        if not all(isinstance(g, torch.Generator) for g in sources):
            raise ValueError(f"{self.what}: a graphed chain draws from a "
                             f"torch.Generator on {self.target.device}")
        if key not in self.graphs:
            self.graphs[key] = self._capture(key, body, sources)
        tapes, call = self.graphs[key]
        for tape, g in zip(tapes, sources):
            tape.fill(g)
        out = call.replay()
        return tuple(o.clone() for o in out) if isinstance(out, tuple) \
            else out.clone()

    def _capture(self, key, body, sources):
        tapes = [DrawTape(g) for g in sources]
        written = self.state + self.target.params
        saved = [t.detach().clone() for t in written]
        gen_states = [g.get_state() for g in sources]

        def warmup():
            with torch.no_grad():
                body(tapes)
                torch._foreach_copy_(written, saved)
            for g, state, tape in zip(sources, gen_states, tapes):
                g.set_state(state)
                tape.freeze()

        return tapes, CapturedCall(lambda: body(tapes), warmup,
                                   f"{self.what} {key}")


def _leapfrog(target, q, p, eps, num_leapfrog):
    """The JAX leapfrog: a half momentum step from grad(q), full steps,
    a last half step; returns (q, p, log p(q))."""
    _, g = target.value_and_grad(q)
    p = p + 0.5 * eps * g
    for _ in range(num_leapfrog - 1):
        q = q + eps * p
        _, g = target.value_and_grad(q)
        p = p + eps * g
    q = q + eps * p
    lp_new, g = target.value_and_grad(q)
    p = p + 0.5 * eps * g
    return q, p, lp_new


class HMCChains:
    """C HMC chains over ``log_prob_fn(model)``, their device state and
    the program that advances it: :meth:`run_chunk` runs the next chunk
    of iterations (one graph replay on the card) and returns its
    positions (n, C, P) without a host read; :meth:`run` runs the rest.
    ``q0`` (C, P): the starting positions, default the model's own;
    ``generators``: one draw source a chain, each a ``torch.Generator`` on
    the model's device or, eagerly, any draw source; a lone chain may be
    given its one source (default: a generator seeded with 0).
    ``program.graphs`` maps each captured chunk length to its (tapes,
    ``CapturedCall``)."""

    def __init__(self, model, log_prob_fn, generators=None, q0=None,
                 num_samples=100, num_burn=100, step_size=0.01,
                 num_leapfrog=10, freeze=None, adapt_step_size=False,
                 target_accept=0.8, target=None):
        t = target or Target(model, log_prob_fn, freeze)
        self.target, self.L = t, num_leapfrog
        q0 = t.flat0[None] if q0 is None else q0
        self.generators = chain_sources(generators, q0.shape[0], t.device)
        self.q = q0.clone()                                   # (C, P)
        self.lp = torch.stack([t.value(q) for q in q0])       # (C,)
        self.acc = torch.zeros_like(self.lp)
        self.it = torch.zeros((), dtype=torch.int64, device=t.device)
        self.da = DualAveraging(t, q0.shape[0], step_size, num_burn,
                                adapt_step_size, target_accept)
        self.num_burn, self.total = num_burn, num_burn + num_samples
        self.done = 0
        self.program = Program(
            t, [self.q, self.lp, self.acc, self.it] + self.da.tensors(),
            "HMC chunk of")
        t.rebuild(t.flat0)

    @torch.no_grad()
    def iteration(self, draws):
        """One HMC iteration of every chain; returns the positions (C,
        P).  ``draws``: one source a chain (its momenta, then its accept
        uniform)."""
        t = self.target
        P = self.q.shape[1]
        eps, in_burn = self.da.eps(self.it)
        p0 = [randn((P,), d, t.dtype, t.device) for d in draws]
        outs = [_leapfrog(t, self.q[c], p, eps[c], self.L)
                for c, p in enumerate(p0)]
        q_new = torch.stack([o[0] for o in outs])
        lp_new = torch.stack([o[2] for o in outs])
        log_u = torch.log(torch.stack([rand((), d, t.dtype, t.device)
                                       for d in draws]))
        # each chain's energy change from its own vectors: a chain's
        # numbers do not depend on how many chains run beside it
        log_alpha = torch.stack([
            o[2] - self.lp[c] - 0.5 * torch.sum(o[1] ** 2)
            + 0.5 * torch.sum(p ** 2)
            for c, (o, p) in enumerate(zip(outs, p0))])
        # divergences (NaN energy) count as acceptance probability 0
        nan = torch.isnan(log_alpha)
        alpha = torch.where(nan, 0.0,
                            torch.clamp(torch.exp(log_alpha), max=1.0))
        accept = log_u < torch.where(nan, -math.inf, log_alpha)
        self.q.copy_(torch.where(accept[:, None], q_new, self.q))
        self.lp.copy_(torch.where(accept, lp_new, self.lp))
        self.acc.add_(accept.to(self.acc.dtype))
        self.da.update_(self.it, in_burn, alpha)
        self.it.add_(1)
        return self.q.clone()

    def run_chunk(self, n=None):
        n = min(n or CHUNK, self.total - self.done)
        out = self.program.run(
            n, lambda d: torch.stack([self.iteration(d) for _ in range(n)]),
            self.generators)
        self.done += n
        self.target.rebuild(self.target.flat0)
        return out

    def run(self):
        """The remaining iterations' positions (T, C, P)."""
        out = []
        while self.done < self.total:
            out.append(self.run_chunk())
        return torch.cat(out)


def _default_generator(generator, device):
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


def chain_sources(generators, num_chains: int, device):
    """``generators`` as a list of one draw source a chain: a sequence of
    ``num_chains`` as given; a lone chain's one source (default: a
    generator seeded with 0) in a list."""
    if isinstance(generators, (list, tuple)):
        if len(generators) != num_chains:
            raise ValueError(f"{len(generators)} draw sources for "
                             f"{num_chains} chains")
        return list(generators)
    if num_chains != 1:
        raise ValueError(f"{num_chains} chains need one draw source each "
                         f"(chain_generators)")
    return [_default_generator(generators, device)]


def hmc_sample(model, log_prob_fn: Callable, generator=None,
               num_samples: int = 100, num_burn: int = 100,
               step_size: float = 0.01, num_leapfrog: int = 10,
               freeze=None, adapt_step_size: bool = False,
               target_accept: float = 0.8):
    """Run HMC; returns (samples, accept_rate, rebuild, info).

    ``samples`` is (num_samples, P), the positions after burn-in, on the
    model's device; ``rebuild(vec)`` writes a position into the model and
    returns it.  ``log_prob_fn(model)`` is the un-normalized log target.
    ``generator``: a ``torch.Generator`` on the model's device (default:
    seeded with 0) or, eagerly, a draw source.  ``adapt_step_size=True``
    tunes the step size by dual averaging toward ``target_accept`` during
    the ``num_burn`` iterations (``step_size`` is the initial guess), then
    freezes it.  ``CHUNK`` iterations are one captured graph on the
    card."""
    chains = HMCChains(model, log_prob_fn, generator, None, num_samples,
                       num_burn, step_size, num_leapfrog, freeze,
                       adapt_step_size, target_accept)
    qs = chains.run()
    accept_rate = float(chains.acc[0]) / chains.total
    info = HMCInfo(accept_rate=accept_rate,
                   step_size=float(chains.da.final_step_sizes()[0]),
                   final_log_prob=float(chains.lp[0]))
    return qs[num_burn:, 0], accept_rate, chains.target.rebuild, info


def chain_generators(generator, num_chains: int, device):
    """The chains' own draw sources from ``generator``, as JAX splits its
    run key into one key a chain: a ``torch.Generator`` draws
    ``num_chains`` seeds, each seeding a generator on ``device``; any other
    draw source gives its ``split(num_chains)``."""
    if not isinstance(generator, torch.Generator):
        return list(generator.split(num_chains))
    seeds = torch.randint(0, 2 ** 62, (num_chains,), generator=generator,
                          device=generator.device)
    return [torch.Generator(device=device).manual_seed(s)
            for s in seeds.tolist()]


def overdispersed_chains(target, generator, num_chains, init_jitter, mesh,
                         chain_axis):
    """(this rank's starts (C_l, P), their draw sources, the gather) of a
    multi-chain run: the model's position plus ``init_jitter`` times
    (C, P) unit normals from ``generator``, then each chain's source
    (:func:`chain_generators`), on every rank.  Without a mesh every
    chain runs here; with one, rank r runs its block of
    ``shard_chains`` and ``gather`` joins the ranks' blocks along the
    chain axis on every rank."""
    generator = _default_generator(generator, target.device)
    q0 = target.flat0[None] + init_jitter * randn(
        (num_chains, target.flat0.shape[0]), generator, target.dtype,
        target.device)
    sources = chain_generators(generator, num_chains, target.device)
    if mesh is None:
        return q0, sources, lambda x: x
    from ..parallel.mesh import all_gather, shard_chains
    q0, idx = shard_chains(mesh, chain_axis, num_chains, q0,
                           torch.arange(num_chains))
    axis = chain_axis or mesh.mesh_dim_names[0]
    return (q0, [sources[int(c)] for c in idx],
            lambda x: all_gather(x, mesh, axis))


def hmc_sample_chains(model, log_prob_fn: Callable, generator=None,
                      num_chains: int = 4, num_samples: int = 100,
                      num_burn: int = 100, step_size: float = 0.01,
                      num_leapfrog: int = 10, freeze=None,
                      adapt_step_size: bool = True,
                      target_accept: float = 0.8,
                      init_jitter: float = 0.1, mesh=None,
                      chain_axis: str = None):
    """C chains from overdispersed starts (the model's position plus
    ``init_jitter`` times unit normals), each adapting its own step size.
    Returns (samples (C, num_samples, P), accept_rates (C,), rebuild, info
    with per-chain step sizes, final log densities, split R-hat and ESS).

    ``generator``: a ``torch.Generator`` on the model's device (default:
    seeded with 0) or, eagerly, a draw source with ``split``; it draws the
    starts, then each chain's own generator (:func:`chain_generators`).
    ``mesh`` splits the chains over the mesh axis ``chain_axis`` (default
    its first): chains are independent, so each rank runs its block with
    no per-step collective, and the draws and statistics are gathered, so
    every rank returns what one process returns.  ``num_chains`` must
    divide by the axis size."""
    target = Target(model, log_prob_fn, freeze)
    q0, sources, gather = overdispersed_chains(
        target, generator, num_chains, init_jitter, mesh, chain_axis)
    chains = HMCChains(model, log_prob_fn, sources, q0, num_samples,
                       num_burn, step_size, num_leapfrog, freeze,
                       adapt_step_size, target_accept, target=target)
    samples = gather(chains.run()[num_burn:].transpose(0, 1).contiguous())
    stats = gather(torch.stack([chains.acc, chains.lp,
                                chains.da.log_eps_bar], dim=1))
    accept_rates = stats[:, 0].double().cpu().numpy() / chains.total
    host = samples.double().cpu().numpy()
    info = {
        "accept_rates": accept_rates,
        "step_sizes": (np.exp(stats[:, 2].double().cpu().numpy())
                       if adapt_step_size
                       else np.full(num_chains, step_size)),
        "final_log_probs": stats[:, 1].double().cpu().numpy(),
        "rhat": potential_scale_reduction(host),
        "ess": effective_sample_size(host),
    }
    return samples, accept_rates, target.rebuild, info


def potential_scale_reduction(samples):
    """Split-R-hat per parameter from ``samples`` (C, S, P) (numpy): each
    chain split in half, R-hat = sqrt(((n-1)/n W + B/n) / W)."""
    x = np.asarray(samples, dtype=np.float64)
    C, S, P = x.shape
    n = S // 2
    halves = np.reshape(x[:, : 2 * n, :], (2 * C, n, P))
    means = np.mean(halves, axis=1)                         # (2C, P)
    variances = np.var(halves, axis=1, ddof=1)              # (2C, P)
    W = np.mean(variances, axis=0)                          # (P,)
    B = n * np.var(means, axis=0, ddof=1)                   # (P,)
    var_plus = (n - 1) / n * W + B / n
    return np.sqrt(var_plus / np.maximum(W, 1e-300))


def effective_sample_size(samples):
    """Combined-chain effective sample size per parameter (Vehtari et al.
    2021) from ``samples`` (C, S, P) (numpy): per-chain FFT
    autocovariances, the combined autocorrelation and Geyer's initial
    monotone positive sequence."""
    x = np.asarray(samples, dtype=np.float64)
    C, S, P = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = 1 << (2 * S - 1).bit_length()
    f = np.fft.rfft(xc, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :S, :] / S
    W = np.mean(acov[:, 0, :] * S / (S - 1), axis=0)        # (P,)
    mean_acov = np.mean(acov, axis=0)                       # (S, P)
    B_over_n = np.var(x.mean(axis=1), axis=0, ddof=1) if C > 1 \
        else np.zeros(P)
    var_plus = (S - 1) / S * W + B_over_n                   # (P,)
    ok = var_plus > 0
    vp = np.where(ok, var_plus, 1.0)
    rho = 1.0 - (W[None, :] - mean_acov) / vp[None, :]      # (S, P)
    if S % 2 == 1:
        rho = np.concatenate([rho, np.zeros((1, P))], axis=0)
    pairs = rho[0::2, :] + rho[1::2, :]                     # (K, P)
    keep = np.cumprod(pairs >= 0, axis=0).astype(bool)
    pairs_mono = np.minimum.accumulate(pairs, axis=0)
    acc = np.sum(np.where(keep, pairs_mono, 0.0), axis=0)   # (P,)
    tau = np.maximum(-1.0 + 2.0 * acc, 1e-12)
    return np.where(ok, C * S / tau, float(C * S))
