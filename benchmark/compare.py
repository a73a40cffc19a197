"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference (the configuration's ``reference`` module)
computed in float64 from the same inputs and the same draws.

Training: the first ``check_chunks`` calls of the chunk that ``fit``
drives through the window (``chunk_steps`` Adam steps, one captured CUDA
graph), observed as ``fit`` calls them.  Three numbers:

- ``loss_gap``: the largest gap of a chunk's mean loss, over the
  reference's;
- ``moment_gap``: Adam's first moment after the first chunk, the
  gradients as the optimizer got them: by the worst leaf, the gap between
  the two norms over the larger of the reference's norm of that leaf and
  of the median leaf;
- ``change_gap``: the parameters' change over the checked chunks, by the
  same measure, over the leaves whose first gradient in the reference is
  at least a thousandth of the median leaf's (a leaf whose gradient is
  nought to rounding moves under Adam by round-off alone).

Serving: a sample, drawn from the seed, of the requests the window
completed; per output (mean, var) the largest absolute gap over every
element (``mean_gap``, ``var_gap``).
"""

from __future__ import annotations

import statistics

import numpy as np


def _norms(d):
    return {n: float(t.double().norm()) for n, t in d.items()}


def _gap(x):
    """A compared number, infinite where it is not finite (NaN compares
    false against any limit)."""
    return float(x) if np.isfinite(x) else float("inf")


def _worst_leaf(prog, ref_, leaves):
    """max over ``leaves`` of |norm_p - norm_r| / max(norm_r, median
    norm_r)."""
    median = statistics.median(ref_[n] for n in leaves)
    return max(_gap(abs(prog[n] - ref_[n]) / max(ref_[n], median, 1e-300))
               for n in leaves)


def train_numbers(prog, reference):
    """The three compared numbers of a training cell."""
    if set(prog["moments"]) != set(reference["moments"]):
        raise ValueError(f"leaves differ: program {sorted(prog['moments'])}"
                         f", reference {sorted(reference['moments'])}")
    loss_gap = max(_gap(abs(p - r) / abs(r)) for p, r in
                   zip(prog["chunk_losses"], reference["chunk_losses"]))
    leaves = sorted(reference["moments"])
    moment_gap = _worst_leaf(_norms(prog["moments"]),
                             _norms(reference["moments"]), leaves)
    first = reference["first_grads"]
    median = statistics.median(first.values())
    moved = [n for n in leaves if first[n] >= 1e-3 * median]

    def change(side):
        return {n: float((side["after"][n].double()
                          - side["init"][n].double()).norm())
                for n in moved}

    change_gap = _worst_leaf(change(prog), change(reference), moved)
    return {"loss_gap": loss_gap, "moment_gap": moment_gap,
            "change_gap": change_gap}


def serve_numbers(prog_outputs, ref_outputs):
    """Largest absolute gaps of the mean and the variance over every
    element of every sampled request."""
    gaps = {"mean_gap": 0.0, "var_gap": 0.0}
    for p, r in zip(prog_outputs, ref_outputs):
        for key, a, b in (("mean_gap", p[0], r[0]), ("var_gap", p[1], r[1])):
            gaps[key] = max(gaps[key], _gap(np.max(np.abs(
                a.astype(np.float64) - b))))
    return gaps
