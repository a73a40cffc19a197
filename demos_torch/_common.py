"""Shared pieces of the torch demos: the ``--device`` argument and the
numerics that the JAX demos set through the global setters, here as the
``Config`` each model is built with."""

import torch

from doubly_stochastic_dgp_tpu_torch import Config

# the JAX demos' accelerator numerics (float32, jitter 1e-5, the staged
# inverse, highest matmul precision: demos/mnist.py:51-54,
# run_regression.py:51-57, uci_benchmark.py:43-46)
ACCELERATOR = Config(dtype=torch.float32, jitter=1e-5, solve_mode="inverse",
                     precision="highest")


def add_device(parser):
    """``--device``; each demo resolves it first (``resolve_device``), so
    that a run without a card and without ``--device cpu`` raises before
    any work."""
    parser.add_argument(
        "--device", default=None,
        help="torch device; default the card (raises without one): pass "
             "'cpu' to run on the CPU")


def numbers(x):
    """Every number in a JSON-like summary (nested dicts and lists)."""
    if isinstance(x, dict):
        for v in x.values():
            yield from numbers(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield float(x)
