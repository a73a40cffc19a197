"""The seeds of one run, each derived from ``--seed`` (any whole number)
and a tag of its use."""

from __future__ import annotations

import numpy as np
import torch


def derived_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    s = int(seed) % 2 ** 64
    words = [s & 0xFFFFFFFF, s >> 32] + [ord(c) for c in tag]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``derived_seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(derived_seed(seed, tag))
    return g
