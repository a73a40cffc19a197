"""Dataset split/normalization and the shape-matched synthetic regression
set.

A copy of ``Dataset.split``/``normalize`` and ``SyntheticRegression``
from ``doubly_stochastic_dgp_tpu/data/datasets.py`` (numpy only; the
JAX package's ``__init__`` imports jax, so the port keeps its own copy).
The split and the test-split std normalization follow the reference's
conventions exactly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Dataset", "SyntheticRegression"]


class Dataset:
    name: str = ""
    N: int = 0
    D: int = 0

    def read_data(self):
        raise NotImplementedError

    def get_data(self, seed=0, split=0, prop=0.9):
        d = self.split(self.read_data(), seed, split, prop)
        d = self.normalize(d, "X")
        return self.normalize(d, "Y")

    def split(self, full_data, seed, split, prop):
        N = full_data["X"].shape[0]
        ind = np.arange(N)
        rng = np.random.RandomState(seed + split)
        rng.shuffle(ind)
        n = int(N * prop)
        return {
            "X": full_data["X"][ind[:n], :],
            "Xs": full_data["X"][ind[n:], :],
            "Y": full_data["Y"][ind[:n], :],
            "Ys": full_data["Y"][ind[n:], :],
        }

    def normalize(self, d, key):
        m = np.average(d[key], 0)[None, :]
        # the reference normalizes by the std of the *test* split
        s = np.std(d[key + "s"], 0)[None, :] + 1e-6
        d[key] = (d[key] - m) / s
        d[key + "s"] = (d[key + "s"] - m) / s
        d[key + "_mean"] = m.flatten()
        d[key + "_std"] = s.flatten()
        return d


class SyntheticRegression(Dataset):
    """X uniform, Y a smooth random function plus noise, at a named
    dataset's (N, D)."""

    def __init__(self, name="kin8nm_synth", N=8192, D=8, seed=0):
        self.name, self.N, self.D, self._seed = name, N, D, seed

    def read_data(self):
        rng = np.random.RandomState(self._seed)
        X = rng.uniform(size=(self.N, self.D))
        w1 = rng.randn(self.D, 32)
        w2 = rng.randn(32, 1)
        Y = np.tanh(X @ w1) @ w2 + rng.randn(self.N, 1) * 0.1
        return {"X": X, "Y": Y}
