"""The UCI dataset registry and loaders, the synthetic regression sets and
the MNIST-style classification loader.

A copy of ``doubly_stochastic_dgp_tpu/data/datasets.py`` (numpy only; the
JAX package's ``__init__`` imports jax, so the port keeps its own copy).
The split and the normalization follow the reference's conventions
exactly, including the normalizing std taken from the *test* split,
because the published RMSE/NLL numbers depend on them.

The nine UCI loaders read local CSVs only (``<data_path>/<name>.csv``,
features then target, through ``data/native.py``).  The port never
downloads: a missing file raises ``FileNotFoundError`` with the JAX
package's advice and the source the CSV comes from.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .native import read_csv

__all__ = ["Dataset", "Datasets", "SyntheticRegression",
           "CompositionalRegression", "ConjugateRegression",
           "load_mnist_npz", "make_synthetic_regression"]

_UCI_BASE = "https://archive.ics.uci.edu/ml/machine-learning-databases/"


class Dataset:
    name: str = ""
    N: int = 0
    D: int = 0
    type: str = "regression"
    url: str = ""

    def __init__(self, data_path: str = "data/"):
        self.data_path = data_path

    def csv_file_path(self):
        return os.path.join(self.data_path, f"{self.name}.csv")

    def read_data(self) -> Dict[str, np.ndarray]:
        data = read_csv(self.csv_file_path())
        return {"X": data[:, :-1], "Y": data[:, -1, None]}

    def get_data(self, seed: int = 0, split: int = 0, prop: float = 0.9):
        path = self.csv_file_path()
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"Dataset {self.name!r} not cached at {path}, and this "
                f"package never downloads. In an offline environment, "
                f"pre-populate the CSV cache (features..., target; the "
                f"source is {self.url or 'not recorded'}) or use "
                f"SyntheticRegression.")
        d = self.split(self.read_data(), seed, split, prop)
        d = self.normalize(d, "X")
        if self.type == "regression":
            d = self.normalize(d, "Y")
        return d

    def split(self, full_data, seed, split, prop):
        # the actual row count, not the registry's nominal N
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


class Boston(Dataset):
    name, N, D = "boston", 506, 12
    url = _UCI_BASE + "housing/housing.data"


class Concrete(Dataset):
    name, N, D = "concrete", 1030, 8
    url = _UCI_BASE + "concrete/compressive/Concrete_Data.xls"


class Energy(Dataset):
    name, N, D = "energy", 768, 8
    url = _UCI_BASE + "00242/ENB2012_data.xlsx"


class Kin8nm(Dataset):
    name, N, D = "kin8nm", 8192, 8
    url = "https://www.openml.org/data/get_csv/3626/dataset_2175_kin8nm.arff"


class Naval(Dataset):
    name, N, D = "naval", 11934, 12
    url = _UCI_BASE + "00316/UCI%20CBM%20Dataset.zip"


class Power(Dataset):
    name, N, D = "power", 9568, 4
    url = _UCI_BASE + "00294/CCPP.zip"


class Protein(Dataset):
    name, N, D = "protein", 45730, 9
    url = _UCI_BASE + "00265/CASP.csv"


class WineRed(Dataset):
    name, N, D = "wine_red", 1599, 11
    url = _UCI_BASE + "wine-quality/winequality-red.csv"


class WineWhite(Dataset):
    name, N, D = "wine_white", 4898, 11
    url = _UCI_BASE + "wine-quality/winequality-white.csv"


class _Synthetic(Dataset):
    """A generated regression set at a named dataset's (N, D)."""

    def __init__(self, name, N, D, data_path="data/", seed=0):
        super().__init__(data_path)
        self.name, self.N, self.D, self._seed = name, N, D, seed

    def get_data(self, seed=0, split=0, prop=0.9):
        d = self.split(self.read_data(), seed, split, prop)
        d = self.normalize(d, "X")
        return self.normalize(d, "Y")


class SyntheticRegression(_Synthetic):
    """X uniform, Y a smooth random function plus noise, at a named
    dataset's (N, D) (throughput does not depend on the data)."""

    def __init__(self, name="kin8nm_synth", N=8192, D=8, data_path="data/",
                 seed=0):
        super().__init__(name, N, D, data_path, seed)

    def read_data(self):
        rng = np.random.RandomState(self._seed)
        X = rng.uniform(size=(self.N, self.D))
        w1 = rng.randn(self.D, 32)
        w2 = rng.randn(32, 1)
        Y = np.tanh(X @ w1) @ w2 + rng.randn(self.N, 1) * 0.1
        return {"X": X, "Y": Y}


def make_synthetic_regression(N=8192, D=8, seed=0, data_path="data/"):
    return SyntheticRegression(N=N, D=D, seed=seed, data_path=data_path)


class CompositionalRegression(_Synthetic):
    """Compositional, non-stationary data: a steep warp composed with a
    smooth function, the regime where deep GPs beat single-layer sparse
    GPs (the qualitative structure of the published kin8nm results)."""

    def __init__(self, name="compositional_synth", N=8192, D=8,
                 data_path="data/", seed=0):
        super().__init__(name, N, D, data_path, seed)

    def read_data(self):
        rng = np.random.RandomState(self._seed)
        X = rng.uniform(size=(self.N, self.D))
        w = rng.randn(self.D)
        w /= np.linalg.norm(w)
        z = (X - 0.5) @ w * 4.0
        # inner warp: a steep, continuous switch with a locally varying
        # amplitude; outer head: smooth in the warped coordinate and a
        # second raw direction
        h = np.tanh(6.0 * z) * (0.6 + 0.4 * np.abs(z)) + 0.3 * np.sin(4.0 * z)
        w2 = rng.randn(self.D)
        w2 /= np.linalg.norm(w2)
        g = np.sin(2.5 * h) * (1.0 + 0.5 * np.tanh((X - 0.5) @ w2 * 3.0))
        Y = (g + rng.randn(self.N) * 0.05)[:, None]
        return {"X": X, "Y": Y}


class ConjugateRegression(_Synthetic):
    """GP-sample data in the conjugate-dominated regime (the kin8nm
    regime): Y from an RBF GP whose hyperparameters match the model's
    initialization after normalization (lengthscale ~1, variance ~1, noise
    variance ~0.05)."""

    def __init__(self, name="conjugate_synth", N=2000, D=8,
                 data_path="data/", seed=0):
        super().__init__(name, N, D, data_path, seed)

    def read_data(self):
        rng = np.random.RandomState(self._seed)
        X = rng.uniform(size=(self.N, self.D))
        # raw lengthscale = std of U(0, 1), so ~1.0 after normalization
        ls = 0.29
        d2 = ((X[:, None, :] - X[None, :, :]) / ls) ** 2
        K = np.exp(-0.5 * d2.sum(-1))
        L = np.linalg.cholesky(K + 1e-10 * np.eye(self.N))
        f = L @ rng.randn(self.N)
        Y = (f + rng.randn(self.N) * np.sqrt(0.05))[:, None]
        return {"X": X, "Y": Y}


class Datasets:
    """The registry of the nine UCI datasets by name."""

    def __init__(self, data_path: str = "data/"):
        self.all_datasets: Dict[str, Dataset] = {}
        for cls in [Boston, Concrete, Energy, Kin8nm, Naval, Power,
                    Protein, WineRed, WineWhite]:
            ds = cls(data_path=data_path)
            self.all_datasets[ds.name] = ds


def load_mnist_npz(path: str) -> Dict[str, np.ndarray]:
    """Load and validate an MNIST-style classification npz: ``X``/``Xs``
    float images scaled to [0, 1], one flattened row per example;
    ``Y``/``Ys`` integer class labels (N, 1) (a 1-D label vector is
    reshaped).  Returns float32 inputs and float64 labels, what
    ``DGP.build`` with ``MultiClass`` takes.  Raises on missing keys and on
    shape, range or label mismatches, so a malformed file fails loudly
    instead of giving wrong accuracies."""
    d = np.load(path)
    missing = [k for k in ("X", "Y", "Xs", "Ys") if k not in d]
    if missing:
        raise ValueError(
            f"{path}: classification npz must carry X, Y, Xs, Ys "
            f"(missing {missing}); see demos/mnist.py --data")
    out = {}
    for kx, ky in (("X", "Y"), ("Xs", "Ys")):
        ki = np.asarray(d[kx], dtype=np.float32)
        kl = np.asarray(d[ky])
        if kl.ndim == 1:
            kl = kl[:, None]
        if ki.ndim != 2 or kl.shape != (ki.shape[0], 1):
            raise ValueError(
                f"{path}: {kx} must be (N, D) with {ky} labels (N, 1); "
                f"got {kx} {ki.shape}, {ky} {kl.shape}")
        if ki.size and (ki.min() < -1e-6 or ki.max() > 1.0 + 1e-6):
            raise ValueError(
                f"{path}: {kx} must be scaled to [0, 1] (the "
                f"reference's /255 convention); got range "
                f"[{ki.min():.3g}, {ki.max():.3g}]")
        if not np.allclose(kl, np.round(kl)):
            raise ValueError(f"{path}: {ky} must hold integer class "
                             f"labels; got non-integer values")
        out[kx], out[ky] = ki, kl.astype(np.float64)
    return out
