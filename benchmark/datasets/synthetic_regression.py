"""Regression rows of a given shape: a frozen copy of the formula of
``data/datasets.py::SyntheticRegression`` (X uniform, Y = tanh(X W1) W2 +
noise, X and Y standardized by the training rows), drawn in float64 from
a ``torch.Generator`` on the device instead of numpy."""

from __future__ import annotations

import torch

from benchmark.seeds import generator


def make(config, seed, device):
    spec = config["data"]
    n, t, D = spec["train_rows"], spec["test_rows"], config["input_dim"]
    f64 = dict(dtype=torch.float64, device=device,
               generator=generator(seed, "data", device))
    X = torch.rand((n + t, D), **f64)
    w1 = torch.randn((D, spec["hidden"]), **f64)
    w2 = torch.randn((spec["hidden"], 1), **f64)
    Y = torch.tanh(X @ w1) @ w2 + spec["noise"] * torch.randn((n + t, 1),
                                                              **f64)
    X = ((X - X[:n].mean(0)) / X[:n].std(0)).float()
    Y = ((Y - Y[:n].mean(0)) / Y[:n].std(0)).float()
    return {"X": X[:n], "Y": Y[:n], "Xs": X[n:], "Ys": Y[n:]}
