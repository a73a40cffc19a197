"""Image-like classification rows: a frozen copy of the formula of
``chip_smoke.py::mnist_data`` (a latent h, pixels clip(0.5 + h A + noise,
0, 1), labels argmax(h W)), drawn in float64 from a ``torch.Generator`` on
the device instead of numpy.  Y holds the labels as float64 (N, 1)."""

from __future__ import annotations

import math

import torch

from benchmark.seeds import generator


def make(config, seed, device):
    spec = config["data"]
    n, t, D = spec["train_rows"], spec["test_rows"], config["input_dim"]
    latent, K = spec["latent"], config["likelihood"]["num_classes"]
    f64 = dict(dtype=torch.float64, device=device,
               generator=generator(seed, "data", device))
    h = torch.randn((n + t, latent), **f64)
    A = torch.randn((latent, D), **f64) * (spec["signal_std"]
                                          / math.sqrt(latent))
    X = torch.clamp(0.5 + h @ A + spec["noise_std"] * torch.randn(
        (n + t, D), **f64), 0.0, 1.0).float()
    Y = torch.argmax(h @ torch.randn((latent, K), **f64), dim=1)[
        :, None].double()
    return {"X": X[:n], "Y": Y[:n], "Xs": X[n:], "Ys": Y[n:]}
