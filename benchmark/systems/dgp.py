"""The port's doubly-stochastic deep GP (``DGP.build``, the paper's layer
stack) as the benchmark builds it: data of the configuration's
``data.kind``, inducing inputs and drawn posteriors made from ``--seed``
on the device.  The port is imported inside the functions that use it."""

from __future__ import annotations

import math
import re

import torch

from benchmark import load
from benchmark.reference.dgp import layer_widths
from benchmark.seeds import generator


def make_inputs(config, seed, device):
    """{"data", "Z", "posterior"}: the data set, Z a seeded random subset
    of ``num_inducing`` training rows, and a posterior a layer drawn so
    that it is not the prior: (v, T), v ~ N(0, 0.5^2) (M, Do), and a
    lower-triangular T (Do, M, M), diagonal uniform on [0.5, 1], strict
    lower triangle N(0, 0.1^2 / M).  The model's q_mu is Lu v, Lu the
    Cholesky factor of its prior covariance Kuu, and its q_sqrt the built
    q_sqrt times T."""
    data = load("datasets", config["data"]["kind"]).make(config, seed,
                                                         device)
    X = data["X"]
    rows = torch.randperm(X.shape[0], device=X.device,
                          generator=generator(seed, "inducing", X.device))
    M = config["num_inducing"]
    kw = dict(dtype=torch.float64, device=device,
              generator=generator(seed, "posterior", device))
    posterior = []
    for _, Do in layer_widths(config):
        v = 0.5 * torch.randn((M, Do), **kw)
        diag = 0.5 + 0.5 * torch.rand((Do, M), **kw)
        T = torch.tril(torch.randn((Do, M, M), **kw), -1) * (
            0.1 / math.sqrt(M))
        posterior.append((v, T + torch.diag_embed(diag)))
    return {"data": data, "Z": X[rows[:M]], "posterior": posterior}


def build_model(config, inputs, device):
    """The port's DGP of the configuration, inner q_sqrt scaled as the
    configuration says, with the drawn posterior set."""
    import doubly_stochastic_dgp_tpu_torch as port
    kern, n = config["kernel"], config["numerics"]
    widths = layer_widths(config)
    kernels = []
    for l, (Dx, _) in enumerate(widths):
        k = port.RBF(Dx, variance=kern["variance"],
                     lengthscales=kern["lengthscales"], ard=True)
        if l < len(widths) - 1 and config["inner_white_variance"]:
            k = k + port.White(Dx, variance=config["inner_white_variance"],
                               trainable=False)
        kernels.append(k)
    lik = config["likelihood"]
    if lik["type"] == "Gaussian":
        likelihood = port.Gaussian(lik["variance"])
    else:
        likelihood = port.MultiClass(lik["num_classes"])
    data = inputs["data"]
    model = port.DGP.build(
        data["X"].cpu().numpy(), data["Y"].cpu().numpy(),
        inputs["Z"].cpu().numpy(), kernels, likelihood,
        num_outputs=config["num_outputs"], num_samples=config["num_samples"],
        config=port.Config(dtype=getattr(torch, n["dtype"]),
                           jitter=n["jitter"], solve_mode=n["solve_mode"],
                           precision=n["precision"],
                           use_pallas=n["use_pallas"]),
        device=device)
    scale = config.get("inner_q_sqrt_scale", 1.0)
    with torch.no_grad():
        for l, layer in enumerate(model.layers):
            Lu = layer.q_sqrt.value[0]          # as built: Kuu's factor
            if scale != 1.0 and l < len(model.layers) - 1:
                layer.q_sqrt.set_value(layer.q_sqrt.value * scale)
            v, T = (t.to(Lu.dtype) for t in inputs["posterior"][l])
            layer.q_mu.set_value(Lu @ v)
            layer.q_sqrt.set_value(torch.tril(layer.q_sqrt.value @ T))
    return model


def leaf_name(port_name: str) -> str:
    """The reference's name of a port parameter: ``.unconstrained`` and a
    sum kernel's first term dropped (``layers.0.kern.kernels.0.variance.
    unconstrained`` is ``layers.0.kern.variance``)."""
    name = port_name.replace(".unconstrained", "")
    return re.sub(r"\.kern\.kernels\.0\.", ".kern.", name)


def trainable_leaves(model):
    """{reference name: parameter} of the port's trainable parameters, in
    the order the optimizer holds them."""
    return {leaf_name(n): p for n, p in model.named_parameters()
            if p.requires_grad}
