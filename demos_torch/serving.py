#!/usr/bin/env python
"""Serving demo on the PyTorch port (demos/serving.py): train a small DGP,
export its ``predict_y`` with ``torch.export`` (``export_predict_y``),
reload the program in a fresh process that builds no model (it imports
torch and the port's loader, whose import registers the kernels' ops
``torch.ops.dsdgp.*``), and check that the served outputs equal the
in-process program's bit for bit, and ``make_server``'s within roundoff.

The exported program holds the model's parameters and takes the request
rows and the unit normals of its draws (``predict_y_draws``), so the
server side needs only the package and the program's file.

  python demos_torch/serving.py --device cpu
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import numpy as np
import torch

from doubly_stochastic_dgp_tpu_torch import resolve_device
from demos_torch._common import add_device

_SERVER = r"""
import sys
import torch
sys.path.insert(0, {repo!r})
from doubly_stochastic_dgp_tpu_torch.serving import load_exported

serve = load_exported({path!r})
inputs = torch.load({xpath!r})
mean, var = serve(inputs["X"], inputs["zs"])
torch.save((mean, var), {opath!r})
print("served", tuple(mean.shape))
"""


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-data", type=int, default=200)
    p.add_argument("--iterations", type=int, default=150)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--num-samples", type=int, default=8)
    p.add_argument("--precomputed", action="store_true",
                   help="export the cached-posterior (precompute) model: "
                        "the program holds no Cholesky or inverse, only "
                        "the gram and matmuls of a request")
    add_device(p)
    return p.parse_args(argv)


def make_data(args):
    rng = np.random.RandomState(0)
    N, D = args.num_data, 2
    X = rng.randn(N, D)
    Y = np.sin(2 * X[:, :1]) + 0.1 * rng.randn(N, 1)
    return {"X": X, "Y": Y, "Z": X[:20].copy()}


def build(args, data, config, device):
    import doubly_stochastic_dgp_tpu_torch as port

    D = data["X"].shape[1]
    return port.DGP.build(data["X"], data["Y"], data["Z"],
                          [port.RBF(D), port.RBF(D)], port.Gaussian(0.05),
                          num_samples=3, config=config, device=device)


def run(args):
    import doubly_stochastic_dgp_tpu_torch as port
    from doubly_stochastic_dgp_tpu_torch.serving import (
        export_predict_y, load_exported, predict_y_draws)

    device = resolve_device(args.device)
    data = make_data(args)
    model = build(args, data, port.Config(), device)
    model, hist = port.fit(model, args.iterations, learning_rate=0.02,
                           log_every=max(10, args.iterations // 3))

    # what the server holds: the live model, or its frozen cached
    # posterior (models/posterior.py)
    served_model = port.precompute(model) if args.precomputed else model

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "predict_y.pt2")
        export_predict_y(model, args.batch, args.num_samples, path=path,
                         precomputed=args.precomputed)
        size = os.path.getsize(path)

        Xs = model._as_input(data["X"][:args.batch])
        zs = predict_y_draws(model, args.batch, args.num_samples,
                             torch.Generator(device=device).manual_seed(3))
        # in-process reference through the same program
        ref_mean, _ = load_exported(path)(Xs, zs)
        with torch.no_grad():
            model_mean, _ = served_model.predict_y(Xs, S=args.num_samples,
                                                   zs=zs)

        # out-of-process server: a fresh interpreter, the program's file
        # and the request
        xpath = os.path.join(td, "inputs.pt")
        opath = os.path.join(td, "served.pt")
        torch.save({"X": Xs, "zs": zs}, xpath)
        code = _SERVER.format(repo=os.path.abspath(REPO), path=path,
                              xpath=xpath, opath=opath)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, (out.returncode, out.stdout[-2000:],
                                     out.stderr[-3000:])
        served = torch.load(opath)[0]

        exact = bool(torch.equal(served, ref_mean))
        assert exact, (
            "fresh-process serving drifted from the in-process program: "
            f"max|diff| = {float((served - ref_mean).abs().max())}")

        # the in-process production path: make_server at the same seed
        # draws the same normals, so it agrees with the program to
        # roundoff
        serve = port.make_server(model, S=args.num_samples,
                                 precompute=args.precomputed,
                                 warmup_batch=args.batch)
        srv_mean, _ = serve(Xs, seed=3)
        server_diff = float((srv_mean - ref_mean).abs().max())
        scale = float(ref_mean.abs().max()) or 1.0
        tol = (1e-4 if ref_mean.dtype == torch.float32 else 1e-10) * scale
        assert server_diff <= tol, (
            f"make_server drifted from the program: {server_diff}")
        summary = {
            "precomputed": args.precomputed,
            "artifact_bytes": size,
            "batch": args.batch, "S": args.num_samples,
            "served_shape": list(served.shape),
            "server_matches_inprocess_bitwise": exact,
            "max_abs_diff": float((served - ref_mean).abs().max()),
            "make_server_max_abs_diff_vs_artifact": server_diff,
        }
        state = {"model": model, "history": hist,
                 "model_bitwise": bool(torch.equal(served, model_mean)),
                 "model_rel_err": float((served - model_mean).abs().max())
                 / max(scale, 1.0)}
    return summary, state


def main(argv=None):
    summary, _ = run(parse_args(argv))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
