"""A copy of the benchmark's tree at CPU-test sizes, for tests only: the
configurations named in ``SIZES`` cut to a few rows, inducing points and
dims, in float64 by default, their cells, the traffic files with small
requests, and the real metric readers."""

import json
import shutil
from pathlib import Path

REAL = Path(__file__).resolve().parents[1]
SIZES = {"dgp5_kin8nm": dict(input_dim=3, hidden_dims=[3, 2, 2, 2],
                             num_inducing=8, train_rows=48, test_rows=120),
         "mnist_dgp3": dict(input_dim=12, hidden_dims=[4, 4], num_outputs=3,
                            num_inducing=8, minibatch=24, train_rows=64,
                            test_rows=120, num_classes=3, latent=4)}


def tiny_tree(root, dtype="float64", limits=None):
    """Writes root/BENCHMARK.json and root/benchmark/{configs, traffic,
    limits, metrics}; returns (spec, root/benchmark).  ``limits``: one
    limit for every compared number (default: the real files')."""
    here = Path(root) / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (here / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REAL / "metrics", here / "metrics", dirs_exist_ok=True)
    spec = json.loads((REAL.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [c for c in spec["configs"] if c["name"] in SIZES]
    spec["workloads"] = [w for w in spec["workloads"] if w["config"] in SIZES]
    for c in spec["configs"]:
        config = json.loads((REAL.parent / c["file"]).read_text())
        s = SIZES[c["name"]]
        for k in ("input_dim", "hidden_dims", "num_outputs", "num_inducing",
                  "minibatch"):
            if k in s:
                config[k] = s[k]
        config["data"].update(train_rows=s["train_rows"],
                              test_rows=s["test_rows"])
        if "latent" in s:
            config["data"]["latent"] = s["latent"]
        if "num_classes" in s:
            config["likelihood"]["num_classes"] = s["num_classes"]
        config["numerics"]["dtype"] = dtype
        (Path(root) / c["file"]).write_text(json.dumps(config))
    for f in (REAL / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["warmup_seconds"] = 0.2
        if t["kind"] == "serve":
            t.update(rows=20, samples=5, check_requests=4)
        (here / "traffic" / f.name).write_text(json.dumps(t))
    for w in spec["workloads"]:
        lim = json.loads((REAL / "limits" / f"{w['name']}.json").read_text())
        if limits is not None:
            lim = {k: limits for k in lim}
        (here / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    (Path(root) / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec, here
