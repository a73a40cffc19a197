"""Runs one cell once: resolves the cell's files by name, builds the system,
measures the window, checks what the timed path produced, and prints the
result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: ``configs/<config>.json`` (the configuration's sizes,
which name its ``system``, ``reference`` and ``data.kind`` modules),
``traffic/<traffic>.json`` (the mix's parameters, whose ``kind`` names the
driver in ``drivers/``), ``limits/<cell>.json`` (the limit of each
compared number) and ``metrics/<metric>.py`` (a reader ``read(ctx)`` of
each metric, which returns a number, or None where it finds nothing to
read).  A cell reports
the end-to-end metrics whose ``workloads`` list it (all, without the key)
with ``--trace 0``, and the per-layer metrics that list it with
``--trace 1``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import load

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "doubly_stochastic_dgp_tpu")


def load_spec(root=ROOT.parent):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec, workload, here=ROOT):
    """(config, traffic, limits, end-to-end metrics, per-layer metrics) of
    the named cell."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((here.parent / configs[cell["config"]]["file"])
                        .read_text())
    traffic = json.loads((here / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    layer = [m for m in spec["per_layer"] if _applies(m, workload)]
    return config, traffic, limits, e2e, layer


def make_driver(config, traffic, seed, device):
    """The driver of the traffic's kind over the configuration's system
    and reference."""
    return load("drivers", traffic["kind"]).Driver(
        config, traffic, seed, device, load("systems", config["system"]),
        load("reference", config["reference"]))


def build_kernels():
    """Builds the port's CUDA kernels at once (nvcc in parallel) where
    they are not built yet; a no-op where they are."""
    from doubly_stochastic_dgp_tpu_torch.ops.cuda.build import build_all
    build_all()


def reader(name, here=ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_info(device):
    """The device fields of the result line."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
             "nounits", f"--id={device.index or 0}"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def run_cell(workload, seed, seconds, trace, device, t_start, spec=None,
             here=ROOT):
    """(the result line of one run of ``workload`` as a dict, the seconds
    of each step of set-up)."""
    spec = spec if spec is not None else load_spec(here.parent)
    config, traffic, limits, e2e, layer = resolve(spec, workload, here)
    device = torch.device(device)
    driver = make_driver(config, traffic, seed, device)
    driver.setup()
    tracer = None
    if trace:
        from .tracing import Tracer
        tracer = Tracer(seconds, traffic["trace_seconds"])
    window = driver.window(seconds, tracer)
    setup_s = window["start"] - t_start
    dev = device_info(device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{found}")
    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check()
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    trace_data = tracer.result() if tracer is not None else None
    ctx = SimpleNamespace(cell=workload, config=config, traffic=traffic,
                          window=dict(window, setup_s=setup_s),
                          trace=trace_data)
    metrics = {}
    for m in (layer if trace else e2e):
        value = reader(m["name"], here)(ctx)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace_data is not None:
        dev["busy_s"] = trace_data.busy_s
        dev["window_s"] = trace_data.span_s
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace_data is not None:
        from .tracing import breakdown
        result["breakdown"] = breakdown(trace_data)
    result["checks"] = checks
    result_phases = dict(driver.phases, window_start=setup_s)
    return result, result_phases


def main(argv, t_start):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_spec()
    cell = next((w for w in spec["workloads"]
                 if w["name"] == args.workload), None)
    chips = cell["chips"] if cell else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 2
    t = time.perf_counter()
    torch.zeros(1, device="cuda:0")
    t_init = time.perf_counter() - t
    build_kernels()
    t_build = time.perf_counter() - t - t_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, phases = run_cell(args.workload, args.seed, args.seconds,
                              args.trace, "cuda:0", t_start, spec)
    print("set-up: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in dict(
            imports=t - t_start, cuda_init=t_init, kernels=t_build,
            **phases).items()), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

