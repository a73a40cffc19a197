"""The readings the limits of ``limits/<cell>.json`` are set from: the
compared numbers of sound runs of the program on many seeds (the lower
reading is their largest) and of the control, the reference in float32
with TF32 products in the program's place (the upper reading is its
smallest), at the cell's own sizes, in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 2] [--out file.jsonl]

The program's readings come from a short window at the cell's own load
(``--seconds``): a serving cell's long enough to complete the requests a
run compares; a training cell's checked chunks come before its window.
``--fault <name>`` plants a fault of ``faults.py`` under the program for
the program's seeds.  Needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from benchmark import faults, harness  # noqa: E402


def readings(workload, seeds, control_seeds, seconds, device="cuda:0",
             spec=None, here=harness.ROOT, fault=None):
    """Yields one dict a seed: {"cell", "seed", "side" ("program" or
    "control"), "fault" (the planted fault's name, or None), the compared
    numbers}."""
    spec = spec if spec is not None else harness.load_spec(here.parent)
    config, traffic, _, _, _ = harness.resolve(spec, workload, here)
    for side, group in (("program", seeds), ("control", control_seeds)):
        for seed in group:
            t = time.perf_counter()
            driver = harness.make_driver(config, traffic, seed, device)
            driver.setup()
            driver.window(seconds)
            driver.release()
            numbers = (driver.check() if side == "program"
                       else driver.control())
            del driver
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            yield dict(cell=workload, seed=seed, side=side, fault=fault,
                       seconds=time.perf_counter() - t, **numbers)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    harness.build_kernels()
    if args.fault:
        faults.plant(args.fault)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    out = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workload, ints(args.seeds),
                          ints(args.control_seeds), args.seconds,
                          fault=args.fault):
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
