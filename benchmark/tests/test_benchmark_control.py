"""The control on the card, at each cell's own sizes: the reference in
float32 with TF32 products, put in the program's place, fails one of the
cell's limits on a seed, and the program on the same seed passes all of
them.  Skips without a CUDA device."""

import json

import pytest
import torch

from benchmark import harness

SPEC = harness.load_spec()


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_control_fails_and_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.build_kernels()
    config, traffic, limits, _, _ = harness.resolve(SPEC, workload)
    driver = harness.make_driver(config, traffic, 2 ** 31 + 99, "cuda:0")
    driver.setup()
    driver.window(1.0)
    driver.release()
    program, control = driver.check(), driver.control()
    summary = json.dumps({"program": program, "control": control,
                          "limits": limits})
    assert all(program[k] <= limits[k] for k in limits), summary
    assert any(control[k] > limits[k] for k in limits), summary
