"""A run of each cell at CPU-test sizes, past the harness's look for a
card: sound, it comes out correct; with the timed path broken underneath
it comes out not correct, once for each fault a cell of its kind can
have (one chip: there is no exchange between chips to leave out)."""

import json
import time

import pytest

from benchmark import faults, harness
from benchmark.tests.tiny import SIZES, tiny_tree

# float64 at these sizes: a sound run reads at rounding, far below this,
# and every fault reads far above it
LIMIT = 1e-8


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"), limits=LIMIT)


def _run(tree, workload, seed=2 ** 31 + 7):
    spec, here = tree
    result, _ = harness.run_cell(workload, seed, 0.3, 0, "cpu",
                                 time.perf_counter(), spec, here)
    return result


def _cells(kind):
    """The cells of the tiny tree whose traffic is of ``kind``."""
    spec = harness.load_spec()
    return [w["name"] for w in spec["workloads"] if w["config"] in SIZES
            and json.loads((harness.ROOT / "traffic" / f"{w['traffic']}.json")
                           .read_text())["kind"] == kind]


@pytest.mark.parametrize("workload", _cells("train") + _cells("serve"))
def test_a_sound_run_is_correct(tree, workload):
    result = _run(tree, workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    (w, name) for name, (_, _, _, kind) in faults.FAULTS.items()
    for w in _cells(kind)])
def test_a_planted_fault_is_not_correct(tree, monkeypatch, workload, fault):
    faults.plant(fault, monkeypatch.setattr)
    result = _run(tree, workload)
    assert not result["correct"], result["checks"]
