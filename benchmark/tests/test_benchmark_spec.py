"""BENCHMARK.json against the contract it is written to, and the files it
names; a run without a card; the modules a run and the reference load."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness, load

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP_KEYS
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir()
    assert (ROOT / SPEC["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_their_keys(section, keys):
    entries = SPEC[section]
    assert 1 <= len(entries) <= 24
    for e in entries:
        assert set(e) == keys
        assert NAME.match(e["name"]), e["name"]
        assert _line(e["why"])
    assert len({e["name"] for e in entries}) == len(entries)


def test_metrics_names_units_and_bounds():
    names = []
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        names.append(m["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_cell_resolves_its_files():
    for w in SPEC["workloads"]:
        config, traffic, limits, e2e, layer = harness.resolve(SPEC,
                                                              w["name"])
        assert config["name"] == w["config"]
        assert hasattr(load("drivers", traffic["kind"]), "Driver")
        system = load("systems", config["system"])
        assert callable(system.make_inputs) and callable(system.build_model)
        assert load("reference", config["reference"])
        assert callable(load("datasets", config["data"]["kind"]).make)
        assert limits and all(isinstance(v, (int, float))
                              for v in limits.values())
        for m in e2e + layer:
            assert callable(harness.reader(m["name"]))
        assert w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith(
            tuple(p + "/" for p in SPEC["paths"]))
        assert json.loads(path.read_text())["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in SPEC["workloads"]]
    for cell in cells:
        _, _, _, e2e, layer = harness.resolve(SPEC, cell)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
    for m in SPEC["per_layer"]:
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


FORBIDDEN = {"jax", "jaxlib", "flax", "doubly_stochastic_dgp_tpu"}


def _loaded_tops(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    tops = _loaded_tops(
        "import sys, json\n"
        "import benchmark.reference.dgp, benchmark.compare\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & FORBIDDEN
    assert "doubly_stochastic_dgp_tpu_torch" not in tops


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, json, time\n"
        "from benchmark import harness\n"
        "from benchmark.tests.tiny import tiny_tree\n"
        f"spec, here = tiny_tree({str(tmp_path)!r})\n"
        "for w in spec['workloads']:\n"
        "    for m in spec['end_to_end'] + spec['per_layer']:\n"
        "        harness.reader(m['name'], here)\n"
        "    harness.run_cell(w['name'], 3, 0.2, 0, 'cpu',\n"
        "                     time.perf_counter(), spec, here)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = _loaded_tops(code)
    assert "doubly_stochastic_dgp_tpu_torch" in tops
    assert not tops & FORBIDDEN
