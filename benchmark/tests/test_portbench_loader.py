"""The harness finds configurations, cells, traffic and metrics by name,
and a cell added as new files alone is found without editing any."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark.harness import cell as cellmod
from benchmark.harness.cell import cell_names, find_cell, load_module, load_spec

SPEC = load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", cell_names(SPEC))
def test_every_cell_resolves_to_its_files(name):
    cell = find_cell(name)
    assert cell.chips == 1
    assert cell.config["name"] == cell.config_name
    for kind, mod in (("deployments", cell.config_name), ("reference", cell.config_name),
                      ("traffic", cell.traffic["generator"])):
        assert load_module(kind, mod).__file__.endswith(f"{kind}/{mod}.py")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())


def test_the_spec_keeps_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/") and NAME.match(c["name"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m.get("workloads", [])) <= set(cell_names(SPEC))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_cell_added_as_files_alone_is_listed(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(cellmod.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((cellmod.ROOT / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    (bench / "traffic" / "closed.c8.64kb.json").write_text(json.dumps({
        "generator": "closed_loop", "inflight": 8, "channels": 2, "pool": 16,
        "payload": {"shape": [16, 1024], "dtype": "float32"}, "keep": 64,
        "warmup_calls": 16}))
    (bench / "workloads" / "echo.64kb.c8.json").write_text(json.dumps(
        find_cell("echo.4kb").workload))
    (bench / "metrics" / "bytes_per_call.py").write_text(
        "def read(ctx):\n    return None\n")
    spec["workloads"].append({"name": "echo.64kb.c8", "config": "ici_echo",
                              "traffic": "closed.c8.64kb", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "bytes_per_call", "unit": "B", "better": "lower",
                              "source": "program_counter", "layer": "ICI fabric and ops",
                              "moves": "calls_per_s", "workloads": ["echo.64kb.c8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert "echo.64kb.c8" in cell_names(load_spec(root))
    cell = find_cell("echo.64kb.c8", root=root)
    assert cell.traffic["inflight"] == 8 and cell.config_name == "ici_echo"
    assert [m["name"] for m in cell.per_layer][-1] == "bytes_per_call"
    assert load_module("metrics", "bytes_per_call", root=root).read(None) is None
    # the cells that were there report what they did
    assert [m["name"] for m in find_cell("echo.4kb", root=root).per_layer] == \
        [m["name"] for m in find_cell("echo.4kb").per_layer]


def test_a_name_that_is_not_there_is_refused():
    with pytest.raises(LookupError):
        find_cell("no.such.cell")
    with pytest.raises(LookupError):
        load_module("metrics", "no_such_metric")


def test_a_module_name_may_hold_dots(tmp_path):
    root = tmp_path / "checkout"
    (root / "benchmark" / "metrics").mkdir(parents=True)
    (root / "benchmark" / "metrics" / "dispatch_ms.serve.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    assert load_module("metrics", "dispatch_ms.serve", root=root).read(None) == 1.5
