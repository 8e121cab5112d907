"""Find a cell of ``BENCHMARK.json`` and every file it names, by name."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    workload: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_names(spec: dict) -> List[str]:
    return [w["name"] for w in spec["workloads"]]


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise LookupError(f"no file {path}")
    return json.loads(path.read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise LookupError(f"BENCHMARK.json names no {what} {name!r}")


def metrics_of(spec: dict, cell: str):
    """(end-to-end entries, per-layer entries) the cell reports: an entry
    with ``workloads`` in the cells it lists, a per-layer entry without
    one in every cell that reports the metric it moves."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in spec["per_layer"]
        if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    return e2e, per_layer


def find_cell(name: str, spec: dict = None, root: Path = ROOT) -> Cell:
    spec = load_spec(root) if spec is None else spec
    bench = root / "benchmark"
    w = _by_name(spec["workloads"], name, "workload")
    cfg = _by_name(spec["configs"], w["config"], "config")
    e2e, per_layer = metrics_of(spec, name)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=cfg["name"],
        config=_read_json(root / cfg["file"]),
        traffic_name=w["traffic"],
        traffic=_read_json(bench / "traffic" / f"{w['traffic']}.json"),
        workload=_read_json(bench / "workloads" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def load_module(kind: str, name: str, root: Path = ROOT):
    """``benchmark/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = root / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {kind} module {path}")
    mod_name = f"benchmark.{kind}.{name}"
    mod = sys.modules.get(mod_name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
