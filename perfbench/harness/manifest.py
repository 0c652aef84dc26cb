"""BENCHMARK.json and the data files it names: a cell's configuration,
traffic and limits, the metrics it reports, and the modules (loops and
metric readers) found by name."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = "perfbench"


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load(root: Path) -> Dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: Dict, name: str) -> str:
    for c in bench["configs"]:
        if c["name"] == name:
            return c["file"]
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics (trace
    on): every entry whose `workloads` names the cell or that has none."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_module(path: Path) -> ModuleType:
    """A module from a file whose name may hold dots (a metric's name)."""
    mod_name = "perfbench_" + re.sub(r"[^A-Za-z0-9_]", "_", str(path.relative_to(
        path.parents[1])))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(root: Path, bench: Dict, cell_name: str) -> Dict:
    """{'cell', 'config', 'traffic', 'limits'} of a workload."""
    cell = workload(bench, cell_name)
    base = root / BENCH_DIR
    return {"cell": cell,
            "config": load_json(root / config_file(bench, cell["config"])),
            "traffic": load_json(base / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(base / "limits" / f"{cell_name}.json")}
