"""BENCHMARK.json against the contract's rules the CPU can check, and the
files the harness finds by name."""

import json
import os
import re
import subprocess
import sys

from tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units():
    for entry in BENCH["configs"] + BENCH["workloads"] + _metrics():
        assert NAME.match(entry["name"]), entry["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = [e["name"] for e in _metrics()]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e


def _reports(cell, metric):
    return cell in metric.get("workloads", [cell])


def test_each_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for w in BENCH["workloads"]:
            if _reports(w["name"], m):
                assert _reports(w["name"], e2e[m["moves"]]), (m["name"], w["name"])


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(w["name"], m) for m in BENCH["per_layer"])


def test_four_chip_cells_at_most_a_quarter():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_files_found_by_name():
    base = ROOT / "perfbench"
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    for w in BENCH["workloads"]:
        traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
        assert (base / "loops" / f"{traffic['loop']}.py").is_file()
        assert json.loads((base / "limits" / f"{w['name']}.json").read_text())
    for m in _metrics():
        assert (base / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "inverse_512_5pass",
                          "--seed", "2147483659", "--seconds", "1"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no card" in out.stderr
