"""BENCHMARK.json against the contract's shape rules, and a cell, a traffic mix and a
per-layer metric found from files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import HERE, ROOT
from harness import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any((ROOT / c["file"]).is_relative_to(ROOT / p) for p in BENCH["paths"])
        file = json.loads((ROOT / c["file"]).read_text())
        assert all(k in file for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    reported = {w: {m["name"] for m in BENCH["end_to_end"] if w in m.get("workloads", cells)}
                for w in cells}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert all(m["moves"] in reported[w] for w in m["workloads"])
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    for w in cells:
        assert "setup_s" in reported[w] and len(reported[w]) >= 2
        assert cell.metrics_of(BENCH, w, True)


def test_a_new_cell_mix_and_metric_are_files_and_entries(tmp_path):
    """A copy of the benchmark with a configuration, a traffic mix, a cell and a per-layer
    metric added as files and entries only: the harness finds and loads each by name."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "perfbench/configs/scp2_ethanol.json").read_text())
    cfg["target"]["length"] = 576
    (root / "perfbench/configs/scp2_short.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic/serve_single.json").read_text())
    mix["pool"] = 3
    (root / "perfbench/traffic/serve_single_pool3.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/requests_traced.serve.py").write_text(
        "def read(ctx):\n    return ctx.slice.units if ctx.slice is not None else None\n")
    bench["configs"].append({"name": "scp2_short", "source": "x", "file":
                             "perfbench/configs/scp2_short.json", "reduced": [], "why": "y"})
    bench["workloads"].append({"name": "scp2_short.pool3", "config": "scp2_short",
                               "traffic": "serve_single_pool3", "chips": 1, "why": "z"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "scp2_ethanol.serve_single" in m["workloads"]:
            m["workloads"].append("scp2_short.pool3")
    bench["per_layer"].append({"name": "requests_traced.serve", "unit": "req", "better": "higher",
                               "source": "program_counter", "layer": "pipeline",
                               "moves": "serve_series_per_s", "workloads": ["scp2_short.pool3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = cell.load_benchmark(root)
    entry, config, traffic = cell.find_cell(loaded, root, "scp2_short.pool3")
    assert config["target"]["length"] == 576 and traffic["pool"] == 3
    assert cell.loop(traffic).__name__ == "loops.serve_single"
    names = [m["name"] for m in cell.metrics_of(loaded, "scp2_short.pool3", True)]
    assert "requests_traced.serve" in names and "osconv_roofline.serve" not in names
    assert "serve_series_per_s" in [m["name"] for m in cell.metrics_of(loaded, "scp2_short.pool3", False)]
    metric = cell.load_metric("requests_traced.serve", cell.home(loaded, root))
    assert metric.read(type("Ctx", (), {"slice": None})()) is None


def test_an_unknown_cell_is_refused():
    with pytest.raises(cell.Refused):
        cell.find_cell(BENCH, ROOT, "no_such.cell")
