"""The benchmark is driven by data: every piece a cell names is found by
name, and BENCHMARK.json keeps to the benchmark's contract."""

import importlib
import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_contract_keys_and_names(bench_json):
    b = bench_json
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("what", ["configs", "traffic", "drivers", "metrics", "limits"])
def test_every_piece_is_found_by_name(bench_json, what):
    from portbench.lib import harness

    for w in bench_json["workloads"]:
        cell = harness.load_cell(w["name"])
        if what == "configs":
            assert set(cell.config["reduced"]) == {"nprofiles"}
            assert cell.config["source"] == next(
                c["source"] for c in bench_json["configs"] if c["name"] == w["config"])
        elif what == "traffic":
            assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        elif what == "drivers":
            mod = importlib.import_module(f"portbench.drivers.{cell.mix['driver']}")
            assert callable(mod.generate) and callable(mod.end_to_end)
        elif what == "metrics":
            assert cell.per_layer, w["name"]
            for m in cell.per_layer:
                assert callable(harness.metric_reader(m["name"]).read), m["name"]
        else:
            from portbench.lib.check import NUMBERS

            assert set(cell.limits) == set(NUMBERS)


def test_each_cell_reports_setup_and_another_end_to_end_metric(bench_json):
    from portbench.lib import harness

    for w in bench_json["workloads"]:
        names = {m["name"] for m in harness.load_cell(w["name"]).end_to_end}
        assert "setup_s" in names and len(names) >= 2
