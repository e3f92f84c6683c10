"""The benchmark is driven by data: every piece a cell names is found by
name, and BENCHMARK.json keeps to the benchmark's contract."""

import importlib
import json
import re
import shutil

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PIECES = ("configs", "traffic", "drivers", "metrics", "limits")


def reduced_faults(entry: dict, config: dict) -> list[str]:
    """How a configuration breaks the contract of ``reduced``: every key
    it names is a key of ``published``; a published key is named exactly
    where the configuration's value differs from the published one; each
    is explained in ``why_reduced`` (one text for all, or one a key);
    and BENCHMARK.json's ``configs`` entry names the same keys."""
    pub, red = config.get("published", {}), config["reduced"]
    out = []
    if sorted(entry["reduced"]) != sorted(red) or len(set(red)) != len(red):
        out.append(f"BENCHMARK.json's reduced {entry['reduced']} is not the file's {red}")
    out += [f"{k!r} is reduced but not published" for k in red if k not in pub]
    for k, v in pub.items():
        if (config.get(k) != v) != (k in red):
            out.append(f"{k!r} is {config.get(k)!r}, published {v!r}, "
                       f"{'yet' if k in red else 'not'} in reduced")
    why = config.get("why_reduced")
    for k in red:
        text = why.get(k) if isinstance(why, dict) else why
        if not (isinstance(text, str) and text.strip()):
            out.append(f"{k!r} is not explained in why_reduced")
    return out


def check_contract(b: dict):
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


def check_piece(b: dict, root, what: str):
    """Every cell of ``b`` finds its ``what`` by name under ``root``."""
    from portbench.lib import harness

    for w in b["workloads"]:
        cell = harness.load_cell(w["name"], root)
        if what == "configs":
            entry = next(c for c in b["configs"] if c["name"] == w["config"])
            assert not reduced_faults(entry, cell.config), w["config"]
            assert cell.config["source"] == entry["source"]
        elif what == "traffic":
            assert (root / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
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


def check_cells_report_setup_and_another(b: dict, root):
    from portbench.lib import harness

    for w in b["workloads"]:
        names = {m["name"] for m in harness.load_cell(w["name"], root).end_to_end}
        assert "setup_s" in names and len(names) >= 2


def test_contract_keys_and_names(bench_json):
    check_contract(bench_json)


@pytest.mark.parametrize("what", PIECES)
def test_every_piece_is_found_by_name(bench_json, what):
    check_piece(bench_json, ROOT, what)


def test_each_cell_reports_setup_and_another_end_to_end_metric(bench_json):
    check_cells_report_setup_and_another(bench_json, ROOT)


def add_cell(b: dict, base: str, config: str, workload: str) -> dict:
    """``b`` with ``workload`` added by the route of portbench/README.md:
    its entries, and its name appended to the ``workloads`` list of every
    metric that names the cell ``base`` of the same traffic."""
    b = json.loads(json.dumps(b))
    w = dict(next(x for x in b["workloads"] if x["name"] == base),
             name=workload, config=config)
    b["workloads"].append(w)
    for m in b["end_to_end"] + b["per_layer"]:
        if base in m.get("workloads", ()):
            m["workloads"].append(workload)
    return b


@pytest.mark.parametrize("case", ["published_scale", "reduced_but_published",
                                  "changed_but_not_reduced"])
def test_a_cell_added_by_files_and_list_appends(bench_json, tmp_path, monkeypatch,
                                                case):
    """A copy of the benchmark gains a configuration at its published
    count (``reduced: []``) and a cell, by new files and appends to
    ``workloads`` lists only: the layout contract and the harness take
    it, and the cell reports what its traffic's cell reports.  The
    contract refuses the copy where ``reduced`` names a key at its
    published value, or leaves out a key that was changed."""
    from portbench.lib import harness

    bench = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "portbench" / d, bench / d)
    monkeypatch.setattr(harness, "BENCH", bench)

    base, workload = "pfam4k_vit.reads150_mix", "pfamA_vit.reads150_mix"
    cfg = json.loads((bench / "configs" / "pfam4k_vit.json").read_text())
    cfg = {k: v for k, v in cfg.items() if k != "why_reduced"}
    cfg.update(nprofiles=cfg["published"]["nprofiles"], reduced=[])
    if case == "reduced_but_published":
        cfg.update(reduced=["nprofiles"], why_reduced="a fifth of the release")
    elif case == "changed_but_not_reduced":
        cfg.update(nprofiles=8192)
    (bench / "configs" / "pfamA_vit.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "limits" / f"{base}.json", bench / "limits" / f"{workload}.json")
    entry = dict(next(c for c in bench_json["configs"] if c["name"] == "pfam4k_vit"),
                 name="pfamA_vit", file="portbench/configs/pfamA_vit.json",
                 reduced=cfg["reduced"])
    copy = add_cell(dict(bench_json, configs=bench_json["configs"] + [entry]),
                    base, "pfamA_vit", workload)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(copy))

    faults = reduced_faults(entry, harness.load_cell(workload, tmp_path).config)
    if case != "published_scale":
        assert len(faults) == 1 and "nprofiles" in faults[0], faults
        return
    assert faults == []
    check_contract(copy)
    for what in PIECES:
        check_piece(copy, tmp_path, what)
    check_cells_report_setup_and_another(copy, tmp_path)
    new, old = harness.load_cell(workload, tmp_path), harness.load_cell(base, tmp_path)
    assert new.config["nprofiles"] == 19632 and new.mix == old.mix
    for part in ("end_to_end", "per_layer"):
        assert getattr(new, part) == getattr(old, part)
        assert all(workload in m.get("workloads", [workload]) for m in getattr(new, part))
    for w in bench_json["workloads"]:  # the cells already there report as before
        was = harness.load_cell(w["name"])
        now = harness.load_cell(w["name"], tmp_path)
        assert [m["name"] for m in now.end_to_end] == [m["name"] for m in was.end_to_end]
        assert [m["name"] for m in now.per_layer] == [m["name"] for m in was.per_layer]
