"""The cell of the whole Pfam-A release, ``pfamA_vit.reads150_mix``: its
configuration keeps to the contract of ``reduced``, its two readers
(``ext_slices_per_unit``, ``tables_roofline_pct``) read hand-made
records and find nothing where nothing was counted or traced, and its
traced run on the CPU reports the metrics BENCHMARK.json gives it."""

import json
import time

import pytest

from conftest import ROOT, tiny_cell, traced_cpu_metrics
from test_portbench_layout import reduced_faults
from test_portbench_spans import _record, _scan

CELL = "pfamA_vit.reads150_mix"
SLICES = "ext_slices_per_unit.release"
ROOFLINE = "tables_roofline_pct.release"


def test_the_configuration_is_the_published_release(bench_json):
    from portbench.lib import harness

    entry = next(c for c in bench_json["configs"] if c["name"] == "pfamA_vit")
    cfg = harness.load_cell(CELL).config
    assert reduced_faults(entry, cfg) == []
    assert cfg["nprofiles"] == cfg["published"]["nprofiles"] == 19632
    assert entry["reduced"] == cfg["reduced"] == []
    small = json.loads((ROOT / "portbench" / "configs" / "pfam4k_vit.json").read_text())
    for k in ("db_seed", "median", "sigma", "clip", "outliers", "peak", "epsilon",
              "entry_dist", "scan", "precision", "assumed", "published"):
        assert cfg[k] == small[k], k


def test_the_cell_reports_the_mix_and_its_own_metrics(bench_json):
    """The cell reports what the 4096-profile mix reports, plus the two
    metrics that name it alone."""
    from portbench.lib import harness

    new, old = harness.load_cell(CELL), harness.load_cell("pfam4k_vit.reads150_mix")
    assert new.mix == old.mix and new.chips == 1
    assert [m["name"] for m in new.end_to_end] == [m["name"] for m in old.end_to_end]
    names = [m["name"] for m in new.per_layer]
    assert names == [m["name"] for m in old.per_layer] + [SLICES, ROOFLINE]
    for m in bench_json["per_layer"]:
        if m["name"] in (SLICES, ROOFLINE):
            assert m["workloads"] == [CELL] and m["moves"] == "reads_per_s.mix"


@pytest.fixture
def two_units(monkeypatch):
    """Two units of 1000 reads, the scans the program recorded, and a
    device timeline whose tables kernel ran 2 ms."""
    from portbench.lib import devtrace, harness, roofline, spans

    per = roofline.PEAK_BYTES * 1e-3  # bytes the card writes in 1 ms
    scans = [
        _scan(1, 10.1, [("pass1.ext_tables", 10)],
              {"ext_slices": 17, "tables_written_bytes": per, "ext_table_bytes": 9 * per}),
        _scan(2, 11.2, [("pass1.ext_tables", 10)],
              {"ext_slices": 13, "tables_written_bytes": 0.5 * per}),
    ]
    monkeypatch.setattr(spans, "recorded", lambda: scans)
    timeline = devtrace.Timeline(3.0, 1.0, {"void tables_kernel<true>(...)": 2e-3,
                                            "viterbi_kernel<4, 8, false>": 0.5}, [])
    records = [_record(10.0, 11.0), _record(11.0, 12.5)]
    return harness.Run(None, records, [], None, timeline), scans


def test_the_readers_on_hand_made_records(two_units):
    from portbench.lib import harness

    run, _ = two_units
    assert harness.metric_reader(SLICES).read(run) == pytest.approx(15.0)
    # 1.5 ms of bytes at the peak over 2 ms of the kernel
    assert harness.metric_reader(ROOFLINE).read(run) == pytest.approx(75.0)


def test_the_readers_find_nothing_where_nothing_was_counted_or_traced(two_units,
                                                                      monkeypatch):
    from portbench.lib import devtrace, harness, spans

    run, scans = two_units
    for s in scans:  # a program older than the counters
        s.counts = {k: n for k, n in s.counts.items()
                    if k not in ("ext_slices", "tables_written_bytes")}
    assert harness.metric_reader(SLICES).read(run) is None
    assert harness.metric_reader(ROOFLINE).read(run) is None
    scans[0].counts.update(ext_slices=2, tables_written_bytes=10)
    assert harness.metric_reader(SLICES).read(run) == pytest.approx(1.0)
    run.timeline = devtrace.Timeline(3.0, 1.0, {"viterbi_kernel": 0.5}, [])
    assert harness.metric_reader(ROOFLINE).read(run) is None  # no kernel event
    run.timeline = None  # no device trace, as on the CPU
    assert harness.metric_reader(ROOFLINE).read(run) is None
    run.records.append(_record(13.0, 14.0))  # a unit without a scan
    assert harness.metric_reader(SLICES).read(run) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)  # a program without the recorder
    run.records.pop()
    assert harness.metric_reader(SLICES).read(run) is None


def test_the_cells_traced_run_on_the_cpu(tiny_cache):
    """A traced run of the cell, cut to a tiny DB, reports exactly the
    metrics of BENCHMARK.json that the program's spans and counters feed,
    the slices among them: slicing, and its counter, do not depend on the
    device.  The tables' roofline is a device trace's and is absent."""
    from portbench.lib import harness

    derived = traced_cpu_metrics(CELL)
    assert SLICES in derived and ROOFLINE not in derived
    res = harness.run(tiny_cell(CELL), 2**31 + 23, 0.5, True, time.perf_counter(),
                      "cpu", log=lambda m: None)
    assert set(res["metrics"]) == derived
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["correct"] and res["failed"] == 0
