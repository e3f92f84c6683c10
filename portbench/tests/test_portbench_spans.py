"""The readers of the program's spans and counters, and the device
timeline they leave as it was: on hand-made records and a synthetic event
list, and in traced runs on the CPU."""

import time
from types import SimpleNamespace

import pytest

from conftest import tiny_cell, traced_cpu_metrics


def _run(cell, trace=False, seconds=0.5):
    from portbench.lib import harness

    return harness.run(cell, 2**31 + 11, seconds, trace, time.perf_counter(),
                       "cpu", log=lambda m: None)


OFFSET = 1_000_000_000  # the recorder's clock less perf_counter_ns, in ns


def _scan(sid, t0, parts, counts):
    """A recorded scan whose root opens at host time ``t0`` (s) and holds
    one span of each (name, ms) of ``parts`` in turn."""
    from deciphon_tpu_torch.utils.trace import Scan, Span

    start = int(t0 * 1e9) + OFFSET
    spans, at = [], start + 1000
    for k, (name, ms) in enumerate(parts):
        spans.append(Span(name, 100 * sid + k + 1, 100 * sid, sid, at,
                          at + int(ms * 1e6)))
        at += int(ms * 1e6)
    root = Span("scan", 100 * sid, 0, sid, start, at)
    return Scan(sid, [root] + spans, dict(counts), OFFSET)


def _record(start, end, nreads=1000, failed=False):
    from portbench.lib.loop import Record

    return Record(unit=0, start=start, end=end, nreads=nreads, failed=failed,
                  timings={}, hits=[], rows={})


@pytest.fixture
def two_units(monkeypatch):
    """Two units of 1000 reads and the scans the program recorded."""
    from portbench.lib import harness, spans

    scans = [
        _scan(1, 10.1, [("pass1.ext_tables", 100), ("pass1.pull", 20),
                        ("pass2.pack", 30), ("pass2.codec", 40)],
              {"hits_decoded": 4, "launch.viterbi": 12, "launch.traceback": 2,
               "wait.pass1": 1}),
        _scan(2, 11.2, [("pass1.ext_tables", 50), ("pass1.pull", 10)],
              {"hits_decoded": 0, "launch.viterbi": 12, "launch.tables": 1}),
    ]
    monkeypatch.setattr(spans, "recorded", lambda: scans)
    records = [_record(10.0, 11.0), _record(11.0, 12.5)]
    return harness.Run(None, records, [], None, None), scans


@pytest.mark.parametrize("metric, want", [
    ("ext_tables_ms_per_kread.mix", 75.0),
    ("pass1_wait_ms_per_kread.batch", 15.0),
    ("trace_pack_ms_per_kread.mix", 15.0),
    ("codec_ms_per_hit.mix", 10.0),
    ("pass1_wait_ms.query", 15.0),
    ("codec_ms_per_hit.query", 10.0),
    ("launches_per_unit.query", 13.5),
])
def test_each_reader_on_hand_made_records(two_units, metric, want):
    from portbench.lib import harness

    run, _ = two_units
    assert harness.metric_reader(metric).read(run) == pytest.approx(want)


def test_readers_find_nothing_without_a_scan_for_every_unit(two_units,
                                                            monkeypatch):
    from portbench.lib import harness, spans

    run, scans = two_units
    run.records.append(_record(13.0, 14.0))  # no scan opened in it
    for m in ("ext_tables_ms_per_kread", "pass1_wait_ms_per_kread",
              "trace_pack_ms_per_kread", "codec_ms_per_hit", "pass1_wait_ms",
              "launches_per_unit"):
        assert harness.metric_reader(m).read(run) is None
    run.records.pop()
    scans[0].counts["hits_decoded"] = 0  # a window without a hit
    assert harness.metric_reader("codec_ms_per_hit").read(run) is None
    for s in scans:  # a window that launched no kernel, as on the CPU
        s.counts = {k: n for k, n in s.counts.items() if not k.startswith("launch.")}
    assert harness.metric_reader("launches_per_unit").read(run) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)  # an older program
    assert harness.metric_reader("pass1_wait_ms_per_kread").read(run) is None


class _KEvent:
    def __init__(self, name, dev, s, e):
        self._n, self._d, self._s, self._e = name, dev, s, e

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def test_the_device_timeline_reads_as_before():
    """devtrace.timeline on a fixed event list: the window, the busy union,
    the kernels by name and the gaps labelled by the phase ranges."""
    from portbench.lib import devtrace

    evts = [
        _KEvent("portbench.unit", False, 0, 10000),
        _KEvent("pass1", False, 0, 4000),
        _KEvent("pass2", False, 5000, 9000),
        _KEvent("k1", True, 1000, 2000),
        _KEvent("k2", True, 1500, 3000),
        _KEvent("Memcpy DtoH", True, 6000, 7000),
        _KEvent("pass1", True, 0, 4000),  # the range mirrored on the device
        _KEvent("portbench.unit", True, 0, 10000),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evts)))
    t = devtrace.timeline(prof)
    assert t.window_s == pytest.approx(1e-5)
    assert t.busy_s == pytest.approx(3e-6)
    assert t.by_name == pytest.approx({"k1": 1e-6, "k2": 1.5e-6,
                                       "Memcpy DtoH": 1e-6})
    assert [(pytest.approx(s), label) for s, label in t.gaps] == [
        (3e-6, "pass2"), (3e-6, "between scans"), (1e-6, "pass1")]
    assert t.kernel_s("k") == pytest.approx(2.5e-6)


MIX = {"pass1_ms_per_kread.mix", "pass2_ms_per_kread.mix"}
SPANS_MIX = {"ext_tables_ms_per_kread.mix", "trace_pack_ms_per_kread.mix",
             "codec_ms_per_hit.mix"}


@pytest.mark.parametrize("workload, want", [
    ("pfam4k_vit.reads150_mix", MIX | SPANS_MIX),
    ("pfam4k_vit.reads150_bg", {"pass1_ms_per_kread.batch",
                                "pass2_ms_per_kread.batch",
                                "pass1_wait_ms_per_kread.batch"}),
    ("pfam4k_fwd.reads150_bg", {"pass1_ms_per_kread.fwd",
                                "pass2_ms_per_kread.fwd"}),
])
def test_traced_run_reports_the_span_metrics(tiny_cache, workload, want):
    """A batch cell's traced run on the CPU reads every metric of the
    program's spans and counters that BENCHMARK.json gives the cell, and
    nothing else: the CPU has no device trace.  ``want``, what the cell
    reported when its set was first derived, stays in it (every mix
    batch holds homologs, so the codec has hits)."""
    derived = traced_cpu_metrics(workload)
    assert want <= derived
    res = _run(tiny_cell(workload), trace=True)
    assert set(res["metrics"]) == derived
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_traced_run_of_a_program_that_records_nothing(tiny_cache,
                                                      monkeypatch):
    """Against a program without the recorder the readers of its spans
    and counters find nothing and the run reports what it reported
    before."""
    from deciphon_tpu_torch.utils import trace

    want = traced_cpu_metrics("pfam4k_vit.reads150_mix", recorder=False)
    assert MIX <= want
    monkeypatch.delattr(trace, "recorded")
    res = _run(tiny_cell(), trace=True)
    assert set(res["metrics"]) == want
