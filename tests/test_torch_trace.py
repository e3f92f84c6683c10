"""The port's traceback (pass 2) vs the JAX package's, on the CPU.

deciphon_tpu_torch/ops/viterbi_trace must give IDENTICAL state paths and
match strings to deciphon_tpu.ops.viterbi_trace.viterbi_alt_batch, on the
patterns of tests/test_viterbi_trace.py, and logliks within 1e-4.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.models import codec
from deciphon_tpu.models.alphabet import DNA
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu.ops import viterbi_trace as jtr
from deciphon_tpu_torch.models import codec as pcodec
from deciphon_tpu_torch.models.profile import sample_profile as psample
from deciphon_tpu_torch.ops import viterbi_trace as ptr


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core oversubscribes the
    cores many times over (these tensors are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LP = 32


def cases(sample=sample_profile):
    """(profile, read) pairs; ``sample`` is the JAX package's
    sample_profile or the port's, on the same seeds."""
    rng = np.random.default_rng(3)
    out = []
    for trial in range(6):
        prof = sample(trial + 1, int(rng.integers(2, 9)))
        L = int(rng.integers(4, LP))
        out.append((prof, "".join(rng.choice(list("ACGT"), L))))
    return out


@pytest.mark.parametrize("mh,h3", [(True, False), (False, False),
                                   (True, True)])
def test_paths_match_jax_batch(mh, h3):
    cs = cases()
    pprofs = [p for p, _ in cases(psample)]
    profs = [p for p, _ in cs]
    encs = [DNA.encode(s) for _, s in cs]
    got = ptr.viterbi_alt_batch(pprofs, encs, mh, h3, kpad=8,
                                 device="cpu")
    ref = jtr.viterbi_alt_batch(profs, encs, mh, h3, kpad=8, pad_to=LP)
    assert len(got) == len(ref) == len(cs)
    for g, r, (prof, seq), pprof, enc in zip(got, ref, cs, pprofs, encs):
        assert g.path == r.path
        assert g.loglik == pytest.approx(r.loglik, abs=1e-4)
        assert pcodec.render_match(pcodec.match_steps(pprof, seq, g.path)) == (
            codec.render_match(codec.match_steps(prof, seq, r.path))
        )
        # and the f64 oracle agrees on the path
        ora = vr.viterbi_alt(prof, enc, multi_hits=mh, hmmer3_compat=h3)
        assert g.path == ora.path


def test_padding_is_inert():
    """Node padding and batch padding (hit axis to a power of two) change
    neither the path nor the score."""
    cs = cases(psample)[:3]
    profs = [p for p, _ in cs]
    encs = [DNA.encode(s) for _, s in cs]
    base = ptr.viterbi_alt_batch(profs, encs, device="cpu")
    padded = ptr.viterbi_alt_batch(profs, encs, kpad=40, device="cpu")
    for a, b in zip(base, padded):
        assert a.path == b.path
        assert a.loglik == pytest.approx(b.loglik, abs=1e-4)


def test_walk_covers_read():
    prof, seq = cases(psample)[1]
    (res,) = ptr.viterbi_alt_batch([prof], [DNA.encode(seq)], device="cpu")
    assert sum(l for _, l in res.path) == len(seq)


@pytest.mark.parametrize("codes", [("N",), ("N", "R")])
def test_paths_with_codes_match_jax_batch(codes):
    """Reads holding IUPAC codes trace on the extended tables: paths
    identical to vtr.viterbi_alt_batch(codes=...) and the f64 oracle,
    match strings identical."""
    from deciphon_tpu.models.alphabet import encode_extended

    rng = np.random.default_rng(len(codes))
    profs, pprofs, reads = [], [], []
    for trial in range(5):
        k = int(rng.integers(2, 9))
        profs.append(sample_profile(trial + 11, k))
        pprofs.append(psample(trial + 11, k))
        r = list(rng.choice(list("ACGT"), int(rng.integers(8, LP))))
        r[trial % 4] = codes[0]
        r[-2] = codes[-1]
        reads.append("".join(r))
    encs = []
    for r in reads:
        enc, got = encode_extended(r)
        assert got == codes
        encs.append(enc)
    got = ptr.viterbi_alt_batch(pprofs, encs, kpad=8, codes=codes,
                                 device="cpu")
    ref = jtr.viterbi_alt_batch(profs, encs, kpad=8, pad_to=LP, codes=codes)
    for g, r, prof, pprof, seq, enc in zip(got, ref, profs, pprofs, reads,
                                           encs):
        assert g.path == r.path
        assert g.loglik == pytest.approx(r.loglik, abs=1e-4)
        assert pcodec.render_match(pcodec.match_steps(pprof, seq, g.path)) == (
            codec.render_match(codec.match_steps(prof, seq, r.path))
        )
        assert g.path == vr.viterbi_alt(prof, enc, codes=codes).path


@pytest.fixture
def tiny_engine(tmp_path):
    """A CPU engine over a 3-profile .dtp and two reads, one planted."""
    from deciphon_tpu_torch.db.format import TensorDB, write_db
    from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
    from deciphon_tpu_torch.models.h3reader import build_profile
    from deciphon_tpu_torch.models.h3writer import random_h3
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine, SeqRecord

    path = str(tmp_path / "t.dtp")
    write_db(path, [build_profile(random_h3(s + 1, k, peak=0.9))
                    for s, k in enumerate((4, 7, 5))])
    db = TensorDB.load(path)
    planted = "".join(
        STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
        for b in map(int, np.argmax(db.profile(1).match_codonp, 1)))
    seqs = [SeqRecord(1, "r1", planted), SeqRecord(2, "r2", "ACGTTGCAACG")]
    return ScanEngine(db, device="cpu"), seqs


def test_device_trace_off_without_the_variable(tiny_engine, tmp_path,
                                               monkeypatch):
    """Without DCP_PROFILE_DIR a scan writes nothing and runs no
    profiler."""
    from deciphon_tpu_torch.utils import trace

    monkeypatch.delenv("DCP_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    engine, seqs = tiny_engine
    before = set(tmp_path.rglob("*"))
    with trace.device_trace("scan", "cpu"):
        assert torch.autograd.profiler._is_profiler_enabled is False
    engine.scan(seqs)
    assert set(tmp_path.rglob("*")) == before


@pytest.mark.parametrize("label", ["scan", "best_hits"])
def test_device_trace_writes_one_chrome_trace(tiny_engine, tmp_path,
                                              monkeypatch, label):
    """With DCP_PROFILE_DIR, scan and best_hits each write one Chrome
    trace under <dir>/<label>/ holding the engine's torch ops and its
    phase ranges (CPU activity only, as the engine runs on the CPU)."""
    import json

    out = tmp_path / "prof"
    monkeypatch.setenv("DCP_PROFILE_DIR", str(out))
    engine, seqs = tiny_engine
    hits = getattr(engine, label)(seqs)
    assert hits  # the planted read hits profile 2
    (path,) = (out / label).iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    phases = {"pass1", "gate", "pass2"} if label == "scan" else {"pass1"}
    assert phases <= names
    assert any(n and n.startswith("aten::") for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)


def test_device_trace_logs_the_traced_scans_counters(tiny_engine, tmp_path,
                                                     monkeypatch):
    """The log line that names the trace gives the counters of the scan it
    traced, and of no scan before it."""
    from deciphon_tpu_torch.utils import trace

    said = []
    monkeypatch.setattr(trace.log, "info", said.append)
    engine, seqs = tiny_engine
    with trace.recording():
        engine.scan(seqs)  # recorded before the traced scan
    monkeypatch.setenv("DCP_PROFILE_DIR", str(tmp_path / "prof"))
    hits = engine.scan(seqs)
    (line,) = said
    want = dict(sorted(engine.last_counts.items()))
    assert want["hits_decoded"] == len(hits) > 0
    assert line.endswith(f", counters {want}")


# The span recorder (utils/trace): a scan's root, its spans and counters.

PASS1 = {"pass1.eidx", "pass1.ext_tables", "pass1.launch", "pass1.pull"}
PASS2 = {"pass2.pack", "pass2.wait", "pass2.walk", "pass2.codec"}


def _with_n(seqs):
    from deciphon_tpu_torch.ops.scan_engine import SeqRecord

    return seqs + [SeqRecord(3, "r3", "ACGNTGCAACGTTA")]


def _recorded_scan(engine, seqs):
    from deciphon_tpu_torch.utils import trace

    with trace.recording():
        hits = engine.scan(seqs)
    return hits, engine.last_spans, engine.last_counts


def _depths(spans):
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        d, p = 0, s.parent
        while p:
            d, p = d + 1, by_id[p].parent
        out[s.id] = d
    return out


def test_span_tree_of_a_tiny_scan(tiny_engine):
    """One root 'scan'; encode, pass1, gate and pass2 under it; pass 1's
    and pass 2's parts under them; one scan id for every span of a scan,
    a new one for the next scan."""
    engine, seqs = tiny_engine
    _, spans, _ = _recorded_scan(engine, _with_n(seqs))
    by_id = {s.id: s for s in spans}
    root = spans[0]
    assert root.name == "scan" and root.parent == 0
    assert {s.scan for s in spans} == {root.scan}
    parent = {s.name: by_id[s.parent].name for s in spans[1:]}
    assert {n for n, p in parent.items() if p == "scan"} == {
        "encode", "pass1", "gate", "pass2"}
    assert {n for n, p in parent.items() if p == "pass1"} == PASS1
    assert {n for n, p in parent.items() if p == "pass2"} == PASS2
    assert {n for n, p in parent.items() if p == "pass1.ext_tables"} == {
        "ext_tables.pack", "ext_tables.synth"}
    # one eidx build per read class (ACGT, N), a launch per block and class
    names = [s.name for s in spans]
    assert names.count("pass1.eidx") == 2
    assert names.count("pass1.launch") == 2 * len(engine.blocks)
    assert names.count("pass1.ext_tables") == len(engine.blocks)
    _, again, _ = _recorded_scan(engine, seqs)
    assert {s.scan for s in again} == {again[0].scan}
    assert again[0].scan != root.scan
    assert not {s.id for s in again} & {s.id for s in spans}


def test_children_lie_inside_their_parent(tiny_engine):
    engine, seqs = tiny_engine
    _, spans, _ = _recorded_scan(engine, _with_n(seqs))
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start <= s.end
        if s.parent:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
    depth = _depths(spans)
    assert max(depth.values()) == 3  # scan > pass1 > ext_tables > pack
    # stamped on torch.profiler's clock, Unix-epoch ns
    import time

    assert abs(spans[-1].end - time.time_ns()) < 60e9


def test_hits_decoded_counts_the_hits(tiny_engine):
    engine, seqs = tiny_engine
    hits, _, counts = _recorded_scan(engine, seqs)
    assert hits and counts["hits_decoded"] == len(hits)
    assert counts["wait.pass1"] == 1 and counts["wait.pass2"] == 1
    # the CPU launches no kernel
    assert not {k for k in counts if k.startswith("launch.")}


@pytest.mark.parametrize("with_n", [True, False])
def test_ext_tables_counted_only_for_reads_with_a_code(tiny_engine, with_n):
    engine, seqs = tiny_engine
    _, spans, counts = _recorded_scan(engine,
                                      _with_n(seqs) if with_n else seqs)
    n_ext = sum(s.name == "pass1.ext_tables" for s in spans)
    if with_n:
        assert counts["ext_tables"] == n_ext == len(engine.blocks)
        want = sum(engine.packed(b, ("N",)).nbytes for b in engine.blocks)
        assert counts["ext_table_bytes"] == want > 0
    else:
        assert counts.get("ext_tables", 0) == n_ext == 0
        assert counts.get("ext_table_bytes", 0) == 0


def test_ext_inputs_built_once_in_the_stores_life(tiny_engine):
    """The extended tables' inputs are built in the first scan that meets
    a code set, and a later scan of another code set reuses them: the
    counter reads 1, then 0."""
    from deciphon_tpu_torch.ops.scan_engine import SeqRecord

    engine, seqs = tiny_engine
    _, _, first = _recorded_scan(engine, _with_n(seqs))
    _, spans, second = _recorded_scan(
        engine, seqs + [SeqRecord(4, "r4", "ACGRTGCAACGTTA")])
    assert first["ext_inputs_built"] == 1
    assert second.get("ext_inputs_built", 0) == 0
    assert second["ext_tables"] == len(engine.blocks)
    assert sum(s.name == "ext_tables.synth" for s in spans) == len(
        engine.blocks)


def test_recording_off_leaves_no_spans_and_the_same_results(tiny_engine):
    """A scan that is not recorded keeps no spans or counters, and hits
    and pass-1 scores equal a recorded scan's."""
    from deciphon_tpu_torch.utils import trace

    engine, seqs = tiny_engine
    seqs = _with_n(seqs)
    assert engine.last_spans == [] and engine.last_counts == {}
    off = engine.scan(seqs)
    assert engine.last_spans == [] and engine.last_counts == {}
    off_scores = engine.last_scores
    assert set(engine.last_timings) == {"encode", "pass1", "gate", "pass2",
                                        "survivors"}
    on, spans, _ = _recorded_scan(engine, seqs)
    assert spans and trace.recorded()[-1].spans == spans
    assert [(h.seq_idx, h.profile_idx, h.alt_loglik, h.path, h.match)
            for h in on] == [(h.seq_idx, h.profile_idx, h.alt_loglik, h.path,
                              h.match) for h in off]
    for a, b in zip(off_scores, engine.last_scores):
        np.testing.assert_array_equal(a, b)
    engine.scan(seqs)  # off again: the last scan's fields empty again
    assert engine.last_spans == [] and engine.last_counts == {}


def test_off_no_range_and_a_profiler_records_with_phase_ranges_only(
        tiny_engine, monkeypatch):
    """Off, no span opens a record_function range.  Under a bare
    torch.profiler a scan is recorded, and of its spans only the phases
    pass1, gate and pass2 are ranges."""
    import torch.profiler as tp

    from deciphon_tpu_torch.utils import trace

    opened = []
    real = tp.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(tp, "record_function", spy)
    engine, seqs = tiny_engine
    engine.scan(_with_n(seqs))
    engine.best_hits(seqs)
    assert opened == []
    with tp.profile(activities=[tp.ProfilerActivity.CPU]):
        engine.scan(_with_n(seqs))
    assert sorted(opened) == ["gate", "pass1", "pass2"]
    assert engine.last_spans and trace.recorded()[-1].spans == engine.last_spans


def test_best_hits_is_a_root_and_leaves_the_scan_fields(tiny_engine):
    from deciphon_tpu_torch.utils import trace

    engine, seqs = tiny_engine
    _, spans, counts = _recorded_scan(engine, seqs)
    with trace.recording():
        assert engine.best_hits(seqs)
    assert engine.last_spans is spans and engine.last_counts is counts
    got = trace.recorded()[-1]
    assert got.spans[0].name == "best_hits"
    assert {s.name for s in got.spans} == {"best_hits", "encode", "pass1",
                                           "pass1.eidx", "pass1.launch",
                                           "pass1.pull"}


def test_counts_and_spans_off_the_scan_thread(tiny_engine):
    """A counter counted on the scan's thread is the scan's; one counted,
    or a span opened, on another thread while a scan records (a warmup
    beside it, say) is not."""
    import threading

    from deciphon_tpu_torch.utils import trace

    engine, seqs = tiny_engine
    seen = []

    def other():
        trace.count("test.bumps", 5)
        with trace.span("elsewhere") as s:
            seen.append(s)

    real = engine._traceback

    def traceback(*a):
        trace.count("test.bumps", 3)
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        return real(*a)

    engine._traceback = traceback
    _, spans, counts = _recorded_scan(engine, seqs)
    assert counts["test.bumps"] == 3
    assert seen == [trace.NOOP]
    assert "elsewhere" not in {s.name for s in spans}


def test_spans_match_their_ranges_in_a_device_trace(tiny_engine, tmp_path,
                                                    monkeypatch, capsys):
    """Under device_trace every span is a record_function range of the
    Chrome trace, and each span's start and end lie within 1 ms of its
    range's (one clock for both; the n-th span of a name pairs with the
    n-th range).  A host that deschedules the scan between the range's
    stamp and the span's widens the gap, so a scan that misses is traced
    again, up to three times."""
    import json

    engine, seqs = tiny_engine
    for attempt in range(3):
        out = tmp_path / f"prof{attempt}"
        monkeypatch.setenv("DCP_PROFILE_DIR", str(out))
        engine.scan(_with_n(seqs))
        spans = engine.last_spans
        (path,) = (out / "scan").iterdir()
        doc = json.loads(path.read_text())
        base = doc.get("baseTimeNanoseconds", 0)
        ranges = {}
        for e in doc["traceEvents"]:
            if e.get("cat") == "user_annotation":
                s = base + 1e3 * e["ts"]
                ranges.setdefault(e["name"], []).append((s, s + 1e3 * e["dur"]))
        assert {s.name for s in spans} == set(ranges)
        gaps = []
        for name, rs in ranges.items():
            mine = [(s.start, s.end) for s in spans if s.name == name]
            assert len(mine) == len(rs)
            for (s0, s1), (r0, r1) in zip(sorted(mine), sorted(rs)):
                gaps += [abs(s0 - r0), abs(s1 - r1)]
        if max(gaps) < 1e6:
            break
    with capsys.disabled():
        print(f"\nspan vs range: median {sorted(gaps)[len(gaps) // 2]:.0f} ns, "
              f"max {max(gaps):.0f} ns (attempt {attempt + 1})")
    assert max(gaps) < 1e6


def test_one_span_costs_off_and_on(capsys):
    """One span's cost with recording off (a check of the thread's open
    root) and on (two clock reads and a tuple), printed, not asserted."""
    import time

    from deciphon_tpu_torch.utils import trace

    n = 20000

    def per_span():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("pass1.launch"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off = per_span()
    with trace.recording(), trace.root("cost") as rec:
        on = per_span()
    assert len(rec.spans) == n + 1
    with capsys.disabled():
        print(f"\none span: {off:.0f} ns off, {on:.0f} ns on (CPU)")
