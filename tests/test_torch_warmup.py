"""The port's ScanEngine.warmup and its callers (CLI, daemon), on the CPU.

``warmup(nseqs, max_len)`` is the counterpart of the JAX engine's
(deciphon_tpu/ops/scan_engine.py:492-616): pass 1 once per block (per
tile on a mesh) on a dummy batch of the scan's shapes, eidx
[nseqs, max_len, 5] of symbol 0 with every read 1 nt long, then the
pull.  It changes no hit: scans after it equal a fresh engine's and the
JAX XLA engine's within the tolerances of tests/test_torch_scan_engine.py
(logliks 1e-4, LRT 2e-4; paths and match strings identical).  The CLI
warms on its first batch (deciphon_tpu/cli/main.py:107-115); the daemon
while it spools a job's reads, joined before the first scan, then topped
up at the job's shapes (deciphon_tpu/server/daemon.py:246-282), and a
failed warmup fails the job.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from deciphon_tpu.db.format import TensorDB as JaxTensorDB
from deciphon_tpu.ops import scan_engine as jse
from deciphon_tpu_torch.cli.main import main as torch_main
from deciphon_tpu_torch.db.format import TensorDB, write_db
from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
from deciphon_tpu_torch.models.h3reader import press_file
from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
from deciphon_tpu_torch.ops import scan_engine as pse
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops import viterbi_trace as vtr
from deciphon_tpu_torch.parallel.mesh import make_scan_mesh
from deciphon_tpu_torch.server import fake_sched
from deciphon_tpu_torch.server.api import SchedAPI
from deciphon_tpu_torch.server.daemon import Server
from deciphon_tpu_torch.utils import trace
from deciphon_tpu_torch.utils.config import ServerConfig
from deciphon_tpu_torch.utils.progress import Progress


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core oversubscribes the
    cores many times over (these tensors are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def consensus_dna(prof):
    return "".join(
        STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
        for b in map(int, np.argmax(prof.match_codonp, axis=1))
    )


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """Four profiles in three widths (blocks), pressed by the port."""
    tmp = tmp_path_factory.mktemp("torch_warmup")
    hmm = tmp / "synth.hmm"
    with open(hmm, "w") as fp:
        write_h3(fp, [random_h3(s, k, peak=0.9)
                      for s, k in [(1, 4), (2, 6), (3, 40), (4, 70)]])
    dbp = str(tmp / "synth.dtp")
    write_db(dbp, press_file(str(hmm)))
    return TensorDB.load(dbp)


def _reads(db):
    return [consensus_dna(db.profile(1)), "ACGTACGTACGTACGTACGTACGT",
            consensus_dna(db.profile(0)), "ACG"]


def _recs(reads, mod=pse):
    return [mod.SeqRecord(i + 1, f"r{i}", r) for i, r in enumerate(reads)]


@pytest.fixture
def spy_scores(monkeypatch):
    """Every vc.scores call's (kpad, eidx shape and dtype, seq_len)."""
    calls = []
    real = vc.scores

    def scores(blk, eidx, seq_len, *a, **k):
        calls.append((blk.fm.shape[2], tuple(eidx.shape), eidx.dtype,
                      seq_len.tolist()))
        return real(blk, eidx, seq_len, *a, **k)

    monkeypatch.setattr(vc, "scores", scores)
    return calls


@pytest.mark.parametrize("algo", ["viterbi", "forward"])
def test_warmup_runs_each_block_once_at_the_dummy_shapes(db, spy_scores,
                                                         algo):
    engine = pse.ScanEngine(db, pse.ScanParams(algo=algo), device="cpu")
    assert len(engine.blocks) >= 2
    spent = engine.warmup(5, 37)
    assert spent > 0
    assert sorted(k for k, *_ in spy_scores) == sorted(
        b.kpad for b in engine.blocks)
    for _, shape, dtype, slen in spy_scores:
        assert shape == (5, 37, 5) and dtype == torch.int32
        assert slen == [1] * 5
    assert all(b.tiles is not None for b in engine.blocks)


def test_warmup_leaves_the_scan_state(db):
    """No last_* field (the recorded spans and counters too), progress or
    pass-2 counter moves, and a warmup while recording records no scan."""
    engine = pse.ScanEngine(db, pse.ScanParams(lrt_threshold=-1e9),
                            device="cpu")
    with trace.recording():
        engine.scan(_recs(_reads(db)[:2]))
        assert engine.last_spans and engine.last_counts
        engine.progress = Progress(10 ** 9)
        before = (engine.last_scores, dict(engine.last_timings),
                  list(engine.last_survivors), engine.progress.consumed,
                  list(engine.last_spans), dict(engine.last_counts),
                  dict(vtr.LAUNCHES), dict(vtr.HOST_WAITS),
                  len(trace.recorded()))
        engine.warmup(3, 50)
        after = (engine.last_scores, dict(engine.last_timings),
                 list(engine.last_survivors), engine.progress.consumed,
                 list(engine.last_spans), dict(engine.last_counts),
                 dict(vtr.LAUNCHES), dict(vtr.HOST_WAITS),
                 len(trace.recorded()))
    assert after[0] is before[0] and after[1:] == before[1:]


@pytest.mark.parametrize("params", [dict(lrt_threshold=10.0),
                                    dict(lrt_threshold=-1e9)])
def test_scan_after_warmup_equals_fresh_and_jax(db, params):
    reads = _reads(db)
    warmed = pse.ScanEngine(db, pse.ScanParams(**params), device="cpu")
    warmed.warmup(len(reads), max(map(len, reads)))
    got = warmed.scan(_recs(reads))
    fresh = pse.ScanEngine(db, pse.ScanParams(**params),
                           device="cpu").scan(_recs(reads))
    ref = jse.ScanEngine(JaxTensorDB.load(db.path), jse.ScanParams(**params),
                         use_pallas=False).scan(_recs(reads, jse))
    assert got and len(got) == len(fresh) == len(ref)
    for a, f, r in zip(got, fresh, ref):
        assert (a.seq_id, a.profile_idx, a.alt_loglik, a.null_loglik,
                a.path, a.match) == (f.seq_id, f.profile_idx, f.alt_loglik,
                                     f.null_loglik, f.path, f.match)
        assert (a.seq_id, a.profile_idx) == (r.seq_id, r.profile_idx)
        assert a.alt_loglik == pytest.approx(r.alt_loglik, abs=1e-4)
        assert a.null_loglik == pytest.approx(r.null_loglik, abs=1e-4)
        assert a.lrt == pytest.approx(r.lrt, abs=2e-4)
        assert a.path == r.path and a.match == r.match


@pytest.mark.parametrize("share", ["one engine", "two engines, one store"])
def test_concurrent_warmups_build_each_block_once(db, monkeypatch, share):
    """Warmups on two threads at once: the engine's lock serializes them,
    and the table store's lock keeps two engines from building one block
    twice."""
    built = []
    real = pse.Tables._build

    def build(self, blk, codes=()):
        built.append(blk.kpad)
        return real(self, blk, codes)

    monkeypatch.setattr(pse.Tables, "_build", build)
    a = pse.ScanEngine(db, device="cpu")
    b = a if share == "one engine" else pse.ScanEngine(
        db, pse.ScanParams(algo="forward"), tables=a.tables)
    errors = []

    def warm(engine):
        try:
            engine.warmup(4, 30)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=warm, args=(e,)) for e in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(built) == sorted(blk.kpad for blk in a.blocks)


def test_mesh_warmup_runs_once_per_tile(db, spy_scores):
    mesh = make_scan_mesh(profile_axis=2, seq_axis=2, devices=["cpu"] * 4)
    engine = pse.ScanEngine(db, mesh=mesh)
    engine.warmup(6, 20)
    tiles = [t for blk in engine.blocks for t in blk.tiles]
    assert len(tiles) > len(engine.blocks)
    assert len(spy_scores) == len(tiles)
    # each read shard gets half of the dummy reads, every one 1 nt long
    assert all(shape == (3, 20, 5) and slen == [1] * 3
               for _, shape, _, slen in spy_scores)
    reads = _reads(db)
    got = engine.scan(_recs(reads))
    want = pse.ScanEngine(db, device="cpu").scan(_recs(reads))
    assert [(h.seq_id, h.profile_idx, h.match) for h in got] == [
        (h.seq_id, h.profile_idx, h.match) for h in want]


@pytest.fixture
def spy_warmup(monkeypatch):
    """Every ScanEngine.warmup call's (thread name, nseqs, max_len)."""
    calls = []
    real = pse.ScanEngine.warmup

    def warmup(self, nseqs, max_len):
        calls.append((threading.current_thread().name, nseqs, max_len))
        return real(self, nseqs, max_len)

    monkeypatch.setattr(pse.ScanEngine, "warmup", warmup)
    return calls


@pytest.mark.parametrize("best_hit", [False, True])
def test_cli_warms_once_on_the_first_batch(db, tmp_path, spy_warmup,
                                           best_hit):
    reads = _reads(db)
    fasta = tmp_path / "reads.fa"
    fasta.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    out = tmp_path / "out.tsv"
    flags = ["--best-hit"] if best_hit else []
    assert torch_main(["scan", db.path, str(fasta), "-o", str(out),
                       "--device", "cpu", "--batch-size", "3", *flags]) == 0
    assert [c[1:] for c in spy_warmup] == [(3, max(map(len, reads[:3])))]
    assert db.profile(1).accession in out.read_text()


@pytest.fixture
def daemon(db, tmp_path, monkeypatch):
    """(fake scheduler, CPU worker) with a pressed DB of the fixture's
    profiles, and DCP_SCAN_BATCH=4."""
    monkeypatch.setenv("DCP_SCAN_BATCH", "4")
    monkeypatch.setenv("DCP_PRESS_PREWARM", "0")
    fake = fake_sched.FakeScheduler(spool_dir=str(tmp_path / "spool"))
    url = fake.serve()
    cfg = ServerConfig(cache_dir=str(tmp_path / "cache"), api_url=url,
                       single_run=True)
    worker = Server(cfg, SchedAPI(url), device="cpu")
    with open(db.path.replace(".dtp", ".hmm"), "rb") as fp:
        fake.add_hmm("synth.hmm", fp.read())
    assert worker.run_one()
    yield fake, worker, next(iter(fake.dbs.values()))
    fake.shutdown()


def test_daemon_warms_during_the_spool(db, daemon, monkeypatch, spy_warmup):
    """The first warmup starts on its own thread while the reads are
    still spooling, with a full batch at the first read's length; it is
    joined before the scan, which a top-up at the job's shapes precedes."""
    fake, worker, db_meta = daemon
    reads = _reads(db)[:3]
    events = []
    started = threading.Event()
    real_iter = worker.api.iter_scan_seqs

    def iter_scan_seqs(scan_id):
        for i, s in enumerate(real_iter(scan_id)):
            yield s
            if i == 0:  # the spool waits for the warmup to start
                assert started.wait(timeout=60)
        events.append("spool done")

    real_warmup = pse.ScanEngine.warmup

    def warmup(self, nseqs, max_len):
        events.append(("warmup", threading.current_thread().name))
        started.set()
        spent = real_warmup(self, nseqs, max_len)
        events.append("warmup done")
        return spent

    real_scan = pse.ScanEngine.scan

    def scan(self, seqs):
        events.append("scan")
        return real_scan(self, seqs)

    monkeypatch.setattr(worker.api, "iter_scan_seqs", iter_scan_seqs)
    monkeypatch.setattr(pse.ScanEngine, "warmup", warmup)
    monkeypatch.setattr(pse.ScanEngine, "scan", scan)
    scan_ = fake.add_scan(db_meta.id,
                          [(f"r{i}", r) for i, r in enumerate(reads)])
    assert worker.run_one()
    assert fake.jobs[scan_.job_id].state == "done", fake.jobs[
        scan_.job_id].error
    assert [c[1:] for c in spy_warmup] == [
        (4, len(reads[0])), (3, max(map(len, reads)))]
    spool_thread = spy_warmup[0][0]
    assert spool_thread.startswith("scan-warmup")
    assert spy_warmup[1][0] == threading.current_thread().name
    assert events[0] == ("warmup", spool_thread)
    assert events.index("spool done") > 0
    # both warmups end before the first scan
    first_scan = events.index("scan")
    assert events[:first_scan].count("warmup done") == 2
    assert db.profile(1).accession in fake.products[-1]


def test_daemon_fails_the_job_when_the_warmup_fails(db, daemon, monkeypatch):
    fake, worker, db_meta = daemon
    scanned = []

    def warmup(self, nseqs, max_len):
        raise RuntimeError("warmup exploded")

    monkeypatch.setattr(pse.ScanEngine, "warmup", warmup)
    monkeypatch.setattr(pse.ScanEngine, "scan",
                        lambda self, seqs: scanned.append(seqs) or [])
    scan = fake.add_scan(db_meta.id, [("r0", _reads(db)[0])])
    assert worker.run_one()
    job = fake.jobs[scan.job_id]
    assert job.state == "fail" and "warmup exploded" in job.error
    assert scanned == [] and fake.products == []
