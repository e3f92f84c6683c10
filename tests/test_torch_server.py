"""The port's daemon through a fake scheduler over real HTTP, on the CPU.

The nine lifecycle cases of tests/test_server.py, run by the port's
``Server(device="cpu")`` against the port's ``FakeScheduler`` and against
the JAX package's (the wire format is the same), and the products of a
press -> scan -> best-hit run held against the JAX daemon's: rows equal
apart from the logliks, which agree within 1e-4
(tests/test_scan_engine.py:112).
"""

import io

import numpy as np
import pytest
import torch

from deciphon_tpu.server import fake_sched as jax_fake_sched
from deciphon_tpu_torch.db.format import TensorDB
from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
from deciphon_tpu_torch.server import fake_sched as port_fake_sched
from deciphon_tpu_torch.server.api import SchedAPI
from deciphon_tpu_torch.server.daemon import Server
from deciphon_tpu_torch.server.prod import HEADER
from deciphon_tpu_torch.server.sched import JobType
from deciphon_tpu_torch.utils.config import ServerConfig
from deciphon_tpu_torch.utils.progress import Progress
from deciphon_tpu_torch.utils.rc import EndOfData


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core oversubscribes the
    cores many times over (these tensors are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAKES = {"port": port_fake_sched, "jax": jax_fake_sched}


def consensus_dna(prof):
    return "".join(
        STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
        for b in map(int, np.argmax(prof.match_codonp, axis=1))
    )


@pytest.fixture(params=sorted(FAKES))
def sched(request, tmp_path):
    fake = FAKES[request.param].FakeScheduler(
        spool_dir=str(tmp_path / "spool")
    )
    url = fake.serve()
    yield fake, url
    fake.shutdown()


@pytest.fixture()
def worker(sched, tmp_path):
    fake, url = sched
    cfg = ServerConfig(
        cache_dir=str(tmp_path / "cache"), api_url=url, single_run=True
    )
    return Server(cfg, SchedAPI(url), device="cpu")


def _hmm_bytes():
    buf = io.StringIO()
    write_h3(buf, [random_h3(s, k, peak=0.9) for s, k in [(1, 4), (2, 7)]])
    return buf.getvalue().encode()


def _pressed(fake, worker):
    fake.add_hmm("synth.hmm", _hmm_bytes())
    assert worker.run_one()  # press
    db_meta = next(iter(fake.dbs.values()))
    return db_meta, TensorDB.load(fake.files[db_meta.filename])


def test_progress_meter():
    fired = []
    p = Progress(1000, callback=fired.append)
    p.consume(5)  # below one meter unit: no callback
    assert fired == []
    p.consume(5)  # 10/1000 -> 1%
    assert fired == [1]
    p.consume(490)
    assert sum(fired) == 50
    p.finish()
    assert sum(fired) == 100


def test_api_reachable_and_wipe(sched):
    fake, url = sched
    api = SchedAPI(url)
    assert api.is_reachable()
    fake.add_hmm("x.hmm", b"data")
    api.wipe()
    assert fake.jobs == {}
    assert not SchedAPI("http://127.0.0.1:1").is_reachable()


def test_idle_queue_raises_end(sched):
    _, url = sched
    with pytest.raises(EndOfData):
        SchedAPI(url).next_pend_job()


def test_press_job_lifecycle(sched, worker):
    fake, _ = sched
    hmm = fake.add_hmm("synth.hmm", _hmm_bytes())
    assert worker.api.next_pend_job().type == JobType.HMM
    assert worker.run_one()
    job = fake.jobs[hmm.job_id]
    assert job.state == "done", job.error
    assert job.progress == 100
    # a .dtp db was uploaded back, and its tables were prewarmed into
    # the store the first scan of it uses
    assert len(fake.dbs) == 1
    db_meta = next(iter(fake.dbs.values()))
    assert db_meta.filename.endswith(".dtp")
    assert TensorDB.load(fake.files[db_meta.filename]).nprofiles == 2
    worker._join_prewarm()
    (tables,) = worker._tables.values()
    assert all(b.tiles is not None for b in tables.blocks)


def test_press_prewarm_switch_off(sched, worker, monkeypatch):
    """DCP_PRESS_PREWARM=0 (the JAX daemon's switch): the press job
    builds no table store and starts no thread; the first scan builds
    the tables itself, in its warmups (the one during the spool builds
    them, the top-up after it finds them built)."""
    import threading

    from deciphon_tpu_torch.ops.scan_engine import Tables

    fake, _ = sched
    prepared, started = [], []
    orig_prepare, orig_start = Tables.prepare, threading.Thread.start

    def prepare(self):
        prepared.append(self)
        return orig_prepare(self)

    def start(self):
        started.append(self.name)
        return orig_start(self)

    monkeypatch.setattr(Tables, "prepare", prepare)
    monkeypatch.setattr(threading.Thread, "start", start)
    monkeypatch.setenv("DCP_PRESS_PREWARM", "0")
    db_meta, db = _pressed(fake, worker)
    assert [j.state for j in fake.jobs.values()] == ["done"]
    assert prepared == [] and "press-prewarm" not in started
    assert worker._prewarm_thread is None and worker._tables == {}
    scan = fake.add_scan(db_meta.id, [("planted", consensus_dna(db.profile(1)))])
    assert worker.run_one()
    assert fake.jobs[scan.job_id].state == "done"
    assert len(prepared) == 2 and "press-prewarm" not in started
    assert all(b.tiles is not None for b in prepared[0].blocks)
    assert db.profile(1).accession in fake.products[-1]


def test_full_press_then_scan_lifecycle(sched, worker):
    fake, _ = sched
    db_meta, db = _pressed(fake, worker)
    prof = db.profile(1)
    scan = fake.add_scan(
        db_meta.id,
        [("planted", consensus_dna(prof)), ("noise", "ACGTACGTACGTACGTACGT")],
    )
    assert worker.run_one()  # scan
    job = fake.jobs[scan.job_id]
    assert job.state == "done", job.error
    assert job.progress == 100
    assert len(fake.products) == 1
    lines = fake.products[0].splitlines()
    assert lines[0] + "\n" == HEADER
    assert len(lines) >= 2
    hit_cols = lines[1].split("\t")
    assert hit_cols[0] == str(scan.id)
    assert hit_cols[2] == prof.accession
    assert not worker.run_one()  # queue drained


def test_scan_job_failure_reported(sched, worker):
    fake, _ = sched
    db_meta = fake.add_db("bad.dtp", b"not a database")
    scan = fake.add_scan(db_meta.id, [("s", "ACGT")])
    assert worker.run_one()
    job = fake.jobs[scan.job_id]
    assert job.state == "fail"
    assert job.error != ""


def test_scan_streams_in_bounded_batches(sched, worker, monkeypatch):
    """DCP_SCAN_BATCH=4 and 11 reads: the engine sees 3 calls, hits from
    the first and the last batch reach one products file."""
    fake, _ = sched
    db_meta, db = _pressed(fake, worker)
    read = consensus_dna(db.profile(1))
    seqs = [("noise%d" % i, "ACGTACGTACGTACGTACGT") for i in range(9)]
    seqs.insert(0, ("planted0", read))
    seqs.append(("planted1", read))
    scan = fake.add_scan(db_meta.id, seqs)
    monkeypatch.setenv("DCP_SCAN_BATCH", "4")
    calls = []
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine

    orig = ScanEngine.scan

    def spy(self, batch):
        calls.append(len(batch))
        return orig(self, batch)

    monkeypatch.setattr(ScanEngine, "scan", spy)
    assert worker.run_one()
    job = fake.jobs[scan.job_id]
    assert job.state == "done", job.error
    assert job.progress == 100
    assert calls == [4, 4, 3]
    rows = [ln.split("\t") for ln in fake.products[-1].splitlines()[1:]]
    assert len({int(r[1]) for r in rows}) >= 2


def test_scan_progress_is_per_block(sched, worker, monkeypatch):
    """Two blocks (cores 300 and 5) and one batch: at least two progress
    PATCHes, one per block as its results come back."""
    fake, _ = sched
    buf = io.StringIO()
    write_h3(
        buf,
        [random_h3(i + 1, 300 if i < 3 else 5, peak=0.9) for i in range(20)],
    )
    fake.add_hmm("two.hmm", buf.getvalue().encode())
    assert worker.run_one()  # press
    db_meta = next(iter(fake.dbs.values()))
    scan = fake.add_scan(
        db_meta.id, [("s%d" % i, "ACGTACGTACGTACGTACGT") for i in range(8)]
    )
    patches = []
    orig = SchedAPI.increment_job_progress

    def spy(self, job_id, inc):
        patches.append(inc)
        return orig(self, job_id, inc)

    monkeypatch.setattr(SchedAPI, "increment_job_progress", spy)
    assert worker.run_one()
    job = fake.jobs[scan.job_id]
    assert job.state == "done", job.error
    assert job.progress == 100
    assert len(patches) >= 2
    assert sum(patches) == 100


def test_scan_best_hit_mode(sched, worker, monkeypatch):
    """DCP_BEST_HIT=1: one product row per LRT-passing read, match
    column empty."""
    fake, _ = sched
    db_meta, db = _pressed(fake, worker)
    read = consensus_dna(db.profile(1))
    scan = fake.add_scan(
        db_meta.id,
        [("planted", read), ("noise", "ACGTACGTACGTACGTACGT"),
         ("planted2", read)],
    )
    monkeypatch.setenv("DCP_BEST_HIT", "1")
    assert worker.run_one()
    job = fake.jobs[scan.job_id]
    assert job.state == "done", job.error
    rows = [ln.split("\t") for ln in fake.products[-1].splitlines()[1:]]
    assert len(rows) == 2
    assert all(r[2] == db.profile(1).accession for r in rows)
    assert all(r[-1] == "" for r in rows)


def _lifecycle(fake, worker, monkeypatch):
    """Press, then a scan and a best-hit scan of the same reads: the
    uploaded .dtp bytes and both products files."""
    db_meta, db = _pressed(fake, worker)
    reads = [
        ("planted1", consensus_dna(db.profile(1))),
        ("noise", "ACGTACGTACGTACGTACGTAC"),
        ("planted0_n", "N" + consensus_dna(db.profile(0))[1:]),
    ]
    fake.add_scan(db_meta.id, reads)
    assert worker.run_one()
    monkeypatch.setenv("DCP_BEST_HIT", "1")
    fake.add_scan(db_meta.id, reads)
    assert worker.run_one()
    monkeypatch.delenv("DCP_BEST_HIT")
    assert all(j.state == "done" for j in fake.jobs.values())
    with open(fake.files[db_meta.filename], "rb") as fp:
        return fp.read(), list(fake.products)


def test_products_match_jax_daemon(tmp_path, monkeypatch):
    from deciphon_tpu.server.api import SchedAPI as JaxSchedAPI
    from deciphon_tpu.server.daemon import Server as JaxServer
    from deciphon_tpu.utils.config import ServerConfig as JaxServerConfig

    out = {}
    for name, fakes, server in (
        ("port", port_fake_sched,
         lambda cfg, url: Server(cfg, SchedAPI(url), device="cpu")),
        ("jax", jax_fake_sched,
         lambda cfg, url: JaxServer(
             JaxServerConfig(**vars(cfg)), JaxSchedAPI(url))),
    ):
        fake = fakes.FakeScheduler(spool_dir=str(tmp_path / name / "spool"))
        url = fake.serve()
        try:
            cfg = ServerConfig(cache_dir=str(tmp_path / name / "cache"),
                               api_url=url, single_run=True)
            out[name] = _lifecycle(fake, server(cfg, url), monkeypatch)
        finally:
            fake.shutdown()
    (port_dtp, port_prods), (jax_dtp, jax_prods) = out["port"], out["jax"]
    assert port_dtp == jax_dtp
    assert len(port_prods) == len(jax_prods) == 2
    for got, want in zip(port_prods, jax_prods):
        have = [ln.split("\t") for ln in got.splitlines()]
        ref = [ln.split("\t") for ln in want.splitlines()]
        assert len(have) == len(ref) >= 2  # header + the planted read
        for g, w in zip(have[1:], ref[1:]):
            assert g[:4] + g[6:] == w[:4] + w[6:]
            for col in (4, 5):
                assert float(g[col]) == pytest.approx(float(w[col]),
                                                      abs=1e-4)
