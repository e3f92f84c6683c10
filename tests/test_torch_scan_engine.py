"""The port's ScanEngine (device="cpu") vs the JAX ScanEngine (CPU).

Same (read, profile) hits, logliks within 1e-4 for Viterbi
(tests/test_scan_engine.py:112) and 2e-3 for forward
(tests/test_forward.py:104), identical paths and match strings, on the
synth DB of tests/test_scan_engine.py:33-44, for ACGT reads and reads
holding IUPAC codes; plus the planted hits, the threshold filter, the
freeing of extended tables and the errors of bad inputs.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.db.format import TensorDB as JaxTensorDB
from deciphon_tpu.ops import scan_engine as jse
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu_torch.db.format import TensorDB, write_db
from deciphon_tpu_torch.models.alphabet import (
    DNA, STANDARD_CODE, encode_extended,
)
from deciphon_tpu_torch.models.h3reader import press_file
from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
from deciphon_tpu_torch.ops import scan_engine as pse
from deciphon_tpu_torch.ops import viterbi_cuda as vc


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
    tmp = tmp_path_factory.mktemp("torch_scan")
    hmm = tmp / "synth.hmm"
    with open(hmm, "w") as fp:
        write_h3(
            fp,
            [random_h3(s, k, peak=0.9) for s, k in [(1, 4), (2, 6), (3, 9)]],
        )
    dbp = str(tmp / "synth.dtp")
    write_db(dbp, press_file(str(hmm)))
    return TensorDB.load(dbp)


@pytest.fixture(scope="module")
def jdb(db):
    """The same file through the JAX package, for the reference side."""
    return JaxTensorDB.load(db.path)


def _reads(db):
    return [
        consensus_dna(db.profile(2)),
        "ACGTACGTACGTACGTACGTACGT",
        consensus_dna(db.profile(0)),
        "ACG",
        "T",
    ]


def _iupac_reads(db):
    """N reads, a partial code, mixed codes in one read and ACGT reads
    in one batch (tests/test_scan_engine.py:129-300 patterns)."""
    read = consensus_dna(db.profile(2))
    code = {"A": "R", "G": "R", "C": "Y", "T": "Y"}[read[6]]
    return [
        read[:6] + "N" + read[7:12] + "N" + read[13:],
        read[:6] + code + read[7:],
        read[:3] + "N" + read[4:9] + "R" + read[10:],
        read,
        "NACGTACGTNACGTAC",
        consensus_dna(db.profile(0))[:-1] + "N",
        "ACGTTGCA",
    ]


def _both(db, reads, **params):
    ref = jse.ScanEngine(
        JaxTensorDB.load(db.path), jse.ScanParams(**params)
    ).scan(
        [jse.SeqRecord(i + 1, f"r{i}", r) for i, r in enumerate(reads)]
    )
    got = pse.ScanEngine(db, pse.ScanParams(**params), device="cpu").scan(
        [pse.SeqRecord(i + 1, f"r{i}", r) for i, r in enumerate(reads)]
    )
    return got, ref


@pytest.mark.parametrize("params", [
    dict(lrt_threshold=10.0),
    dict(lrt_threshold=-1e9),
    dict(lrt_threshold=-1e9, multi_hits=False, hmmer3_compat=True),
])
def test_hits_match_jax_engine(db, params):
    got, ref = _both(db, _reads(db), **params)
    assert [(h.seq_id, h.profile_idx) for h in got] == [
        (h.seq_id, h.profile_idx) for h in ref
    ]
    if params["lrt_threshold"] < 0:  # every pair passes
        assert len(got) == 5 * db.nprofiles
    for a, b in zip(got, ref):
        assert a.alt_loglik == pytest.approx(b.alt_loglik, abs=1e-4)
        assert a.null_loglik == pytest.approx(b.null_loglik, abs=1e-4)
        assert a.lrt == pytest.approx(b.lrt, abs=2e-4)
        assert a.path == b.path
        assert a.match == b.match
        assert a.accession == b.accession


def test_planted_hit_matches_oracle(db, jdb):
    target = db.profile(2)
    read = consensus_dna(target)
    eng = pse.ScanEngine(db, pse.ScanParams(lrt_threshold=10.0),
                         device="cpu")
    hits = eng.scan([pse.SeqRecord(1, "planted", read),
                     pse.SeqRecord(2, "random", "ACGTACGTACGTACGTACGTACGT")])
    h = next(h for h in hits if h.seq_id == 1 and h.profile_idx == 2)
    ora = vr.viterbi_alt(jdb.profile(2), DNA.encode(read))
    orn = vr.viterbi_null(jdb.profile(2), DNA.encode(read))
    assert h.alt_loglik == pytest.approx(ora.loglik, abs=2e-3)
    assert h.null_loglik == pytest.approx(orn.loglik, abs=2e-3)
    assert sum(l for _, l in h.path) == len(read)
    assert "".join(c.split(",")[0] for c in h.match.split(";")) == read
    # pass-1 scores are kept, rows in input order, columns in DB order
    alt, null = eng.last_scores
    assert alt.shape == (2, db.nprofiles)
    assert alt[0, 2] == h.alt_loglik


def test_threshold_filters(db):
    read = consensus_dna(db.profile(2))
    eng = pse.ScanEngine(db, pse.ScanParams(lrt_threshold=1e9),
                         device="cpu")
    assert eng.scan([pse.SeqRecord(1, "r", read)]) == []
    assert eng.scan([]) == []


def test_rejects_non_iupac(db):
    eng = pse.ScanEngine(db, device="cpu")
    with pytest.raises(ValueError):
        eng.scan([pse.SeqRecord(1, "r", "ACGTZ")])


def _assert_same_hits(got, ref, tol):
    assert [(h.seq_id, h.profile_idx) for h in got] == [
        (h.seq_id, h.profile_idx) for h in ref
    ]
    for a, b in zip(got, ref):
        assert a.alt_loglik == pytest.approx(b.alt_loglik, abs=tol)
        assert a.null_loglik == pytest.approx(b.null_loglik, abs=tol)
        assert a.lrt == pytest.approx(b.lrt, abs=2 * tol)
        assert a.path == b.path
        assert a.match == b.match


@pytest.mark.parametrize("threshold", [10.0, -1e9])
def test_forward_hits_match_jax_engine(db, jdb, threshold):
    """algo="forward": forward logliks, Viterbi paths and matches."""
    reads = _reads(db)
    got, ref = _both(db, reads, lrt_threshold=threshold, algo="forward")
    _assert_same_hits(got, ref, 2e-3)
    if threshold < 0:
        assert len(got) == len(reads) * db.nprofiles
        for h in got:  # forward mass >= the best path
            best = vr.viterbi_alt(jdb.profile(h.profile_idx),
                                  DNA.encode(reads[h.seq_idx]))
            assert h.alt_loglik >= best.loglik - 1e-3
    else:
        assert (1, 2) in {(h.seq_id, h.profile_idx) for h in got}


@pytest.mark.parametrize("algo,tol", [("viterbi", 1e-4), ("forward", 2e-3)])
def test_iupac_hits_match_jax_engine(db, algo, tol):
    """Every (read, profile) pair of a batch mixing N reads, a partial
    code, two codes in one read and ACGT reads."""
    reads = _iupac_reads(db)
    got, ref = _both(db, reads, lrt_threshold=-1e9, algo=algo)
    assert len(got) == len(reads) * db.nprofiles
    _assert_same_hits(got, ref, tol)


def test_planted_n_read_hits(db, jdb):
    """N planted into a consensus read still hits its profile, scores as
    the base-5 oracle and below the concrete read
    (tests/test_scan_engine.py:129)."""
    from deciphon_tpu_torch.models.alphabet import encode_iupac

    target = db.profile(2)
    read = consensus_dna(target)
    noisy = read[:6] + "N" + read[7:12] + "N" + read[13:]
    hits = pse.ScanEngine(db, device="cpu").scan(
        [pse.SeqRecord(1, "n", noisy), pse.SeqRecord(2, "c", read)]
    )
    h = {h.seq_id: h for h in hits if h.profile_idx == 2}
    assert set(h) == {1, 2}
    enc = encode_iupac(noisy)
    ora = vr.viterbi_alt(jdb.profile(2), enc, base=5)
    assert h[1].alt_loglik == pytest.approx(ora.loglik, abs=1e-3)
    assert h[1].null_loglik == pytest.approx(
        vr.viterbi_null(jdb.profile(2), enc, base=5).loglik, abs=1e-3)
    assert h[1].path == ora.path
    assert h[1].lrt < h[2].lrt


def test_last_scores_cover_classes_in_input_order(db):
    """Reads of three classes scanned together give the pass-1 rows of
    each read scanned alone, in input order."""
    reads = _iupac_reads(db)
    # no survivors: pass 1 only
    eng = pse.ScanEngine(db, pse.ScanParams(lrt_threshold=1e9),
                         device="cpu")
    eng.scan([pse.SeqRecord(i, f"r{i}", r) for i, r in enumerate(reads)])
    alt, null = eng.last_scores
    assert alt.shape == (len(reads), db.nprofiles)
    for i, r in enumerate(reads):
        eng.scan([pse.SeqRecord(0, "one", r)])
        one_alt, one_null = eng.last_scores
        np.testing.assert_allclose(alt[i], one_alt[0], atol=1e-6)
        np.testing.assert_allclose(null[i], one_null[0], atol=1e-6)


def test_extended_blocks_freed_after_scan(db, monkeypatch):
    """Each extended block is built for one launch and is gone once the
    scan returns; the base-4 blocks stay."""
    import gc
    import weakref

    built = []
    orig = vc.CudaBlock.from_profiles.__func__

    def spy(cls, profiles, kpad=None, device="cuda", codes=()):
        blk = orig(cls, profiles, kpad, device, codes)
        if codes:
            built.append((codes, weakref.ref(blk.fm)))
        return blk

    monkeypatch.setattr(vc.CudaBlock, "from_profiles", classmethod(spy))
    reads = _iupac_reads(db)
    classes = {encode_extended(r)[1] for r in reads} - {()}
    eng = pse.ScanEngine(db, pse.ScanParams(lrt_threshold=1e9),
                         device="cpu")
    eng.scan([pse.SeqRecord(i, f"r{i}", r) for i, r in enumerate(reads)])
    gc.collect()
    assert len(classes) == 3
    assert {c for c, _ in built} == classes
    assert len(built) == len(classes) * len(eng.blocks)
    assert all(ref() is None for _, ref in built)
    assert all(b.tiles is not None for b in eng.blocks)


def test_unknown_algo_raises(db):
    with pytest.raises(ValueError, match="algo"):
        pse.ScanEngine(db, pse.ScanParams(algo="posterior"), device="cpu")


def test_blocks_cover_db_once(db):
    eng = pse.ScanEngine(db, device="cpu")
    idx = np.concatenate([b.chunk for b in eng.blocks])
    assert sorted(idx.tolist()) == list(range(db.nprofiles))
    for b in eng.blocks:
        assert b.kpad % vc.LANE == 0
        assert b.kpad >= int(db.core_sizes[b.chunk].max())
