"""The port's ScanEngine (device="cpu") vs the JAX ScanEngine (CPU).

Same (read, profile) hits, logliks within 1e-4 (tests/test_scan_engine.py
:112), identical paths and match strings, on the synth DB of
tests/test_scan_engine.py:33-44; plus the planted hit, the threshold
filter and the errors of the inputs this slice does not take.
"""

import numpy as np
import pytest

from deciphon_tpu.db.format import TensorDB, write_db
from deciphon_tpu.models.alphabet import DNA, STANDARD_CODE
from deciphon_tpu.models.h3reader import press_file
from deciphon_tpu.models.h3writer import random_h3, write_h3
from deciphon_tpu.ops import scan_engine as jse
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu_torch.ops import scan_engine as pse
from deciphon_tpu_torch.ops import viterbi_cuda as vc


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


def _reads(db):
    return [
        consensus_dna(db.profile(2)),
        "ACGTACGTACGTACGTACGTACGT",
        consensus_dna(db.profile(0)),
        "ACG",
        "T",
    ]


def _both(db, reads, **params):
    ref = jse.ScanEngine(db, jse.ScanParams(**params)).scan(
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


def test_planted_hit_matches_oracle(db):
    target = db.profile(2)
    read = consensus_dna(target)
    eng = pse.ScanEngine(db, pse.ScanParams(lrt_threshold=10.0),
                         device="cpu")
    hits = eng.scan([pse.SeqRecord(1, "planted", read),
                     pse.SeqRecord(2, "random", "ACGTACGTACGTACGTACGTACGT")])
    h = next(h for h in hits if h.seq_id == 1 and h.profile_idx == 2)
    ora = vr.viterbi_alt(target, DNA.encode(read))
    orn = vr.viterbi_null(target, DNA.encode(read))
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


def test_iupac_not_ported_yet(db):
    eng = pse.ScanEngine(db, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.scan([pse.SeqRecord(1, "r", "ACGTNACGT")])


def test_forward_not_ported_yet(db):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pse.ScanEngine(db, pse.ScanParams(algo="forward"), device="cpu")


def test_blocks_cover_db_once(db):
    eng = pse.ScanEngine(db, device="cpu")
    idx = np.concatenate([b.chunk for b in eng.blocks])
    assert sorted(idx.tolist()) == list(range(db.nprofiles))
    for b in eng.blocks:
        assert b.kpad % vc.LANE == 0
        assert b.kpad >= int(db.core_sizes[b.chunk].max())
