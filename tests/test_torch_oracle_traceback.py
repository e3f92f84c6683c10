"""The port's one-hit traceback and oracle pass 2 vs the JAX package's.

``viterbi_trace.viterbi_alt`` (the counterpart of
deciphon_tpu/ops/viterbi_trace.py:333-365) must give the JAX
``viterbi_alt``'s path and alt within 1e-4, for ACGT reads and reads
holding IUPAC codes, with a prebuilt (padded) block row or without.
``ScanEngine(traceback="oracle")`` (scan_engine.py:962-974) must give
the default's (read, profile) pairs, alt within 1e-4 of the JAX oracle
engine's and the same paths; the default's paths equal ``viterbi_alt``'s
(tests/test_scan_engine.py:302-331), and every path, of either mode,
scores its hit's alt in f64 within 1e-4, so where the default's and the
f64 oracle's paths differ (an f32-vs-f64 tie) both score the same.  The
pass-2 entry points run on the card unless given the CPU.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.db.format import TensorDB as JaxTensorDB
from deciphon_tpu.models.alphabet import encode_extended
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import scan_engine as jse
from deciphon_tpu.ops import viterbi_trace as jtr
from deciphon_tpu_torch.db.format import TensorDB, write_db
from deciphon_tpu_torch.models import state as st
from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
from deciphon_tpu_torch.models.h3reader import press_file
from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
from deciphon_tpu_torch.models.profile import sample_profile as psample
from deciphon_tpu_torch.models.profile import special_transitions
from deciphon_tpu_torch.ops import scan_engine as pse
from deciphon_tpu_torch.ops import viterbi_ref as pvr
from deciphon_tpu_torch.ops.emissions import fragment_indices
from deciphon_tpu_torch.ops import viterbi_trace as ptr
from deciphon_tpu_torch.ops.viterbi_torch import build_profile_block


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


def hits(codes: tuple):
    """(JAX profile, port profile, read) on the same seeds; reads hold
    ``codes`` at fixed positions."""
    rng = np.random.default_rng(7 + len(codes))
    out = []
    for trial in range(4):
        k = int(rng.integers(2, 9))
        read = list(rng.choice(list("ACGT"), int(rng.integers(6, 30))))
        for j, c in enumerate(codes):
            read[(3 * j + trial) % len(read)] = c
        out.append((sample_profile(trial + 21, k), psample(trial + 21, k),
                    "".join(read)))
    return out


@pytest.mark.parametrize("codes", [(), ("N",), ("N", "R")])
@pytest.mark.parametrize("mh,h3", [(True, False), (False, True)])
def test_viterbi_alt_matches_jax(codes, mh, h3):
    for jprof, pprof, read in hits(codes):
        enc, got_codes = encode_extended(read)
        assert got_codes == codes
        kw = dict(codes=codes) if codes else {}
        ref = jtr.viterbi_alt(jprof, enc, mh, h3, **kw)
        got = ptr.viterbi_alt(pprof, enc, mh, h3, device="cpu", **kw)
        assert got.path == ref.path
        assert got.loglik == pytest.approx(ref.loglik, abs=1e-4)


def test_viterbi_alt_block_row_pad_and_base5():
    """A prebuilt block row padded beyond the core, padded index rows and
    ``base=5`` (the N tables) change neither path nor alt."""
    for jprof, pprof, read in hits(("N",)):
        enc, _ = encode_extended(read)
        ref = jtr.viterbi_alt(jprof, enc, base=5)
        row = build_profile_block([pprof], kpad=pprof.core_size + 7,
                                  codes=("N",))
        for kw in (dict(base=5), dict(codes=("N",), block_row=row),
                   dict(base=5, pad_to=len(enc) + 9)):
            got = ptr.viterbi_alt(pprof, enc, device="cpu", **kw)
            assert got.path == ref.path
            assert got.loglik == pytest.approx(ref.loglik, abs=1e-4)
    with pytest.raises(ValueError, match="base"):
        ptr.viterbi_alt(pprof, enc, base=6, device="cpu")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_oracle")
    hmm = tmp / "synth.hmm"
    with open(hmm, "w") as fp:
        write_h3(fp, [random_h3(s, k, peak=0.9)
                      for s, k in [(1, 4), (2, 6), (3, 9)]])
    dbp = str(tmp / "synth.dtp")
    write_db(dbp, press_file(str(hmm)))
    return TensorDB.load(dbp)


def _reads(db):
    read = consensus_dna(db.profile(2))
    return [read, consensus_dna(db.profile(0)), "ACGTACGTACGTACGTACGT",
            read[:3] + "N" + read[4:], read[:3] + "N" + read[4:9] + "R"
            + read[10:]]


def path_score(prof, enc, path, multi_hits, hmmer3_compat, codes) -> float:
    """The f64 score of ``path``, [(state, fragment length)] from S to T
    over the read ``enc`` (holding ``codes``): the alt model's
    transitions (viterbi_ref's graph) and each emitting step's fragment
    entry, summed along the path."""
    xt = special_transitions(len(enc), multi_hits, hmmer3_compat)
    _, trans = pvr._build_graph(prof, xt)
    base = 4 + len(codes)
    fm, fi, fn = prof.fragment_tables(base=base, codes=codes or None)
    fidx = fragment_indices(enc, base=base)
    K = prof.core_size
    emit = {sid: fn for sid in (st.N, st.J, st.C)}
    emit.update({st.match_id(k): fm[k] for k in range(K)})
    emit.update({st.insert_id(k): fi for k in range(K)})
    score, pos = 0.0, 0
    assert path[0] == (st.S, 0) and path[-1] == (st.T, 0)
    for (a, _), (b, n) in zip(path, path[1:]):
        score += dict(trans[a])[b]
        if n:
            score += float(emit[b][fidx[pos, n - 1]])
            pos += n
    assert pos == len(enc)
    return score


# paths of the default pass 2 that differ from the f64 oracle's on this
# fixture (f32-vs-f64 ties), under either set of flags
TIES = 1


@pytest.mark.parametrize("params", [dict(lrt_threshold=-1e9),
                                    dict(lrt_threshold=-1e9,
                                         multi_hits=False,
                                         hmmer3_compat=True)])
def test_oracle_engine_matches_default_and_jax_oracle(db, params):
    reads = _reads(db)
    recs = [pse.SeqRecord(i + 1, f"r{i}", r) for i, r in enumerate(reads)]
    p = pse.ScanParams(**params)
    fast = pse.ScanEngine(db, p, device="cpu").scan(recs)
    slow = pse.ScanEngine(db, p, device="cpu", traceback="oracle").scan(recs)
    ref = jse.ScanEngine(
        JaxTensorDB.load(db.path), jse.ScanParams(**params),
        use_pallas=False, traceback="oracle",
    ).scan([jse.SeqRecord(i + 1, f"r{i}", r) for i, r in enumerate(reads)])
    assert len(fast) == len(slow) == len(ref) == len(reads) * db.nprofiles
    ties = 0
    for f, s, r in zip(fast, slow, ref):
        assert (f.seq_idx, f.profile_idx) == (s.seq_idx, s.profile_idx) == (
            r.seq_idx, r.profile_idx)
        assert s.alt_loglik == pytest.approx(r.alt_loglik, abs=1e-4)
        assert s.path == r.path and s.match == r.match
        prof = db.profile(f.profile_idx)
        enc, codes = encode_extended(reads[f.seq_idx])
        one = ptr.viterbi_alt(prof, enc, p.multi_hits, p.hmmer3_compat,
                              codes=codes, device="cpu")
        assert f.path == one.path
        for path in (f.path, s.path):
            assert path_score(prof, enc, path, p.multi_hits,
                              p.hmmer3_compat, codes) == pytest.approx(
                f.alt_loglik, abs=1e-4)
        ties += f.path != s.path
    assert ties == TIES


def test_unknown_traceback_raises(db):
    with pytest.raises(ValueError, match="traceback"):
        pse.ScanEngine(db, device="cpu", traceback="jax")


def test_pass2_entry_points_default_to_the_card(monkeypatch):
    """Without a device argument, the traceback runs on the card: on a
    machine without one it raises before anything is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(ptr, "build_profile_block",
                        lambda *a, **k: built.append(1))
    _, pprof, read = hits(())[0]
    enc, _ = encode_extended(read)
    for call in (lambda: ptr.viterbi_alt(pprof, enc),
                 lambda: ptr.viterbi_alt_batch([pprof], [enc]),
                 lambda: ptr.trace_scan([([pprof], [enc], None, ())])):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert built == []
