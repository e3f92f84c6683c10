"""The batched codec (models/codec.decode_steps, render_matches) against
the per-step one (frame.decode_codon, match_steps), on the CPU.

The batched decoder does decode_codon's float operations in its order,
so every codon, ties included, and every match string must come out
identical; a scan counts the steps it decoded as ``codec_steps``.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu_torch.db.format import TensorDB, write_db
from deciphon_tpu_torch.models import codec, frame
from deciphon_tpu_torch.models import state as st
from deciphon_tpu_torch.models.alphabet import STANDARD_CODE, encode_extended
from deciphon_tpu_torch.models.h3reader import build_profile
from deciphon_tpu_torch.models.h3writer import random_h3
from deciphon_tpu_torch.ops import viterbi_trace as ptr
from deciphon_tpu_torch.ops.scan_engine import ScanEngine, SeqRecord
from deciphon_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core oversubscribes the
    cores many times over (these tensors are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CODE_SETS = {"acgt": (), "n": ("N",), "n_r": ("N", "R"), "b_y": ("B", "Y")}


def steps(length, code_sets, n, seed, ties=False):
    """n random steps of fragments of ``length``, each step's codes drawn
    from ``code_sets`` in turn; under ``ties`` uniform codon and
    background distributions, so that only the first-index rule picks."""
    rng = np.random.default_rng(seed)
    frags, cps, qs, eps, codes = [], [], [], [], []
    for i in range(n):
        cs = code_sets[i % len(code_sets)]
        frags.append(rng.integers(0, 4 + len(cs), length).astype(np.int8))
        if ties:
            cp, q = np.full(64, np.log(1 / 64)), np.full(4, np.log(0.25))
        else:
            cp = np.log(rng.dirichlet(np.full(64, 0.5)))
            q = np.log(rng.dirichlet(np.ones(4)))
        cps.append(cp)
        qs.append(np.append(q, 0.0))  # q5_pad's log 1 sentinel
        eps.append((0.01, 0.05)[i % 2])
        codes.append(cs)
    return frags, np.stack(cps), np.stack(qs), np.asarray(eps), codes


@pytest.mark.parametrize("length", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", ["acgt", "n", "n_r", "mixed", "ties"])
def test_decode_steps_equals_decode_codon(length, case):
    """(a) Every step's codon equals frame.decode_codon's, for symbols of
    base 4, 5 (N), 6 (N and R), steps of several code sets in one batch,
    and a tie-heavy batch where only the first index decides."""
    code_sets = (list(CODE_SETS.values()) if case in ("mixed", "ties")
                 else [CODE_SETS[case]])
    frags, cps, qs, eps, codes = steps(length, code_sets, 64,
                                       seed=length * 10 + len(case),
                                       ties=case == "ties")
    got = codec.decode_steps(frags, cps, qs, eps, codes)
    want = [frame.decode_codon(f, c, q, e, cs)
            for f, c, q, e, cs in zip(frags, cps, qs, eps, codes)]
    assert got.tolist() == [16 * a + 4 * b + c for a, b, c in want]
    if case == "ties":  # many steps have a tied maximum
        posts = [c + frame.loglik_given_codon(f, q, e, cs)
                 for f, c, q, e, cs in zip(frags, cps, qs, eps, codes)]
        assert sum((p == p.max()).sum() > 1 for p in posts) >= 8


def test_decode_steps_of_no_step():
    got = codec.decode_steps([], np.zeros((0, 64)), np.zeros((0, 5)),
                             np.zeros(0), [])
    assert got.shape == (0,)


def consensus(prof):
    return "".join(STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
                   for b in map(int, np.argmax(prof.match_codonp, 1)))


def reads_of(profs, codes, seed):
    """A homolog of each profile: its consensus with one nucleotide
    dropped and one added (fragments of 2 and 4), in random flanks, with
    each of ``codes`` placed in the flank and inside the homolog."""
    rng = np.random.default_rng(seed)
    out = []
    for prof in profs:
        core = list(consensus(prof))
        del core[len(core) // 3]
        core.insert(2 * len(core) // 3, "A")
        left = list(rng.choice(list("ACGT"), int(rng.integers(3, 12))))
        right = list(rng.choice(list("ACGT"), int(rng.integers(3, 12))))
        r = left + core + right
        for j, c in enumerate(codes):
            r[j] = c
            r[len(left) + 4 + 3 * j] = c
        out.append("".join(r))
    return out


def emitting(path):
    return sum(1 for s, n in path if n > 0 and not st.is_mute(s))


@pytest.mark.parametrize("case", ["acgt", "n", "n_r"])
def test_render_matches_equals_match_steps(case):
    """(b) Paths of the port's CPU traceback through random profiles,
    mute steps included: render_matches gives render_match(match_steps())
    of each hit, character for character."""
    codes = CODE_SETS[case]
    profs = [build_profile(random_h3(s, k, peak=0.9))
             for s, k in [(1, 6), (2, 11), (3, 17), (4, 8)]]
    reads = reads_of(profs, codes, seed=len(case))
    encs = []
    for r in reads:
        enc, got = encode_extended(r)
        assert got == codes
        encs.append(enc)
    res = ptr.viterbi_alt_batch(profs, encs, device="cpu",
                                codes=codes or None)
    paths = [r.path for r in res]
    assert all(any(st.is_mute(s) for s, _ in p) for p in paths)
    lens = {n for p in paths for s, n in p if not st.is_mute(s)}
    assert {2, 3, 4} <= lens
    got, nsteps = codec.render_matches(list(zip(profs, reads, paths)))
    assert got == [codec.render_match(codec.match_steps(p, r, path))
                   for p, r, path in zip(profs, reads, paths)]
    assert nsteps == sum(map(emitting, paths))


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("codec") / "t.dtp")
    write_db(path, [build_profile(random_h3(s + 1, k, peak=0.9))
                    for s, k in enumerate((4, 7, 5, 9))])
    return ScanEngine(TensorDB.load(path), device="cpu")


@pytest.mark.parametrize("case", ["acgt", "n", "n_r", "none"])
def test_scan_match_strings_and_codec_steps(engine, case):
    """(b) The scan's match strings equal match_steps' on its paths, for
    reads with and without codes (several read classes in one scan); (c)
    its ``codec_steps`` counter is the number of emitting steps of its
    hits' paths, 0 in a scan with no hit."""
    db = engine.db
    profs = [db.profile(i) for i in range(db.nprofiles)]
    if case == "none":
        seqs = [SeqRecord(1, "r1", "ACGTTGCAACG")]
    else:
        reads = reads_of(profs, CODE_SETS[case], seed=7)
        reads += reads_of(profs[1:3], (), seed=8)
        seqs = [SeqRecord(j + 1, f"r{j}", r) for j, r in enumerate(reads)]
    with trace.recording():
        hits = engine.scan(seqs)
    counts = engine.last_counts
    assert bool(hits) == (case != "none")
    for h in hits:
        prof = db.profile(h.profile_idx)
        assert h.match == codec.render_match(
            codec.match_steps(prof, seqs[h.seq_idx].data, h.path))
    assert counts["codec_steps"] == sum(emitting(h.path) for h in hits)
    assert counts["hits_decoded"] == len(hits)
