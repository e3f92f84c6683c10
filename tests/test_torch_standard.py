"""The port's standard (typeid-1) profiles vs the JAX package's, on the CPU.

The cases of tests/test_standard.py, with the port's
``standard_viterbi_scores`` held against the JAX package's within 1e-5,
DB files written by one package and read by the other, typeid dispatch,
the CLI's rows against the JAX CLI's, and the empty read, which scores
as the batch's longest read of symbol 0 in both packages.
"""

import msgpack
import numpy as np
import pytest
import torch

from deciphon_tpu.models.alphabet import DNA
from deciphon_tpu.models.standard import StandardProfile, sample_standard
from deciphon_tpu.ops import viterbi_standard as jvs
from deciphon_tpu_torch.models import standard as pstd
from deciphon_tpu_torch.models.alphabet import DNA as PDNA
from deciphon_tpu_torch.ops import viterbi_standard as pvs
from tests.test_standard import brute_force_viterbi


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_profile(p: StandardProfile) -> pstd.StandardProfile:
    """The port's StandardProfile holding the same arrays."""
    return pstd.StandardProfile(
        accession=p.accession, abc=PDNA, name=p.name,
        **{k: np.array(getattr(p, k)) for k in (
            "alt_start", "alt_trans", "alt_emis", "alt_end",
            "null_start", "null_trans", "null_emis", "null_end")},
    )


def both_scores(profiles, reads):
    """(port alt, null), (JAX alt, null) as numpy [Q, B]."""
    Lp = max(len(r) for r in reads)
    seqs = np.zeros((len(reads), Lp), np.int32)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        e = DNA.encode(r)
        seqs[i, : len(e)] = e
        lens[i] = len(e)
    got = pvs.standard_viterbi_scores(
        pvs.build_standard_block([port_profile(p) for p in profiles], "cpu"),
        torch.from_numpy(seqs), torch.from_numpy(lens),
    )
    want = jvs.standard_viterbi_scores(jvs.build_standard_block(profiles),
                                       seqs, lens)
    return ([t.numpy() for t in got], [np.asarray(t) for t in want])


def test_port_samples_equal_jax_samples():
    for seed, n in ((1, 2), (5, 7)):
        a, b = sample_standard(seed, n), pstd.sample_standard(seed, n)
        for k in ("alt_start", "alt_trans", "alt_emis", "null_emis"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.accession == b.accession


def test_standard_viterbi_vs_jax_and_brute_force():
    profiles = [sample_standard(s + 1, (s % 3) + 2) for s in range(4)]
    reads = ["ACGT", "TTTAC", "G"]
    (alt, null), (jalt, jnull) = both_scores(profiles, reads)
    np.testing.assert_allclose(alt, jalt, atol=1e-5)
    np.testing.assert_allclose(null, jnull, atol=1e-5)
    for q, r in enumerate(reads):
        e = DNA.encode(r)
        for b, p in enumerate(profiles):
            assert alt[q, b] == pytest.approx(brute_force_viterbi(
                p.alt_start, p.alt_trans, p.alt_emis, p.alt_end, e), abs=1e-4)


def test_profile_chunks_equal_one_pass(monkeypatch):
    """Chunking the profile axis changes no score."""
    profiles = [sample_standard(s + 1, (s % 4) + 2) for s in range(7)]
    reads = ["ACGTTGCA", "TTA", "GGGCCCAT"]
    (alt, null), _ = both_scores(profiles, reads)
    monkeypatch.setattr(pvs, "STEP_BYTES", 1)  # one profile a chunk
    (calt, cnull), _ = both_scores(profiles, reads)
    np.testing.assert_array_equal(alt, calt)
    np.testing.assert_array_equal(null, cnull)


def test_standard_hand_computed():
    emis = np.log(np.array([[0.9, 0.1 / 3, 0.1 / 3, 0.1 / 3],
                            [0.1 / 3, 0.9, 0.1 / 3, 0.1 / 3]]))
    prof = StandardProfile(
        accession="HAND", abc=DNA,
        alt_start=np.log(np.array([1.0, 1e-30])),
        alt_trans=np.log(np.array([[0.2, 0.8], [0.8, 0.2]])),
        alt_emis=emis, alt_end=np.zeros(2),
        null_start=np.zeros(1), null_trans=np.zeros((1, 1)),
        null_emis=np.log(np.full((1, 4), 0.25)), null_end=np.zeros(1),
    )
    (alt, null), (jalt, jnull) = both_scores([prof], ["AC"])
    want = np.log(0.9) + np.log(0.8) + np.log(0.9)
    assert alt[0, 0] == pytest.approx(want, abs=1e-5)
    assert null[0, 0] == pytest.approx(2 * np.log(0.25), abs=1e-5)
    np.testing.assert_allclose(alt, jalt, atol=1e-5)


def test_empty_read_scores_as_the_jax_package_does():
    """An empty read takes the scores at the batch's last padded
    position: those of a read of the longest length, all symbol 0."""
    profiles = [sample_standard(s, s + 1) for s in (1, 2, 3)]
    reads = ["ACGTACGTAA", "", "ACG"]
    (alt, null), (jalt, jnull) = both_scores(profiles, reads)
    np.testing.assert_allclose(alt, jalt, atol=1e-5)
    np.testing.assert_allclose(null, jnull, atol=1e-5)
    assert np.isfinite(alt[1]).all()
    (aalt, anull), _ = both_scores(profiles, ["A" * 10])
    np.testing.assert_array_equal(alt[1], aalt[0])
    np.testing.assert_array_equal(null[1], anull[0])
    pprofs = [port_profile(p) for p in profiles]
    assert pvs.scan_standard(pprofs, reads, -1e9, device="cpu") == (
        jvs.scan_standard(profiles, reads, -1e9))


def test_scan_and_db_files_cross_both_ways(tmp_path):
    from deciphon_tpu.db.standard_db import (
        load_standard_db as jload, write_standard_db as jwrite,
    )
    from deciphon_tpu_torch.db.standard_db import (
        load_standard_db as pload, write_standard_db as pwrite,
    )

    profiles = [sample_standard(s + 1, 3) for s in range(5)]
    profiles[2].alt_emis[:] = np.log(
        np.array([0.97, 0.01, 0.01, 0.01]))[None, :]
    jpath, ppath = str(tmp_path / "j.dtp"), str(tmp_path / "p.dtp")
    assert jwrite(jpath, profiles) == 5
    assert pwrite(ppath, [port_profile(p) for p in profiles]) == 5
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    from_jax, from_port = pload(jpath), jload(ppath)
    for p, a, b in zip(profiles, from_jax, from_port):
        assert a.accession == b.accession == p.accession
        np.testing.assert_array_equal(a.alt_emis, p.alt_emis)
        np.testing.assert_array_equal(b.alt_trans, p.alt_trans)
    reads = ["A" * 12, "CGTCGTCGTCGT"]
    hits = pvs.scan_standard(from_jax, reads, lrt_threshold=5.0,
                             device="cpu")
    assert hits == jvs.scan_standard(from_port, reads, lrt_threshold=5.0)
    assert any(q == 0 and b == 2 for q, b, *_ in hits)
    assert from_jax[0].state_name(12) == "S12"


def test_typeid_dispatch(tmp_path):
    from deciphon_tpu_torch.db.dispatch import STANDARD, db_typeid, open_db
    from deciphon_tpu_torch.db.format import TensorDB, write_db
    from deciphon_tpu_torch.db.standard_db import (
        load_standard_db, write_standard_db,
    )
    from deciphon_tpu_torch.models.profile import sample_profile
    from deciphon_tpu_torch.utils.rc import DcpError

    std = str(tmp_path / "std.dtp")
    write_standard_db(std, [pstd.sample_standard(1, 3)])
    assert db_typeid(std) == STANDARD
    tid, profs = open_db(std)
    assert tid == STANDARD and profs[0].accession == "STD00001"
    prot = str(tmp_path / "prot.dtp")
    write_db(prot, [sample_profile(1, 3)])
    tid, db = open_db(prot)
    assert tid == "protein" and isinstance(db, TensorDB)
    bad = str(tmp_path / "bad.dtp")
    with open(bad, "wb") as fp:
        fp.write(msgpack.packb({"header": {"magic_number": 0xC6F0,
                                           "profile_typeid": 2},
                                "profiles": []}))
    with pytest.raises(DcpError):
        load_standard_db(bad)


def test_cli_scan_and_info_match_jax_cli(tmp_path, capsys):
    from deciphon_tpu.cli.main import main as jmain
    from deciphon_tpu.db.standard_db import write_standard_db
    from deciphon_tpu_torch.cli.main import main as pmain

    profiles = [sample_standard(s + 1, 3) for s in range(3)]
    profiles[1].alt_emis[:] = np.log(
        np.array([0.97, 0.01, 0.01, 0.01]))[None, :]
    db = str(tmp_path / "std.dtp")
    write_standard_db(db, profiles)
    fa = tmp_path / "reads.fa"
    fa.write_text(">r1\nAAAAAAAAAAAA\n>r2\nCGTCGTCGTCGT\n>r3\nAAAAAA\n")
    jout, pout = str(tmp_path / "j.tsv"), str(tmp_path / "p.tsv")
    args = ["--lrt-threshold", "5.0", "--batch-size", "2"]
    assert jmain(["scan", db, str(fa), "-o", jout, *args]) == 0
    assert pmain(["scan", db, str(fa), "-o", pout, *args,
                  "--device", "cpu"]) == 0
    jrows = [r.split("\t") for r in open(jout).read().splitlines()]
    prows = [r.split("\t") for r in open(pout).read().splitlines()]
    assert len(prows) == len(jrows) > 1
    assert any(r[2] == "STD00002" and "standard" in r for r in prows[1:])
    for j, p in zip(jrows, prows):
        assert [x for i, x in enumerate(p) if i not in (4, 5)] == [
            x for i, x in enumerate(j) if i not in (4, 5)]
        if j is not jrows[0]:
            for i in (4, 5):
                assert float(p[i]) == pytest.approx(float(j[i]), abs=1e-5)
    capsys.readouterr()
    assert jmain(["info", db]) == 0
    jinfo = capsys.readouterr().out
    assert pmain(["info", db]) == 0
    assert capsys.readouterr().out == jinfo
    assert "type:       standard" in jinfo


def test_cuda_without_gpu_raises(tmp_path, monkeypatch):
    """A standard scan asked for CUDA never runs on the CPU instead."""
    from deciphon_tpu_torch.cli.main import main as pmain
    from deciphon_tpu_torch.db.standard_db import write_standard_db

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    profs = [pstd.sample_standard(1, 3)]
    with pytest.raises(RuntimeError, match="cuda"):
        pvs.scan_standard(profs, ["ACGT"])
    with pytest.raises(RuntimeError, match="cuda"):
        pvs.build_standard_block(profs, "cuda")
    db = str(tmp_path / "std.dtp")
    write_standard_db(db, profs)
    fa = tmp_path / "r.fa"
    fa.write_text(">r1\nACGT\n")
    with pytest.raises(RuntimeError, match="cuda"):
        pmain(["scan", db, str(fa), "-o", str(tmp_path / "o.tsv")])
