"""Profile-sharded scans, best hits and --shard on the port, on the CPU.

A mesh of repeated CPU devices (["cpu"] * n, as the JAX tests run on 8
virtual CPU devices) exercises the tiling: each tile holds its own
tables and scores its own reads with the plain version of the kernel.
Sharded pass-1 Viterbi scores must EQUAL the unsharded engine's bit for
bit (every (read, profile) cell is computed alone, so the split cannot
move a bit).  Forward scores agree within rtol 1e-6: torch's CPU
logaddexp rounds a tensor's SIMD body and its tail differently, so the
plain version's last bit depends on the tensor's shape (the card's
kernel has no such dependence, and chip_smoke.py holds it to 0).
Against the JAX mesh engine (XLA, CPU) logliks agree within 1e-4
(tests/test_parallel.py:118) and matches are equal.  Best hits must
pick the JAX engine's winners, ties included.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from deciphon_tpu.cli.main import main as jax_main
from deciphon_tpu.db.format import TensorDB as JaxTensorDB
from deciphon_tpu.ops import scan_engine as jse
from deciphon_tpu.parallel.mesh import make_scan_mesh as jax_mesh
from deciphon_tpu_torch.cli.main import main as torch_main
from deciphon_tpu_torch.db.format import TensorDB, write_db
from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
from deciphon_tpu_torch.models.h3reader import press_file
from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
from deciphon_tpu_torch.models.profile import sample_profile
from deciphon_tpu_torch.ops import scan_engine as pse
from deciphon_tpu_torch.parallel.mesh import make_scan_mesh


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
def scan_db(tmp_path_factory):
    """10 HMMER-shaped profiles of cores 2..12 (the sizes of
    tests/test_parallel.py:71-85), reads of 20-40 nt: random ACGT, two
    consensus reads (hits), and reads with N and with N and R (three
    read classes)."""
    rng = np.random.default_rng(11)
    tmp = tmp_path_factory.mktemp("db")
    with open(tmp / "mini.hmm", "w") as fp:
        write_h3(fp, [random_h3(s + 1, int(rng.integers(2, 12)), peak=0.9)
                      for s in range(10)])
    path = str(tmp / "mini.dtp")
    write_db(path, press_file(str(tmp / "mini.hmm")))
    db = TensorDB.load(path)
    seqs = [
        "".join(rng.choice(list("ACGT"), int(rng.integers(20, 40))))
        for _ in range(4)
    ]
    seqs += [consensus_dna(db.profile(3)), consensus_dna(db.profile(8))]
    seqs += ["N" + seqs[0][1:], seqs[1][:5] + "N" + seqs[1][6:10] + "R"]
    return db, seqs


def _recs(seqs):
    return [pse.SeqRecord(i + 1, f"s{i}", s) for i, s in enumerate(seqs)]


def test_mesh_shapes():
    devs = ["cpu"] * 8
    mesh = make_scan_mesh(devices=devs)
    assert mesh.seqs * mesh.profiles == 8
    mesh = make_scan_mesh(profile_axis=2, devices=devs)
    assert mesh.shape == {"seqs": 4, "profiles": 2}
    assert mesh.device(3, 1).type == "cpu"
    with pytest.raises(ValueError):
        make_scan_mesh(profile_axis=3, seq_axis=3, devices=devs)
    with pytest.raises(ValueError):
        make_scan_mesh(devices=[])


@pytest.mark.parametrize("algo", ["viterbi", "forward"])
@pytest.mark.parametrize("seq_axis", [1, 2])
@pytest.mark.parametrize("profile_axis", [1, 2, 4])
def test_sharded_equals_unsharded(scan_db, profile_axis, seq_axis, algo):
    db, seqs = scan_db
    params = pse.ScanParams(algo=algo)
    mesh = make_scan_mesh(profile_axis=profile_axis, seq_axis=seq_axis,
                          devices=["cpu"] * (profile_axis * seq_axis))
    sharded = pse.ScanEngine(db, params, mesh=mesh)
    single = pse.ScanEngine(db, params, device="cpu")
    hs, h1 = sharded.scan(_recs(seqs)), single.scan(_recs(seqs))
    for got, want in zip(sharded.last_scores, single.last_scores):
        if algo == "viterbi":
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(h1) >= 2  # the consensus reads hit
    assert [(h.seq_idx, h.profile_idx, h.match) for h in hs] == [
        (h.seq_idx, h.profile_idx, h.match) for h in h1]
    # every tile holds its own tables, also where devices repeat
    for blk in sharded.blocks:
        ptrs = [t.blk.fm.data_ptr() for t in blk.tiles]
        assert len(set(ptrs)) == len(ptrs)
    bs, b1 = sharded.best_hits(_recs(seqs)), single.best_hits(_recs(seqs))
    assert [(b.seq_id, b.profile_idx) for b in bs] == [
        (b.seq_id, b.profile_idx) for b in b1]
    for a, b in zip(bs, b1):
        if algo == "viterbi":
            assert a.lrt == b.lrt
        else:  # 2 x (alt - null), each within rtol 1e-6 of ~60 nats
            assert a.lrt == pytest.approx(b.lrt, abs=1e-4)


@pytest.mark.parametrize("threshold", [-1e9, 10.0])
def test_sharded_matches_jax_mesh_engine(scan_db, threshold):
    db, seqs = scan_db
    if threshold < 0:  # every pair is a hit: keep the traceback small
        seqs = seqs[3:7]
    mesh = make_scan_mesh(profile_axis=4, seq_axis=2, devices=["cpu"] * 8)
    got = pse.ScanEngine(db, pse.ScanParams(lrt_threshold=threshold),
                         mesh=mesh).scan(_recs(seqs))
    ref = jse.ScanEngine(
        JaxTensorDB.load(db.path), jse.ScanParams(lrt_threshold=threshold),
        mesh=jax_mesh(profile_axis=4, seq_axis=2), use_pallas=False,
    ).scan([jse.SeqRecord(i + 1, f"s{i}", s) for i, s in enumerate(seqs)])
    assert got and len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a.seq_idx, a.profile_idx) == (b.seq_idx, b.profile_idx)
        assert a.alt_loglik == pytest.approx(b.alt_loglik, abs=1e-4)
        assert a.null_loglik == pytest.approx(b.null_loglik, abs=1e-4)
        assert a.match == b.match


@pytest.fixture(scope="module")
def tie_db(tmp_path_factory):
    """Five profiles, 1 and 2 identical but for the accession: a read
    scores equal LRTs against both."""
    profs = [sample_profile(s, k) for s, k in ((1, 6), (2, 7), (3, 5))]
    twin = replace(profs[1], accession="TWIN", name="TWIN")
    path = str(tmp_path_factory.mktemp("tie") / "tie.dtp")
    write_db(path, [profs[0], profs[1], twin, profs[2],
                    sample_profile(4, 30)])
    db = TensorDB.load(path)
    seqs = [consensus_dna(profs[1]), consensus_dna(profs[0]),
            "ACGTACGTACGTAC", consensus_dna(profs[1])[:-2] + "NA"]
    return db, seqs


@pytest.mark.parametrize("mesh_shape", [None, (2, 1), (4, 2)])
def test_best_hits_match_jax_engine(tie_db, mesh_shape):
    """Winners (ties to the lower index within a block) and LRTs within
    2e-4 of the JAX engine's best_hits."""
    db, seqs = tie_db
    params = pse.ScanParams(lrt_threshold=-1e9)
    mesh = None
    if mesh_shape is not None:
        paxis, saxis = mesh_shape
        mesh = make_scan_mesh(profile_axis=paxis, seq_axis=saxis,
                              devices=["cpu"] * (paxis * saxis))
    got = pse.ScanEngine(db, params, device="cpu", mesh=mesh).best_hits(
        _recs(seqs))
    ref = jse.ScanEngine(JaxTensorDB.load(db.path),
                         jse.ScanParams(lrt_threshold=-1e9),
                         use_pallas=False).best_hits(
        [jse.SeqRecord(i + 1, f"s{i}", s) for i, s in enumerate(seqs)])
    assert [(b.seq_id, b.profile_idx, b.accession) for b in got] == [
        (b.seq_id, b.profile_idx, b.accession) for b in ref]
    assert got[0].profile_idx == 1  # the tie went to the lower index
    for a, b in zip(got, ref):
        assert a.lrt == pytest.approx(b.lrt, abs=2e-4)
        assert a.alt_loglik == pytest.approx(b.alt_loglik, abs=1e-4)
        assert a.null_loglik == pytest.approx(b.null_loglik, abs=1e-4)


def test_subset_scans_only_its_profiles(scan_db):
    db, seqs = scan_db
    subset = [1, 4, 5, 9]
    eng = pse.ScanEngine(db, pse.ScanParams(lrt_threshold=-1e9),
                         device="cpu", subset=subset)
    hits = eng.scan(_recs(seqs))
    assert {h.profile_idx for h in hits} == set(subset)
    alt, _ = eng.last_scores
    assert np.all(alt[:, [0, 2, 3, 6, 7, 8]] == pse.NEG)
    single = pse.ScanEngine(db, pse.ScanParams(lrt_threshold=-1e9),
                            device="cpu")
    single.scan(_recs(seqs))
    assert np.array_equal(alt[:, subset], single.last_scores[0][:, subset])


@pytest.mark.parametrize("flags", [["--shard", "1/3"], ["--shard", "3/3"],
                                   ["--shard", "2/3", "--best-hit"],
                                   ["--best-hit"]])
def test_cli_rows_match_jax_cli(scan_db, tmp_path, flags, capsys):
    db, seqs = scan_db
    fasta = tmp_path / "reads.fa"
    fasta.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    ref, got = tmp_path / "jax.tsv", tmp_path / "torch.tsv"
    common = ["--lrt-threshold=-1e9", *flags]
    assert jax_main(["scan", db.path, str(fasta), "-o", str(ref),
                     *common]) == 0
    assert torch_main(["scan", db.path, str(fasta), "-o", str(got),
                       "--device", "cpu", *common]) == 0
    capsys.readouterr()
    want = [r.split("\t") for r in ref.read_text().splitlines()[1:]]
    have = [r.split("\t") for r in got.read_text().splitlines()[1:]]
    assert have and len(have) == len(want)
    for g, w in zip(have, want):
        assert g[:4] + g[6:] == w[:4] + w[6:]
        for col in (4, 5):
            assert float(g[col]) == pytest.approx(float(w[col]), abs=1e-4)
