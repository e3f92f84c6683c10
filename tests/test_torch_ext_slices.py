"""Extended tables in profile slices (ops/scan_engine.EXT_SLICE_BYTES).

A block whose extended tables (fm and fin of a read class with IUPAC
codes) exceed the budget is built and scanned in runs of whole profiles,
one run alive at a time.  On the CPU plain path, with a budget patched
small enough to cut every block: pass-1 cells equal the whole blocks'
bit for bit, hits, paths, match strings and best hits are identical,
under both semirings, for N and N+R reads, unsharded and on a 2 x 2
mesh; the slices cover each block once; the counters count them; and a
sliced scan's scores agree with the benchmark's float64 reference
(portbench/reference) within the mix cell's pass-1 limit.
"""

import io
import json
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
from deciphon_tpu_torch.ops import scan_engine as pse
from deciphon_tpu_torch.ops import tables as pt
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.parallel.mesh import make_scan_mesh
from deciphon_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
# two blocks: width 32 (six profiles) and width 64 (four)
SIZES = (20, 24, 28, 30, 18, 26, 50, 56, 60, 40)
CLASSES = (("N",), ("N", "R"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core oversubscribes the
    cores many times over (these tensors are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """(TensorDB, each profile's .hmm text) of SIZES."""
    from deciphon_tpu_torch.db.format import TensorDB, write_db
    from deciphon_tpu_torch.models.h3reader import build_profile, read_h3
    from deciphon_tpu_torch.models.h3writer import random_h3, write_h3

    texts = []
    for s, k in enumerate(SIZES):
        buf = io.StringIO()
        write_h3(buf, random_h3(s + 1, k, peak=0.9))
        texts.append(buf.getvalue())
    path = str(tmp_path_factory.mktemp("ext_slices") / "t.dtp")
    write_db(path, [build_profile(next(read_h3(io.StringIO(t))))
                    for t in texts])
    return TensorDB.load(path), texts


def budget() -> int:
    """2.5 base-5 profiles of width 32: N slices of two profiles at width
    32 (three on a mesh shard: two and one) and of one at width 64; N+R
    slices of one profile, at width 64 over the budget alone."""
    return int(2.5 * pt.table_bytes(("N",), 32))


def consensus(prof) -> str:
    return "".join(
        STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
        for b in map(int, np.argmax(prof.match_codonp, axis=1))
    )


def reads(tdb) -> list:
    """Homologs (66 nt of a consensus) of three profiles with an N, with
    an N and an R, plain; a background read with an N."""
    out = []
    for p in (3, 7, 9):
        r = consensus(tdb.profile(p))[:66]
        out += [r[:10] + "N" + r[11:], r[:5] + "N" + r[6:20] + "R" + r[21:], r]
    out.append("ACGTTGCANACGGTCATTGACCA")
    return [pse.SeqRecord(i + 1, f"r{i}", s) for i, s in enumerate(out)]


def engine(tdb, layout: str, algo: str = "viterbi"):
    mesh = (make_scan_mesh(profile_axis=2, seq_axis=2, devices=["cpu"] * 4)
            if layout == "mesh" else None)
    return pse.ScanEngine(tdb, pse.ScanParams(algo=algo), device="cpu",
                          mesh=mesh)


def recorded(eng, seqs, best=False):
    with trace.recording():
        out = (eng.best_hits if best else eng.scan)(seqs)
    return out, trace.recorded()[-1].counts


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("layout", ["unsharded", "mesh"])
@pytest.mark.parametrize("algo", ["viterbi", "forward"])
def test_sliced_scan_equals_the_whole_blocks(db, monkeypatch, algo, layout):
    """The same engine scans with whole blocks, then with every extended
    block cut: pass-1 cells bit for bit, hits with their scores, paths
    and match strings, and best hits, all identical."""
    tdb, _ = db
    seqs = reads(tdb)
    eng = engine(tdb, layout, algo)
    whole, whole_counts = recorded(eng, seqs)
    whole_scores = eng.last_scores
    whole_best = eng.best_hits(seqs)
    monkeypatch.setattr(pse, "EXT_SLICE_BYTES", budget())
    cut, counts = recorded(eng, seqs)
    assert counts["ext_slices"] > whole_counts["ext_slices"] == (
        len(CLASSES) * len(eng.blocks) * (2 if layout == "mesh" else 1))
    for w, c in zip(whole_scores, eng.last_scores):
        assert np.array_equal(bits(w), bits(c))
    assert whole and {h.seq_idx for h in whole if "R" in seqs[h.seq_idx].data}
    assert [vars(h) for h in cut] == [vars(h) for h in whole]
    assert [vars(b) for b in eng.best_hits(seqs)] == [vars(b) for b in whole_best]


@pytest.mark.parametrize("layout", ["unsharded", "mesh"])
@pytest.mark.parametrize("codes", CLASSES)
@pytest.mark.parametrize("scale", [1, 2.5, 6, 1e9])
def test_slices_are_runs_of_whole_profiles_covering_each_block_once(
        db, monkeypatch, layout, codes, scale):
    """Each profile shard's slices are consecutive runs of its profiles,
    in order, covering it once: the fewest runs whose tables fit the
    budget, their lengths within one of each other; a profile over the
    budget is a run alone, and a shard under it one run."""
    tdb, _ = db
    limit = int(scale * pt.table_bytes(("N",), 32))
    monkeypatch.setattr(pse, "EXT_SLICE_BYTES", limit)
    eng = engine(tdb, layout)
    for blk in eng.blocks:
        per = pt.table_bytes(codes, blk.kpad)
        tiles = list(eng.tables.tiles(blk, codes))
        base = eng.tables.tiles(blk)
        for b in base:
            got = [t for t in tiles if (t.s, t.p) == (b.s, b.p)]
            assert np.array_equal(np.concatenate([t.cols for t in got]),
                                  b.cols)
            lens = [len(t.cols) for t in got]
            fit = max(1, limit // per)
            assert len(lens) == -(-len(b.cols) // fit)
            assert max(lens) - min(lens) <= 1
            for t in got:
                assert t.blk.fm.shape[0] == len(t.cols)
                assert (t.blk.fm.numel() + t.blk.fin.numel()) * 4 <= max(
                    limit, per)
        assert len(tiles) == sum(
            len(col) for col, _ in eng.tables.slices(blk, codes))


@pytest.mark.parametrize("codes", CLASSES)
def test_a_budget_below_one_profile_gives_each_profile_a_slice(db, monkeypatch,
                                                              codes):
    tdb, _ = db
    monkeypatch.setattr(pse, "EXT_SLICE_BYTES", 1)
    eng = engine(tdb, "unsharded")
    for blk in eng.blocks:
        (base,) = eng.tables.tiles(blk)
        tiles = list(eng.tables.tiles(blk, codes))
        assert [t.cols.tolist() for t in tiles] == [[i] for i in base.cols]
        for i, t in enumerate(tiles):  # views of the base tile's planes
            assert t.blk.trans.data_ptr() == base.blk.trans[i].data_ptr()
            assert t.blk.ptrans.data_ptr() == base.blk.ptrans[i].data_ptr()
            want = vc.CudaBlock.from_profiles([tdb.profile(int(blk.chunk[i]))],
                                              kpad=blk.kpad, device="cpu",
                                              codes=codes)
            assert torch.equal(t.blk.fm, want.fm)
            assert torch.equal(t.blk.fin, want.fin)


@pytest.mark.parametrize("layout", ["unsharded", "mesh"])
@pytest.mark.parametrize("best", [False, True])
def test_at_most_one_slice_is_alive(db, monkeypatch, layout, best):
    """Spied builds and frees: when a slice is built, no tile of the
    last one (its tables or their copies down a mesh column) is alive."""
    tdb, _ = db
    monkeypatch.setattr(pse, "EXT_SLICE_BYTES", budget())
    alive, seen = set(), []
    real = pse.extend_tiles

    def spy(*args):
        seen.append(len(alive))
        tiles = real(*args)
        for t in tiles:
            for x in (t.blk.fm, t.blk.fin):
                alive.add(id(x))
                weakref.finalize(x, alive.discard, id(x))
        return tiles

    monkeypatch.setattr(pse, "extend_tiles", spy)
    eng = engine(tdb, layout)
    seqs = reads(tdb)
    (eng.best_hits if best else eng.scan)(seqs)
    assert len(seen) > len(CLASSES) * len(eng.blocks)
    assert seen == [0] * len(seen) and not alive


def test_counters_and_a_block_under_the_budget(db, monkeypatch):
    """``ext_slices`` counts each slice built, ``tables_written_bytes`` the
    fm and fin it writes.  Under the default budget each block is one
    slice, built from the store's own inputs and base tile, as before
    slicing."""
    tdb, _ = db
    eng = engine(tdb, "unsharded")
    seqs = reads(tdb)
    calls = []
    real = vc.CudaBlock.extended.__func__

    def spy(cls, inputs, base, codes):
        calls.append((inputs, base))
        return real(cls, inputs, base, codes)

    monkeypatch.setattr(vc.CudaBlock, "extended", classmethod(spy))
    _, counts = recorded(eng, seqs)
    n = len(eng.blocks)
    assert counts["ext_slices"] == counts["ext_tables"] == len(CLASSES) * n
    for (inputs, base), blk in zip(calls, eng.blocks * len(CLASSES)):
        assert inputs is blk.ext[0] and base is blk.tiles[0].blk
    want = sum(pt.table_bytes(c, blk.kpad) * len(blk.chunk)
               for c in CLASSES for blk in eng.blocks)
    assert counts["tables_written_bytes"] == want
    monkeypatch.setattr(pse, "EXT_SLICE_BYTES", budget())
    _, counts = recorded(eng, seqs)
    slices = sum(len(eng.tables.slices(blk, c))
                 for c in CLASSES for blk in eng.blocks)
    assert counts["ext_slices"] == slices > len(CLASSES) * n
    assert counts["tables_written_bytes"] == want
    assert counts.get("ext_tables", 0) == slices
    assert not {k for k in counts if k.startswith("launch.")}


def test_packed_refuses_a_sliced_block(db, monkeypatch):
    tdb, _ = db
    eng = engine(tdb, "unsharded")
    assert eng.packed(eng.blocks[0], ("N",)).fm.shape[0] == len(
        eng.blocks[0].chunk)
    monkeypatch.setattr(pse, "EXT_SLICE_BYTES", budget())
    with pytest.raises(ValueError, match="slices"):
        eng.packed(eng.blocks[0], ("N",))


@pytest.mark.parametrize("algo", ["viterbi", "forward"])
def test_sliced_scores_agree_with_the_plain_reference(db, monkeypatch, algo):
    """A sliced scan's pass-1 scores of N and N+R reads (and plain ones)
    against portbench/reference's float64 DP from the .hmm text, within
    the pass-1 limit of the mix cell."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.lib import check

    tdb, texts = db
    limit = json.loads((ROOT / "portbench" / "limits"
                        / "pfam4k_vit.reads150_mix.json").read_text())
    monkeypatch.setattr(pse, "EXT_SLICE_BYTES", budget())
    seqs = reads(tdb)
    eng = engine(tdb, "unsharded", algo)
    eng.scan(seqs)
    alt, null = eng.last_scores
    ref = check.Reference(lambda p: texts[p],
                          {"epsilon": 0.01, "entry_dist": "occupancy"}, "cpu")
    cells = [(r, p) for r in range(len(seqs)) for p in range(len(SIZES))]
    scan = dict(multi_hits=True, hmmer3_compat=False)
    ra, rn = ref.scores([s.data for s in seqs], cells,
                        "lse" if algo == "forward" else "max", scan)
    shape = (len(seqs), len(SIZES))
    for got, want in ((alt, ra.reshape(shape)), (null, rn.reshape(shape))):
        gap = np.abs(got - want) / (1 + np.abs(want))
        assert gap.max() <= limit["pass1_gap"], gap.max()
