"""Pass 2's fragment tables by the card route, on the CPU device.

On a card, ``viterbi_trace.pack_chunk`` computes a chunk's traceback
tables with ``card_tables`` (the host's f64 product, log, NEG clamp and
f32 cast) from the rows of ``table_rows``, instead of taking them from
the host block of ``build_profile_block``.  Here the same torch calls
run on the CPU:

- its fmT and fin equal the host block's (fm transposed, fi and fn
  stacked, NEG past each core, the sentinel row NEG) to at most one f32
  ulp, with the count of differing entries printed: base 4, ("N",),
  ("N", "R"), ("N", "R") with its coefficient matrix uploaded in many
  column slices, a chunk of mixed cores under one width cut into
  slices that split hits, and a chunk of two epsilons;
- a code set beyond ("N",) holds at most two column slices of its
  coefficient matrix on the device, for any number of codes;
- ``trace_dp`` on the two routes' tables gives the same arrays and
  paths on tests/test_torch_traceback_kernel.py's cases;
- a scan whose pass 2 takes the card route counts every hit it traces
  in ``trace_tables``, and a window on a card counts the route's
  device bytes.
"""

import numpy as np
import pytest
import torch

import test_torch_traceback_kernel as ttk
from deciphon_tpu_torch.models.alphabet import encode_extended
from deciphon_tpu_torch.models.profile import ProteinCfg, sample_profile
from deciphon_tpu_torch.ops import viterbi_trace as vtr
from deciphon_tpu_torch.ops.viterbi_torch import (
    NEG,
    ProfileBlock,
    build_profile_block,
)

scan_db = ttk.scan_db


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance of two f32 arrays in units in the last place (the float
    line ordered as integers)."""
    def key(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32)
        i = i.astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(key(a) - key(b))


def chunk_of(profs, codes, rng):
    """(profiles, eidx, lens) of one chunk: a read of 20-60 nt a hit over
    ACGT and ``codes``."""
    reads = ["".join(rng.choice(list("ACGT") + list(codes),
                                int(rng.integers(20, 60))))
             for _ in profs]
    encs = [encode_extended(r)[0] for r in reads]
    ((chunk_p, eidx, lens),) = vtr.chunk_reads(profs, encs, codes or None)
    return chunk_p, eidx, lens


TABLE_CASES = {  # profiles (seed, core), codes, rows a slice, slice bytes
    "base4": ([(1, 7), (2, 30), (3, 12)], (), None, None),
    "base5": ([(4, 9), (5, 21)], ("N",), None, None),
    "base6": ([(6, 5), (7, 14)], ("N", "R"), None, None),
    # the base-6 matrix in slices of 1000 columns, 5 rows a slice
    "base6_cols": ([(13, 9), (14, 4)], ("N", "R"), 5, 8 * 7**5 * 1000),
    # ragged cores under one width, slices of 7 rows that cut hits
    "mixed": ([(8, 3), (9, 40), (10, 129), (11, 2), (12, 77)], (), 7, None),
}


@pytest.mark.parametrize("case", [*TABLE_CASES, "two_eps"])
def test_card_tables_equal_the_host_block(case, monkeypatch):
    """fmT and fin of ``pack_chunk`` equal the host block's (fm
    transposed, fi and fn stacked) within one f32 ulp (the count of
    differing entries printed; 0 on the CPU so far), every node past a
    core NEG, the sentinel row NEG; the planes, eidx and specials equal
    trace_dp's uploads of the host block."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "two_eps":
        cfgs = [ProteinCfg(), ProteinCfg(), ProteinCfg(epsilon=0.02)]
        profs = [sample_profile(20 + j, k, cfg) for j, (k, cfg) in
                 enumerate(zip((6, 11, 8), cfgs))]
        codes, rows, nbytes = (), None, None
    else:
        spec, codes, rows, nbytes = TABLE_CASES[case]
        profs = [sample_profile(s, k) for s, k in spec]
    if nbytes:
        monkeypatch.setattr(vtr, "TABLE_SLICE_BYTES", nbytes)
        assert vtr._col_step(codes) == 1000
    if rows:
        monkeypatch.setattr(vtr, "_slice_rows", lambda codes: rows)
    K = max(p.core_size for p in profs) + 5  # padding nodes too
    chunk_p, eidx, lens = chunk_of(profs, codes, rng)
    got = vtr.pack_chunk(chunk_p, eidx, lens, K, codes, True, False, "cpu")
    block = build_profile_block(profs, kpad=K, codes=codes or None)
    ntab = block.fm.shape[2]
    want = {"fmT": block.fm.transpose(0, 2, 1),
            "fin": np.stack([block.fi, block.fn], 1)}
    for name in ("fmT", "fin"):
        a, b = getattr(got, name).numpy(), want[name]
        assert a.shape == b.shape and a.dtype == np.float32
        d = ulps(a, b)
        print(f"{case} {name} {a.shape}: {int((d > 0).sum())} of {d.size} "
              f"entries differ, at most {int(d.max())} ulp")
        assert d.max() <= 1, name
    fmT = got.fmT.numpy()
    for h, p in enumerate(profs):
        assert (fmT[h, :, p.core_size:] == np.float32(NEG)).all()
    assert (fmT[:, ntab - 1] == np.float32(NEG)).all()
    assert (got.fin.numpy()[:, :, ntab - 1] == np.float32(NEG)).all()
    d = vtr._upload(block._asdict(), eidx, lens, True, False,
                    torch.device("cpu"))
    assert torch.equal(got.planes,
                       torch.stack([d[n] for n in vtr.TRACE_PLANES], 1))
    assert torch.equal(got.eidx, d["eidx"][:, :int(lens.max())].int())
    assert torch.equal(got.sp, torch.stack([d["NN"], d["NB"]], 1))
    assert (got.EJ, got.EC) == (float(d["EJ"]), float(d["EC"]))


@pytest.mark.parametrize("ncodes", range(2, 12))
def test_code_sets_hold_two_column_slices(ncodes):
    """For a code set beyond ("N",) (two to eleven codes, S up to 16)
    the card holds at most two column slices of the coefficient matrix
    at once, together at most 2 * TABLE_SLICE_BYTES, and the slices
    cover every column; a row slice's temporaries stay within
    TABLE_SLICE_BYTES.  Counted without building the matrices, which
    take 1.25 GB of host memory for two codes and 5.1 GB for three."""
    codes = ("N", "R", "Y", "S", "W", "K", "M", "B", "D", "H", "V")[:ncodes]
    W, S = vtr._row_width(codes)
    assert (W, S) == ((5 + ncodes) ** 3, 5 + ncodes)
    step = vtr._col_step(codes)
    assert 8 * S * S * W * step <= vtr.TABLE_SLICE_BYTES
    assert vtr._coef_bytes(codes) <= 2 * vtr.TABLE_SLICE_BYTES
    assert -(-vtr._ntab(codes) // step) * step >= vtr._ntab(codes)
    per_row = 8 * (S * S + S * S * W + step) + 4 * step
    assert 1 <= vtr._slice_rows(codes) * per_row <= vtr.TABLE_SLICE_BYTES


def test_code_set_slices_are_the_host_matrix(monkeypatch):
    """``_coef_slices`` of ("N", "R") uploads the host's
    frame.ext_fragment_matrix a column slice at a time, each within
    TABLE_SLICE_BYTES, together every column in order; of () and
    ("N",) it gives the one kept matrix."""
    from deciphon_tpu_torch.models import frame

    monkeypatch.setattr(vtr, "TABLE_SLICE_BYTES", 8 * 7**5 * 2048)
    codes, dev = ("N", "R"), torch.device("cpu")
    C = frame.ext_fragment_matrix(0.01, codes)
    end = 0
    for c0, c1, part in vtr._coef_slices(0.01, codes, dev):
        assert c0 == end and part.shape == (C.shape[0], c1 - c0)
        assert part.numel() * 8 <= vtr.TABLE_SLICE_BYTES
        assert np.array_equal(part.numpy(), C[:, c0:c1])
        end = c1
    assert end == C.shape[1] == vtr._ntab(codes)
    for codes in ((), ("N",)):
        (c0, c1, part), = vtr._coef_slices(0.01, codes, dev)
        assert part is vtr.fragment_coefs(0.01, codes, dev)
        assert (c0, c1) == (0, vtr._ntab(codes))


def card_block(block: ProfileBlock, pk: vtr.TracePack) -> ProfileBlock:
    """``block`` with the tables of the packed chunk ``pk``."""
    fin = pk.fin.numpy()
    return block._replace(fm=pk.fmT.numpy().transpose(0, 2, 1).copy(),
                          fi=fin[:, 0].copy(), fn=fin[:, 1].copy())


@pytest.mark.parametrize("case,mh,h3", ttk.CASES)
def test_trace_dp_on_card_tables_equals_host_tables(case, mh, h3):
    """``trace_dp`` on the card route's tables gives the host block's
    arrays (every row, VT too) and walked paths."""
    _, pps, reads, codes = ttk.hits(case)
    encs = [encode_extended(r)[0] if r else np.zeros(0, np.int8)
            for r in reads]
    kpad = max(p.core_size for p in pps) + 3
    ((block, eidx, lens),) = vtr.chunks(pps, encs, kpad, codes or None)
    pk = vtr.pack_chunk(pps, eidx, lens, kpad, codes, mh, h3, "cpu")
    _, want = vtr.trace_dp(block, eidx, lens, mh, h3)
    _, got = vtr.trace_dp(card_block(block, pk), eidx, lens, mh, h3)
    for k in vtr.YS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for h, L in enumerate(lens):
        if L:
            assert vtr.walk({k: v[:, h] for k, v in got.items()}, int(L),
                            kpad) == vtr.walk(
                {k: v[:, h] for k, v in want.items()}, int(L), kpad)


def test_scan_counts_the_tables_it_built(scan_db, monkeypatch):
    """A recorded scan whose pass 2 takes the card route (on the CPU,
    ``kernel_mirror`` in the kernel's place) counts every hit it traced
    in ``trace_tables``, as many as ``hits_decoded``, and gives the hits
    of the plain route; the plain route counts none."""
    from deciphon_tpu_torch.ops import _build
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine
    from deciphon_tpu_torch.utils import trace

    def mirror_launch(pk, out=None):
        ys = ttk.kernel_mirror(pk, vtr.trace_plan(pk.fmT.shape[2]))
        raw = out.buf.numpy()
        for k, (off, dt, shape) in out.views.items():
            b = np.ascontiguousarray(ys[k], dtype=dt).view(np.uint8)
            raw[off:off + b.size] = b.ravel()
        return out

    engine = ScanEngine(scan_db, device="cpu")
    seqs = ttk.scan_reads(scan_db)
    with trace.recording():
        want = engine.scan(seqs)
    assert "trace_tables" not in engine.last_counts
    monkeypatch.setattr(_build, "library", lambda: None)
    monkeypatch.setattr(vtr, "_on_card", lambda dev: True)
    monkeypatch.setattr(vtr, "launch_trace", mirror_launch)
    monkeypatch.setattr(vtr, "trace_dp", None)  # never called
    with trace.recording():
        got = engine.scan(seqs)
    counts = engine.last_counts
    assert counts["trace_tables"] == counts["hits_decoded"] == len(got) > 0
    assert [vars(h) for h in got] == [vars(h) for h in want]


def test_card_windows_count_the_route_bytes(monkeypatch):
    """``_rows_bytes`` is the size of ``table_rows``' buffer; on a card a
    window holds a slice's bytes and the groups' coefficient matrices
    besides its chunks and their rows, within QUEUE_BYTES unless it is
    one chunk; a budget under which the CPU queues one window cuts the
    card's queue into several."""
    rng = np.random.default_rng(3)
    groups = []
    for codes in ((), ("N",)):
        profs = [sample_profile(30 + j, k) for j, k in enumerate((6, 19))]
        chunk_p, _, _ = chunk_of(profs, codes, rng)
        assert vtr._rows_bytes(chunk_p, codes) == vtr.table_rows(
            chunk_p, codes, 19).numel()
        reads = [encode_extended("ACGT" * 9)[0]] * len(profs)
        groups.append((profs, reads, 32, codes))
    monkeypatch.setattr(vtr, "TRACE_BATCH", 1)
    held = [vtr._chunk_bytes(*shape) + vtr._rows_bytes(profs[i:i + 1], codes)
            for profs, reads, kpad, codes in groups
            for i, shape in enumerate(vtr.chunk_shapes(profs, reads, kpad,
                                                       codes))]
    fixed = vtr.TABLE_SLICE_BYTES + vtr._coef_bytes(()) + vtr._coef_bytes(
        ("N",))
    assert fixed == vtr.TABLE_SLICE_BYTES + 8 * 3125 * (1365 + 3906)
    monkeypatch.setattr(vtr, "QUEUE_BYTES", fixed + sum(held) // 2)
    assert len(vtr._windows(groups)) == 1
    windows = vtr._windows(groups, card=True)
    assert len(windows) > 1
    assert sum(len(w) for w, _ in windows) == len(held)
    it = iter(held)
    for w, _ in windows:
        size = sum(next(it) for _ in w)
        assert len(w) == 1 or fixed + size <= vtr.QUEUE_BYTES
