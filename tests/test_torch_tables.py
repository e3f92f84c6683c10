"""Torch fragment-table synthesis vs the JAX synthesis and the host tables.

deciphon_tpu_torch/ops/tables.synth_fragment_tables must reproduce
models/frame.fragment_table (host f64) and deciphon_tpu's on-device
synthesis up to f32 rounding: atol 2e-5, the tolerance of
tests/test_tables.py:47; its extended (IUPAC) tables must reproduce
frame.fragment_table_codes and ProteinProfile.fragment_tables(codes=...)
within the same tolerance.  CudaBlock.from_profiles must give the packed
layout of pack_numpy_block on the host tables.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.models import frame
from deciphon_tpu.ops import tables as jtables
from deciphon_tpu_torch.models.profile import sample_profile
from deciphon_tpu_torch.ops import tables, viterbi_cuda as vc
from deciphon_tpu_torch.ops import viterbi_torch as vt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core oversubscribes the
    cores many times over (these tensors are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5


def _rand_states(n, seed=0):
    rng = np.random.default_rng(seed)
    margs, qs = [], []
    for _ in range(n):
        lcodon = np.log(rng.dirichlet(np.ones(64)))
        margs.append(frame.codon_marg(lcodon))
        qs.append(frame.q5_pad(frame.nuclt_lprob_from_codon(lcodon)))
    return np.stack(margs), np.stack(qs)


@pytest.mark.parametrize("eps", [0.01, 0.1])
def test_synth_matches_host_and_jax(eps):
    marg, q = _rand_states(6)
    host = frame.fragment_table(marg, q, eps)  # [6, 1365] f64
    mp = np.exp(marg).astype(np.float32)
    qp = np.exp(q).astype(np.float32)
    got = tables.synth_fragment_tables(
        torch.from_numpy(mp), torch.from_numpy(qp), eps, row_chunk=4
    ).numpy()
    ref = np.asarray(jtables.synth_fragment_tables(mp, qp, eps=eps))
    assert got.shape == host.shape == ref.shape
    finite = np.isfinite(host)
    np.testing.assert_allclose(got[finite], host[finite], atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    # -inf entries and the sentinel column are NEG, never -inf
    assert np.all(got[~finite] == vt.NEG)
    assert np.all(got[:, -1] == vt.NEG)


def test_padding_rows_are_neg():
    """Zero-probability (padding-node) rows come out exactly NEG."""
    got = tables.synth_fragment_tables(
        torch.zeros(3, 125), torch.zeros(3, 5), 0.01
    )
    assert torch.all(got == vt.NEG)


def test_from_profiles_matches_host_pack():
    profiles = [sample_profile(s + 1, (s % 5) + 2) for s in range(10)]
    host = vc.pack_numpy_block(vt.build_profile_block(profiles, kpad=8))
    dev = vc.CudaBlock.from_profiles(profiles, kpad=8, device="cpu")
    assert dev.fm.shape == host.fm.shape == (10, 1365, vc.LANE)
    for got, want in ((dev.fm, host.fm), (dev.fin, host.fin)):
        live = want > vt.NEG / 2
        np.testing.assert_allclose(got[live], want[live], atol=ATOL)
        assert torch.all(got[~live] <= vt.NEG / 2)
    assert torch.equal(dev.trans, host.trans)


CODE_SETS = [("N",), ("N", "R"), ("B", "D", "H")]
NTAB_OF = {("N",): 3906, ("N", "R"): 9331, ("B", "D", "H"): 19608}


@pytest.mark.parametrize("codes", CODE_SETS)
@pytest.mark.parametrize("eps", [0.01, 0.1])
def test_ext_synth_matches_host(codes, eps):
    """Extended tables from codon probabilities [64] + q [5] vs the host
    f64 frame.fragment_table_codes, every row incl. the sentinel."""
    rng = np.random.default_rng(len(codes))
    lcodon = np.log(rng.dirichlet(np.ones(64), size=5))
    q = frame.q5_pad(frame.nuclt_lprob_from_codon(lcodon))
    host = frame.fragment_table_codes(lcodon, q, eps, codes)
    got = tables.synth_fragment_tables(
        torch.from_numpy(np.exp(lcodon).astype(np.float32)),
        torch.from_numpy(np.exp(q).astype(np.float32)), eps, codes,
        row_chunk=2,
    ).numpy()
    assert got.shape == host.shape == (5, NTAB_OF[codes])
    finite = np.isfinite(host)
    np.testing.assert_allclose(got[finite], host[finite], atol=ATOL)
    assert np.all(got[~finite] == vt.NEG)
    assert np.all(got[:, -1] == vt.NEG)


@pytest.mark.parametrize("codes", CODE_SETS)
def test_ext_from_profiles_matches_fragment_tables(codes):
    """CudaBlock.from_profiles(codes=...) vs the packed host block of
    ProteinProfile.fragment_tables(codes=...) (the base-5 marginal path
    for ("N",), the codon path for the others)."""
    profiles = [sample_profile(s + 3, (s % 4) + 2) for s in range(5)]
    host = vc.pack_numpy_block(
        vt.build_profile_block(profiles, kpad=6, codes=codes)
    )
    dev = vc.CudaBlock.from_profiles(profiles, kpad=6, device="cpu",
                                     codes=codes)
    ntab = NTAB_OF[codes]
    assert dev.fm.shape == host.fm.shape == (5, ntab, vc.LANE)
    assert dev.fin.shape == host.fin.shape == (5, 2, ntab)
    for got, want in ((dev.fm, host.fm), (dev.fin, host.fin)):
        live = want > vt.NEG / 2
        np.testing.assert_allclose(got[live], want[live], atol=ATOL)
        assert torch.all(got[~live] <= vt.NEG / 2)
    assert torch.equal(dev.trans, host.trans)


# csrc/tables.cu: its term lists, its inputs and the blocks it builds.
# The kernel runs only on a card; here its term lists and its arithmetic
# are held against the synthesis it replaces there.

TERM_CODE_SETS = [(), ("N",), ("N", "R")]


@pytest.mark.parametrize("codes", TERM_CODE_SETS)
@pytest.mark.parametrize("eps", [0.01, 0.1])
def test_kernel_term_rows_are_the_length_terms(codes, eps):
    """Row f of term_rows lists _length_terms' (midx, pair, class) of its
    fragment in order, with term_coefs' coefficients through coef_row;
    the sentinel row has none."""
    from deciphon_tpu_torch.models.frame import frag_layout, term_coefs

    start, word, combo = tables.term_rows(codes)
    coef = tables.coef_row(eps)
    offsets, sentinel = frag_layout(4 + len(codes))
    S = 5 + len(codes)
    assert start.dtype == np.int32 and word.dtype == np.uint32
    assert combo.dtype == np.int32 and len(np.unique(combo)) == len(combo)
    assert len(start) == sentinel + 2 and start[0] == 0
    assert start[-1] == len(word) and start[-2] == start[-1]
    want_coef = term_coefs(eps)
    for length, (midx, pair, cls) in enumerate(
            tables._length_terms(codes), 1):
        F, T = midx.shape
        lo = offsets[length]
        assert np.all(np.diff(start[lo : lo + F + 1]) == T)
        w = word[start[lo] : start[lo + F]].astype(np.int64).reshape(F, T)
        np.testing.assert_array_equal(w & 0xFFFF, midx)
        cb = combo[w >> 16]
        np.testing.assert_array_equal((cb & 0xFF) * S + (cb >> 8 & 0xFF),
                                      pair)
        got = coef[cb >> 16]
        want = np.array([np.float32(want_coef[c]) for c in cls])
        np.testing.assert_array_equal(got, np.broadcast_to(want, (F, T)))


def kernel_mirror(me, qe, eps, codes):
    """csrc/tables.cu's arithmetic from its term lists, in torch: each
    row's staged (qe_i * qe_j) * c per combination, then per fragment
    row the terms summed first to last from 0 as f32 products of Me and
    those, and the log clamped at NEG.  [R, ntab]."""
    start, word, combo = tables.term_rows(codes)
    coef = torch.from_numpy(tables.coef_row(eps))
    cb = torch.from_numpy(combo.astype(np.int64))
    qqc = (qe[:, cb & 0xFF] * qe[:, cb >> 8 & 0xFF]) * coef[cb >> 16]
    w = torch.from_numpy(word.astype(np.int64))
    m, c = w & 0xFFFF, w >> 16
    out = torch.empty((me.shape[0], len(start) - 1))
    for f in range(len(start) - 1):
        acc = torch.zeros(me.shape[0])
        for t in range(start[f], start[f + 1]):
            acc = acc + me[:, m[t]] * qqc[:, c[t]]
        out[:, f] = torch.log(acc).clamp_min(vt.NEG)
    return out


@pytest.mark.parametrize("codes", [("N",), ("N", "R")])
def test_kernel_arithmetic_equals_the_synthesis(codes):
    """The kernel's sums over term_rows give synth_fragment_tables' bits
    (on the CPU, where both use torch's log), padding rows included."""
    rng = np.random.default_rng(7)
    codonp = np.zeros((4, 64), np.float32)
    codonp[:3] = rng.dirichlet(np.ones(64), size=3)
    qp = np.zeros((4, 5), np.float32)
    qp[:3, :4] = rng.dirichlet(np.ones(4), size=3)
    qp[:3, 4] = 1.0
    codonp, qp = torch.from_numpy(codonp), torch.from_numpy(qp)
    me, qe = tables._ext_inputs(codonp, qp, codes, 0.01)
    got = kernel_mirror(me, qe, 0.01, codes)
    want = tables.synth_fragment_tables(codonp, qp, 0.01, codes)
    assert torch.equal(got, want)
    assert torch.all(got[3] == vt.NEG)


def test_ext_inputs_are_the_compact_pack():
    """CompactInputs holds pack_compact's emis, qp, ine and inq bit for bit:
    the nodes first, then each profile's insert and null rows."""
    profiles = [sample_profile(s + 5, (s % 4) + 2) for s in range(6)]
    got = vc.CompactInputs.from_profiles(profiles, 6, "cpu")
    emis, qp, ine, inq, *_ = vc.pack_compact(profiles, 6, ("N",))
    B, Kp = 6, vc.LANE
    assert (got.B, got.kpad, got.eps) == (
        B, Kp, float(profiles[0].cfg.epsilon))
    n = B * Kp
    for t, want in ((got.emis[:n], emis), (got.qp[:n], qp),
                    (got.emis[n:], ine), (got.qp[n:], inq)):
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), want.reshape(t.shape))


def test_on_the_cpu_extended_blocks_take_the_synthesis(monkeypatch):
    """CPU tensors never reach the kernel: from_profiles(codes=...) and a
    store's extended block go through synth_fragment_tables, node and
    insert/null rows apart, and launch nothing."""
    calls = []
    synth = tables.synth_fragment_tables

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return synth(*args, **kwargs)

    monkeypatch.setattr(tables, "synth_fragment_tables", counted)
    before = tables.LAUNCHES["tables"]
    profiles = [sample_profile(s + 1, 3) for s in range(4)]
    blk = vc.CudaBlock.from_profiles(profiles, kpad=3, device="cpu",
                                     codes=("N",))
    assert blk.fm.shape == (4, NTAB_OF[("N",)], vc.LANE)
    assert calls == [4 * vc.LANE, 8]
    assert tables.LAUNCHES["tables"] == before


@pytest.fixture
def store(tmp_path):
    """A CPU Tables store over a 5-profile .dtp of two widths."""
    from deciphon_tpu_torch.db.format import TensorDB, write_db
    from deciphon_tpu_torch.models.h3reader import build_profile
    from deciphon_tpu_torch.models.h3writer import random_h3
    from deciphon_tpu_torch.ops.scan_engine import Tables

    path = str(tmp_path / "t.dtp")
    write_db(path, [build_profile(random_h3(s + 1, k, peak=0.9))
                    for s, k in enumerate((4, 7, 5, 40, 36))])
    return Tables(TensorDB.load(path), device="cpu")


@pytest.mark.parametrize("codes", [("N",), ("N", "R")])
def test_store_extended_block_shares_the_base_planes(store, codes):
    """A store's extended block holds the base-4 tile's own trans and
    ptrans tensors, and tables equal from_profiles' of the same
    profiles bit for bit."""
    assert len(store.blocks) == 2
    for blk in store.blocks:
        (base,) = store.tiles(blk)
        (ext,) = store.tiles(blk, codes)
        assert ext.blk.trans is base.blk.trans
        assert ext.blk.ptrans is base.blk.ptrans
        want = vc.CudaBlock.from_profiles(
            [store.db.profile(int(i)) for i in blk.chunk], kpad=blk.kpad,
            device="cpu", codes=codes)
        assert torch.equal(ext.blk.fm, want.fm)
        assert torch.equal(ext.blk.fin, want.fin)
        assert torch.equal(ext.blk.trans, want.trans)
        assert torch.equal(ext.blk.ptrans, want.ptrans)


def test_store_uploads_the_inputs_once(store, monkeypatch):
    """The first extended block builds every block's inputs; later ones,
    of any code set, reuse them."""
    built = []
    make = vc.CompactInputs.from_profiles
    monkeypatch.setattr(vc.CompactInputs, "from_profiles", classmethod(
        lambda cls, *a: built.append(a[1]) or make(*a)))
    for codes in (("N",), ("R",), ("N", "R")):
        for blk in store.blocks:
            list(store.tiles(blk, codes))
    assert built == [blk.kpad for blk in store.blocks]


@pytest.mark.parametrize("codes", [("N",), ("N", "R")])
def test_mesh_extended_tiles_come_from_shard_inputs(store, codes):
    """On a mesh the store uploads each profile shard's inputs once and
    builds each extended tile from them: every tile holds its own base-4
    tile's trans and ptrans, no two tiles share an fm or fin tensor, and
    each tile's tables are the unsharded block's columns bit for bit."""
    from deciphon_tpu_torch.ops.scan_engine import Tables
    from deciphon_tpu_torch.parallel.mesh import make_scan_mesh

    mesh = make_scan_mesh(profile_axis=2, seq_axis=2, devices=["cpu"] * 4)
    sharded = Tables(store.db, mesh=mesh)
    for blk, whole in zip(sharded.blocks, store.blocks):
        base = sharded.tiles(blk)
        ext = list(sharded.tiles(blk, codes))
        assert sorted(blk.ext) == sorted({t.p for t in base})
        for p, e in blk.ext.items():
            cols = next(t.cols for t in base if t.p == p)
            assert (e.B, e.kpad) == (len(cols), blk.kpad)
        (full,) = store.tiles(whole, codes)
        assert [(t.s, t.p) for t in ext] == [(t.s, t.p) for t in base]
        for t, b in zip(ext, base):
            assert t.blk.trans is b.blk.trans
            assert t.blk.ptrans is b.blk.ptrans
            assert torch.equal(t.blk.fm, full.blk.fm[t.cols])
            assert torch.equal(t.blk.fin, full.blk.fin[t.cols])
        ptrs = [x.data_ptr() for t in ext for x in (t.blk.fm, t.blk.fin)]
        assert len(set(ptrs)) == len(ptrs)
