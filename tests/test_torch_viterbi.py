"""The port's Viterbi and forward scoring vs the JAX package, on the CPU.

deciphon_tpu_torch/ops/viterbi_cuda.scores_plain is the plain version of
the CUDA kernel; on CPU tensors ``scores`` runs it.  It is held against
the XLA engine (viterbi_jax.viterbi_scores) and the Pallas kernel in
interpret mode, at atol 1e-5 for Viterbi (tests/test_viterbi_pallas.py:42)
and 2e-3 for forward (tests/test_forward.py:104), on base-4 and extended
(IUPAC) tables, and its packing against viterbi_pallas.pack_block
exactly.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.models.alphabet import DNA
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops import viterbi_pallas as vp
from deciphon_tpu.ops.emissions import fragment_indices
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops import viterbi_torch as vt

SEQS = ["ATGAAACGCATTAGCACC", "ACGT", "TTTCCCGGGAAA"]
LP = 24
FLAGS = [(True, False), (False, True)]
ATOL = 1e-5
FWD_ATOL = 2e-3


def _eidx(seqs, pad_to):
    return np.stack([
        vj.end_fragment_indices(fragment_indices(DNA.encode(s), pad_to=pad_to))
        for s in seqs
    ])


@pytest.fixture(scope="module")
def setup():
    # the fixture of tests/test_viterbi_pallas.py:16-35: 20 profiles,
    # cores 2..8 padded to 8 nodes
    profiles = [sample_profile(s + 1, (s % 7) + 2) for s in range(20)]
    block = vj.build_profile_block(profiles, kpad=8)
    slen = np.array([len(s) for s in SEQS], np.int32)
    return profiles, block, _eidx(SEQS, LP), slen


def test_host_helpers_match_jax(setup):
    profiles, block, eidx, slen = setup
    mine = vt.build_profile_block(profiles, kpad=8)
    for name in block._fields:
        np.testing.assert_array_equal(getattr(mine, name),
                                      np.asarray(getattr(block, name)))
    fidx = fragment_indices(DNA.encode(SEQS[0]), pad_to=LP)
    np.testing.assert_array_equal(
        vt.end_fragment_indices(fidx), vj.end_fragment_indices(fidx)
    )


@pytest.mark.parametrize("mh,h3", FLAGS + [(True, True), (False, False)])
def test_specials_match_jax(mh, h3):
    lens = np.array([1, 7, 255, 4000], np.int32)
    got = vt.specials(torch.from_numpy(lens), mh, h3)
    ref = vj._specials(lens, mh, h3)
    for k, v in ref.items():
        np.testing.assert_allclose(
            np.broadcast_to(np.asarray(got[k], np.float64), lens.shape),
            np.broadcast_to(np.asarray(v, np.float64), lens.shape),
            rtol=1e-6, err_msg=k,
        )


def test_pack_matches_pallas_pack(setup):
    """pack_numpy_block == vp.pack_block(group=16) un-grouped, exactly —
    including the -1e4 clamp of dead DD links in cdd (:799-811)."""
    _, block, _, _ = setup
    B, K = block.fm.shape[0], block.fm.shape[1]
    femis_m, femis_in, trans, nb = vp.pack_block(block, group=16)
    assert nb == B

    def ungroup(a):  # [P, X, 16, W] -> [P*16, X, W]
        P, X, G, W = a.shape
        return a.transpose(0, 2, 1, 3).reshape(P * G, X, W)[:B]

    got = vc.pack_numpy_block(block)
    np.testing.assert_array_equal(got.fm[:, :, :K], ungroup(femis_m)[..., :K])
    # femis_in is [P, NTAB, 2, 16]: profiles on the last axis
    fin = femis_in.transpose(0, 3, 2, 1).reshape(-1, 2, femis_in.shape[1])
    np.testing.assert_array_equal(got.fin, fin[:B])
    np.testing.assert_array_equal(got.trans[:, :, :K], ungroup(trans)[..., :K])
    # padding nodes past each core: dead DD links cost exactly 1e4 apiece
    cdd = got.trans[:, vc.P_CDD].numpy()
    steps = np.diff(cdd[:, :K], axis=1)
    assert abs(steps.min() + 1e4) < 1e-2  # f32 rounding of the cumsum
    # every padded node (also past K) is dead in the kernel layout
    assert torch.all(got.fm[:, :, K:] == vt.NEG)


@pytest.mark.parametrize("mh,h3", FLAGS)
def test_scores_match_xla_engine(setup, mh, h3):
    _, block, eidx, slen = setup
    ref_alt, ref_null = vj.viterbi_scores(
        block, eidx, slen, multi_hits=mh, hmmer3_compat=h3
    )
    alt, null = vt.viterbi_scores(
        block, eidx, slen, multi_hits=mh, hmmer3_compat=h3
    )
    assert alt.shape == (3, 20) and alt.dtype == torch.float32
    np.testing.assert_allclose(alt.numpy(), np.asarray(ref_alt), atol=ATOL)
    np.testing.assert_allclose(null.numpy(), np.asarray(ref_null), atol=ATOL)


@pytest.mark.parametrize("mh,h3", FLAGS)
def test_scores_match_pallas_interpret(setup, mh, h3):
    _, block, eidx, slen = setup
    ref_alt, ref_null = vp.viterbi_scores_pallas(
        block, eidx, slen, multi_hits=mh, hmmer3_compat=h3, interpret=True
    )
    alt, null = vt.viterbi_scores(
        block, eidx, slen, multi_hits=mh, hmmer3_compat=h3
    )
    np.testing.assert_allclose(alt.numpy(), ref_alt, atol=ATOL)
    np.testing.assert_allclose(null.numpy(), ref_null, atol=ATOL)


def test_long_reads_ragged_k129():
    """K=129 (padded to 160 here, 256 on the TPU) with cores down to 3,
    reads crossing the TPU kernel's 255-position chunk, and a 1-nt read
    whose lookbacks all reach before position 0."""
    rng = np.random.default_rng(11)
    profiles = [sample_profile(40 + s, k) for s, k in
                enumerate([129, 128, 64, 3])]
    block = vj.build_profile_block(profiles, kpad=129)
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in (300, 256, 1)]
    eidx = _eidx(seqs, 300)
    slen = np.array([len(s) for s in seqs], np.int32)
    ref_alt, ref_null = vj.viterbi_scores(block, eidx, slen)
    alt, null = vt.viterbi_scores(block, eidx, slen)
    assert torch.isfinite(alt).all()
    np.testing.assert_allclose(alt.numpy(), np.asarray(ref_alt), atol=ATOL)
    np.testing.assert_allclose(null.numpy(), np.asarray(ref_null), atol=ATOL)


def test_dead_dd_links_match_pallas_and_oracle():
    """Dead DD links inside the core (dd = -inf) go through the -1e4
    clamp of the packed cdd plane, as in the Pallas kernel, and score as
    the f64 oracle does.  (The XLA engine's NEG/1e6 clamp loses these
    scores in f32, so it is not the reference here.)"""
    from dataclasses import replace

    from deciphon_tpu.ops import viterbi_ref as vr

    prof = sample_profile(5, 12)
    dd = prof.dd_in.copy()
    dd[[4, 8]] = -np.inf
    prof = replace(prof, dd_in=dd)
    block = vj.build_profile_block([prof, sample_profile(6, 9)], kpad=12)
    rng = np.random.default_rng(1)
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in (40, 17, 3)]
    eidx = _eidx(seqs, 40)
    slen = np.array([len(s) for s in seqs], np.int32)
    alt, null = vt.viterbi_scores(block, eidx, slen)
    ref_alt, ref_null = vp.viterbi_scores_pallas(
        block, eidx, slen, interpret=True
    )
    np.testing.assert_allclose(alt.numpy(), ref_alt, atol=ATOL)
    np.testing.assert_allclose(null.numpy(), ref_null, atol=ATOL)
    for i, s in enumerate(seqs):
        ora = vr.viterbi_alt(prof, DNA.encode(s)).loglik
        assert alt[i, 0].item() == pytest.approx(ora, abs=1e-3)


def test_zero_length_rows_stay_neg(setup):
    """Batch-padding rows (length 0) are never captured: exactly NEG."""
    _, block, eidx, _ = setup
    slen = np.array([0, 4, 0], np.int32)
    alt, null = vt.viterbi_scores(block, eidx, slen)
    assert torch.all(alt[[0, 2]] == vt.NEG) and torch.all(null[[0, 2]] == vt.NEG)
    assert torch.all(alt[1] > vt.NEG / 2)


def test_cpu_scores_do_not_launch(setup):
    """A CPU block takes the plain version and counts no launch."""
    _, block, eidx, slen = setup
    before = dict(vc.LAUNCHES)
    blk = vc.pack_numpy_block(block)
    for semiring in vc.SEMIRINGS:
        vc.scores(blk, torch.from_numpy(eidx), torch.from_numpy(slen),
                  semiring=semiring)
    assert vc.LAUNCHES == before


def test_unknown_semiring_raises(setup):
    _, block, eidx, slen = setup
    with pytest.raises(ValueError, match="semiring"):
        vc.scores(vc.pack_numpy_block(block), torch.from_numpy(eidx),
                  torch.from_numpy(slen), semiring="sum")


@pytest.fixture(scope="module")
def fwd_batch():
    # the fixture of tests/test_forward.py:54-71
    rng = np.random.default_rng(9)
    profs = [sample_profile(s + 1, int(rng.integers(2, 9))) for s in range(6)]
    block = vj.build_profile_block(profs)
    seqs = ["".join(rng.choice(list("ACGT"), int(rng.integers(8, 24))))
            for _ in range(5)]
    slen = np.array([len(s) for s in seqs], np.int32)
    return profs, seqs, block, _eidx(seqs, 24), slen


@pytest.mark.parametrize("mh,h3", FLAGS)
def test_forward_matches_xla_engine(fwd_batch, mh, h3):
    _, _, block, eidx, slen = fwd_batch
    ref_alt, ref_null = vj.forward_scores(block, eidx, slen, mh, h3)
    alt, null = vt.forward_scores(block, eidx, slen, mh, h3)
    np.testing.assert_allclose(alt.numpy(), np.asarray(ref_alt),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(null.numpy(), np.asarray(ref_null),
                               atol=FWD_ATOL)
    # forward mass is at least the best path's
    vit, _ = vt.viterbi_scores(block, eidx, slen, mh, h3)
    assert torch.all(alt >= vit - 1e-4)


def test_forward_matches_pallas_interpret(fwd_batch):
    from deciphon_tpu.models.frame import FRAG_SENTINEL

    _, seqs, block, eidx, slen = fwd_batch
    # the TPU kernel packs 255-position chunks (tests/test_forward.py:92)
    eidx_p = np.full((len(seqs), 255, 5), FRAG_SENTINEL, np.int32)
    eidx_p[:, : eidx.shape[1]] = eidx
    ref_alt, ref_null = vp.viterbi_scores_pallas(
        block, eidx_p, slen, interpret=True, semiring="logsumexp"
    )
    alt, null = vt.viterbi_scores(block, eidx, slen, semiring="logsumexp")
    np.testing.assert_allclose(alt.numpy(), ref_alt, atol=FWD_ATOL)
    np.testing.assert_allclose(null.numpy(), ref_null, atol=FWD_ATOL)


def test_forward_matches_oracle(fwd_batch):
    from deciphon_tpu.ops import viterbi_ref as vr

    profs, seqs, block, eidx, slen = fwd_batch
    alt, null = vt.forward_scores(block, eidx, slen)
    for si, s in enumerate(seqs):
        enc = DNA.encode(s)
        for bi, prof in enumerate(profs):
            assert alt[si, bi].item() == pytest.approx(
                vr.forward_alt(prof, enc), abs=FWD_ATOL)
            assert null[si, bi].item() == pytest.approx(
                vr.forward_null(prof, enc), abs=FWD_ATOL)


def test_forward_dead_dd_links_match_oracle():
    """Forward through the -1e4 clamp of dead DD links (the telescoped
    D-chain under logcumsumexp) scores as the f64 forward oracle and the
    Pallas kernel in interpret mode."""
    from dataclasses import replace

    from deciphon_tpu.models.frame import FRAG_SENTINEL
    from deciphon_tpu.ops import viterbi_ref as vr

    prof = sample_profile(5, 12)
    dd = prof.dd_in.copy()
    dd[[4, 8]] = -np.inf
    prof = replace(prof, dd_in=dd)
    block = vj.build_profile_block([prof, sample_profile(6, 9)], kpad=12)
    rng = np.random.default_rng(1)
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in (40, 17, 3)]
    eidx = _eidx(seqs, 40)
    slen = np.array([len(s) for s in seqs], np.int32)
    alt, null = vt.forward_scores(block, eidx, slen)
    for i, s in enumerate(seqs):
        ora = vr.forward_alt(prof, DNA.encode(s))
        assert alt[i, 0].item() == pytest.approx(ora, abs=FWD_ATOL)
    eidx_p = np.full((3, 255, 5), FRAG_SENTINEL, np.int32)
    eidx_p[:, :40] = eidx
    ref_alt, ref_null = vp.viterbi_scores_pallas(
        block, eidx_p, slen, interpret=True, semiring="logsumexp"
    )
    np.testing.assert_allclose(alt.numpy(), ref_alt, atol=FWD_ATOL)
    np.testing.assert_allclose(null.numpy(), ref_null, atol=FWD_ATOL)


def _iupac_case(codes, seed):
    """Profiles, a base-(4+D) block and reads holding ``codes``, with
    codes[0] at positions 1-5 (lookbacks that also reach the sentinel
    row) and codes[-1] mid-read, as tests/test_viterbi_pallas.py:242."""
    from deciphon_tpu.models.alphabet import encode_extended

    rng = np.random.default_rng(seed)
    profiles = [
        sample_profile(s + 1, int(rng.integers(3, 20))) for s in range(8)
    ]
    block = vj.build_profile_block(profiles, kpad=20, codes=codes)
    reads = []
    for k in range(5):
        r = list(rng.choice(list("ACGT"), int(rng.integers(14, 40))))
        r[k] = codes[0]
        r[9] = codes[-1]
        reads.append("".join(r))
    reads.append("".join(codes * 3)[:3])  # every fragment ambiguous
    encs = []
    for r in reads:
        enc, got = encode_extended(r)
        assert got == tuple(sorted(set(codes)))
        encs.append(enc)
    base = 4 + len(codes)
    eidx = np.stack([
        vt.end_fragment_indices(
            fragment_indices(e, pad_to=40, base=base), base=base
        )
        for e in encs
    ])
    slen = np.array([len(e) for e in encs], np.int32)
    return profiles, block, eidx, slen, encs


@pytest.mark.parametrize("codes", [("N",), ("N", "R")])
@pytest.mark.parametrize("semiring", ["max", "logsumexp"])
def test_extended_tables_match_xla_engine(codes, semiring):
    profiles, block, eidx, slen, _ = _iupac_case(codes, 7)
    assert block.fm.shape[-1] == {1: 3906, 2: 9331}[len(codes)]
    ref_alt, ref_null = vj.viterbi_scores(block, eidx, slen,
                                          semiring=semiring)
    alt, null = vt.viterbi_scores(block, eidx, slen, semiring=semiring)
    tol = ATOL if semiring == "max" else FWD_ATOL
    assert torch.isfinite(alt).all()
    np.testing.assert_allclose(alt.numpy(), np.asarray(ref_alt), atol=tol)
    np.testing.assert_allclose(null.numpy(), np.asarray(ref_null), atol=tol)


@pytest.mark.parametrize("semiring", ["max", "logsumexp"])
def test_extended_tables_match_pallas_interpret(semiring):
    """Base-5 tables through the TPU kernel (interpret mode) and the
    port's plain version agree."""
    from deciphon_tpu.models.frame import frag_layout

    profiles, block, eidx, slen, _ = _iupac_case(("N",), 3)
    eidx_p = np.full((len(slen), 255, 5), frag_layout(5)[1], np.int32)
    eidx_p[:, : eidx.shape[1]] = eidx
    ref_alt, ref_null = vp.viterbi_scores_pallas(
        block, eidx_p, slen, interpret=True, semiring=semiring
    )
    alt, null = vt.viterbi_scores(block, eidx, slen, semiring=semiring)
    tol = ATOL if semiring == "max" else FWD_ATOL
    np.testing.assert_allclose(alt.numpy(), ref_alt, atol=tol)
    np.testing.assert_allclose(null.numpy(), ref_null, atol=tol)


def test_extended_sentinel_is_last_row():
    """Base-(4+D) end-fragment indices point lookbacks before position 0
    at the LAST row of the taller table (3905 at base 5), as the JAX
    helper does; the block's sentinel row is NEG."""
    from deciphon_tpu.models.alphabet import encode_extended

    enc, codes = encode_extended("NACGTRNA")
    base = 4 + len(codes)
    fidx = fragment_indices(enc, pad_to=10, base=base)
    got = vt.end_fragment_indices(fidx, base=base)
    np.testing.assert_array_equal(got, vj.end_fragment_indices(fidx, base))
    block = vt.build_profile_block([sample_profile(1, 4)], codes=codes)
    ntab = block.fm.shape[-1]
    assert got[0, 1:].tolist() == [ntab - 1] * 4
    assert np.all(block.fm[..., ntab - 1] == vt.NEG)
    assert np.all(block.fn[:, ntab - 1] == vt.NEG)
