"""The port's Viterbi scoring vs the JAX package, on the CPU.

deciphon_tpu_torch/ops/viterbi_cuda.scores_plain is the plain version of
the CUDA kernel; on CPU tensors ``scores`` runs it.  It is held against
the XLA engine (viterbi_jax.viterbi_scores) and the Pallas kernel in
interpret mode, at atol 1e-5 (tests/test_viterbi_pallas.py:42), and its
packing against viterbi_pallas.pack_block exactly.
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
    before = vc.LAUNCHES
    blk = vc.pack_numpy_block(block)
    vc.scores(blk, torch.from_numpy(eidx), torch.from_numpy(slen))
    assert vc.LAUNCHES == before
