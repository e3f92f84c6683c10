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
