"""The port's traceback (pass 2) vs the JAX package's, on the CPU.

deciphon_tpu_torch/ops/viterbi_trace must give IDENTICAL state paths and
match strings to deciphon_tpu.ops.viterbi_trace.viterbi_alt_batch, on the
patterns of tests/test_viterbi_trace.py, and logliks within 1e-4.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.models import codec
from deciphon_tpu.models.alphabet import DNA
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu.ops import viterbi_trace as jtr
from deciphon_tpu_torch.models import codec as pcodec
from deciphon_tpu_torch.models.profile import sample_profile as psample
from deciphon_tpu_torch.ops import viterbi_trace as ptr


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers at
    once, and torch's default of one thread per core oversubscribes the
    cores many times over (these tensors are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LP = 32


def cases(sample=sample_profile):
    """(profile, read) pairs; ``sample`` is the JAX package's
    sample_profile or the port's, on the same seeds."""
    rng = np.random.default_rng(3)
    out = []
    for trial in range(6):
        prof = sample(trial + 1, int(rng.integers(2, 9)))
        L = int(rng.integers(4, LP))
        out.append((prof, "".join(rng.choice(list("ACGT"), L))))
    return out


@pytest.mark.parametrize("mh,h3", [(True, False), (False, False),
                                   (True, True)])
def test_paths_match_jax_batch(mh, h3):
    cs = cases()
    pprofs = [p for p, _ in cases(psample)]
    profs = [p for p, _ in cs]
    encs = [DNA.encode(s) for _, s in cs]
    got = ptr.viterbi_alt_batch(pprofs, encs, mh, h3, kpad=8)
    ref = jtr.viterbi_alt_batch(profs, encs, mh, h3, kpad=8, pad_to=LP)
    assert len(got) == len(ref) == len(cs)
    for g, r, (prof, seq), pprof, enc in zip(got, ref, cs, pprofs, encs):
        assert g.path == r.path
        assert g.loglik == pytest.approx(r.loglik, abs=1e-4)
        assert pcodec.render_match(pcodec.match_steps(pprof, seq, g.path)) == (
            codec.render_match(codec.match_steps(prof, seq, r.path))
        )
        # and the f64 oracle agrees on the path
        ora = vr.viterbi_alt(prof, enc, multi_hits=mh, hmmer3_compat=h3)
        assert g.path == ora.path


def test_padding_is_inert():
    """Node padding and batch padding (hit axis to a power of two) change
    neither the path nor the score."""
    cs = cases(psample)[:3]
    profs = [p for p, _ in cs]
    encs = [DNA.encode(s) for _, s in cs]
    base = ptr.viterbi_alt_batch(profs, encs)
    padded = ptr.viterbi_alt_batch(profs, encs, kpad=40)
    for a, b in zip(base, padded):
        assert a.path == b.path
        assert a.loglik == pytest.approx(b.loglik, abs=1e-4)


def test_walk_covers_read():
    prof, seq = cases(psample)[1]
    (res,) = ptr.viterbi_alt_batch([prof], [DNA.encode(seq)])
    assert sum(l for _, l in res.path) == len(seq)


@pytest.mark.parametrize("codes", [("N",), ("N", "R")])
def test_paths_with_codes_match_jax_batch(codes):
    """Reads holding IUPAC codes trace on the extended tables: paths
    identical to vtr.viterbi_alt_batch(codes=...) and the f64 oracle,
    match strings identical."""
    from deciphon_tpu.models.alphabet import encode_extended

    rng = np.random.default_rng(len(codes))
    profs, pprofs, reads = [], [], []
    for trial in range(5):
        k = int(rng.integers(2, 9))
        profs.append(sample_profile(trial + 11, k))
        pprofs.append(psample(trial + 11, k))
        r = list(rng.choice(list("ACGT"), int(rng.integers(8, LP))))
        r[trial % 4] = codes[0]
        r[-2] = codes[-1]
        reads.append("".join(r))
    encs = []
    for r in reads:
        enc, got = encode_extended(r)
        assert got == codes
        encs.append(enc)
    got = ptr.viterbi_alt_batch(pprofs, encs, kpad=8, codes=codes)
    ref = jtr.viterbi_alt_batch(profs, encs, kpad=8, pad_to=LP, codes=codes)
    for g, r, prof, pprof, seq, enc in zip(got, ref, profs, pprofs, reads,
                                           encs):
        assert g.path == r.path
        assert g.loglik == pytest.approx(r.loglik, abs=1e-4)
        assert pcodec.render_match(pcodec.match_steps(pprof, seq, g.path)) == (
            codec.render_match(codec.match_steps(prof, seq, r.path))
        )
        assert g.path == vr.viterbi_alt(prof, enc, codes=codes).path
