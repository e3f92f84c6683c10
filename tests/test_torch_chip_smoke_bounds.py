"""The yardsticks of chip_smoke.py, on the CPU.

chip_smoke.py bounds the Viterbi kernel by the recurrence's work on the
core nodes at the card's f32 issue rate, and holds forward on long reads
against the plain version in f64.  Its top level is numpy-only, so it
imports here.  The f64 plain version (viterbi_cuda.scores_plain with
dtype=torch.float64, on a block packed in f64) is held against the
port's f64 oracle (ops/viterbi_ref.py) and the JAX package's, under both
semirings.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from deciphon_tpu.models.alphabet import DNA as JDNA
from deciphon_tpu.models.profile import sample_profile as jsample
from deciphon_tpu.ops import viterbi_ref as jvr
from deciphon_tpu_torch.models.alphabet import DNA
from deciphon_tpu_torch.models.profile import sample_profile
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops import viterbi_ref as vr
from deciphon_tpu_torch.ops import viterbi_torch as vt
from deciphon_tpu_torch.ops.emissions import fragment_indices


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CORES = (40, 12)
LENS = (1, 5, 37, 120, 300)
CLOCK = 1.98e9


def _reads():
    rng = np.random.default_rng(3)
    return ["".join(rng.choice(list("ACGT"), n)) for n in LENS]


def _case(dtype=np.float32, kpad=None):
    profiles = [sample_profile(3 + j, k) for j, k in enumerate(CORES)]
    reads = _reads()
    eidx = np.stack([
        vt.end_fragment_indices(fragment_indices(DNA.encode(r),
                                                 pad_to=max(LENS)))
        for r in reads
    ])
    blk = vc.pack_numpy_block(
        vt.build_profile_block(profiles, kpad=kpad, dtype=dtype), dtype)
    slen = np.array(LENS, np.int32)
    return profiles, reads, blk, torch.from_numpy(eidx), torch.from_numpy(slen)


def test_viterbi_bound_counts_core_nodes_at_issue_rate():
    _, _, blk, eidx, slen = _case()
    assert blk.kpad == 64
    nbytes, cells = cs.launch_work(blk, eidx, slen, "max", sum(CORES))
    assert cells == sum(LENS) * 52
    rate = cs.SMS * cs.F32_LANES * CLOCK
    assert cs.ops_seconds("max", CLOCK) == cs.MAX_OPS / rate
    assert cs.MAX_OPS == 34
    ms, by = cs.bound(nbytes, cells, "max", CLOCK)
    t_ops, t_bytes = cells * cs.MAX_OPS / rate, nbytes / cs.PEAK_BYTES
    assert ms == pytest.approx(1e3 * max(t_ops, t_bytes), rel=1e-12)
    assert by == ("operations" if t_ops > t_bytes else "bytes")
    # padding never enters the count
    _, _, wide, _, _ = _case(kpad=128)
    assert cs.launch_work(wide, eidx, slen, "max", sum(CORES))[1] == cells


@pytest.mark.parametrize("semiring", ["max", "logsumexp"])
@pytest.mark.parametrize("mh,h3", [(True, False), (False, True)])
def test_f64_plain_equals_f64_oracles(semiring, mh, h3):
    profiles, reads, blk, eidx, slen = _case(np.float64)
    assert blk.fm.dtype == torch.float64
    alt, null = vc.scores_plain(blk, eidx, slen, mh, h3, semiring,
                                dtype=torch.float64)
    assert alt.dtype == null.dtype == torch.float64
    jprofs = [jsample(3 + j, k) for j, k in enumerate(CORES)]
    for si, r in enumerate(reads):
        enc, jenc = DNA.encode(r), JDNA.encode(r)
        for bi, (p, jp) in enumerate(zip(profiles, jprofs)):
            if semiring == "max":
                mine = (vr.viterbi_alt(p, enc, mh, h3).loglik,
                        vr.viterbi_null(p, enc, mh, h3).loglik)
                ref = (jvr.viterbi_alt(jp, jenc, mh, h3).loglik,
                       jvr.viterbi_null(jp, jenc, mh, h3).loglik)
            else:
                mine = (vr.forward_alt(p, enc, mh, h3),
                        vr.forward_null(p, enc, mh, h3))
                ref = (jvr.forward_alt(jp, jenc, mh, h3),
                       jvr.forward_null(jp, jenc, mh, h3))
            assert mine == ref  # the port's oracle is the JAX package's
            got = (alt[si, bi].item(), null[si, bi].item())
            for g, w in zip(got, ref):
                assert abs(g - w) <= 1e-9, (si, bi, g, w)


@pytest.mark.parametrize("semiring", ["max", "logsumexp"])
def test_f32_plain_unchanged_by_dtype_argument(semiring):
    """The f32 path is the default, and an f32 block cast to f64 runs
    the same recurrence: f64 agrees with f32 to f32's rounding, which
    accumulates over 300 positions at |score| ~ 450 (chip_smoke.py's
    forward tolerance)."""
    _, _, blk, eidx, slen = _case()
    a32, n32 = vc.scores_plain(blk, eidx, slen, semiring=semiring)
    b32, m32 = vc.scores_plain(blk, eidx, slen, semiring=semiring,
                               dtype=torch.float32)
    assert a32.dtype == torch.float32
    assert torch.equal(a32, b32) and torch.equal(n32, m32)
    a64, n64 = vc.scores_plain(blk, eidx, slen, semiring=semiring,
                               dtype=torch.float64)
    torch.testing.assert_close(a64.float(), a32, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(n64.float(), n32, atol=1e-3, rtol=1e-5)


def test_top_level_imports_no_torch():
    """chip_smoke.py imports torch and the port only inside its phases,
    so it starts (and, without a card or the package, fails) cleanly."""
    code = ("import sys; import chip_smoke; "
            "assert 'torch' not in sys.modules; "
            "assert not any(m.startswith('deciphon') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=cs.__file__.rsplit("/", 1)[0])
