"""The port's f64 plain version vs the JAX package's f64 XLA engine.

The JAX engine computes in f64 only under JAX_ENABLE_X64, which must be
set before jax starts, so the comparison runs in a subprocess.  On the
fixture of tests/test_f64.py, ``viterbi_cuda.scores_plain(...,
dtype=torch.float64)`` on ``pack_numpy_block(..., np.float64)`` must
equal ``vj.viterbi_scores`` within 1e-9 and ``vj.forward_scores`` within
1e-8, the tolerances tests/test_f64.py holds the JAX engine to against
the f64 oracle.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import torch
from deciphon_tpu.models.alphabet import DNA
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops.emissions import fragment_indices
from deciphon_tpu_torch.models.profile import sample_profile as psample
from deciphon_tpu_torch.ops import viterbi_cuda as vc
from deciphon_tpu_torch.ops import viterbi_torch as vt

rng = np.random.default_rng(23)
ks = [int(rng.integers(2, 9)) for _ in range(4)]
seqs = ["".join(rng.choice(list("ACGT"), int(rng.integers(8, 30))))
        for _ in range(4)]
eidx = np.stack([
    vj.end_fragment_indices(fragment_indices(DNA.encode(s), pad_to=32))
    for s in seqs
])
slen = np.array([len(s) for s in seqs], np.int32)
block = vj.build_profile_block([sample_profile(s + 1, k)
                                for s, k in enumerate(ks)], dtype=np.float64)
assert block.fm.dtype == np.float64
pblk = vc.pack_numpy_block(vt.build_profile_block(
    [psample(s + 1, k) for s, k in enumerate(ks)], dtype=np.float64),
    np.float64)
for semiring, fn, tol in (("max", vj.viterbi_scores, 1e-9),
                          ("logsumexp", vj.forward_scores, 1e-8)):
    want = fn(block, eidx, slen)
    got = vc.scores_plain(pblk, torch.from_numpy(eidx),
                          torch.from_numpy(slen), semiring=semiring,
                          dtype=torch.float64)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        d = float(np.abs(g.numpy() - np.asarray(w, np.float64)).max())
        assert d <= tol, (semiring, d)
        print(semiring, "max|d|", d)
print("F64 OK")
"""


def test_f64_plain_equals_jax_f64_engine():
    env = {
        "PATH": os.environ.get("PATH", os.defpath),
        "HOME": os.environ.get("HOME", REPO),
        "PYTHONPATH": REPO,
        "OMP_NUM_THREADS": "1",
        "JAX_PLATFORMS": "cpu",
        "JAX_ENABLE_X64": "1",
    }
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "F64 OK" in proc.stdout, proc.stdout + proc.stderr
