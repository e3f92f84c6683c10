"""The port's multi-process scan (parallel/distributed.py) on the CPU.

Two OS processes join one gloo process group over localhost, as
tests/test_distributed.py runs the JAX package's two processes.  Each
runs ``worker_parity_check`` (its tiles against the unsharded plain
version) on a reads-sharded and on a profile-sharded mesh, and saves its
tiles of the same fixture; this process holds every tile against the
JAX package's ``vj.viterbi_scores`` at atol 1e-5.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist
from deciphon_tpu_torch.parallel import distributed as pd

out = sys.argv[1]
pd.initialize()
rank = dist.get_rank()
profiles, eidx, slen = pd.parity_fixture()
for axis in (None, 2):
    pd.worker_parity_check(profile_axis=axis, device="cpu")
    mesh = pd.global_scan_mesh(axis, device="cpu")
    tiles = pd.global_viterbi_scores(mesh, profiles, eidx, slen)
    arrays = {}
    for j, (rows, cols, alt, null) in enumerate(tiles):
        arrays.update({f"rows{j}": rows, f"cols{j}": cols,
                       f"alt{j}": alt.numpy(), f"null{j}": null.numpy()})
    np.savez(f"{out}/rank{rank}_axis{axis}.npz", **arrays)
dist.destroy_process_group()
print("PARITY_OK", rank, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiles(path):
    """[(rows, cols, alt, null)] saved by a worker."""
    z = np.load(path)
    n = sum(k.startswith("rows") for k in z.files)
    return [tuple(z[f"{k}{j}"] for k in ("rows", "cols", "alt", "null"))
            for j in range(n)]


@pytest.fixture(scope="module")
def jax_scores():
    """vj.viterbi_scores on the JAX package's worker_parity_check
    fixture (seed 7)."""
    from deciphon_tpu.models.alphabet import DNA
    from deciphon_tpu.models.h3reader import build_profile
    from deciphon_tpu.models.h3writer import random_h3
    from deciphon_tpu.ops import viterbi_jax as vj
    from deciphon_tpu.ops.emissions import fragment_indices

    rng = np.random.default_rng(7)
    profiles = [build_profile(random_h3(s + 1, 5, peak=0.8))
                for s in range(8)]
    seqs = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(6)]
    eidx = np.stack([
        vj.end_fragment_indices(fragment_indices(DNA.encode(s), pad_to=40))
        for s in seqs
    ])
    slen = np.array([len(s) for s in seqs], np.int32)
    alt, null = vj.viterbi_scores(vj.build_profile_block(profiles), eidx,
                                  slen)
    return np.asarray(alt), np.asarray(null)


def test_two_process_scan_matches_jax(tmp_path, jax_scores):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {
            "PATH": os.environ.get("PATH", os.defpath),
            "HOME": os.environ.get("HOME", str(tmp_path)),
            "PYTHONPATH": REPO,
            "OMP_NUM_THREADS": "1",
            "DCP_COORDINATOR": f"127.0.0.1:{port}",
            "DCP_NUM_PROCS": "2",
            "DCP_PROC_ID": str(pid),
        }
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO,
        ))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
        assert "PARITY_OK" in out, f"no parity marker\n{out}\n{err}"

    ref_alt, ref_null = jax_scores
    for axis in (None, 2):
        seen = np.zeros(ref_alt.shape, int)
        for rank in range(2):
            tiles = _tiles(tmp_path / f"rank{rank}_axis{axis}.npz")
            assert tiles, f"rank {rank} holds no tile (axis {axis})"
            for rows, cols, alt, null in tiles:
                cell = np.ix_(rows, cols)
                np.testing.assert_allclose(alt, ref_alt[cell], atol=1e-5)
                np.testing.assert_allclose(null, ref_null[cell], atol=1e-5)
                seen[cell] += 1
        # the two processes' tiles cover every cell once
        assert (seen == 1).all(), axis


def test_cuda_without_gpu_raises(monkeypatch):
    """A multi-process mesh asked for CUDA never falls to the CPU."""
    import torch

    from deciphon_tpu_torch.parallel import distributed as pd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pd.global_scan_mesh()


def test_initialize_needs_the_cluster(monkeypatch):
    """Nothing on a GPU machine names the cluster: without the
    coordinator, the process count or the process id, initialize
    raises before it touches torch.distributed."""
    from deciphon_tpu_torch.parallel import distributed as pd

    for k in ("DCP_COORDINATOR", "DCP_NUM_PROCS", "DCP_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="DCP_COORDINATOR"):
        pd.initialize()
    monkeypatch.setenv("DCP_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DCP_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="DCP_PROC_ID"):
        pd.initialize()


def test_profile_shards_follow_the_padded_axis():
    """Shards of ceil(n / shards), as _pad_axis0 pads the JAX package's
    profile axis, without its padding rows."""
    from deciphon_tpu.parallel.pallas_scan import _pad_axis0
    from deciphon_tpu_torch.parallel.sharded_scan import profile_shards

    for n, k in ((8, 2), (5, 2), (5, 4), (1, 3), (13, 4)):
        padded = _pad_axis0(np.arange(n), k, -1)
        want = [s[s >= 0] for s in np.split(padded, k)]
        got = profile_shards(n, k)
        assert [list(g) for g in got] == [list(w) for w in want]
