"""deciphon_tpu_torch never imports jax, and never falls back quietly.

The no-jax check runs in a subprocess: tests/conftest.py imports jax into
the pytest process itself.
"""

import os
import subprocess
import sys

import pytest
import torch

from deciphon_tpu.db.format import TensorDB, write_db
from deciphon_tpu.models.h3reader import press_file
from deciphon_tpu.models.h3writer import random_h3, write_h3
from deciphon_tpu_torch.ops import _build
from deciphon_tpu_torch.ops import scan_engine as pse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, sys
import numpy as np
assert "jax" not in sys.modules, "jax preloaded by the interpreter"
for m in (
    "deciphon_tpu_torch", "deciphon_tpu_torch.ops.viterbi_torch",
    "deciphon_tpu_torch.ops.tables", "deciphon_tpu_torch.ops.viterbi_cuda",
    "deciphon_tpu_torch.ops._build", "deciphon_tpu_torch.ops.viterbi_trace",
    "deciphon_tpu_torch.ops.scan_engine", "deciphon_tpu_torch.cli.main",
):
    importlib.import_module(m)
from deciphon_tpu.db.format import TensorDB
from deciphon_tpu.models.alphabet import STANDARD_CODE
from deciphon_tpu.models.h3writer import random_h3, write_h3
from deciphon_tpu_torch.cli.main import main
tmp = sys.argv[1]
with open(f"{tmp}/s.hmm", "w") as fp:
    write_h3(fp, [random_h3(s + 1, k, peak=0.9) for s, k in enumerate((4, 6))])
assert main(["press", f"{tmp}/s.hmm", "-o", f"{tmp}/s.dtp"]) == 0
p = TensorDB.load(f"{tmp}/s.dtp").profile(1)
read = "".join(STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
               for b in map(int, np.argmax(p.match_codonp, 1)))
with open(f"{tmp}/r.fa", "w") as fp:
    fp.write(f">r1\n{read}\n")
assert main(["scan", f"{tmp}/s.dtp", f"{tmp}/r.fa", "-o", f"{tmp}/p.tsv",
             "--device", "cpu"]) == 0
assert p.accession in open(f"{tmp}/p.tsv").read()
# a forward scan of one read holding N (extended tables)
with open(f"{tmp}/n.fa", "w") as fp:
    fp.write(f">n1\n{read[:4]}N{read[5:]}\n")
assert main(["scan", f"{tmp}/s.dtp", f"{tmp}/n.fa", "-o", f"{tmp}/f.tsv",
             "--device", "cpu", "--forward"]) == 0
assert p.accession in open(f"{tmp}/f.tsv").read()
jax_mods = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
assert not jax_mods, jax_mods
print("NO-JAX OK")
"""


def test_port_never_imports_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO-JAX OK" in proc.stdout


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_import")
    with open(tmp / "s.hmm", "w") as fp:
        write_h3(fp, [random_h3(1, 5, peak=0.9)])
    write_db(str(tmp / "s.dtp"), press_file(str(tmp / "s.hmm")))
    return TensorDB.load(str(tmp / "s.dtp"))


def test_cuda_without_gpu_raises(db, monkeypatch):
    """Asking for CUDA on a machine without a GPU raises; it never runs
    on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pse.ScanEngine(db, device="cuda")
    with pytest.raises(RuntimeError):
        pse.resolve_device("cuda:0")
    assert pse.ScanEngine(db, device="cpu").device.type == "cpu"


def test_unsupported_device_raises(db):
    with pytest.raises(ValueError):
        pse.ScanEngine(db, device="meta")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """The kernel build raises when there is no compiler (no fallback)."""
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
