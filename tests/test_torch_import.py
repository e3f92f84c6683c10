"""deciphon_tpu_torch never imports jax or deciphon_tpu, and never falls
back quietly.

The no-import check runs in a subprocess (tests/conftest.py imports jax
into the pytest process itself) and, on the source, as an AST walk.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deciphon_tpu_torch.db.format import TensorDB, write_db
from deciphon_tpu_torch.models.h3reader import press_file
from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
from deciphon_tpu_torch.ops import _build
from deciphon_tpu_torch.ops import scan_engine as pse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np
import deciphon_tpu_torch
assert "jax" not in sys.modules, "jax preloaded by the interpreter"
for m in pkgutil.walk_packages(deciphon_tpu_torch.__path__,
                               "deciphon_tpu_torch."):
    importlib.import_module(m.name)
from deciphon_tpu_torch.db.format import TensorDB
from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
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
# best hits, and one share-nothing partition
assert main(["scan", f"{tmp}/s.dtp", f"{tmp}/r.fa", "-o", f"{tmp}/b.tsv",
             "--device", "cpu", "--best-hit"]) == 0
assert p.accession in open(f"{tmp}/b.tsv").read()
assert main(["scan", f"{tmp}/s.dtp", f"{tmp}/r.fa", "-o", f"{tmp}/h.tsv",
             "--device", "cpu", "--shard", "2/2"]) == 0
# the daemon: a press job, then a scan job, one serve --single-run each
from deciphon_tpu_torch.server.fake_sched import FakeScheduler

fake = FakeScheduler(spool_dir=f"{tmp}/spool")
url = fake.serve()
host, port = url.rsplit("/", 1)[1].split(":")
with open(f"{tmp}/.env", "w") as fp:
    fp.write(f"API_HOST={host}\nAPI_PORT={port}\n")
serve = ["serve", "--env", f"{tmp}/.env", "--single-run", "--device", "cpu",
         "--cache-dir", f"{tmp}/cache"]
fake.add_hmm("d.hmm", open(f"{tmp}/s.hmm", "rb").read())
assert main(serve) == 0
db = next(iter(fake.dbs.values()))
fake.add_scan(db.id, [("r1", read)])
assert main(serve) == 0
fake.shutdown()
assert all(j.state == "done" for j in fake.jobs.values()), fake.jobs
assert p.accession in fake.products[-1]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "deciphon_tpu"))
assert not bad, bad
print("NO-JAX OK")
"""


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_port_sources_import_no_jax_package():
    """No module of deciphon_tpu_torch, and not chip_smoke.py, imports
    jax or deciphon_tpu, at any depth of the source."""
    files = sorted(Path(REPO, "deciphon_tpu_torch").rglob("*.py"))
    files.append(Path(REPO, "chip_smoke.py"))
    assert len(files) > 30
    bad = {
        (str(f.relative_to(REPO)), m)
        for f in files for m in _imported_modules(f)
        if m.split(".")[0] in ("jax", "jaxlib", "deciphon_tpu")
    }
    assert not bad, sorted(bad)


def test_port_never_imports_jax(tmp_path):
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # small tensors; workers run in parallel
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
