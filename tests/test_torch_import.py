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
import contextlib, importlib, pkgutil, sys, traceback


@contextlib.contextmanager
def step(name):
    # each step fails with its own message, which names it
    try:
        yield
    except BaseException as exc:
        traceback.print_exc()
        sys.exit(f"step {name!r} failed: {type(exc).__name__}: {exc}")
    print(f"step ok: {name}", flush=True)


def no_jax(where):
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "deciphon_tpu"))
    assert not bad, f"{where}: {bad}"


with step("interpreter start"):
    no_jax("loaded before the port")
with step("import every module of the port"):
    import numpy as np
    import deciphon_tpu_torch
    for m in pkgutil.walk_packages(deciphon_tpu_torch.__path__,
                                   "deciphon_tpu_torch."):
        importlib.import_module(m.name)
    from deciphon_tpu_torch.db.format import TensorDB
    from deciphon_tpu_torch.models.alphabet import STANDARD_CODE
    from deciphon_tpu_torch.models.h3writer import random_h3, write_h3
    from deciphon_tpu_torch.cli.main import main
    from deciphon_tpu_torch.server.fake_sched import FakeScheduler
    no_jax("after the imports")
tmp = sys.argv[1]
with step("press"):
    with open(f"{tmp}/s.hmm", "w") as fp:
        write_h3(fp, [random_h3(s + 1, k, peak=0.9)
                      for s, k in enumerate((4, 6))])
    assert main(["press", f"{tmp}/s.hmm", "-o", f"{tmp}/s.dtp"]) == 0, "rc"
    p = TensorDB.load(f"{tmp}/s.dtp").profile(1)
    read = "".join(STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
                   for b in map(int, np.argmax(p.match_codonp, 1)))
    with open(f"{tmp}/r.fa", "w") as fp:
        fp.write(f">r1\n{read}\n")
    with open(f"{tmp}/n.fa", "w") as fp:
        fp.write(f">n1\n{read[:4]}N{read[5:]}\n")


def scan(fasta, out, *extra):
    assert main(["scan", f"{tmp}/s.dtp", f"{tmp}/{fasta}", "-o",
                 f"{tmp}/{out}", "--device", "cpu", *extra]) == 0, "rc"
    text = open(f"{tmp}/{out}").read()
    assert p.accession in text, f"{p.accession} not in {text!r}"


with step("scan"):
    scan("r.fa", "p.tsv")
with step("forward scan of a read holding N"):
    scan("n.fa", "f.tsv", "--forward")
with step("scan --best-hit"):
    scan("r.fa", "b.tsv", "--best-hit")
with step("scan --shard 2/2"):
    assert main(["scan", f"{tmp}/s.dtp", f"{tmp}/r.fa", "-o",
                 f"{tmp}/h.tsv", "--device", "cpu", "--shard", "2/2"]) == 0
with step("standard scan"):
    from deciphon_tpu_torch.db.standard_db import write_standard_db
    from deciphon_tpu_torch.models.standard import sample_standard
    write_standard_db(f"{tmp}/std.dtp",
                      [sample_standard(s + 1, 3) for s in range(2)])
    assert main(["scan", f"{tmp}/std.dtp", f"{tmp}/r.fa", "-o",
                 f"{tmp}/std.tsv", "--device", "cpu"]) == 0, "rc"
with step("info on a .dcp"):
    import msgpack
    from deciphon_tpu_torch.db import dcp
    prof = {"accession": "PF00001.1", "null": b"\x01" * 40,
            "alt": b"\x02" * 90, "core_size": 3, "consensus": "AAA",
            **{k: i + 1 for i, k in enumerate(dcp._SPECIALS)}}
    with open(f"{tmp}/ref.dcp", "wb") as fp:
        fp.write(msgpack.packb({"header": {
            "magic_number": dcp.DCP_MAGIC, "profile_typeid": 2,
            "float_size": 4, "entry_dist": 2, "epsilon": 0.01,
            "profile_sizes": [100]}, "profiles": [prof]}))
    assert main(["info", f"{tmp}/ref.dcp"]) == 0, "rc"
with step("parity"):
    assert main(["parity", f"{tmp}/s.hmm", "-o", f"{tmp}/par.tsv"]) == 0
with step("start the fake scheduler"):
    fake = FakeScheduler(spool_dir=f"{tmp}/spool")
    url = fake.serve()
    host, port = url.rsplit("/", 1)[1].split(":")
    with open(f"{tmp}/.env", "w") as fp:
        fp.write(f"API_HOST={host}\nAPI_PORT={port}\n")
serve = ["serve", "--env", f"{tmp}/.env", "--single-run", "--device", "cpu",
         "--cache-dir", f"{tmp}/cache"]
try:
    with step("serve --single-run: press job"):
        fake.add_hmm("d.hmm", open(f"{tmp}/s.hmm", "rb").read())
        assert main(serve) == 0, "rc"
        jobs = {j.state for j in fake.jobs.values()}
        assert jobs == {"done"}, fake.jobs
    with step("serve --single-run: scan job"):
        db = next(iter(fake.dbs.values()))
        fake.add_scan(db.id, [("r1", read)])
        assert main(serve) == 0, "rc"
        assert all(j.state == "done" for j in fake.jobs.values()), fake.jobs
        assert p.accession in fake.products[-1], fake.products
finally:
    fake.shutdown()
with step("no jax at the end"):
    no_jax("after every step")
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
    """Press, scan (Viterbi, forward with N, --best-hit, --shard), a
    standard scan, info on a .dcp, parity and two serve --single-run
    jobs in a fresh interpreter, with no module of
    jax or deciphon_tpu loaded at any step.  The environment is fixed
    (nothing of the caller's: no PYTHONPATH entries that could preload
    jax, no scheduler or daemon settings), with its own home, temp and
    cache directories."""
    home, tmp, work = tmp_path / "home", tmp_path / "tmp", tmp_path / "work"
    for d in (home, tmp, work):
        d.mkdir()
    env = {
        "PATH": os.environ.get("PATH", os.defpath),
        "HOME": str(home),
        "PYTHONPATH": REPO,
        "OMP_NUM_THREADS": "1",  # small tensors; workers run in parallel
        "TMPDIR": str(tmp),
        "XDG_CACHE_HOME": str(home / ".cache"),
    }
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(work)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO-JAX OK" in proc.stdout, proc.stdout + proc.stderr


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
