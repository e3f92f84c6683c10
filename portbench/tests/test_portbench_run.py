"""A whole run on the CPU at a tiny size: the last line's shape, the
imports, the control and the planted faults all come out as they must."""

import ast
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_cell, traced_cpu_metrics

FORBIDDEN = {"jax", "jaxlib", "flax", "deciphon_tpu"}


def _run(cell, trace=False, seconds=0.5):
    from portbench.lib import harness

    return harness.run(cell, 2**31 + 11, seconds, trace, time.perf_counter(),
                       "cpu", log=lambda m: None)


def test_last_line_shape(tiny_cache):
    res = _run(tiny_cell())
    assert list(res)[-1] == "check" and res["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["metrics"]) == {"reads_per_s.mix", "setup_s"}
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in res["check"].values())
    json.dumps(res, allow_nan=False)


def test_traced_run_reports_per_layer_metrics(tiny_cache):
    """The genes cell's traced run on the CPU reads every metric of the
    program's spans and counters that BENCHMARK.json gives the cell (the
    CPU has no device trace, and launches no kernel to count)."""
    want = traced_cpu_metrics("pfam4k_vit.genes_query")
    assert {"pass1_ms.query", "pass2_ms.query", "pass1_wait_ms.query",
            "codec_ms_per_hit.query"} <= want
    # the window's third request carries a domain: room for a few
    res = _run(tiny_cell("pfam4k_vit.genes_query"), trace=True, seconds=2.0)
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("script, seed", [("run.py", "--seed"),
                                          ("calibrate.py", "--seeds")])
def test_without_a_card_exits_nonzero_and_prints_no_result(script, seed):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, f"portbench/{script}", "--workload",
                        "pfam4k_vit.reads150_bg", seed, "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


def test_sample_holds_every_kind_of_read_and_every_block(tiny_cache):
    """The check's sample takes reads of each kind in the window (homologs,
    background with an N, plain background) and a profile of each of the
    program's blocks."""
    from deciphon_tpu_torch.server.prod import ProdWriter

    from portbench.lib import check, harness
    from portbench.lib.loop import run_window

    cell = tiny_cell()
    cell.mix["check"] = dict(cell.mix["check"], reads=6, profiles=0)
    engine, prm, _ = harness.open_engine(cell, "cpu", lambda m: None)
    blocks = harness.blocks_of(engine)
    assert len(blocks) > 1
    for seed in (1, 2, 3):
        pool, _, _ = harness.make_traffic(cell, prm, seed)
        recs = run_window(engine, ProdWriter(), pool, 0.2)
        sample, _ = check.choose(recs, pool, prm.sizes, blocks, cell.mix["check"], seed)
        kinds = [0 if any(r == u.reads[j] and u.source[j] >= 0 for u in pool
                          for j in range(len(u.reads))) else 1 if "N" in r else 2
                 for r in sample.reads]
        assert len(sample.reads) == 6 and sorted(set(kinds)) == [0, 1, 2], kinds
        assert all(set(b.tolist()) & set(sample.profiles) for b in blocks)


def test_forbidden_names_compare_whole_top_level_names():
    from portbench.lib import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
    top = lambda m: m.split(".")[0]  # noqa: E731
    assert top("deciphon_tpu_torch.ops") not in FORBIDDEN
    assert top("deciphon_tpu.ops") in FORBIDDEN and top("jax.numpy") in FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program_or_jax():
    for f in (ROOT / "portbench" / "reference").glob("*.py"):
        assert not set(_imports(f)) & (FORBIDDEN | {"deciphon_tpu_torch"}), f


def test_benchmark_imports_no_jax():
    for f in (ROOT / "portbench").rglob("*.py"):
        if "tests" not in f.parts:
            assert not set(_imports(f)) & FORBIDDEN, f


def test_a_run_loads_no_jax(tiny_cache):
    code = ("import sys, time, json; sys.path.insert(0, %r); sys.path.insert(0, %r);"
            "from conftest import tiny_cell; from portbench.lib import harness, dbgen;"
            "import pathlib; dbgen.CACHE = pathlib.Path(%r);"
            "harness.run(tiny_cell(), 5, 0.2, False, time.perf_counter(), 'cpu', lambda m: None);"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(ROOT), str(ROOT / "portbench" / "tests"), str(tiny_cache)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert not set(json.loads(p.stdout.splitlines()[-1])) & FORBIDDEN


def test_control_in_a_lower_precision_is_not_correct(tiny_cache):
    """The reference in bfloat16, in the program's place, fails the check
    on three seeds (at the cell's own size it runs on the card:
    portbench/calibrate.py --control-seeds)."""
    from deciphon_tpu_torch.server.prod import ProdWriter

    from portbench.lib import check, harness
    from portbench.lib.loop import run_window

    cell = tiny_cell()
    engine, prm, dbf = harness.open_engine(cell, "cpu", lambda m: None)
    for seed in (1, 2, 3):
        pool, _, _ = harness.make_traffic(cell, prm, seed)
        recs = run_window(engine, ProdWriter(), pool, 0.2)
        res = harness.judge_window(cell, dbf, prm, harness.blocks_of(engine), recs,
                                   pool, seed, "cpu", lambda m: None, torch.bfloat16)
        assert all(res[0][k] <= cell.limits[k] for k in check.NUMBERS)
        assert any(res[2][k] > cell.limits[k] for k in check.NUMBERS)


def _faulty(monkeypatch, fault):
    from deciphon_tpu_torch.ops.scan_engine import ScanEngine

    scan = ScanEngine.scan
    last = {}

    def broken(self, seqs):
        if fault == "half":  # half of the batch left out
            half = len(seqs) // 2
            hits = scan(self, seqs[:half])
            alt, null = self.last_scores
            pad = np.full((len(seqs) - half, alt.shape[1]), -1e30, np.float32)
            self.last_scores = (np.concatenate([alt, pad]), np.concatenate([null, pad]))
            return hits
        hits = scan(self, seqs)
        if fault == "stale":  # the state of the previous call returned again
            prev = last.get("v")
            last["v"] = (hits, self.last_scores)
            if prev is not None:
                hits, self.last_scores = prev
        elif fault == "match" and hits:  # an answer altered where it is produced
            cells = hits[0].match.split(";")
            i = next(i for i, c in enumerate(cells) if c.split(",")[2])
            f, s, codon, _ = cells[i].split(",")
            codon = "TGG" if codon != "TGG" else "TTT"
            cells[i] = ",".join([f, s, codon, {"TGG": "W", "TTT": "F"}[codon]])
            hits[0].match = ";".join(cells)
        elif fault == "score" and hits:
            hits[0].alt_loglik += 1.0
        return hits

    monkeypatch.setattr(ScanEngine, "scan", broken)


@pytest.mark.parametrize("fault", ["half", "stale", "match", "score"])
def test_a_broken_timed_path_is_not_correct(tiny_cache, monkeypatch, fault):
    _faulty(monkeypatch, fault)
    res = _run(tiny_cell(), seconds=1.0)
    assert res["correct"] is False, res["check"]


@pytest.mark.card
def test_a_cell_on_the_card(card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "pfam4k_vit.reads150_bg", "--seed", "3", "--seconds", "2"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
