"""Shared fixtures of the benchmark's tests: a tiny cell on the CPU.

Run with ``python -m pytest portbench/tests``.  Tests marked ``card``
need a CUDA card and skip without one; the skip is decided inside the
``card`` fixture, never at import.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return "cuda"


@pytest.fixture
def tiny_cache(tmp_path, monkeypatch):
    from portbench.lib import dbgen

    monkeypatch.setattr(dbgen, "CACHE", tmp_path / "cache")
    return tmp_path / "cache"


def tiny_cell(workload="pfam4k_vit.reads150_mix", algo=None):
    """The named cell cut to a few small profiles and short reads."""
    from portbench.lib import harness

    c = harness.load_cell(workload)
    cfg = dict(c.config, nprofiles=6, median=20, clip=[8, 40], outliers=[48])
    cfg["scan"] = dict(cfg["scan"], algo=algo or cfg["scan"]["algo"])
    mix = dict(c.mix, check={"reads": 8, "profiles": 3, "hits": 6})
    if mix["driver"] == "batches":
        mix.update(batch=24, read_nt=36, pool=2,
                   homologous=min(mix["homologous"], 4),
                   with_n=min(mix["with_n"], 2),
                   homologous_with_n=min(mix["homologous_with_n"], 1))
    else:
        mix.update(median_nt=60, clip=[30, 90], round=4, with_domain=1,
                   pool_rounds=2)
    return harness.Cell(c.name, 1, cfg, mix, c.limits, c.end_to_end, c.per_layer)


@pytest.fixture
def bench_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# Quantities that only a card produces, and why a traced run on the CPU
# reads nothing of them.
CARD_ONLY = (
    ("launches_per_unit", "the launch.* counters count kernel launches, and the CPU path launches none"),
)


def traced_cpu_metrics(workload: str, recorder: bool = True) -> set[str]:
    """The per-layer metrics that a traced run of ``workload`` on the CPU
    reports, taken from BENCHMARK.json: the cell's entries that the
    program's spans and counters feed (the CPU has no device trace), less
    the quantities of CARD_ONLY.  With ``recorder`` false (a program that
    records no scan) only those whose reader reads no recorded scan."""
    from portbench.lib import harness, spans

    card_only = {q for q, _ in CARD_ONLY}
    out = set()
    for m in harness.load_cell(workload).per_layer:
        if (m["source"] not in ("program_span", "program_counter")
                or m["name"].split(".")[0] in card_only):
            continue
        if recorder or vars(harness.metric_reader(m["name"])).get("spans") is not spans:
            out.add(m["name"])
    return out
